"""Update-rule registry + boundary tap substitution (DESIGN.md §4, §8, §9).

The torch counterpart of ``repro.kernels.rules``. The fused stencil
applies ``fields' = rule(fields, tap_sums)`` after every tap sum; these
callables are the plain versions that the CPU path runs and that the
CUDA kernel's rule epilogue (csrc/stencil3d.cu) reproduces bit for bit.

A rule declares ``channels`` (C) and its ``apply(fields_f32,
tap_sums_f32, g)`` receives the C state fields stacked on a leading axis
together with the weighted tap sum of every channel. gol, jacobi and
identity are elementwise C=1 rules; ``wave`` (C=2) is the leapfrog that
couples channels.

:func:`apply_window_bc` substitutes boundary values into a window's
ghost layers before each tap sum on clamped runs, axis by axis (k, i, j)
so corners compose like the padded-cube oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.boundary import BoundarySpec, MixedBoundary, as_boundary

__all__ = ["UpdateRule", "RULES", "get_rule", "gol_thresholds",
           "WAVE_KAPPA", "apply_window_bc"]


@dataclass(frozen=True)
class UpdateRule:
    """name: registry key; apply(fields_f32, tap_sums_f32, g) -> next_f32;
    ``channels`` (C) is the number of state fields the rule advances."""
    name: str
    apply: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
    doc: str = ""
    channels: int = 1


def gol_thresholds(g: int) -> tuple[int, int, int]:
    """(survive_lo, survive_hi, born) for the generalised GoL rule: with
    n = (2g+1)³ - 1 neighbours, survive in [2,3]·n/8, born at 3n/8."""
    n = (2 * g + 1) ** 3 - 1
    lo = (2 * n) // 8
    hi = (3 * n) // 8
    return lo, hi, hi


def _gol(centre: torch.Tensor, tap: torch.Tensor, g: int) -> torch.Tensor:
    lo, hi, born = gol_thresholds(g)
    alive = centre > 0.5
    nxt = torch.where(alive, (tap >= lo) & (tap <= hi), tap == born)
    return nxt.to(torch.float32)


def _jacobi(centre: torch.Tensor, tap: torch.Tensor, g: int) -> torch.Tensor:
    # Box-filter mean over the (2g+1)³ cube. The divisor is a tensor on the
    # operands' device: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, which can round differently from the
    # IEEE division that the kernel performs.
    n = (2 * g + 1) ** 3 - 1
    div = torch.full((), float(n + 1), dtype=torch.float32, device=centre.device)
    return (centre + tap) / div


def _identity(centre: torch.Tensor, tap: torch.Tensor, g: int) -> torch.Tensor:
    return tap


# Courant-like coupling of the wave leapfrog: a power of two, so κ·lap is an
# exact f32 scaling and the rule rounds the same in every implementation.
WAVE_KAPPA = 0.03125  # 2**-5


def _wave(fields: torch.Tensor, taps: torch.Tensor, g: int) -> torch.Tensor:
    """2-field wave leapfrog (DESIGN.md §9): lap u = Σ_neigh u - n·u, then
    v' = v + κ·lap u, u' = u + v'. ``n·u`` is subtracted as power-of-two
    multiples in descending order (16u, 8u, 2u for g=1), each an exact
    scaling, so every implementation rounds alike."""
    n = (2 * g + 1) ** 3 - 1
    u, v = fields[0], fields[1]
    lap = taps[0]
    bit = 1 << (n.bit_length() - 1)
    rem = n
    while bit:
        if rem >= bit:
            lap = lap - float(bit) * u
            rem -= bit
        bit >>= 1
    v2 = v + WAVE_KAPPA * lap
    u2 = u + v2
    return torch.stack([u2, v2])


RULES: dict[str, UpdateRule] = {
    "gol": UpdateRule("gol", _gol, "generalised 3D Game of Life (paper §4)"),
    "jacobi": UpdateRule("jacobi", _jacobi, "Jacobi/heat box-filter relaxation"),
    "identity": UpdateRule("identity", _identity, "raw weighted stencil sum"),
    "wave": UpdateRule("wave", _wave,
                       "FDTD-style 2-field wave leapfrog (u, v)", channels=2),
}


def apply_window_bc(x: torch.Tensor, flags, depth: int,
                    bc: BoundarySpec | MixedBoundary | str) -> torch.Tensor:
    """Substitute boundary values into a window's ghost layers.

    x:      a window whose last three axes are spatial — ``(nb, E, E, E)``
            or ``(C, nb, E, E, E)`` in the batched plain versions
    flags:  ``(nb, 6)`` int tensor of clamped domain faces,
            ``[k-, k+, i-, i+, j-, j+]`` (core.neighbors.boundary_face_table)
    depth:  ghost width to refresh on each flagged face
    bc:     dirichlet writes its constant, neumann0 replicates the plane
            at ``depth`` (low side) or ``E-1-depth`` (high side); periodic
            axes of a mixed contract are skipped.

    Axes go in k, i, j order; each axis sees the planes that the earlier
    axes wrote, as per-axis padding does.
    """
    bc = as_boundary(bc)
    if not bc.clamped or depth == 0:
        return x
    E = x.shape[-1]

    def flag(col):  # (nb, 1, 1, 1): broadcasts over the window and channels
        return (flags[..., col] != 0)[..., None, None, None]

    for ax in range(3):
        ax_bc = bc.axes[ax]
        if not ax_bc.clamped:
            continue
        axis = ax - 3
        shape = [1, 1, 1]
        shape[ax] = E
        iota = torch.arange(E, device=x.device).reshape(shape)
        if ax_bc.kind == "dirichlet":
            lo_fill = hi_fill = torch.full((), ax_bc.value, dtype=x.dtype,
                                           device=x.device)
        else:  # neumann0: replicate the nearest in-domain plane
            lo_fill = x.narrow(axis, depth, 1)
            hi_fill = x.narrow(axis, E - 1 - depth, 1)
        x = torch.where((iota < depth) & flag(2 * ax), lo_fill, x)
        x = torch.where((iota >= E - depth) & flag(2 * ax + 1), hi_fill, x)
    return x


def get_rule(rule: str | UpdateRule) -> UpdateRule:
    if isinstance(rule, UpdateRule):
        return rule
    try:
        return RULES[rule]
    except KeyError:
        raise ValueError(
            f"unknown update rule {rule!r}; known: {sorted(RULES)}") from None
