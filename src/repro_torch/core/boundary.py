"""Physical boundary conditions for the stencil pipelines (DESIGN.md §8).

The torch counterpart of ``repro.core.boundary``: one definition of the
boundary contract shared by every pipeline form and its plain version.

- ``periodic``         — wrap at the domain edge (the torus default);
- ``dirichlet(value)`` — ghost sites hold a fixed value at all times;
- ``neumann0``         — zero normal gradient: ghost sites replicate the
  nearest in-domain plane (edge replication).

:class:`MixedBoundary` carries one :class:`BoundarySpec` per grid axis in
``(k, i, j)`` order; every consumer reads the per-axis contract through
the shared ``axes`` property, so uniform and mixed runs flow through the
same code. On a multi-field store (DESIGN.md §9) the contract applies to
every channel alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["BoundarySpec", "MixedBoundary", "PERIODIC", "NEUMANN0",
           "dirichlet", "mixed", "as_boundary", "axes_periodic", "pad_cube"]

_KINDS = ("periodic", "dirichlet", "neumann0")


@dataclass(frozen=True)
class BoundarySpec:
    """The boundary-condition contract of one stencil run.

    kind:  "periodic" | "dirichlet" | "neumann0"
    value: the fixed ghost value for dirichlet (ignored otherwise)
    """
    kind: str = "periodic"
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown boundary kind {self.kind!r}; known: {_KINDS}")

    @property
    def clamped(self) -> bool:
        return self.kind != "periodic"

    @property
    def axes(self) -> tuple["BoundarySpec", "BoundarySpec", "BoundarySpec"]:
        return (self, self, self)


PERIODIC = BoundarySpec("periodic")
NEUMANN0 = BoundarySpec("neumann0")


@dataclass(frozen=True)
class MixedBoundary:
    """Per-axis boundary contract: one :class:`BoundarySpec` per grid axis
    (``k``, ``i``, ``j``). Build with :func:`mixed`, which collapses a
    uniform triple back to the plain spec."""
    k: BoundarySpec = PERIODIC
    i: BoundarySpec = PERIODIC
    j: BoundarySpec = PERIODIC

    def __post_init__(self):
        for ax in (self.k, self.i, self.j):
            if not isinstance(ax, BoundarySpec):
                raise ValueError(
                    f"MixedBoundary axes must be BoundarySpec, got {ax!r}")

    @property
    def kind(self) -> str:
        return "mixed"

    @property
    def clamped(self) -> bool:
        return any(ax.clamped for ax in self.axes)

    @property
    def axes(self) -> tuple[BoundarySpec, BoundarySpec, BoundarySpec]:
        return (self.k, self.i, self.j)


def dirichlet(value: float = 0.0) -> BoundarySpec:
    """Fixed-value boundary: ghost sites hold ``value`` at every step."""
    return BoundarySpec("dirichlet", float(value))


def mixed(k: "BoundarySpec | str" = PERIODIC,
          i: "BoundarySpec | str" = PERIODIC,
          j: "BoundarySpec | str" = PERIODIC):
    """Per-axis contract, e.g. ``mixed(k="neumann0")`` for a clamped-k slab;
    a uniform triple collapses to the plain :class:`BoundarySpec`."""
    k, i, j = as_boundary(k), as_boundary(i), as_boundary(j)
    if k == i == j:
        return k
    return MixedBoundary(k, i, j)


def as_boundary(bc: "BoundarySpec | MixedBoundary | str"):
    """Coerce a kind string to a :class:`BoundarySpec` (dirichlet value
    0.0); specs and :class:`MixedBoundary` pass through unchanged."""
    if isinstance(bc, (BoundarySpec, MixedBoundary)):
        return bc
    return BoundarySpec(bc)


def axes_periodic(bc) -> tuple[bool, bool, bool]:
    """Per-axis wrap flags — the neighbour-table view."""
    return tuple(not ax.clamped for ax in as_boundary(bc).axes)


_PAD_MODE = {"periodic": "circular", "neumann0": "replicate"}


def _pad(cube: torch.Tensor, pads: tuple, bc: BoundarySpec) -> torch.Tensor:
    """``F.pad`` of an (M,M,M) cube through a 5-D view (circular and
    replicate padding need the batch and channel axes)."""
    x = cube[None, None]
    if bc.kind == "dirichlet":
        out = F.pad(x, pads, mode="constant", value=bc.value)
    else:
        out = F.pad(x, pads, mode=_PAD_MODE[bc.kind])
    return out[0, 0]


def pad_cube(cube: torch.Tensor, g: int, bc) -> torch.Tensor:
    """Ghost-extend an (M,M,M) cube by ``g`` per side under ``bc``.

    Wrap for periodic, constant fill for dirichlet, edge replication for
    neumann0. A uniform contract pads all axes in one call; a
    :class:`MixedBoundary` pads each axis under its own spec in k, i, j
    order — the corner semantics ``apply_window_bc`` reproduces.
    """
    bc = as_boundary(bc)
    axes = bc.axes
    if axes[0] == axes[1] == axes[2]:
        return _pad(cube, (g,) * 6, axes[0])
    out = cube
    for ax in range(3):
        pads = [0] * 6  # F.pad lists the last axis (j) first
        pads[2 * (2 - ax)] = pads[2 * (2 - ax) + 1] = g
        out = _pad(out, tuple(pads), axes[ax])
    return out
