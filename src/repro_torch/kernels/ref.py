"""Plain PyTorch versions of the stencil and row-gather kernels.

The torch counterparts of ``repro.kernels.ref``. On a CPU tensor the
kernel wrappers (kernels/stencil3d.py) run these; on the card
``chip_smoke.py`` holds each CUDA kernel against them on the same inputs.
Taps accumulate in f32 in dk, di, dj order, as the kernels do: with no
fused multiply-add on either side, results are bit-identical.
"""

from __future__ import annotations

import torch

from repro_torch.core.boundary import PERIODIC, as_boundary, pad_cube

from .rules import apply_window_bc, get_rule

__all__ = ["stencil_sum_ref", "gol_rule_ref", "gol3d_step_ref",
           "assemble_halo_ref", "stencil_sum_resident_ref",
           "stencil_fused_ref", "fields_step_ref", "gather_rows_ref"]


def stencil_sum_ref(blocks: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted (2g+1)³ stencil over halo-extended blocks.

    blocks:  (nb, T+2g, T+2g, T+2g)
    weights: (2g+1, 2g+1, 2g+1)
    returns: (nb, T, T, T) f32 — acc[b, z] = sum_d w[d] * blocks[b, z+d]
    """
    s = weights.shape[0]
    g = (s - 1) // 2
    T = blocks.shape[1] - 2 * g
    w = weights.to(torch.float32)
    acc = torch.zeros((blocks.shape[0], T, T, T), dtype=torch.float32,
                      device=blocks.device)
    for dk in range(s):
        for di in range(s):
            for dj in range(s):
                acc = acc + w[dk, di, dj] * (
                    blocks[:, dk:dk + T, di:di + T, dj:dj + T].to(torch.float32))
    return acc


def assemble_halo_ref(store: torch.Tensor, nbr: torch.Tensor, g: int) -> torch.Tensor:
    """Gather each block's (T+2g)³ window from the un-haloed curve-ordered
    store through the (nb, 27) neighbour table.

    store: (nb_src, T, T, T) or the stacked (C, nb_src, T, T, T) store;
    nbr: (nb, 27), nb ≤ nb_src. Returns (nb, T+2g, T+2g, T+2g), with the
    leading C kept for stacked input.
    """
    multi = store.ndim == 5
    T = store.shape[-3]
    if g > T:
        raise ValueError(f"halo width {g} exceeds block edge {T}")
    lead = (slice(None),) if multi else ()
    nb = nbr.shape[0]
    own = store if store.shape[-4] == nb else store[lead + (slice(None, nb),)]
    spans = (slice(T - g, T), slice(None), slice(0, g))  # lo, mid, hi
    slabs = []
    for a in range(3):
        planes = []
        for b in range(3):
            parts = []
            for c in range(3):
                col = a * 9 + b * 3 + c
                src = own if col == 13 else store[lead + (nbr[:, col],)]
                parts.append(src[lead + (slice(None), spans[a], spans[b],
                                         spans[c])])
            planes.append(torch.cat(parts, dim=-1))
        slabs.append(torch.cat(planes, dim=-2))
    return torch.cat(slabs, dim=-3)


def stencil_sum_resident_ref(store: torch.Tensor, weights: torch.Tensor,
                             nbr: torch.Tensor) -> torch.Tensor:
    """Plain version of stencil3d.stencil_sum_resident."""
    g = (weights.shape[0] - 1) // 2
    return stencil_sum_ref(assemble_halo_ref(store, nbr, g), weights)


def stencil_fused_ref(store: torch.Tensor, weights: torch.Tensor,
                      nbr: torch.Tensor, *, S: int = 1, rule="gol",
                      bc=PERIODIC, bnd: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of stencil3d.stencil_step_fused (DESIGN.md §4).

    Assembles the (T+2·S·g)³ window once, then runs S substeps of ghost
    refresh (clamped runs) + tap sum of every channel + rule, the window
    shrinking by g per side, vectorised over blocks. Bit-identical (f32)
    to S sequential S=1 steps.
    """
    g = (weights.shape[0] - 1) // 2
    bc = as_boundary(bc)
    r = get_rule(rule)
    if bc.clamped and bnd is None:
        raise ValueError(f"bc={bc.kind!r} needs the (nb, 6) bnd flag table")
    multi = store.ndim == 5
    C = store.shape[0] if multi else 1
    if C != r.channels:
        raise ValueError(
            f"rule {r.name!r} advances {r.channels} channel(s) but the store "
            f"carries {C} (shape {tuple(store.shape)})")
    x = assemble_halo_ref(store, nbr, S * g).to(torch.float32)
    for u in range(S):
        if bc.clamped:
            x = apply_window_bc(x, bnd, g * (S - u), bc)
        if multi:
            tap = torch.stack([stencil_sum_ref(x[c], weights) for c in range(C)])
            centre = x[:, :, g:-g, g:-g, g:-g]
        else:
            tap = stencil_sum_ref(x, weights)
            centre = x[:, g:-g, g:-g, g:-g]
        x = r.apply(centre, tap, g)
    return x.to(store.dtype)


def fields_step_ref(fields: torch.Tensor, weights: torch.Tensor, g: int,
                    rule="gol", bc=PERIODIC) -> torch.Tensor:
    """One multi-field update on (C, M, M, M) canonical row-major fields:
    ghost-extend every channel under ``bc``, tap-sum per channel in dk, di,
    dj order, apply the rule. A 3-D input is C=1 and returned 3-D."""
    r = get_rule(rule)
    squeeze = fields.ndim == 3
    if squeeze:
        fields = fields[None]
    C, M = fields.shape[0], fields.shape[1]
    if tuple(fields.shape) != (C, M, M, M):
        raise ValueError(f"fields_step_ref needs (C,M,M,M), got {tuple(fields.shape)}")
    if C != r.channels:
        raise ValueError(
            f"rule {r.name!r} advances {r.channels} channel(s), got {C}")
    s = weights.shape[0]
    if s != 2 * g + 1:
        raise ValueError(f"weights {tuple(weights.shape)} do not match g={g}")
    w = weights.to(torch.float32)
    xp = torch.stack([pad_cube(fields[c], g, bc) for c in range(C)])
    tap = torch.zeros((C, M, M, M), dtype=torch.float32, device=fields.device)
    for dk in range(s):
        for di in range(s):
            for dj in range(s):
                tap = tap + w[dk, di, dj] * (
                    xp[:, dk:dk + M, di:di + M, dj:dj + M].to(torch.float32))
    out = r.apply(fields.to(torch.float32), tap, g).to(fields.dtype)
    return out[0] if squeeze else out


def gol_rule_ref(state: torch.Tensor, neigh_sum: torch.Tensor, g: int) -> torch.Tensor:
    """Generalised Game-of-Life rule (rules.gol_thresholds)."""
    return get_rule("gol").apply(state, neigh_sum, g).to(state.dtype)


def gol3d_step_ref(cube: torch.Tensor, g: int, bc=PERIODIC) -> torch.Tensor:
    """One gol3d update on an (M,M,M) canonical cube: the
    ordering-independent oracle every pipeline form is held against."""
    s = 2 * g + 1
    xp = pad_cube(cube, g, bc)
    M = cube.shape[0]
    total = torch.zeros_like(cube, dtype=torch.float32)
    for dk in range(s):
        for di in range(s):
            for dj in range(s):
                total = total + xp[dk:dk + M, di:di + M, dj:dj + M].to(torch.float32)
    neigh = total - cube.to(torch.float32)  # exclude centre
    return gol_rule_ref(cube, neigh, g)


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src: (N, L); idx: (R,) int32 -> (R, L), ``src[idx]``."""
    return src[idx]
