"""Plain PyTorch versions of the stencil, row-gather and attention kernels.

The torch counterparts of ``repro.kernels.ref``. On a CPU tensor the
kernel wrappers (kernels/stencil3d.py, sfc_gather.py, flash_attn.py) run
these; on the card
``chip_smoke.py`` holds each CUDA kernel against them on the same inputs.
Taps accumulate in f32 in dk, di, dj order, as the kernels do: with no
fused multiply-add on either side, results are bit-identical.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.boundary import PERIODIC, as_boundary, pad_cube

from .rules import apply_window_bc, get_rule

__all__ = ["round_to", "stencil_sum_ref", "gol_rule_ref", "gol3d_step_ref",
           "assemble_halo_ref", "stencil_sum_resident_ref",
           "stencil_fused_ref", "fields_step_ref", "gather_rows_ref",
           "attention_ref", "flash_attention_ref", "flash_attention_lse_ref",
           "flash_attention_bwd_ref"]

# float8_e4m3fn has no infinity and 448 is its largest finite value; XLA
# rounds to nearest even below the midpoint to the next step (480, which
# the format lacks) and gives NaN above it.
_E4M3_LIMIT = 464.0


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded once to ``dtype`` as XLA converts: to nearest even.

    ``Tensor.to(float8_e4m3fn)`` saturates at 448 where XLA gives NaN
    (every |x| > 464, and ±inf), keeping the sign; this gives NaN there.
    Every other dtype is ``x.to(dtype)``, XLA's values (a NaN's payload
    is not: even the JAX package writes e5m2 NaN as 0x7E from ``astype``
    and 0x7F from its kernels). The CUDA kernels' stores round the same
    (csrc/fp8_round.cuh).
    """
    if dtype == torch.float8_e4m3fn:
        nan = torch.copysign(torch.full((), float("nan"), device=x.device), x)
        return torch.where(~(x.abs() <= _E4M3_LIMIT), nan, x).to(dtype)
    return x.to(dtype)


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
    return round_to(x, store.dtype)


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
    out = round_to(r.apply(fields.to(torch.float32), tap, g), fields.dtype)
    return out[0] if squeeze else out


def gol_rule_ref(state: torch.Tensor, neigh_sum: torch.Tensor, g: int) -> torch.Tensor:
    """Generalised Game-of-Life rule (rules.gol_thresholds)."""
    return round_to(get_rule("gol").apply(state, neigh_sum, g), state.dtype)


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


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(sq, sk) bool: key j is visible to query i iff j <= i + (sk - sq),
    the causal diagonal aligned to the END (decode against a cache)."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril(sk - sq)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Dense softmax attention oracle. q,k,v: (BH, S, D) (heads pre-folded).
    A causal row with no key (Sq > Sk) gives NaN, as in the JAX package."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return round_to(torch.einsum("bqk,bkd->bqd", p, v.float()), q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The plain version of the ``flash_attention_fwd`` kernel: dense f32
    softmax attention, scores scaled by 1/sqrt(D) after the product as the
    kernel does, the causal diagonal aligned to the end. A row with no
    key gives 0, as the kernel does (``attention_ref`` gives NaN).

    q: (BH, Sq, D); k, v: (BH, Sk, D); any dtype the kernel takes -> q's
    dtype, rounded once by :func:`round_to`.
    """
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        empty = ~mask.any(dim=-1)[None, :, None]
        s = s.masked_fill(~mask, float("-inf")).masked_fill(empty, 0.0)
        p = torch.softmax(s, dim=-1).masked_fill(empty, 0.0)
    else:
        p = torch.softmax(s, dim=-1)
    return round_to(torch.einsum("bqk,bkd->bqd", p, v.float()), q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 (BH, Sq, Sk) scores q·k scaled by 1/sqrt(D) after the product,
    keys past the causal diagonal (aligned to the end) at -inf."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        s.masked_fill_(~_causal_mask(q.shape[1], k.shape[1], q.device),
                       float("-inf"))
    return s


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = True) -> torch.Tensor:
    """The per-row log-sum-exp of the scaled scores that the forward
    kernels save for the backward: f32 (BH, Sq), natural log. A row with no
    key gets +inf, the sentinel under which the backward's exp(s - lse) is
    0 for every key, so that the row's gradients are 0."""
    lse = torch.logsumexp(_scores(q, k, causal), dim=-1)
    return lse.masked_fill(lse == float("-inf"), float("inf"))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True):
    """The plain version of the ``flash_attention_bwd`` kernels: the
    vector-Jacobian product of :func:`flash_attention_ref` at (q, k, v)
    against the output's cotangent ``do``, from the forward's output ``o``
    and log-sum-exp ``lse`` (:func:`flash_attention_lse_ref`), in f32 as
    the kernels compute it: P = exp(s - lse) from the scaled scores s,
    dV = Pᵀ dO, dP = dO Vᵀ, Δ = rowsum(dO∘O), dS = P∘(dP - Δ),
    dQ = dS K / sqrt(D), dK = dSᵀ Q / sqrt(D). Keys past the causal
    diagonal and rows with no key (lse = +inf) get P = 0, so such a row's
    gradients are 0 (the dense oracle's are NaN there).

    q, o, do: (BH, Sq, D); k, v: (BH, Sk, D); lse: f32 (BH, Sq). Returns
    (dq, dk, dv), each rounded once to q's dtype by :func:`round_to`.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = _scores(q, k, causal).sub_(lse[..., None]).exp_()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = torch.einsum("bqd,bkd->bqk", dof, vf).sub_(delta).mul_(p)
    del p
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return tuple(round_to(t, q.dtype) for t in (dq, dk, dv))
