"""Public operations around the kernels: the repack step, the face pack
primitive and flash attention with GQA folding.

The torch counterparts of ``repro.kernels.ops.uniform_weights``,
``gol3d_step``, ``sfc_gather_take``, ``pack_surface`` and
``unpack_surface`` and ``flash_attention``. The device decides the path:
on CUDA the tap sum runs through the ``stencil_sum_blocks`` kernel, the
gather through the ``gather_rows`` kernel and attention through the
``flash_attention_fwd`` kernel; on the CPU through their plain versions
(the gather is then ``index_select`` along the last axis). The rule and the
element selection after the row gather run as torch code on both, and so
does attention's backward, a recompute through the dense oracle.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.boundary import PERIODIC
from repro_torch.core.layout import blockize_with_halo, device_constant, unblockize
from repro_torch.core.orderings import OrderingSpec
from repro_torch.core.surfaces import surface_path_indices

from . import ref
from .flash_attn import flash_attention_fwd
from .sfc_gather import gather_rows
from .stencil3d import stencil_sum_blocks

__all__ = ["flash_attention", "gol3d_step", "pack_surface", "sfc_gather_take",
           "uniform_weights", "unpack_surface"]


def _build_uniform_weights(g: int) -> np.ndarray:
    s = 2 * g + 1
    w = np.ones((s, s, s), dtype=np.float32)
    w[g, g, g] = 0.0
    return w


def uniform_weights(g: int, device="cuda") -> torch.Tensor:
    """All-ones stencil with a zero centre (neighbour count), as a cached
    device constant. Callers must not write to it."""
    return device_constant(("golw", g), lambda: _build_uniform_weights(g), device)


def gol3d_step(cube: torch.Tensor, *, g: int, T: int = 8,
               block_kind: str = "morton", bc=PERIODIC) -> torch.Tensor:
    """One gol3d update via the SFC-blocked repack pipeline:
    blockize_with_halo → tap-sum kernel → rule → unblockize. Equal to
    ref.gol3d_step_ref under the same ``bc``."""
    M = cube.shape[0]
    blocks = blockize_with_halo(cube, T, g, kind=block_kind, bc=bc)
    neigh = stencil_sum_blocks(blocks, uniform_weights(g, cube.device), g=g)
    centre = blocks[:, g:g + T, g:g + T, g:g + T]
    nxt = ref.gol_rule_ref(centre, neigh, g)
    return unblockize(nxt, M, kind=block_kind)


def _surface_idx_device(spec: OrderingSpec, M: int, g: int, face: str,
                        device="cuda") -> torch.Tensor:
    """Cached device copy of a face's path-index list (int64, the index
    type of ``index_copy``)."""
    return device_constant(
        ("surfidx", spec, M, g, face),
        lambda: surface_path_indices(spec, M, g, face).astype(np.int64), device)


_ROW_PLANS: dict = {}
_ROW_PLANS_CAP = 256
# Same contract as layout._DEVICE_CONSTANTS_LOCK: every read-modify-write
# of the LRU dict holds the lock.
_ROW_PLANS_LOCK = threading.RLock()


def _row_plan(idx: np.ndarray, line: int, plan_key=None):
    """(unique rows covering idx, per-element position) — cached by key.

    The np.unique/searchsorted plan depends only on (idx, line); callers
    with a stable idx provenance (pack_surface: one face of one ordering)
    pass ``plan_key`` so repeated packs of the same face skip the O(|idx|
    log |idx|) host work. LRU-capped and lock-guarded like
    layout.device_constant; concurrent misses may both compute the plan
    (pure — benign), the dict is only touched under the lock.
    """
    key = None if plan_key is None else (plan_key, line)
    if key is not None:
        with _ROW_PLANS_LOCK:
            hit = _ROW_PLANS.get(key)
            if hit is not None:
                _ROW_PLANS[key] = _ROW_PLANS.pop(key)  # move-to-end
                return hit
    idx = np.asarray(idx)
    rows = np.unique(idx // line).astype(np.int32)
    pos = (np.searchsorted(rows, idx // line) * line + idx % line).astype(np.int32)
    rows.setflags(write=False)
    pos.setflags(write=False)
    if key is not None:
        with _ROW_PLANS_LOCK:
            while len(_ROW_PLANS) >= _ROW_PLANS_CAP:
                _ROW_PLANS.pop(next(iter(_ROW_PLANS)))
            _ROW_PLANS[key] = (rows, pos)
    return rows, pos


def _table(key, build, device) -> torch.Tensor:
    """A device copy of ``build()``: cached when the caller named it."""
    if key is None:
        return torch.from_numpy(np.array(build())).to(device)
    return device_constant(key, build, device)


def sfc_gather_take(data: torch.Tensor, idx: np.ndarray, *, line: int = 64,
                    plan_key=None) -> torch.Tensor:
    """``data[..., idx]`` for a flat ``(n,)`` array or a stacked ``(C, n)``
    store, bit for bit.

    On the card: fetch the unique ``line``-sized rows covering ``idx``
    with the ``gather_rows`` kernel (one launch for every channel: row
    ``c·(channel stride)/line + row`` of the store), then select the
    elements. The row count is the device-memory traffic of the pack —
    SFC layouts need fewer rows (paper Figs 11/15 re-expressed). On the
    CPU: ``index_select`` along the last axis. ``plan_key`` (hashable,
    identifying idx's provenance) memoises the row plan and its device
    tables across calls.
    """
    idx = np.asarray(idx)
    if data.device.type == "cpu":
        ix = _table(None if plan_key is None else ("takeidx", plan_key),
                    lambda: idx, data.device)
        return data.index_select(-1, ix)
    return _row_take(data, idx, line, plan_key)


def _row_take(data: torch.Tensor, idx: np.ndarray, line: int,
              plan_key) -> torch.Tensor:
    """The card's route of :func:`sfc_gather_take`: whole rows through
    ``gather_rows``, then the elements. On a CPU tensor ``gather_rows``
    runs its plain version, which is how the tests check this route's
    index arithmetic."""
    dev = data.device
    if data.ndim not in (1, 2):
        raise ValueError(f"data must be (n,) or (C, n), got {tuple(data.shape)}")
    n = data.shape[-1]
    if n % line:
        raise ValueError(f"data length {n} is not a multiple of line={line}")
    rows, pos = _row_plan(idx, line, plan_key)
    flat = data if data.ndim == 2 else data[None]
    C = flat.shape[0]
    if flat.stride(-1) != 1 or flat.stride(0) % line or \
            (C > 1 and flat.stride(0) < n):
        flat = flat.contiguous()
    chan_rows = flat.stride(0) // line if C > 1 else n // line
    src = flat.as_strided(((C - 1) * chan_rows + n // line, line), (line, 1))
    pkey = None if plan_key is None else ("rowplan", plan_key, line)
    rows_all = _table(
        None if pkey is None else pkey + ("rows", C, chan_rows),
        lambda: (np.arange(C, dtype=np.int64)[:, None] * chan_rows
                 + rows[None, :]).astype(np.int32).ravel(), dev)
    got = gather_rows(src, rows_all).view(C, -1)
    out = got.index_select(-1, _table(None if pkey is None else pkey + ("pos",),
                                      lambda: pos, dev))
    return out if data.ndim == 2 else out[0]


def pack_surface(data_path: torch.Tensor, spec: OrderingSpec, M: int, g: int,
                 face: str, *, line: int = 64) -> torch.Tensor:
    """Pack one face of a path-ordered cube into a contiguous buffer.

    ``data_path`` is the (M³,) cube in ``spec`` order (apply_ordering) —
    or the stacked multi-field ``(C, M³)`` state (DESIGN.md §9), packed
    along the last axis so one call moves every channel's face. Buffer
    order is curve-visit order p_t (paper §3.2). The row plan is cached
    on (spec, M, g, face, line) across calls.

    ``g`` is the face *width* — the communication-avoiding distributed
    pipeline packs deep faces of width S·g (stencil/halo.py), straight
    from the resident block store by passing ``layout.store_spec(kind,
    T)`` as the spec (the store is path-ordered state under that hybrid
    ordering).
    """
    idx = surface_path_indices(spec, M, g, face)
    return sfc_gather_take(data_path, idx, line=line,
                           plan_key=(spec, M, g, face))


def unpack_surface(data_path: torch.Tensor, buf: torch.Tensor,
                   spec: OrderingSpec, M: int, g: int, face: str) -> torch.Tensor:
    """Inverse of pack_surface: a copy of ``data_path`` with the buffer
    scattered back into the face (the input is not modified)."""
    idx = _surface_idx_device(spec, M, g, face, data_path.device)
    return data_path.index_copy(-1, idx, buf)


# ----------------------------------------------------------------------
# Flash attention public API (GQA folding + trainable autograd.Function)
# ----------------------------------------------------------------------

def _fold_gqa(q, k, v):
    """(B,Hq,S,D)/(B,Hkv,S,D) -> (B*Hq, S, D) with kv repeated per group:
    query head h reads kv head h // (Hq/Hkv), as ``jnp.repeat`` along the
    heads gives (``Tensor.repeat`` would tile instead). The backward of
    ``repeat_interleave`` sums each group's gradients into its kv head."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    assert Hq % Hkv == 0, (Hq, Hkv)
    rep = Hq // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    return (q.reshape(B * Hq, Sq, D), k.reshape(B * Hq, -1, D),
            v.reshape(B * Hq, -1, D))


def _pick_block(s: int, pref: int) -> int:
    b = min(pref, s)
    while s % b:
        b //= 2
    return max(b, 1)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` of ``flash_attention``: the forward
    launches ``flash_attention_fwd`` and saves (q, k, v); the backward
    recomputes the dense oracle (``ref.attention_ref``) on them and takes
    its vector-Jacobian product. The kernel stays forward only, as on the
    TPU; the recompute is plain torch arithmetic on the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, schedule, block_q, block_k):
        B, Hq, Sq, D = q.shape
        qf, kf, vf = _fold_gqa(q, k, v)
        bq = _pick_block(Sq, block_q)
        bk = _pick_block(kf.shape[1], block_k)
        o = flash_attention_fwd(qf, kf, vf, causal=causal, block_q=bq,
                                block_k=bk, schedule=schedule)
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return o.reshape(B, Hq, Sq, D)

    @staticmethod
    def backward(ctx, g_out):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd_recompute"), \
                torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            B, Hq, Sq, D = q.shape
            o = ref.attention_ref(*_fold_gqa(q, k, v), causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o.reshape(B, Hq, Sq, D), (q, k, v),
                                             g_out)
        return dq, dk, dv, None, None, None, None


_BATCH_AXES = ("pod", "data")


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous: a gradient that leaves
    ``local_map`` reaches DTensor's views of the heads (the backward of a
    (B, S, H·hd) -> (B, S, H, hd) view), which refuse a permuted local
    tensor."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_heads(fn, qs, kvs, shared=(), head_dim: int = 2):
    """``fn(*qs, *kvs, *shared)`` on each rank's batch rows and heads of
    DTensors (``local_map``; an attention has no DTensor sharding rule
    that keeps its heads split). ``qs`` hold H q heads along
    ``head_dim``, ``kvs`` KV heads there, ``shared`` (B, ...) are read by
    every head; ``fn`` returns the heads it was given along ``head_dim``,
    and so does this, as one DTensor placed as q is. The batch (dim 0) is
    split over the mesh's batch axes where they divide it, the heads over
    "model" where H divides it and each rank's q heads read whole kv
    groups or all one kv head; the rest is replicated. Where a rank's q
    heads read one kv head of fewer than the ranks, the kv heads come
    whole and it takes that one, and the gradients of ``kvs`` and
    ``shared`` are partial sums over "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = qs[0].device_mesh
    B, H = qs[0].shape[0], qs[0].shape[head_dim]
    KV = kvs[0].shape[head_dim]
    rep = H // KV
    q_pl, kv_pl, kv_grad, sh_pl, sh_grad = [], [], [], [], []
    pick = False
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        q_p = kv_p = kv_g = sh_p = sh_g = Replicate()
        if name in _BATCH_AXES and B % n == 0:
            B //= n
            q_p = kv_p = kv_g = sh_p = sh_g = Shard(0)
        elif name == "model" and H % n == 0 and (KV % n == 0 or rep % (H // n) == 0):
            q_p, sh_g = Shard(head_dim), Partial()
            pick = KV % n != 0
            kv_p, kv_g = ((Replicate(), Partial()) if pick
                          else (Shard(head_dim), Shard(head_dim)))
        q_pl.append(q_p)
        kv_pl.append(kv_p)
        kv_grad.append(kv_g)
        sh_pl.append(sh_p)
        sh_grad.append(sh_g)
    nq, nkv, ns = len(qs), len(kvs), len(shared)

    def local(*ts):
        ts = tuple(_ContiguousGrad.apply(t) for t in ts)
        lq, lkv = ts[:nq], ts[nq:nq + nkv]
        if pick:  # this rank's q heads all read global kv head `first // rep`
            first = mesh.get_local_rank("model") * lq[0].shape[head_dim]
            lkv = tuple(t.narrow(head_dim, first // rep, 1) for t in lkv)
        return fn(*lq, *lkv, *ts[nq + nkv:])

    q_pl, kv_pl, kv_grad = tuple(q_pl), tuple(kv_pl), tuple(kv_grad)
    sh_pl, sh_grad = tuple(sh_pl), tuple(sh_grad)
    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl,) * nq + (kv_pl,) * nkv + (sh_pl,) * ns,
                     in_grad_placements=(q_pl,) * nq + (kv_grad,) * nkv
                     + (sh_grad,) * ns,
                     device_mesh=mesh, redistribute_inputs=True)(*qs, *kvs, *shared)


def _flash_on_mesh(q, k, v, causal, schedule, block_q, block_k):
    """``_FlashAttention`` on each rank's part of DTensor q, k, v
    (:func:`on_heads`, the heads at dim 1): the kernel has no DTensor
    sharding rule."""
    return on_heads(lambda q, k, v: _FlashAttention.apply(
        q, k, v, causal, schedule, block_q, block_k), (q,), (k, v), head_dim=1)


def flash_attention(q, k, v, causal: bool = True, schedule: str = "morton",
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """Trainable flash attention. q: (B,Hq,S,D); k,v: (B,Hkv,Sk,D).

    The forward folds GQA into the batch axis and runs the SFC-scheduled
    ``flash_attention_fwd`` (the CUDA kernel on the card, its plain
    version on the CPU); the backward recomputes through the dense oracle
    (the JAX package's recompute backward, which keeps the kernel forward
    only). Blocks are ``block_q`` and ``block_k`` halved until they
    divide the sequence (each rank's, on a mesh). DTensor inputs run on
    each rank's batch and heads (:func:`_flash_on_mesh`).
    """
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _flash_on_mesh(q, k, v, causal, schedule, block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, schedule, block_q, block_k)
