"""Attention variants: GQA (+ sliding window), MLA; full-sequence and decode.

The torch counterpart of ``repro.models.attention``. The
full-sequence path runs the SFC-scheduled ``flash_attention_fwd`` kernel
(kernels/flash_attn.py) when ``cfg.use_flash_kernel`` is set, the model
is causal and has no sliding window — on the card that is the CUDA
kernel — and ``masked_sdpa`` otherwise. ``masked_sdpa`` never
materialises an (S, S) score tensor for long sequences: above 4096
queries it walks them in chunks of 1024. Decode attends one new token to
the preallocated cache through ``masked_sdpa``. On a device mesh
(DTensor parameters) each rank attends its own batch rows and heads
(``kernels.ops.on_heads``), but decode over a sequence-split cache
redistributes its scores to ``cfg.score_spec``, as the JAX package pins
them.

The per-layer flag ``is_global`` (gemma3's local:global pattern) is a
Python bool here: the layers run in a Python loop, not under ``scan``.
MLA (DeepSeek-V2) keeps a compressed cache, the latent ``c_kv`` and the
shared RoPE key ``k_rope``, and attends blockwise through it in plain
arithmetic (queries in chunks of 1024 above 4096); it never calls the
flash kernel, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.layout import device_constant
from repro_torch.kernels.ops import _BATCH_AXES, flash_attention, on_heads

from .config import ModelConfig
from .layers import _rotate, causal_window_mask, rope_freqs
from .params import constrain, gathered

__all__ = ["masked_sdpa", "gqa_attention", "gqa_decode", "mla_attention",
           "mla_decode", "rope_with_freqs", "select_freqs", "merge_heads",
           "split_heads"]

_NEG = -1e30
_Q_CHUNK = 1024
_CHUNK_THRESHOLD = 4096


def rope_with_freqs(x, pos, freqs):
    """Rotary with explicit (possibly per-layer-selected) frequencies."""
    return _rotate(x, pos[..., None].float() * freqs)


def select_freqs(cfg: ModelConfig, is_global, hd: int | None = None,
                 device="cpu") -> torch.Tensor:
    """The RoPE frequencies of a layer, a cached device constant (a copy
    from the host per layer and call would stall the stream)."""
    hd = hd or cfg.hd
    theta = cfg.rope_theta
    if cfg.sliding_window is not None and is_global:
        theta = cfg.global_rope_theta
    return device_constant(("rope_freqs", hd, theta),
                           lambda: rope_freqs(hd, theta), device)


def _mask_for(posq, posk, window, is_global, causal=True):
    """(Sq,Sk) mask; window applies only when is_global is False."""
    if not causal:
        return torch.ones((posq.shape[0], posk.shape[0]), dtype=torch.bool,
                          device=posq.device)
    m = causal_window_mask(posq, posk, None)
    if window is not None and not is_global:
        m = causal_window_mask(posq, posk, window)
    return m


def masked_sdpa(q, k, v, posq, posk, *, window=None, is_global=None,
                causal=True, q_chunk: int = _Q_CHUNK, score_spec=None):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd). f32 softmax.

    Queries are grouped (KV, rep) so K/V are never repeated; the products
    take the operands cast to f32 (the JAX package's f32 accumulation of
    bf16 operands), the probabilities are rounded to v's dtype before the
    second product, and the output is in v's dtype. For Sq > 4096 it
    walks q in chunks so live scores are O(C·Sk). ``score_spec`` (B, H,
    Sq, Sk) pins the scores' sharding where they are a DTensor (decode
    over a sequence-sharded cache); the (B, KV, rep, Sq, Sk) scores take
    it with the group dims unsplit.

    On DTensors without ``score_spec`` and with k and v whole along their
    sequence, each rank attends its own batch rows and heads
    (``kernels.ops.on_heads``); otherwise DTensor runs the products with
    the heads whole (:func:`heads_whole`), the sequence split kept.
    """
    if isinstance(q, DTensor):
        if score_spec is None and not _seq_split(k, v):
            return on_heads(lambda q, k, v: masked_sdpa(
                q, k, v, posq, posk, window=window, is_global=is_global,
                causal=causal, q_chunk=q_chunk), (q,), (k, v))
        q, k, v = heads_whole(q), heads_whole(k), heads_whole(v)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    kf, vf = k.float(), v.float()

    def blk(qc, pq):
        C = qc.shape[1]
        m = _mask_for(pq, posk, window, is_global, causal)
        qg = qc.reshape(B, C, KV, rep, hd).float()
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) / math.sqrt(hd)
        s = torch.where(m, s, _NEG)
        if score_spec is not None:
            bspec, _, qspec, kspec = score_spec
            s = constrain(s, (bspec, None, None, qspec, kspec))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), vf)
        return o.reshape(B, C, H, hd).to(v.dtype)

    if Sq <= _CHUNK_THRESHOLD or Sq % q_chunk:
        return blk(q, posq)
    return torch.cat([blk(q[:, i:i + q_chunk], posq[i:i + q_chunk])
                      for i in range(0, Sq, q_chunk)], dim=1)


def _whole_after_seq(t):
    """DTensor ``t`` with every dim after the first two whole: a split of
    them replicated, a partial sum reduced, onto the batch (dim 0) where
    the mesh dim is a batch axis that divides it, else replicated."""
    mesh, want, ways = t.device_mesh, [], 1
    for i, pl in enumerate(t.placements):
        if pl.is_shard(0):
            ways *= mesh.size(i)
    for i, pl in enumerate(t.placements):
        n = mesh.size(i)
        if pl.is_partial():
            if mesh.mesh_dim_names[i] in _BATCH_AXES and t.shape[0] % (ways * n) == 0:
                pl, ways = Shard(0), ways * n
            else:
                pl = Replicate()
        elif any(pl.is_shard(d) for d in range(2, t.ndim)):
            pl = Replicate()
        want.append(pl)
    want = tuple(want)
    return t if want == tuple(t.placements) else t.redistribute(placements=want)


class _HeadsWhole(torch.autograd.Function):
    """:func:`_whole_after_seq` forward, and on the gradient backward."""

    @staticmethod
    def forward(ctx, t):
        return _whole_after_seq(t)

    @staticmethod
    def backward(ctx, g):
        return _whole_after_seq(g)


def heads_whole(t):
    """(B, S, heads, ...) with the heads (and every dim after them) whole
    on every rank and no partial sums, where it is a DTensor, and its
    gradient so too; the batch and sequence splits stay. For attention
    that DTensor runs itself (a sequence-split cache, pinned scores):
    its products flatten the batch with the heads, which DTensor refuses
    while a dim after the first is split (torch 2.11), in the forward and
    in the backward, or cannot do at all where the q heads are split
    finer than their kv groups (64 heads in 8 groups over 16 ranks). A
    plain tensor passes through."""
    return _HeadsWhole.apply(t) if isinstance(t, DTensor) else t


def _seq_split(*ts) -> bool:
    """Whether a DTensor among ``ts`` splits its dim 1 (the sequence)."""
    return any(isinstance(t, DTensor) and any(pl.is_shard(1) for pl in t.placements)
               for t in ts)


def _heads_aligned(t, H: int):
    """DTensor ``t`` (B, S, H·hd) with any split of its last dim over a
    mesh dim that does not divide H replicated (a split DTensor cannot
    view as whole heads)."""
    want = tuple(Replicate() if pl.is_shard(t.ndim - 1) and H % t.device_mesh.size(i)
                 else pl for i, pl in enumerate(t.placements))
    return t if want == tuple(t.placements) else t.redistribute(placements=want)


class _MergeHeads(torch.autograd.Function):
    """(B, S, H, hd) -> (B, S, H·hd); the gradient viewed back as heads
    after :func:`_heads_aligned`."""

    @staticmethod
    def forward(ctx, t):
        ctx.heads = tuple(t.shape[-2:])
        return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])

    @staticmethod
    def backward(ctx, g):
        H, hd = ctx.heads
        return _heads_aligned(g, H).reshape(*g.shape[:-1], H, hd)


def merge_heads(t):
    """(B, S, H, hd) -> (B, S, H·hd), the heads' split kept. On a DTensor
    the gradient arrives with its columns split as the output projection
    is, which DTensor will not view as heads where the mesh dim does not
    divide H (whisper's 12 heads over 16): that split is gathered first."""
    if isinstance(t, DTensor):
        return _MergeHeads.apply(t)
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


def split_heads(t, H: int, hd: int):
    """(..., H·hd) -> (..., H, hd). Where ``t`` is a DTensor whose fused
    columns are split over a mesh dim that does not divide H (a head cut in
    two, which GSPMD reshards silently and DTensor's view refuses), the
    columns are gathered first."""
    if isinstance(t, DTensor) and any(
            pl.is_shard(t.ndim - 1) and H % t.device_mesh.size(i)
            for i, pl in enumerate(t.placements)):
        t = gathered(t, -1)
    return t.reshape(*t.shape[:-1], H, hd)


def write_token(cache_t, cur: int, val) -> None:
    """``cache_t[:, cur] = val`` in place (``val`` (B, ...) rounded to the
    cache's dtype). A DTensor cache, its sequence perhaps split over the
    mesh, takes the token through a select over positions (the JAX
    package's ``dynamic_update_slice``, a pass over the cache): DTensor
    would write a split sequence at each shard's own index ``cur``."""
    val = val.to(cache_t.dtype)
    if not isinstance(cache_t, DTensor):
        cache_t[:, cur] = val
        return
    at = torch.arange(cache_t.shape[1], device=cache_t.device) == cur
    at = at.view(1, -1, *([1] * (cache_t.ndim - 2)))
    cache_t.copy_(torch.where(at, val[:, None], cache_t))


def _proj_qkv(p, x, cfg: ModelConfig):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(x @ p["wq"].to(x.dtype), H, hd)
    k = split_heads(x @ p["wk"].to(x.dtype), KV, hd)
    v = split_heads(x @ p["wv"].to(x.dtype), KV, hd)
    return q, k, v


def gqa_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  is_global=None, pos: torch.Tensor | None = None,
                  causal: bool = True) -> torch.Tensor:
    """Full-sequence GQA (prefill). x: (B,S,D)."""
    S = x.shape[1]
    q, k, v = _proj_qkv(p, x, cfg)
    if pos is None:
        pos = torch.arange(S, device=x.device)
    freqs = select_freqs(cfg, is_global, device=x.device)
    q = rope_with_freqs(q, pos, freqs)
    k = rope_with_freqs(k, pos, freqs)
    if cfg.use_flash_kernel and causal and cfg.sliding_window is None:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True, cfg.flash_schedule,
                            128, 128).transpose(1, 2)
    else:
        o = masked_sdpa(q, k, v, pos, pos, window=cfg.sliding_window,
                        is_global=is_global, causal=causal)
    return merge_heads(o) @ p["wo"].to(x.dtype)


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, cur: int,
               cfg: ModelConfig, *, is_global=None):
    """Single-token decode, one pass (mask/rope selected by flag).

    ``cache`` holds this layer's ``k`` and ``v`` (B, max_len, KV, hd);
    the new token's k and v are written into them in place at ``cur``
    (the JAX package's ``dynamic_update_slice``, same numbers). The
    attention output is cast to the activation dtype before the output
    projection, so the layer returns x's dtype whatever the cache's (the
    JAX package's decode scan refuses an f32 cache under bf16
    activations for want of that cast; with f32 activations it is a
    no-op).
    """
    q, k, v = _proj_qkv(p, x, cfg)
    posq = torch.full((1,), cur, dtype=torch.int64, device=x.device)
    freqs = select_freqs(cfg, is_global, device=x.device)
    q = rope_with_freqs(q, posq, freqs)
    k = rope_with_freqs(k, posq, freqs)
    ck, cv = cache["k"], cache["v"]
    write_token(ck, cur, k[:, 0])
    write_token(cv, cur, v[:, 0])
    posk = torch.arange(ck.shape[1], device=x.device)
    o = masked_sdpa(q, ck, cv, posq, posk, window=cfg.sliding_window,
                    is_global=is_global, score_spec=cfg.score_spec)
    return merge_heads(o).to(x.dtype) @ p["wo"].to(x.dtype), cache


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV latent cache
# ----------------------------------------------------------------------

def _mla_parts(p, x, cfg: ModelConfig):
    mla = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    nope, rope = mla.qk_nope_dim, mla.qk_rope_dim
    q = split_heads(x @ p["wq"].to(x.dtype), H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = x @ p["w_dkv"].to(x.dtype)
    c_kv, k_rope = dkv[..., :mla.kv_lora_rank], dkv[..., mla.kv_lora_rank:]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, posq, posk, cfg: ModelConfig,
                q_chunk: int = _Q_CHUNK):
    """Blockwise attention through the latent cache: scores and output in
    f32 from the operands cast to f32 (the JAX package's f32 accumulation),
    the probabilities rounded to v's dtype before the second product, the
    output (B, Sq, H·v_dim) in v's dtype. For Sq > 4096 (a multiple of
    ``q_chunk``) the queries go in chunks, so live scores are O(C·Sk).
    On DTensors each rank attends its own rows and heads
    (``kernels.ops.on_heads``) unless decode pins the scores or the latent
    cache is split along its sequence; then DTensor runs it, the heads
    whole."""
    mla = cfg.mla
    Sq = q_nope.shape[1]
    H = cfg.n_heads
    nope, rope, vd = mla.qk_nope_dim, mla.qk_rope_dim, mla.v_dim
    freqs = device_constant(("rope_freqs", rope, cfg.rope_theta),
                            lambda: rope_freqs(rope, cfg.rope_theta), c_kv.device)
    q_rope = rope_with_freqs(q_rope, posq, freqs)
    k_rope = rope_with_freqs(k_rope[..., None, :], posk, freqs)[..., 0, :]
    k_nope = split_heads(c_kv @ p["w_uk"].to(c_kv.dtype), H, nope)
    v = split_heads(c_kv @ p["w_uv"].to(c_kv.dtype), H, vd)
    pinned = Sq == 1 and cfg.score_spec is not None  # decode's score hint
    if isinstance(q_nope, DTensor):
        if not pinned and not _seq_split(k_nope, v, k_rope):
            return merge_heads(on_heads(
                lambda qn, qr, kn, v, kr: _mla_scores(qn, qr, kn, v, kr, posq,
                                                      posk, cfg, q_chunk),
                (q_nope, q_rope), (k_nope, v), (k_rope,)))
        q_nope, q_rope = heads_whole(q_nope), heads_whole(q_rope)
        k_nope, v = heads_whole(k_nope), heads_whole(v)
    return merge_heads(_mla_scores(q_nope, q_rope, k_nope, v, k_rope, posq, posk,
                                   cfg, q_chunk))


def _mla_scores(q_nope, q_rope, k_nope, v, k_rope, posq, posk,
                cfg: ModelConfig, q_chunk: int):
    """:func:`_mla_attend`'s attention on the heads it is given: (B, Sq,
    H', v_dim) in v's dtype."""
    mla = cfg.mla
    Sq = q_nope.shape[1]
    kf, vf, krf = k_nope.float(), v.float(), k_rope.float()
    scale = 1.0 / math.sqrt(mla.qk_nope_dim + mla.qk_rope_dim)

    def blk(qn, qr, pq):
        s = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), kf)
             + torch.einsum("bqhd,bkd->bhqk", qr.float(), krf)) * scale
        s = torch.where(causal_window_mask(pq, posk, None), s, _NEG)
        if Sq == 1:  # decode
            s = constrain(s, cfg.score_spec)
        pr = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype).float(),
                            vf).to(v.dtype)

    if Sq <= _CHUNK_THRESHOLD or Sq % q_chunk:
        return blk(q_nope, q_rope, posq)
    return torch.cat([blk(q_nope[:, i:i + q_chunk], q_rope[:, i:i + q_chunk],
                          posq[i:i + q_chunk])
                      for i in range(0, Sq, q_chunk)], dim=1)


def mla_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  pos: torch.Tensor | None = None, **_) -> torch.Tensor:
    """Full-sequence MLA (prefill). x: (B,S,D)."""
    S = x.shape[1]
    if pos is None:
        pos = torch.arange(S, device=x.device)
    qn, qr, c_kv, k_rope = _mla_parts(p, x, cfg)
    o = _mla_attend(p, qn, qr, c_kv, k_rope, pos, pos, cfg)
    return o @ p["wo"].to(x.dtype)


def mla_decode(p: dict, x: torch.Tensor, cache: dict, cur: int,
               cfg: ModelConfig, **_):
    """Single-token MLA decode against the compressed cache ``{c_kv:
    (B,Smax,lora), k_rope: (B,Smax,rope)}``, written in place at ``cur``
    as ``gqa_decode`` writes its cache. The attention output is cast to
    the activation dtype before the output projection, as there."""
    qn, qr, c_kv_new, k_rope_new = _mla_parts(p, x, cfg)
    ck, kr = cache["c_kv"], cache["k_rope"]
    write_token(ck, cur, c_kv_new[:, 0])
    write_token(kr, cur, k_rope_new[:, 0])
    posq = torch.full((1,), cur, dtype=torch.int64, device=x.device)
    posk = torch.arange(ck.shape[1], device=x.device)
    o = _mla_attend(p, qn, qr, ck, kr, posq, posk, cfg).to(x.dtype)
    return o @ p["wo"].to(x.dtype), cache
