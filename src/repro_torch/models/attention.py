"""Attention variants: GQA (+ sliding window), MLA; full-sequence and decode.

The torch counterpart of ``repro.models.attention``. The
full-sequence path runs the SFC-scheduled ``flash_attention_fwd`` kernel
(kernels/flash_attn.py) when ``cfg.use_flash_kernel`` is set, the model
is causal and has no sliding window — on the card that is the CUDA
kernel — and ``masked_sdpa`` otherwise. ``masked_sdpa`` never
materialises an (S, S) score tensor for long sequences: above 4096
queries it walks them in chunks of 1024. Decode attends one new token to
the preallocated cache through ``masked_sdpa``. On a device mesh
(DTensor parameters) decode redistributes its scores to
``cfg.score_spec``, as the JAX package pins them.

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
from torch.distributed.tensor import DTensor

from repro_torch.core.layout import device_constant
from repro_torch.kernels.ops import flash_attention

from .config import ModelConfig
from .layers import _rotate, causal_window_mask, rope_freqs
from .params import constrain, gathered

__all__ = ["masked_sdpa", "gqa_attention", "gqa_decode", "mla_attention",
           "mla_decode", "rope_with_freqs", "select_freqs"]

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
    """
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
    B, S, D = x.shape
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
    o = o.reshape(B, S, cfg.n_heads * cfg.hd)
    return o @ p["wo"].to(x.dtype)


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
    B = x.shape[0]
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
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return o @ p["wo"].to(x.dtype), cache


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
    ``q_chunk``) the queries go in chunks, so live scores are O(C·Sk)."""
    mla = cfg.mla
    B, Sk = c_kv.shape[:2]
    Sq = q_nope.shape[1]
    H = cfg.n_heads
    nope, rope, vd = mla.qk_nope_dim, mla.qk_rope_dim, mla.v_dim
    freqs = device_constant(("rope_freqs", rope, cfg.rope_theta),
                            lambda: rope_freqs(rope, cfg.rope_theta), c_kv.device)
    q_rope = rope_with_freqs(q_rope, posq, freqs)
    k_rope = rope_with_freqs(k_rope[..., None, :], posk, freqs)[..., 0, :]
    k_nope = split_heads(c_kv @ p["w_uk"].to(c_kv.dtype), H, nope).float()
    v = split_heads(c_kv @ p["w_uv"].to(c_kv.dtype), H, vd)
    vf, krf = v.float(), k_rope.float()
    scale = 1.0 / math.sqrt(nope + rope)

    def blk(qn, qr, pq):
        s = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope)
             + torch.einsum("bqhd,bkd->bhqk", qr.float(), krf)) * scale
        s = torch.where(causal_window_mask(pq, posk, None), s, _NEG)
        if Sq == 1:  # decode
            s = constrain(s, cfg.score_spec)
        pr = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype).float(),
                            vf).to(v.dtype)

    if Sq <= _CHUNK_THRESHOLD or Sq % q_chunk:
        o = blk(q_nope, q_rope, posq)
    else:
        o = torch.cat([blk(q_nope[:, i:i + q_chunk], q_rope[:, i:i + q_chunk],
                           posq[i:i + q_chunk])
                       for i in range(0, Sq, q_chunk)], dim=1)
    return o.reshape(B, Sq, H * vd)


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
