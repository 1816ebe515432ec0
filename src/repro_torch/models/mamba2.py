"""Mamba2 (SSD — state-space duality) block, chunked forward + O(1) decode.

The torch counterpart of ``repro.models.mamba2`` (arXiv:2405.21060): the
sequence goes in chunks; within a chunk the recurrence is the masked
(L×L) "dual" quadratic form, and a Python loop over the chunks carries
the state between them (the JAX package's ``lax.scan``). Decode keeps a
constant-size (H, P, N) state per layer.

The dtype steps are the JAX package's: the SSD runs in f32, the conv's
output is cast to the activation dtype, then the ``silu(z)`` gate, then
``rmsnorm`` with ``gnorm``. Two rules keep the chunked form finite and
small at the production chunk of 256:
- the causal mask selects (``torch.where``) and never multiplies: above
  the diagonal ``exp(diff)`` overflows to inf, and inf·0 is NaN. It
  selects before the ``exp`` (−inf there, so ``exp`` gives the same 0):
  the JAX package selects after it, and its gradient then meets 0·inf
  where the forward does not, non-finite at chunk 256;
- every three-operand product is two contractions, so no per-position
  (…, N, P) tensor is formed (one (B, nc, L, H, N, P) tensor of
  mamba2-2.7b's prefill would be 21 GB).
B and C are shared by the ``rep = H / G`` heads of a group, so the
products that involve them run per group, the heads of a group on a
trailing axis (the same sums as the JAX package's repeat to H heads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import rmsnorm

__all__ = ["ssd_chunked", "ssd_decode_step", "mamba2_block", "mamba2_decode"]


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD scan. x:(B,T,H,P) dt:(B,T,H) A:(H,)<0 Bm/Cm:(B,T,G,N) -> y:(B,T,H,P) f32.

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t ;  y_t = C_t · h_t
    """
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = chunk
    if T % L:
        raise ValueError(f"sequence length {T} is not a multiple of the SSD "
                         f"chunk {L}")
    nc, rep = T // L, H // G
    dt = dt.float()
    xd = x.float() * dt[..., None]
    la = dt * A.float()[None, None, :]                  # log decay per step
    xc = xd.reshape(Bsz, nc, L, G, rep, P)
    Bc = Bm.float().reshape(Bsz, nc, L, G, N)
    Cc = Cm.float().reshape(Bsz, nc, L, G, N)
    cums = torch.cumsum(la.reshape(Bsz, nc, L, H), dim=2)  # inclusive

    # intra-chunk dual form: M[t,s] = exp(cums_t - cums_s)·(C_t·B_s), s<=t
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (B,nc,Lt,Ls,H)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    scores = torch.einsum("bclgn,bcsgn->bclsg", Cc, Bc)
    M = torch.exp(torch.where(tri[None, None, :, :, None], diff, -torch.inf))
    M = M.reshape(Bsz, nc, L, L, G, rep) * scores[..., None]
    y_intra = torch.einsum("bclsgr,bcsgrp->bclgrp", M, xc)

    # chunk-final local states, then the states entering each chunk
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)     # (B,nc,L,H)
    xe = xc * decay_to_end.reshape(Bsz, nc, L, G, rep, 1)
    S = torch.einsum("bclgrp,bclgn->bcgrpn", xe, Bc)        # (B,nc,G,rep,P,N)
    chunk_decay = torch.exp(cums[:, :, -1, :]).reshape(Bsz, nc, G, rep, 1, 1)
    h = torch.zeros((Bsz, G, rep, P, N), dtype=torch.float32, device=x.device)
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = h * chunk_decay[:, c] + S[:, c]
    h_enter = torch.stack(h_enter, dim=1)                   # (B,nc,G,rep,P,N)
    y_inter = torch.einsum("bclgn,bcgrpn->bclgrp", Cc, h_enter)
    y_inter = y_inter * torch.exp(cums).reshape(Bsz, nc, L, G, rep, 1)
    return (y_intra + y_inter).reshape(Bsz, T, H, P)


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """One token. h:(B,H,P,N) x:(B,H,P) dt:(B,H) Bm/Cm:(B,G,N) -> (y, h')."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    Bh = Bm.float().repeat_interleave(rep, dim=1)
    Ch = Cm.float().repeat_interleave(rep, dim=1)
    dt = dt.float()
    a = torch.exp(dt * A.float()[None, :])                  # (B,H)
    u = (x.float() * dt[..., None])[..., None] * Bh[:, :, None, :]
    h_new = h * a[..., None, None] + u
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y, h_new


def _split_proj(p, xin, cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    gn = ssm.n_groups * ssm.d_state
    H = d_inner // ssm.head_dim
    zxbcdt = xin @ p["in_proj"].to(xin.dtype)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, xbc, dt, d_inner, gn, H


def _conv_train(xbc, w, b):
    """Causal depthwise conv over time. xbc:(B,T,C) w:(W,C) b:(C,)."""
    W, T = w.shape[0], xbc.shape[1]
    pads = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for t in range(W):
        out = out + pads[:, t:t + T].float() * w[t][None, None].float()
    return F.silu(out + b[None, None].float()).to(xbc.dtype)


def _gate_out(p, y, xh, z, x_dtype, cfg: ModelConfig):
    """The D skip, the ``silu(z)`` gate, ``gnorm`` and the output
    projection, from the SSD's f32 ``y`` (…, H, P)."""
    y = y + p["d_skip"].float()[:, None] * xh.float()
    y = y.reshape(*y.shape[:-2], -1).to(x_dtype)
    y = y * F.silu(z.float()).to(x_dtype)
    y = rmsnorm(y, p["gnorm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x_dtype)


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 mixer (pre-norm residual applied by caller)."""
    ssm = cfg.ssm
    Bsz, T, _ = x.shape
    z, xbc, dtp, d_inner, gn, H = _split_proj(p, x, cfg)
    xbc = _conv_train(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_inner]
    Bm = xbc[..., d_inner:d_inner + gn].reshape(Bsz, T, ssm.n_groups, ssm.d_state)
    Cm = xbc[..., d_inner + gn:].reshape(Bsz, T, ssm.n_groups, ssm.d_state)
    dt = F.softplus(dtp.float() + p["dt_bias"].float()[None, None])
    A = -torch.exp(p["a_log"].float())
    xh = xs.reshape(Bsz, T, H, ssm.head_dim)
    y = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk)
    return _gate_out(p, y, xh, z, x.dtype, cfg)


def mamba2_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token decode. x:(B,1,D); cache {conv:(B,W-1,C), ssm:(B,H,P,N)}
    -> (out (B,1,D), the new {conv, ssm}, in the cache's dtype). The cache
    is only read: the caller writes the new states where they belong."""
    ssm = cfg.ssm
    Bsz = x.shape[0]
    z, xbc, dtp, d_inner, gn, H = _split_proj(p, x[:, 0], cfg)
    # conv with rolling state
    conv_in = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (B,W,C)
    xbc_c = F.silu(torch.einsum("bwc,wc->bc", conv_in.float(), p["conv_w"].float())
                   + p["conv_b"].float()[None]).to(x.dtype)
    xs = xbc_c[..., :d_inner]
    Bm = xbc_c[..., d_inner:d_inner + gn].reshape(Bsz, ssm.n_groups, ssm.d_state)
    Cm = xbc_c[..., d_inner + gn:].reshape(Bsz, ssm.n_groups, ssm.d_state)
    dt = F.softplus(dtp.float() + p["dt_bias"].float()[None])
    A = -torch.exp(p["a_log"].float())
    xh = xs.reshape(Bsz, H, ssm.head_dim)
    y, h_new = ssd_decode_step(cache["ssm"].float(), xh, dt, A, Bm, Cm)
    out = _gate_out(p, y, xh, z, x.dtype, cfg)[:, None]
    return out, {"conv": conv_in[:, 1:].to(cache["conv"].dtype),
                 "ssm": h_new.to(cache["ssm"].dtype)}
