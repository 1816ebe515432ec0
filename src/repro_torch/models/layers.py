"""Shared neural layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, losses,
masks.

The torch counterparts of ``repro.models.layers``, with the same dtype
rules: parameters are cast to the activation dtype at each use, norms,
RoPE and the SiLU run in f32 and return the input's dtype, and logits and
the loss are f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.layout import device_constant

__all__ = ["rmsnorm", "rope_freqs", "apply_rope", "swiglu", "embed",
           "unembed", "nll", "softmax_cross_entropy", "causal_window_mask"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * rms) * (1.0 + w.float())).to(x.dtype)


def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate split halves of ``x`` (..., S, H, hd) by ``ang`` (..., S, hd/2)."""
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); pos: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = device_constant(("rope_freqs", hd, theta),
                            lambda: rope_freqs(hd, theta), x.device)
    return _rotate(x, pos[..., None].float() * freqs)


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP. p: {gate: (D,F), up: (D,F), down: (F,D)}."""
    g = x @ p["gate"].to(x.dtype)
    u = x @ p["up"].to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["down"].to(x.dtype)


def embed(w: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``w`` (V, D) at ``tokens``, in ``dtype``. ``F.embedding``,
    not indexing: its backward sums each row's gradients in a fixed order
    on the CPU, where indexing's accumulating scatter does not."""
    return F.embedding(tokens.long(), w).to(dtype)


def unembed(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (numerics) — w: (D, V)."""
    return x.float() @ w.float()


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood: logits (..., V) f32, labels
    (...) int -> (...)."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE. logits: (B,S,V) f32; labels: (B,S) int32; with
    ``mask`` (B,S), the mean over the positions it keeps (at least 1)."""
    per_pos = nll(logits, labels)
    if mask is None:
        return per_pos.mean()
    mask = mask.float()
    return (per_pos * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int | None) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m
