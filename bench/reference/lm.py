"""Plain PyTorch reference of a Llama-architecture decoder (SmolLM), in float32.

The model, from the published description of the Llama family that
SmolLM follows: token embedding; per layer a pre-norm grouped-query
attention block with rotary positions and a pre-norm SwiGLU block, each
added to the residual; a final RMSNorm; the output head. Causal
attention, softmax in float32, scale 1/sqrt(head_dim); query head h reads
key/value head h // (n_heads / n_kv_heads). RoPE rotates the two halves
of each head (x1·cos - x2·sin, x2·cos + x1·sin) by position·theta**(-2i/hd).

The weights come as a dict in the layout the benchmark makes them (every
product is ``x @ W``; the layers' leaves stacked on a leading axis):
``embed`` (V, D), ``final_norm`` (D,), ``layers.norm1`` / ``norm2`` (L, D),
``layers.wq`` (L, D, H·hd), ``wk`` / ``wv`` (L, D, KV·hd), ``wo``
(L, H·hd, D), ``gate`` / ``up`` (L, D, F), ``down`` (L, F, D), and
``unembed`` (D, V) unless the head is tied to the embedding (then
``embed``ᵀ). Departure from the published parametrisation: a norm's gain
is stored as its offset from 1 (the gain is 1 + w), as the benchmark
stores it.

Everything runs in float32 with TF32 off. ``gemm_dtype=torch.float8_e4m3fn``
rounds both operands of every product (projections, attention's two
products, the SwiGLU, the head) to fp8 e4m3 with one scale per operand
(its largest magnitude mapped to 448), the arithmetic staying float32:
the lower precision a later change might reach for.

The training reference works one sequence at a time (a sequence of 4,096
tokens keeps about 30 GB for its backward; ``remat=True`` recomputes
each layer in the backward instead, ``torch.utils.checkpoint``);
attention walks its queries in blocks. AdamW
follows the optimizer the configuration states: clipping by the global
norm, a warm-up then cosine learning rate, bias corrections, decoupled
weight decay on every leaf of two or more dims.

Imports nothing but torch.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYER_KEYS = ("norm1", "norm2", "wq", "wk", "wv", "wo", "gate", "up", "down")
Q_BLOCK = 1024
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (TF32 off) within."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale (largest magnitude to
    448), back in float32."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = amax / FP8_MAX
    q = (x / scale).to(dtype).to(torch.float32) * scale
    # the rounding passes no gradient of its own (straight through)
    return x + (q - x).detach()


class Ref:
    """The reference model of config ``cfg`` (a dict of the configuration
    file's keys) over ``weights``; ``gemm_dtype`` None for float32."""

    def __init__(self, cfg: dict, weights: dict, gemm_dtype=None):
        self.cfg = cfg
        self.w = weights
        self.gemm_dtype = gemm_dtype
        hd = cfg["head_dim"]
        dev = weights["embed"].device
        i = torch.arange(0, hd, 2, dtype=torch.float64, device=dev)
        self.freqs = (1.0 / cfg["rope_theta"] ** (i / hd)).to(torch.float32)

    # -- products -------------------------------------------------------
    def _q(self, x):
        return x if self.gemm_dtype is None else _round_fp8(x, self.gemm_dtype)

    def mm(self, x, w):
        return self._q(x) @ self._q(w)

    # -- layers ---------------------------------------------------------
    def norm(self, x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.cfg["norm_eps"]) * (1.0 + w)

    def rope(self, x, pos):
        ang = pos[:, None].to(torch.float32) * self.freqs        # (S, hd/2)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, q, k, v):
        """q (S, H, hd), k and v (S, KV, hd) -> (S, H·hd), causal."""
        S, H, hd = q.shape
        rep = H // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, S, hd)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = []
        for s0 in range(0, S, Q_BLOCK):
            s1 = min(s0 + Q_BLOCK, S)
            kb, vb = k[:, :s1], v[:, :s1]
            sc = self.mm(q[:, s0:s1], kb.transpose(1, 2)) / math.sqrt(hd)
            qi = torch.arange(s0, s1, device=q.device)[:, None]
            ki = torch.arange(s1, device=q.device)[None, :]
            sc = sc.masked_fill(ki > qi, float("-inf"))
            out.append(self.mm(torch.softmax(sc, dim=-1), vb))
        return torch.cat(out, dim=1).transpose(0, 1).reshape(S, H * hd)

    def layer(self, x, pos, *lw):
        p = dict(zip(LAYER_KEYS, lw))
        cfg = self.cfg
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        S = x.shape[0]
        h = self.norm(x, p["norm1"])
        q = self.rope(self.mm(h, p["wq"]).view(S, H, hd), pos)
        k = self.rope(self.mm(h, p["wk"]).view(S, KV, hd), pos)
        v = self.mm(h, p["wv"]).view(S, KV, hd)
        x = x + self.mm(self.attention(q, k, v), p["wo"])
        h = self.norm(x, p["norm2"])
        return x + self.mm(F.silu(self.mm(h, p["gate"])) * self.mm(h, p["up"]), p["down"])

    def head(self):
        return self.w["embed"].t() if self.cfg["tie_embeddings"] else self.w["unembed"]

    def hidden(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """(S,) tokens -> (S, D) hidden after the final norm."""
        x = self.w["embed"][tokens.long()]
        pos = torch.arange(tokens.shape[0], device=tokens.device)
        for i in range(self.cfg["n_layers"]):
            lw = [self.w[f"layers.{k}"][i] for k in LAYER_KEYS]
            if remat:
                x = checkpoint(self.layer, x, pos, *lw, use_reentrant=False)
            else:
                x = self.layer(x, pos, *lw)
        return self.norm(x, self.w["final_norm"])

    # -- entries ----------------------------------------------------------
    @torch.no_grad()
    def last_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(S,) prompt -> (V,) float32 logits at its last position."""
        with no_tf32():
            return self.mm(self.hidden(tokens)[-1:], self.head())[0]

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(S,) prompt -> (S, V) float32 logits at every position."""
        with no_tf32():
            return self.mm(self.hidden(tokens), self.head())

    def loss_and_grads(self, tokens: torch.Tensor, labels: torch.Tensor,
                       remat: bool = False):
        """Mean next-token cross-entropy over (B, S) ``tokens``/``labels``
        and its gradient in every weight: (loss, {name: grad})."""
        B, S = tokens.shape
        leaves = {n: t.detach().requires_grad_() for n, t in self.w.items()}
        saved, self.w = self.w, leaves
        total = 0.0
        try:
            with no_tf32():
                for b in range(B):
                    h = self.hidden(tokens[b], remat=remat)
                    logits = self.mm(h, self.head())
                    nll = torch.logsumexp(logits, -1) - logits.gather(
                        -1, labels[b].long()[:, None])[:, 0]
                    part = nll.sum() / (B * S)
                    part.backward()
                    total += part.item()
        finally:
            self.w = saved
        return total, {n: t.grad for n, t in leaves.items()}


def lr_at(step: int, opt: dict) -> float:
    warm = min((step + 1) / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


@torch.no_grad()
def adamw_step(weights: dict, grads: dict, state: dict, step: int, opt: dict) -> dict:
    """One AdamW step (``step`` counts from 0) on ``weights`` in place;
    ``state`` holds m and v per name (created at step 0). Returns the
    clipped gradients, as the optimizer applies them."""
    gn = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    scale = min(opt["clip_norm"] / (gn + 1e-9), 1.0)
    lr = lr_at(step, opt)
    t = step + 1
    bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
    clipped = {}
    for n, p in weights.items():
        g = grads[n] * scale
        clipped[n] = g
        m = state.setdefault(("m", n), torch.zeros_like(p))
        v = state.setdefault(("v", n), torch.zeros_like(p))
        m.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
        v.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        if p.ndim >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    return clipped
