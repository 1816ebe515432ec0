"""The benchmark's frozen work arithmetic: peaks, kernel bounds, model FLOPs.

Every share the benchmark reports (a kernel's roofline, a step's MFU)
divides by a count made here from shapes alone, never from what the
program does: a change that fuses or removes operations does not lower
the yardstick it is measured against.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity, at the full 700 W power limit): 989 TFLOP/s in bf16 and fp16
on the tensor cores, 67 TFLOP/s in f32 on the CUDA cores (an FMA counts
two operations), 1,979 TFLOP/s in fp8, 3.35 TB/s of HBM3.

Counting rules:

- A kernel's bound is the larger of its operations over the peak of its
  type and its bytes over the HBM bandwidth. Each input byte is read once
  and each output byte written once, whatever the kernel reads again.
- The stencil function counts a multiply and an add per tap of the
  advanced field u per site and substep, plus the rule's arithmetic
  (``RULE_FLOPS``); gol's rule is comparisons and counts nothing. It does
  not count what a design adds: recomputed halo sites, or the tap sum of
  the wave rule's v, which the rule discards.
- Causal attention visits S·(S+1)/2 (query, key) pairs a head; the
  forward does 4·D operations a pair (two products), the backward 2.5
  times that.
- Model FLOPs count every weight product: 2 a weight and token forward,
  6 for a training step (the forward and the two products of the
  backward). The embedding lookup is no product; the output head is (tied
  or not). Training adds three times the forward's attention, prefill
  its forward's attention once, and prefill runs the head at the last
  position only.
"""

from __future__ import annotations

PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
                   "float8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

# floating-point operations of an update rule per site and substep, beyond
# the tap sum: wave subtracts 16u, 8u and 2u (three products, three
# differences), adds kappa*lap to v (two) and v' to u (one)
RULE_FLOPS = {"gol": 0, "identity": 0, "jacobi": 2, "wave": 9}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time on one H100: the larger of operations over the
    type's peak and bytes over HBM bandwidth."""
    return max(flops / PEAK_FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def stencil_flops_per_site(g: int, rule: str) -> int:
    """Operations of the stencil function per site and substep."""
    return 2 * (2 * g + 1) ** 3 + RULE_FLOPS[rule]


def fused_launch(M: int, T: int, g: int, S: int, rule: str, channels: int,
                 itemsize: int = 4, clamped: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one fused launch of S substeps over an M³
    grid of T³ blocks: the store read once and written once, its
    neighbour table (27 ids a block), the face flags where the boundary
    is clamped, and the weights."""
    nb = (M // T) ** 3
    taps = (2 * g + 1) ** 3
    flops = S * M ** 3 * stencil_flops_per_site(g, rule)
    nbytes = itemsize * 2 * channels * M ** 3 + 4 * (nb * taps + taps)
    if clamped:
        nbytes += 4 * nb * 6
    return float(flops), float(nbytes)


def fused_launch_bound_s(M: int, T: int, g: int, S: int, rule: str,
                         channels: int, itemsize: int = 4) -> float:
    flops, nbytes = fused_launch(M, T, g, S, rule, channels, itemsize)
    return bound_s(flops, nbytes, "float32")


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def flash_fwd(BH: int, S: int, D: int, itemsize: int = 2,
              kv_heads_ratio: float = 1.0) -> tuple[float, float]:
    """(operations, bytes) of causal flash attention's forward over BH
    folded heads: q and o of BH heads, k and v of BH·kv_heads_ratio."""
    flops = 4 * BH * D * causal_pairs(S)
    nbytes = itemsize * BH * S * D * (2 + 2 * kv_heads_ratio)
    return float(flops), float(nbytes)


def flash_bwd(BH: int, S: int, D: int, itemsize: int = 2,
              kv_heads_ratio: float = 1.0) -> tuple[float, float]:
    """(operations, bytes) of its backward: 2.5 times the forward's
    operations; q, k, v, o, do read and dq, dk, dv written (the per-row
    log-sum-exp in f32 read too)."""
    flops = 10 * BH * D * causal_pairs(S)
    per_head = S * D * (4 + 4 * kv_heads_ratio)
    nbytes = itemsize * BH * per_head + 4 * BH * S
    return float(flops), float(nbytes)


def lm_weight_params(cfg: dict) -> int:
    """Weights that enter a product per token: every layer's q, k, v, o
    projections and SwiGLU, and the output head."""
    D, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * cfg["d_ff"]
    return cfg["n_layers"] * per_layer + D * cfg["vocab"]


def lm_attention_fwd_flops(cfg: dict, S: int) -> float:
    """Causal attention's forward over one sequence, every layer."""
    return float(4 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"]
                 * causal_pairs(S))


def lm_train_flops(cfg: dict, B: int, S: int) -> float:
    """Model FLOPs of one training step over B sequences of S tokens."""
    return 6.0 * lm_weight_params(cfg) * B * S + 3.0 * B * lm_attention_fwd_flops(cfg, S)


def lm_prefill_flops(cfg: dict, S: int) -> float:
    """Model FLOPs of prefilling one prompt of S tokens: the trunk at
    every position, the head at the last."""
    head = cfg["d_model"] * cfg["vocab"]
    trunk = lm_weight_params(cfg) - head
    return 2.0 * trunk * S + 2.0 * head + lm_attention_fwd_flops(cfg, S)
