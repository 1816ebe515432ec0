"""Model assembly: param-def trees + the layer loop for forward/decode.

The torch counterpart of ``repro.models.transformer``, every family:

  dense  — GQA decoder LM (smollm, deepseek-coder, phi4, gemma3's
           local:global pattern through per-layer flags)
  moe    — GQA or MLA attention + fine-grained MoE FFN (deepseek-moe,
           deepseek-v2-lite); the first ``first_k_dense`` layers
           (``dense_layers``) take a dense FFN of the "active-equivalent"
           width d_ff_expert·(top_k + n_shared)
  ssm    — Mamba2/SSD stack (mamba2-2.7b; models/mamba2.py)
  hybrid — Mamba2 stack + ONE weight-shared GQA block applied after every
           ``period`` layers (zamba2)
  encdec — whisper: a bidirectional encoder over stubbed frame embeddings
           (``masked_sdpa``, no flash), a causal decoder with
           cross-attention to the encoder's K/V
  vlm    — internvl: stubbed ViT patch embeddings -> projector ->
           prepended to the dense LM's tokens; the loss scores the text

With DTensor parameters (``Model.shard``) the same code runs over a
device mesh under ``params.on_mesh``, forward and backward:
``_act_constraint`` pins the residual stream to ``cfg.act_spec`` after
each layer, as the JAX package's ``with_sharding_constraint`` does.

Per-layer parameters are stacked on a leading ``layers`` axis, as in the
JAX package, so the two parameter trees match leaf for leaf; a Python loop
over that axis takes the place of ``lax.scan``. Training runs through
``loss_fn``: the layer loop under activation checkpointing (``remat``, the
JAX package's ``jax.checkpoint`` around the scanned layer) and the
cross-entropy over sequence chunks (``_chunked_ce``), plus the MoE
layers' router aux loss. Decode writes the cache in place through
per-layer views; an unknown family raises ``ValueError(family)``, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint as tcp
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ops import on_heads

from . import attention as attn
from . import moe as moe_mod
from .config import ModelConfig
from .layers import embed, nll, rmsnorm, softmax_cross_entropy, swiglu, unembed
from .mamba2 import mamba2_block, mamba2_decode
from .params import ParamDef, constrain, gathered, leaf_paths, unflatten

__all__ = ["model_defs", "forward", "forward_hidden", "prefill",
           "decode_step", "cache_defs", "loss_fn"]

L = "layers"
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError(family)`` unless ``cfg``'s family is one of
    :data:`FAMILIES`."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ======================================================================
# Param defs
# ======================================================================

def _lead(n_layers: int | None) -> tuple[tuple, tuple]:
    """The leading shape and axis of a stack of ``n_layers`` (none for an
    unstacked block, ``n_layers=None``)."""
    return ((), ()) if n_layers is None else ((n_layers,), (L,))


def _attn_defs(cfg: ModelConfig, n_layers: int | None, *, heads=None,
               kv=None) -> dict:
    """GQA projection defs; n_layers=None -> unstacked (shared block)."""
    H, KV = heads or cfg.n_heads, kv or cfg.n_kv_heads
    hd, D = cfg.hd, cfg.d_model
    lead, la = _lead(n_layers)
    o_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "wq": ParamDef(lead + (D, H * hd), la + ("embed", "heads")),
        "wk": ParamDef(lead + (D, KV * hd), la + ("embed", "kv_heads")),
        "wv": ParamDef(lead + (D, KV * hd), la + ("embed", "kv_heads")),
        "wo": ParamDef(lead + (H * hd, D), la + ("heads", "embed"), scale=o_scale),
    }


def _mlp_defs(D: int, F: int, n_layers: int | None, o_scale: float) -> dict:
    lead, la = _lead(n_layers)
    return {
        "gate": ParamDef(lead + (D, F), la + ("embed", "ffn")),
        "up": ParamDef(lead + (D, F), la + ("embed", "ffn")),
        "down": ParamDef(lead + (F, D), la + ("ffn", "embed"), scale=o_scale),
    }


def _norm(D: int, n_layers: int | None) -> ParamDef:
    lead, la = _lead(n_layers)
    return ParamDef(lead + (D,), la + (None,), init="zeros")


def _mla_defs(cfg: ModelConfig, n_layers: int) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    o_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "wq": ParamDef((n_layers, D, H * (m.qk_nope_dim + m.qk_rope_dim)),
                       (L, "embed", "heads")),
        "w_dkv": ParamDef((n_layers, D, m.kv_lora_rank + m.qk_rope_dim),
                          (L, "embed", None)),
        "w_uk": ParamDef((n_layers, m.kv_lora_rank, H * m.qk_nope_dim),
                         (L, None, "heads")),
        "w_uv": ParamDef((n_layers, m.kv_lora_rank, H * m.v_dim),
                         (L, None, "heads")),
        "wo": ParamDef((n_layers, H * m.v_dim, D), (L, "heads", "embed"),
                       scale=o_scale),
    }


def _moe_defs(cfg: ModelConfig, n_layers: int) -> dict:
    mo = cfg.moe
    D, E, Fe = cfg.d_model, mo.n_routed, mo.d_ff_expert
    Fs = mo.n_shared * Fe
    o_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "router": ParamDef((n_layers, D, E), (L, "embed", None)),
        "w1": ParamDef((n_layers, E, D, Fe), (L, "expert", None, None)),
        "w3": ParamDef((n_layers, E, D, Fe), (L, "expert", None, None)),
        "w2": ParamDef((n_layers, E, Fe, D), (L, "expert", None, None),
                       scale=o_scale),
        "shared_gate": ParamDef((n_layers, D, Fs), (L, "embed", "ffn")),
        "shared_up": ParamDef((n_layers, D, Fs), (L, "embed", "ffn")),
        "shared_down": ParamDef((n_layers, Fs, D), (L, "ffn", "embed"),
                                scale=o_scale),
    }


def _mamba_defs(cfg: ModelConfig, n_layers: int) -> dict:
    ssm = cfg.ssm
    D = cfg.d_model
    d_inner = ssm.expand * D
    gn = ssm.n_groups * ssm.d_state
    H = d_inner // ssm.head_dim
    d_in_proj = 2 * d_inner + 2 * gn + H
    conv_dim = d_inner + 2 * gn
    o_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "norm": _norm(D, n_layers),
        "in_proj": ParamDef((n_layers, D, d_in_proj), (L, "embed", "inner")),
        "conv_w": ParamDef((n_layers, ssm.conv_width, conv_dim),
                           (L, None, "conv")),
        "conv_b": ParamDef((n_layers, conv_dim), (L, "conv"), init="zeros"),
        "a_log": ParamDef((n_layers, H), (L, None), init="custom:a_log"),
        "d_skip": ParamDef((n_layers, H), (L, None), init="ones"),
        "dt_bias": ParamDef((n_layers, H), (L, None), init="custom:dt_bias"),
        "gnorm": ParamDef((n_layers, d_inner), (L, "inner"), init="zeros"),
        "out_proj": ParamDef((n_layers, d_inner, D), (L, "inner", "embed"),
                             scale=o_scale),
    }


def _decoder_layer_defs(cfg: ModelConfig, n_layers: int, *, use_moe: bool,
                        d_ff: int | None = None, cross: bool = False) -> dict:
    """One stack of decoder layers: GQA or MLA, with ``cross`` an MHA
    cross-attention (``cross``, ``norm_x``), then MoE or a SwiGLU FFN of
    width ``d_ff`` (default ``cfg.d_ff``)."""
    D = cfg.d_model
    o_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    d = {"norm1": _norm(D, n_layers), "norm2": _norm(D, n_layers)}
    d.update(_mla_defs(cfg, n_layers) if cfg.mla is not None
             else _attn_defs(cfg, n_layers))
    if cross:
        d["norm_x"] = _norm(D, n_layers)
        d["cross"] = _attn_defs(cfg, n_layers, kv=cfg.n_heads)
    if use_moe:
        d["moe"] = _moe_defs(cfg, n_layers)
    else:
        d.update(_mlp_defs(D, d_ff or cfg.d_ff, n_layers, o_scale))
    return d


def model_defs(cfg: ModelConfig) -> dict:
    check_family(cfg)
    D, V = cfg.d_model, cfg.vocab_padded
    defs: dict[str, Any] = {
        "embed": ParamDef((V, D), ("vocab", "embed")),
        "final_norm": _norm(D, None),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((D, V), ("embed", "vocab"))
    fam = cfg.family
    if fam in ("dense", "vlm"):
        defs["layers"] = _decoder_layer_defs(cfg, cfg.n_layers, use_moe=False)
        if fam == "vlm":
            defs["projector"] = {
                "w1": ParamDef((cfg.vlm.vit_dim, D), (None, "embed")),
                "norm": ParamDef((cfg.vlm.vit_dim,), (None,), init="zeros"),
            }
    elif fam == "moe":
        mo = cfg.moe
        k = mo.first_k_dense
        if k:
            # the first-k dense layers use the "active-equivalent" FFN width
            defs["dense_layers"] = _decoder_layer_defs(
                cfg, k, use_moe=False, d_ff=mo.d_ff_expert * (mo.top_k + mo.n_shared))
        defs["layers"] = _decoder_layer_defs(cfg, cfg.n_layers - k, use_moe=True)
    elif fam in ("ssm", "hybrid"):
        defs["layers"] = _mamba_defs(cfg, cfg.n_layers)
        if fam == "hybrid":
            hy = cfg.hybrid
            shared = {"norm1": _norm(D, None), "norm2": _norm(D, None)}
            shared.update(_attn_defs(cfg, None, heads=hy.shared_n_heads,
                                     kv=hy.shared_n_kv_heads))
            shared.update(_mlp_defs(D, hy.shared_d_ff, None,
                                    0.02 / np.sqrt(2 * cfg.n_layers)))
            defs["shared_block"] = shared
    else:  # encdec
        defs["layers"] = _decoder_layer_defs(cfg, cfg.n_layers, use_moe=False,
                                             cross=True)
        defs["enc_layers"] = _decoder_layer_defs(cfg, cfg.encdec.n_enc_layers,
                                                 use_moe=False)
        defs["enc_final_norm"] = _norm(D, None)
    return defs


# ======================================================================
# Forward (full sequence)
# ======================================================================

def _layer_flags(cfg: ModelConfig) -> np.ndarray:
    return np.array([cfg.layer_is_global(i) for i in range(cfg.n_layers)],
                    dtype=np.bool_)


def _layers(stacked: dict) -> list[dict]:
    """Every layer's slice of the stacked parameters, nested as they are
    (views, one unbind per leaf, whose backward stacks the layers'
    gradients once)."""
    paths, ws = zip(*((path, t.unbind(0)) for path, t in leaf_paths(stacked)))
    return [unflatten(dict(zip(paths, layer))) for layer in zip(*ws)]


def _stacks(cfg: ModelConfig) -> list[tuple[str, np.ndarray]]:
    """The stacked layer groups in the order they run, each with its
    layers' ``is_global`` flags: the moe family's ``dense_layers`` (the
    first ``first_k_dense``), then ``layers``."""
    flags = _layer_flags(cfg)
    k = cfg.moe.first_k_dense if cfg.family == "moe" else 0
    groups = [("dense_layers", flags[:k])] if k else []
    return groups + [("layers", flags[k:])]


def _act_constraint(x, cfg: ModelConfig):
    """The residual stream redistributed to ``cfg.act_spec`` (set by the
    launcher per mesh, typically ``(batch_axes, "model", None)``: batch and
    sequence sharded, Megatron-SP style, so that the residuals remat
    keeps are 1/TP the size) where it is a 3-dim DTensor; otherwise ``x``."""
    if cfg.act_spec is None or x.ndim != 3:
        return x
    return constrain(x, cfg.act_spec)


def _seq_whole(x):
    """The (B, S, D) residual with the sequence whole on every rank where
    it is a DTensor, taken at a layer's entry: the all-gather that
    sequence-sharded residuals take before the projections. DTensor will
    not flatten (B, S) for a product while S is split, nor, in the
    backward, the gradient of a sublayer's output added to a split
    residual; the layer's output goes back to ``act_spec``. A plain
    tensor passes through."""
    return gathered(x, 1) if x.ndim == 3 else x


def _ffn(p, h, cfg: ModelConfig):
    """The layer's FFN: MoE where it has one, else SwiGLU (no aux loss)."""
    if "moe" in p:
        return moe_mod.moe_ffn(p["moe"], h, cfg)
    return swiglu(p, h), torch.zeros((), dtype=torch.float32, device=h.device)


def _attn_layer_train(p, x, cfg: ModelConfig, is_global, pos, cross_kv=None):
    """One decoder layer (attention, the cross-attention to ``cross_kv``
    where given, FFN/MoE) -> (x, aux)."""
    x = _seq_whole(x)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        x = x + attn.mla_attention(p, h, cfg, pos=pos)
    else:
        x = x + attn.gqa_attention(p, h, cfg, is_global=is_global, pos=pos)
    if cross_kv is not None:
        hx = rmsnorm(x, p["norm_x"], cfg.norm_eps)
        x = x + _cross_attention(p["cross"], hx, cross_kv, cfg)
    f, aux = _ffn(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    return _act_constraint(x + f, cfg), aux


def _cross_attention(p, h, enc_kv, cfg: ModelConfig):
    """Decoder cross-attention over precomputed encoder K/V (B, F, H, hd):
    scores and softmax in f32, the probabilities rounded to v's dtype, the
    output cast to h's dtype before the output projection (under f32
    activations a no-op; decode may read an f32 cache under bf16
    activations, as ``attention.gqa_decode`` does). On DTensors each rank
    attends its own rows and heads (``kernels.ops.on_heads``) unless the
    encoder K/V are split along their frames; then DTensor runs it, the
    heads whole."""
    H, hd = cfg.n_heads, cfg.hd
    q = attn.split_heads(h @ p["wq"].to(h.dtype), H, hd)
    k, v = enc_kv

    def cross(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype).float(), v.float())
        return o.to(v.dtype)

    if isinstance(q, DTensor) and not attn._seq_split(k, v):
        o = on_heads(cross, (q,), (k, v))
    else:
        o = cross(*(attn.heads_whole(t) for t in (q, k, v)))
    return attn.merge_heads(o).to(h.dtype) @ p["wo"].to(h.dtype)


def _mamba_layer(p, x, cfg: ModelConfig):
    x = _seq_whole(x)
    return _act_constraint(
        x + mamba2_block(p, rmsnorm(x, p["norm"], cfg.norm_eps), cfg), cfg)


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The hybrid's shared attention block as a config of its own."""
    hy = cfg.hybrid
    return dataclasses.replace(cfg, n_heads=hy.shared_n_heads,
                               n_kv_heads=hy.shared_n_kv_heads,
                               head_dim=cfg.d_model // hy.shared_n_heads,
                               mla=None, sliding_window=None)


def _mamba_segments(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """The Mamba2 layers' segments ``(start, stop, shared)`` in order: the
    ssm family's one; the hybrid's of ``period`` layers each (the last may
    be shorter), ``shared`` where the shared block follows: after every
    segment but a short last one."""
    nl = cfg.n_layers
    if cfg.family == "ssm":
        return [(0, nl, False)]
    period = cfg.hybrid.period
    out = []
    for start in range(0, nl, period):
        stop = min(start + period, nl)
        out.append((start, stop, stop < nl or stop % period == 0))
    return out


def _n_shared_apps(cfg: ModelConfig) -> int:
    return sum(shared for _, _, shared in _mamba_segments(cfg))


def _shared_apply(shared, x, cfg: ModelConfig, pos):
    scfg = _shared_cfg(cfg)
    x = x + attn.gqa_attention(shared, rmsnorm(x, shared["norm1"], cfg.norm_eps),
                               scfg, pos=pos)
    return x + swiglu(shared, rmsnorm(x, shared["norm2"], cfg.norm_eps))


# The weight GEMMs of a layer (``x @ w`` on (B,S,D) activations lowers to
# ``mm``): what ``remat="dots"`` keeps, as the JAX package's
# ``dots_with_no_batch_dims_saveable`` keeps dots without batch dims (the
# attention's batched products are recomputed).
_SAVED_BY_DOTS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    return (tcp.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(layer_fn, remat):
    """``layer_fn`` under the JAX package's remat modes: True recomputes the
    whole layer in the backward (``checkpoint``, non-reentrant), "dots"
    saves the weight GEMMs' outputs and recomputes the rest (a selective
    checkpoint), False saves everything. Without grad mode there is nothing
    to save, and the layer runs as it is."""
    if remat not in (True, False, "dots"):
        raise ValueError(f"remat must be True, False or 'dots', got {remat!r}")
    if remat == "dots" and not hasattr(tcp, "create_selective_checkpoint_contexts"):
        raise NotImplementedError(
            f"remat='dots' needs torch.utils.checkpoint."
            f"create_selective_checkpoint_contexts, which torch "
            f"{torch.__version__} lacks; use remat=True or False")
    if not remat or not torch.is_grad_enabled():
        return layer_fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            tcp.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(tcp.checkpoint, layer_fn, use_reentrant=False, **kw)


def _encode(params, frames, cfg: ModelConfig, remat=True):
    """whisper's encoder: bidirectional attention over frame embeddings
    (``masked_sdpa``: the flash kernel is causal only, as in the JAX
    package)."""
    x = frames.to(getattr(torch, cfg.activation_dtype))
    pos = torch.arange(x.shape[1], device=x.device)

    def layer(p, x):
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        x = x + attn.gqa_attention(p, h, cfg, pos=pos, causal=False)
        return x + swiglu(p, rmsnorm(x, p["norm2"], cfg.norm_eps))

    layer = _remat(layer, remat)
    for p in _layers(params["enc_layers"]):
        x = layer(p, x)
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def _enc_kv_all(params, enc, cfg: ModelConfig):
    """The cross K and V of every decoder layer from the encoder's output
    ``enc`` (B, F, D): (n_layers, B, F, H, hd) each."""
    H, hd = cfg.n_heads, cfg.hd
    B, F, _ = enc.shape
    cross = params["layers"]["cross"]
    k = torch.stack([(enc @ w.to(enc.dtype)).reshape(B, F, H, hd)
                     for w in cross["wk"]])
    v = torch.stack([(enc @ w.to(enc.dtype)).reshape(B, F, H, hd)
                     for w in cross["wv"]])
    return k, v


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig,
                   remat: bool | str = True):
    """Full-sequence trunk -> (hidden (B,S,D) after final norm, aux_loss).
    The vlm family's hidden covers [patches; text]."""
    check_family(cfg)
    adt = getattr(torch, cfg.activation_dtype)
    x = embed(params["embed"], batch["tokens"], adt)
    fam = cfg.family
    if fam == "vlm":
        pn = params["projector"]
        patches = rmsnorm(batch["patches"].to(adt), pn["norm"], cfg.norm_eps)
        x = torch.cat([patches @ pn["w1"].to(adt), x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fam in ("ssm", "hybrid"):
        mamba = _remat(functools.partial(_mamba_layer, cfg=cfg), remat)
        layers = _layers(params["layers"])
        for start, stop, shared in _mamba_segments(cfg):
            for p in layers[start:stop]:
                x = mamba(p, x)
            if shared:
                x = _shared_apply(params["shared_block"], x, cfg, pos)
    else:
        layer = _remat(functools.partial(_attn_layer_train, cfg=cfg, pos=pos), remat)
        cross = [None] * cfg.n_layers
        if fam == "encdec":
            ek, ev = _enc_kv_all(params, _encode(params, batch["frames"], cfg, remat),
                                 cfg)
            cross = list(zip(ek, ev))
        for name, flags in _stacks(cfg):
            for p, fl, ckv in zip(_layers(params[name]), flags, cross):
                x, a = layer(p, x, is_global=bool(fl), cross_kv=ckv)
                aux = aux + a
    return rmsnorm(_seq_whole(x), params["final_norm"], cfg.norm_eps), aux


def _unembed_w(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _mask_pad(logits, cfg: ModelConfig):
    """-1e30 on the padded vocab tail (vocab_pad_multiple) wherever logits
    surface, so padding never wins a softmax/argmax."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    return torch.where(keep, logits, -1e30)


def forward(params: dict, batch: dict, cfg: ModelConfig,
            remat: bool | str = True):
    """Full-sequence forward -> (logits f32 (B,S,V), aux_loss).

    Materialises the full logits — use only for small configs/tests;
    loss_fn and prefill use the chunked/last-position paths.
    """
    x, aux = forward_hidden(params, batch, cfg, remat)
    return _mask_pad(unembed(_unembed_w(params, cfg), x), cfg), aux


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Inference prefill: trunk + LAST-position logits only (B,V)."""
    x, _ = forward_hidden(params, batch, cfg, remat=False)
    return _mask_pad(unembed(_unembed_w(params, cfg), x[:, -1]), cfg)


def _chunked_ce(hidden, w_un, labels, mask, cfg, chunk: int = 512):
    """CE without materialising (B,S,V): a loop over sequence chunks, each
    chunk's logits summed into the total as the JAX package's scan sums
    them. A sequence that is not a multiple of ``chunk`` takes the full
    logits, as there."""
    S = hidden.shape[1]
    if S % chunk:
        logits = _mask_pad(unembed(w_un, hidden), cfg)
        return softmax_cross_entropy(logits, labels, mask)
    mk = (torch.ones(labels.shape, dtype=torch.float32, device=hidden.device)
          if mask is None else mask.float())
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        logits = _mask_pad(unembed(w_un, hidden[:, i:i + chunk]), cfg)
        mc = mk[:, i:i + chunk]
        tot = tot + (nll(logits, labels[:, i:i + chunk]) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, remat: bool | str = True):
    """(ce + aux, (ce, aux)): the mean next-token cross-entropy over
    ``batch["labels"]`` (kept positions only with ``batch["loss_mask"]``;
    the vlm family scores its text positions only)."""
    hidden, aux = forward_hidden(params, batch, cfg, remat)
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.vlm.n_patches:]
    ce = _chunked_ce(hidden, _unembed_w(params, cfg), batch["labels"],
                     batch.get("loss_mask"), cfg)
    return ce + aux, (ce, aux)


# ======================================================================
# Decode (single token with cache)
# ======================================================================

def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """ParamDef tree for the decode cache (zeros, dtype chosen at init):
    per stack of layers, GQA's ``k`` and ``v`` or MLA's compressed
    ``c_kv`` and ``k_rope``; Mamba2's ``conv`` and ``ssm`` states (and the
    hybrid's ``shared`` k/v, one per application of the shared block);
    the encdec decoder's ``cross`` K/V, which the caller fills."""
    check_family(cfg)
    m = cfg.mla
    B, nl, hd = batch, cfg.n_layers, cfg.hd

    def kv(n, kvh, seq, head_dim=hd, axes=(L, "batch", "seq", "kv_heads", None)):
        shape = (n, B, seq, kvh, head_dim)
        return {"k": ParamDef(shape, axes, init="zeros"),
                "v": ParamDef(shape, axes, init="zeros")}

    def stack(n):
        if m is not None:
            axes = (L, "batch", "seq", None)
            return {"c_kv": ParamDef((n, B, max_len, m.kv_lora_rank), axes,
                                     init="zeros"),
                    "k_rope": ParamDef((n, B, max_len, m.qk_rope_dim), axes,
                                       init="zeros")}
        return kv(n, cfg.n_kv_heads, max_len)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return {name: stack(len(flags)) for name, flags in _stacks(cfg)}
    if fam == "encdec":
        return {"layers": stack(nl),
                "cross": kv(nl, cfg.n_heads, cfg.encdec.n_frames,
                            axes=(L, "batch", None, "heads", None))}
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    gn = ssm.n_groups * ssm.d_state
    H = d_inner // ssm.head_dim
    d = {"layers": {
        "conv": ParamDef((nl, B, ssm.conv_width - 1, d_inner + 2 * gn),
                         (L, "batch", None, "conv"), init="zeros"),
        "ssm": ParamDef((nl, B, H, ssm.head_dim, ssm.d_state),
                        (L, "batch", "inner", None, None), init="zeros")}}
    if fam == "hybrid":
        hy = cfg.hybrid
        d["shared"] = kv(_n_shared_apps(cfg), hy.shared_n_kv_heads, max_len,
                         head_dim=cfg.d_model // hy.shared_n_heads,
                         axes=(None, "batch", "seq", "kv_heads", None))
    return d


def _attn_layer_decode(p, x, cl, cur, cfg, is_global, cross_kv=None):
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, cl_new = attn.mla_decode(p, h, cl, cur, cfg)
    else:
        a, cl_new = attn.gqa_decode(p, h, cl, cur, cfg, is_global=is_global)
    x = x + a
    if cross_kv is not None:
        hx = rmsnorm(x, p["norm_x"], cfg.norm_eps)
        x = x + _cross_attention(p["cross"], hx, cross_kv, cfg)
    f, _ = _ffn(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + f, cl_new


def _mamba_layer_decode(p, x, cl, cfg: ModelConfig):
    """One Mamba2 layer's decode step; its new conv and SSM states are
    copied into the layer's views of the stacked cache ``cl``."""
    o, new = mamba2_decode(p, rmsnorm(x, p["norm"], cfg.norm_eps), cl, cfg)
    cl["conv"].copy_(new["conv"])
    cl["ssm"].copy_(new["ssm"])
    return x + o


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode. batch: {tokens:(B,1), cur: int} -> (logits, cache).

    The cache is written in place (position ``cur`` of every attention
    layer, every Mamba2 layer's states, through the per-layer views
    ``_layers`` gives) and returned. The vlm family decodes text tokens as
    the dense one does; the encdec decoder reads ``cache["cross"]``."""
    check_family(cfg)
    adt = getattr(torch, cfg.activation_dtype)
    cur = int(batch["cur"])
    x = embed(params["embed"], batch["tokens"], adt)
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        layers = list(zip(_layers(params["layers"]), _layers(cache["layers"])))
        app = 0
        for start, stop, shared in _mamba_segments(cfg):
            for p, cl in layers[start:stop]:
                x = _mamba_layer_decode(p, x, cl, cfg)
            if shared:
                sh, sc = params["shared_block"], cache["shared"]
                h = rmsnorm(x, sh["norm1"], cfg.norm_eps)
                a, _ = attn.gqa_decode(sh, h, {"k": sc["k"][app], "v": sc["v"][app]},
                                       cur, _shared_cfg(cfg))
                x = x + a
                x = x + swiglu(sh, rmsnorm(x, sh["norm2"], cfg.norm_eps))
                app += 1
    else:
        cross = [None] * cfg.n_layers
        if fam == "encdec":
            cross = list(zip(cache["cross"]["k"], cache["cross"]["v"]))
        for name, flags in _stacks(cfg):
            for p, cl, fl, ckv in zip(_layers(params[name]), _layers(cache[name]),
                                      flags, cross):
                x, _ = _attn_layer_decode(p, x, cl, cur, cfg, bool(fl), ckv)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _mask_pad(unembed(_unembed_w(params, cfg), x), cfg), cache
