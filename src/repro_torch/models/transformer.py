"""Model assembly: param-def trees + the layer loop for forward/decode.

The torch counterpart of ``repro.models.transformer`` for the dense and
moe families:

  dense — GQA decoder LM (smollm, deepseek-coder, phi4, gemma3's
          local:global pattern through per-layer flags)
  moe   — GQA or MLA attention + fine-grained MoE FFN (deepseek-moe,
          deepseek-v2-lite); the first ``first_k_dense`` layers
          (``dense_layers``) take a dense FFN of the "active-equivalent"
          width d_ff_expert·(top_k + n_shared)

Per-layer parameters are stacked on a leading ``layers`` axis, as in the
JAX package, so the two parameter trees match leaf for leaf; a Python loop
over that axis takes the place of ``lax.scan``. Training runs through
``loss_fn``: the layer loop under activation checkpointing (``remat``, the
JAX package's ``jax.checkpoint`` around the scanned layer) and the
cross-entropy over sequence chunks (``_chunked_ce``), plus the MoE
layers' router aux loss.

The other families — ssm, hybrid, encdec, vlm — raise
:class:`NotImplementedError` naming ROADMAP.md queue 1, item 12.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint as tcp

from . import attention as attn
from . import moe as moe_mod
from .config import ModelConfig
from .layers import embed, nll, rmsnorm, softmax_cross_entropy, swiglu, unembed
from .params import ParamDef, leaf_paths, unflatten

__all__ = ["model_defs", "forward", "forward_hidden", "prefill",
           "decode_step", "cache_defs", "loss_fn"]

L = "layers"
_NOT_PORTED = "is not ported yet: ROADMAP.md queue 1, item 12"
_PORTED_FAMILIES = ("dense", "moe")


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of a family this package runs (dense or
    moe, with GQA or MLA attention)."""
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} ({cfg.name}) "
                                  f"{_NOT_PORTED}")


# ======================================================================
# Param defs
# ======================================================================

def _attn_defs(cfg: ModelConfig, n_layers: int) -> dict:
    """GQA projection defs, stacked over n_layers."""
    H, KV, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    o_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "wq": ParamDef((n_layers, D, H * hd), (L, "embed", "heads")),
        "wk": ParamDef((n_layers, D, KV * hd), (L, "embed", "kv_heads")),
        "wv": ParamDef((n_layers, D, KV * hd), (L, "embed", "kv_heads")),
        "wo": ParamDef((n_layers, H * hd, D), (L, "heads", "embed"), scale=o_scale),
    }


def _mlp_defs(D: int, F: int, n_layers: int, o_scale: float) -> dict:
    return {
        "gate": ParamDef((n_layers, D, F), (L, "embed", "ffn")),
        "up": ParamDef((n_layers, D, F), (L, "embed", "ffn")),
        "down": ParamDef((n_layers, F, D), (L, "ffn", "embed"), scale=o_scale),
    }


def _norm(D: int, n_layers: int | None) -> ParamDef:
    lead = () if n_layers is None else (n_layers,)
    la = () if n_layers is None else (L,)
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


def _decoder_layer_defs(cfg: ModelConfig, n_layers: int, *, use_moe: bool,
                        d_ff: int | None = None) -> dict:
    """One stack of decoder layers: GQA or MLA, then MoE or a SwiGLU FFN of
    width ``d_ff`` (default ``cfg.d_ff``)."""
    D = cfg.d_model
    o_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    d = {"norm1": _norm(D, n_layers), "norm2": _norm(D, n_layers)}
    d.update(_mla_defs(cfg, n_layers) if cfg.mla is not None
             else _attn_defs(cfg, n_layers))
    if use_moe:
        d["moe"] = _moe_defs(cfg, n_layers)
    else:
        d.update(_mlp_defs(D, d_ff or cfg.d_ff, n_layers, o_scale))
    return d


def model_defs(cfg: ModelConfig) -> dict:
    check_ported(cfg)
    D, V = cfg.d_model, cfg.vocab_padded
    defs: dict[str, Any] = {
        "embed": ParamDef((V, D), ("vocab", "embed")),
        "final_norm": _norm(D, None),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((D, V), ("embed", "vocab"))
    if cfg.family == "moe":
        mo = cfg.moe
        k = mo.first_k_dense
        if k:
            # the first-k dense layers use the "active-equivalent" FFN width
            defs["dense_layers"] = _decoder_layer_defs(
                cfg, k, use_moe=False, d_ff=mo.d_ff_expert * (mo.top_k + mo.n_shared))
        defs["layers"] = _decoder_layer_defs(cfg, cfg.n_layers - k, use_moe=True)
    else:
        defs["layers"] = _decoder_layer_defs(cfg, cfg.n_layers, use_moe=False)
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


def _ffn(p, h, cfg: ModelConfig):
    """The layer's FFN: MoE where it has one, else SwiGLU (no aux loss)."""
    if "moe" in p:
        return moe_mod.moe_ffn(p["moe"], h, cfg)
    return swiglu(p, h), torch.zeros((), dtype=torch.float32, device=h.device)


def _attn_layer_train(p, x, cfg: ModelConfig, is_global, pos):
    """One decoder layer (attention + FFN/MoE) -> (x, aux)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        x = x + attn.mla_attention(p, h, cfg, pos=pos)
    else:
        x = x + attn.gqa_attention(p, h, cfg, is_global=is_global, pos=pos)
    f, aux = _ffn(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + f, aux


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


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig,
                   remat: bool | str = True):
    """Full-sequence trunk -> (hidden (B,S,D) after final norm, aux_loss)."""
    check_ported(cfg)
    adt = getattr(torch, cfg.activation_dtype)
    x = embed(params["embed"], batch["tokens"], adt)
    pos = torch.arange(x.shape[1], device=x.device)
    layer = _remat(functools.partial(_attn_layer_train, cfg=cfg, pos=pos), remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, flags in _stacks(cfg):
        for p, fl in zip(_layers(params[name]), flags):
            x, a = layer(p, x, is_global=bool(fl))
            aux = aux + a
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


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
    ``batch["labels"]`` (kept positions only with ``batch["loss_mask"]``)."""
    hidden, aux = forward_hidden(params, batch, cfg, remat)
    ce = _chunked_ce(hidden, _unembed_w(params, cfg), batch["labels"],
                     batch.get("loss_mask"), cfg)
    return ce + aux, (ce, aux)


# ======================================================================
# Decode (single token with cache)
# ======================================================================

def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """ParamDef tree for the decode cache (zeros, dtype chosen at init):
    per stack of layers, GQA's ``k`` and ``v`` or MLA's compressed
    ``c_kv`` and ``k_rope``."""
    check_ported(cfg)
    m = cfg.mla

    def stack(n):
        if m is not None:
            axes = (L, "batch", "seq", None)
            return {"c_kv": ParamDef((n, batch, max_len, m.kv_lora_rank), axes,
                                     init="zeros"),
                    "k_rope": ParamDef((n, batch, max_len, m.qk_rope_dim), axes,
                                       init="zeros")}
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.hd)
        axes = (L, "batch", "seq", "kv_heads", None)
        return {"k": ParamDef(shape, axes, init="zeros"),
                "v": ParamDef(shape, axes, init="zeros")}

    return {name: stack(len(flags)) for name, flags in _stacks(cfg)}


def _attn_layer_decode(p, x, cl, cur, cfg, is_global):
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, cl_new = attn.mla_decode(p, h, cl, cur, cfg)
    else:
        a, cl_new = attn.gqa_decode(p, h, cl, cur, cfg, is_global=is_global)
    x = x + a
    f, _ = _ffn(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + f, cl_new


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode. batch: {tokens:(B,1), cur: int} -> (logits, cache).

    The cache is written in place (position ``cur`` of every layer, through
    the per-layer views ``_layers`` gives) and returned."""
    check_ported(cfg)
    adt = getattr(torch, cfg.activation_dtype)
    cur = int(batch["cur"])
    x = embed(params["embed"], batch["tokens"], adt)
    for name, flags in _stacks(cfg):
        for p, cl, fl in zip(_layers(params[name]), _layers(cache[name]), flags):
            x, _ = _attn_layer_decode(p, x, cl, cur, cfg, bool(fl))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _mask_pad(unembed(_unembed_w(params, cfg), x), cfg), cache
