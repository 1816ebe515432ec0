"""Architecture registry: --arch <id> → config, shape suite, inputs.

The torch counterpart of ``repro.configs.registry``: every architecture
of the JAX package, its configurations in a module of
``repro_torch.configs``; an unknown name raises ``KeyError``. The 10
architectures × their 4 LM shapes are 40 cells of the dry run
(``launch/dryrun.py``). ``long_500k`` needs sub-quadratic attention and
runs only for the SSM, hybrid and sliding-window archs (``LONG_OK``); the
pure full-attention archs record it as a skip with its reason.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke", "input_specs",
           "cells", "shape_skip_reason", "LONG_OK"]

ARCHS = ("smollm-360m", "gemma3-1b", "deepseek-coder-33b", "phi4-mini-3.8b",
         "deepseek-v2-lite-16b", "deepseek-moe-16b", "whisper-small",
         "internvl2-76b", "zamba2-1.2b", "mamba2-2.7b")

# arch -> module under repro_torch.configs
PORTED = {"smollm-360m": "smollm_360m", "gemma3-1b": "gemma3_1b",
          "deepseek-coder-33b": "deepseek_coder_33b",
          "phi4-mini-3.8b": "phi4_mini_3p8b",
          "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
          "deepseek-moe-16b": "deepseek_moe_16b",
          "whisper-small": "whisper_small", "internvl2-76b": "internvl2_76b",
          "zamba2-1.2b": "zamba2_1p2b", "mamba2-2.7b": "mamba2_2p7b"}

# archs for which long_500k decode is sub-quadratic-legal
LONG_OK = ("mamba2-2.7b", "zamba2-1.2b", "gemma3-1b")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; one of {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{PORTED[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_skip_reason(arch: str, shape: str) -> str | None:
    """Why the dry run skips (``arch``, ``shape``), or None."""
    if shape == "long_500k" and arch not in LONG_OK:
        return ("full-attention arch: 512k dense KV decode is the "
                "quadratic-prefill regime the assignment skips")
    return None


def cells(include_skipped: bool = False) -> list[tuple[str, str]]:
    """All (arch, shape) pairs, minus the documented skips."""
    return [(a, s) for a in ARCHS for s in SHAPES
            if include_skipped or shape_skip_reason(a, s) is None]


def _input_shapes(cfg: ModelConfig, shape: ShapeSpec, batch_override=None):
    """Shapes and dtypes of a cell's model inputs, in the JAX package's
    order (``input_specs``): int32 tokens and labels, and the stubbed
    frontends' f32 frames (encdec) or patches (vlm, whose text takes the
    sequence's other S − n_patches positions)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32, f32 = np.int32, np.float32
    if shape.mode in ("train", "prefill"):
        if cfg.family == "vlm":
            st = S - cfg.vlm.n_patches
            return {"tokens": ((B, st), i32), "labels": ((B, st), i32),
                    "patches": ((B, cfg.vlm.n_patches, cfg.vlm.vit_dim), f32)}
        out = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
        if cfg.family == "encdec":
            out["frames"] = ((B, cfg.encdec.n_frames, cfg.d_model), f32)
        return out
    return {"tokens": ((B, 1), i32), "cur": ((), i32)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch_override=None) -> dict:
    """Meta tensors (shapes and dtypes, no data) standing in for every
    model input of a cell: the counterpart of the JAX package's
    ``ShapeDtypeStruct``. train/prefill: the full-sequence batch;
    decode: the one-token batch (the cache is a state operand,
    ``Model.abstract_cache``)."""
    return {k: torch.empty(shp, dtype=getattr(torch, np.dtype(dt).name),
                           device="meta")
            for k, (shp, dt) in _input_shapes(cfg, shape, batch_override).items()}


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec, *, batch_override=None,
                   seed: int = 0, device="cuda") -> dict:
    """A cell's inputs drawn from ``numpy.random.default_rng(seed)`` as
    the JAX package draws them (the same tokens, frames and patches, key
    by key in its order), as tensors on ``device``: int32 tokens, f32
    normal frames and patches."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dtype) in _input_shapes(cfg, shape, batch_override).items():
        if dtype == np.float32:
            arr = rng.normal(size=shp).astype(np.float32)
        elif shp:
            hi = cfg.vocab if k in ("tokens", "labels") else max(shape.seq_len, 2)
            arr = rng.integers(0, hi, shp, dtype=np.int32)
        else:
            arr = np.zeros((), np.int32)
        out[k] = torch.from_numpy(arr).to(dev)
    return out
