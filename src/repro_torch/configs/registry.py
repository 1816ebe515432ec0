"""Architecture registry: --arch <id> → config, shape suite, inputs.

The torch counterpart of ``repro.configs.registry`` for the architectures
ported so far. Every architecture of the JAX package has a name here;
one that is not ported yet raises, naming ROADMAP.md queue 1, item 12.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "PORTED", "SHAPES", "ShapeSpec", "get_config",
           "get_smoke", "concrete_batch"]

ARCHS = ("smollm-360m", "gemma3-1b", "deepseek-coder-33b", "phi4-mini-3.8b",
         "deepseek-v2-lite-16b", "deepseek-moe-16b", "whisper-small",
         "internvl2-76b", "zamba2-1.2b", "mamba2-2.7b")

# arch -> module under repro_torch.configs, for the archs ported so far
PORTED = {"smollm-360m": "smollm_360m", "gemma3-1b": "gemma3_1b",
          "deepseek-coder-33b": "deepseek_coder_33b",
          "phi4-mini-3.8b": "phi4_mini_3p8b",
          "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
          "deepseek-moe-16b": "deepseek_moe_16b"}


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
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP.md queue 1, item 12 "
            f"(ported: {', '.join(PORTED)})")
    return importlib.import_module(f"repro_torch.configs.{PORTED[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def _input_shapes(cfg: ModelConfig, shape: ShapeSpec, batch_override=None):
    """Shapes of a cell's int32 model inputs, in the JAX package's order
    (``input_specs`` of the dense and moe families)."""
    B = batch_override or shape.global_batch
    if shape.mode in ("train", "prefill"):
        return {"tokens": (B, shape.seq_len), "labels": (B, shape.seq_len)}
    return {"tokens": (B, 1), "cur": ()}


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec, *, batch_override=None,
                   seed: int = 0, device="cuda") -> dict:
    """A cell's inputs drawn from ``numpy.random.default_rng(seed)`` as
    the JAX package draws them (the same tokens), as int32 tensors on
    ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in _input_shapes(cfg, shape, batch_override).items():
        if shp:
            hi = cfg.vocab if k in ("tokens", "labels") else max(shape.seq_len, 2)
            arr = rng.integers(0, hi, shp, dtype=np.int32)
        else:
            arr = np.zeros((), np.int32)
        out[k] = torch.from_numpy(arr).to(dev)
    return out
