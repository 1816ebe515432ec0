"""What the LM loops share: the model configuration, the weights the
benchmark makes from the seed, and loading them into the program."""

from __future__ import annotations

import dataclasses
import math

import torch

# the leaves of a decoder-only Llama-architecture model, in the layout both
# the program (``repro_torch.models.Model``'s parameter names) and the
# reference (``bench/reference/lm.py``) take
LAYER_LEAVES = ("norm1", "norm2", "wq", "wk", "wv", "wo", "gate", "up", "down")
OUT_PROJECTIONS = ("layers.wo", "layers.down")


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file's keys."""
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    D, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    F, V, L = cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    shapes = {"embed": (V, D), "final_norm": (D,),
              "layers.norm1": (L, D), "layers.norm2": (L, D),
              "layers.wq": (L, D, H * hd), "layers.wk": (L, D, KV * hd),
              "layers.wv": (L, D, KV * hd), "layers.wo": (L, H * hd, D),
              "layers.gate": (L, D, F), "layers.up": (L, D, F),
              "layers.down": (L, F, D)}
    if not cfg["tie_embeddings"]:
        shapes["unembed"] = (D, V)
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every weight from ``seed`` in one normal draw on ``device``, in
    float32 (the master weights' type): standard deviation ``initializer_range``,
    the output projections' divided by sqrt(2·n_layers) (the norms' gain
    offsets included, so that a norm's weight is not inert)."""
    shapes = weight_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    std = cfg["initializer_range"]
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[at:at + n].view(shape)
        t.mul_(std / math.sqrt(2 * cfg["n_layers"]) if name in OUT_PROJECTIONS else std)
        out[name] = t
        at += n
    return out


def load_model(cfg: dict, weights: dict, device):
    """The program's ``Model`` of ``cfg`` holding a copy of ``weights``."""
    from repro_torch.models import Model

    model = Model(model_config(cfg), device=device)
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise ValueError(f"the program's parameters {sorted(names)} are not the "
                         f"benchmark's {sorted(weights)}")
    with torch.no_grad():
        for name, p in names.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the program's {tuple(p.shape)}, the "
                                 f"benchmark's {tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return model


def flash_designs(launches: dict, backward: bool) -> dict:
    fwd = launches["FLASH_DESIGN_LAUNCHES"]
    out = {"flash forward launches by design": fwd}
    ok = fwd.get("simple", 0) == 0 and fwd.get("sm90", 0) > 0
    if backward:
        bwd = launches["FLASH_BWD_DESIGN_LAUNCHES"]
        out["flash backward launches by design"] = bwd
        ok = ok and bwd.get("simple", 0) == 0 and bwd.get("sm90", 0) > 0
    out["sm90 only"] = ok
    return out
