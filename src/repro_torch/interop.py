"""Carry state, stores and weights across as numpy arrays.

The JAX package and the torch package exchange data only as numpy
arrays: a test makes its inputs with numpy and hands the same arrays to
both. These helpers check what they are given and put it on a device.
A language model's weights cross the same way: JAX's random streams
cannot be reproduced in torch, so ``lm_params_from_numpy`` takes the JAX
parameter tree as numpy arrays, and ``opt_state_from_numpy`` its AdamW
state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import leaf_paths, unflatten
from repro_torch.models.transformer import model_defs
from repro_torch.models.zoo import Model
from repro_torch.stencil.gol3d import Gol3d, Gol3dConfig

__all__ = ["from_reference_state", "lm_params_from_numpy", "load_lm_params",
           "opt_state_from_numpy", "store_from_numpy", "store_to_numpy",
           "weights_from_numpy"]


def from_reference_state(state_path: np.ndarray, cfg: Gol3dConfig,
                         device="cuda") -> Gol3d:
    """A :class:`Gol3d` of ``cfg`` whose state is ``state_path``, the
    (M³,) f32 state in ``cfg.ordering`` order (e.g. a JAX
    ``Gol3d.state_path``), on ``device``."""
    arr = np.asarray(state_path)
    if arr.shape != (cfg.M ** 3,) or arr.dtype != np.float32:
        raise ValueError(f"state_path must be ({cfg.M ** 3},) float32, "
                         f"got {arr.shape} {arr.dtype}")
    app = Gol3d(dataclasses.replace(cfg, device=str(device)))
    app.state_path = torch.from_numpy(arr.copy()).to(app.device)
    return app


def store_from_numpy(store: np.ndarray, device="cuda") -> torch.Tensor:
    """An ``(nb, T, T, T)`` or ``(C, nb, T, T, T)`` f32 block store."""
    arr = np.asarray(store)
    ok = arr.ndim in (4, 5) and arr.shape[-1] == arr.shape[-2] == arr.shape[-3]
    if not ok or arr.dtype != np.float32:
        raise ValueError(f"a store is (nb,T,T,T) or (C,nb,T,T,T) float32, "
                         f"got {arr.shape} {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(resolve_device(device))


def store_to_numpy(store: torch.Tensor) -> np.ndarray:
    """A copy of a block store (any device) as a numpy array."""
    if store.ndim not in (4, 5):
        raise ValueError(f"a store is (nb,T,T,T) or (C,nb,T,T,T), "
                         f"got {tuple(store.shape)}")
    return store.detach().cpu().numpy().copy()


def weights_from_numpy(weights: np.ndarray, device="cuda") -> torch.Tensor:
    """(2g+1)³ f32 tap weights."""
    arr = np.asarray(weights)
    s = arr.shape[0] if arr.ndim == 3 else 0
    if arr.shape != (s, s, s) or s % 2 == 0 or arr.dtype != np.float32:
        raise ValueError(f"weights must be (2g+1,)*3 float32, got {arr.shape} {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def _checked_leaves(tree: dict, defs, dtype: np.dtype, what: str) -> dict:
    """``tree``'s leaves as numpy arrays by path, after checking that every
    path, shape and dtype matches the ParamDef tree ``defs``, with no leaf
    missing or left over."""
    want = {path: d for path, d in leaf_paths(defs)}
    got = {path: np.asarray(a) for path, a in leaf_paths(tree)}
    if set(got) != set(want):
        missing = sorted("/".join(p) for p in set(want) - set(got))
        extra = sorted("/".join(p) for p in set(got) - set(want))
        raise ValueError(f"{what} does not match: missing {missing}, "
                         f"unexpected {extra}")
    for path, d in want.items():
        arr = got[path]
        if arr.shape != tuple(d.shape) or arr.dtype != dtype:
            raise ValueError(f"{'/'.join(path)}: want {tuple(d.shape)} {dtype}, "
                             f"got {arr.shape} {arr.dtype}")
    return got


def load_lm_params(model: Model, tree: dict) -> Model:
    """Copy ``tree``, a JAX parameter tree as numpy arrays, into ``model``'s
    parameters (checked as :func:`lm_params_from_numpy` checks it)."""
    got = _checked_leaves(tree, model.defs(), np.dtype(model.cfg.param_dtype),
                          f"parameter tree of {model.cfg.name}")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for path, arr in got.items():
            params[".".join(path)].copy_(torch.from_numpy(arr))
    return model


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    """A :class:`Model` of ``cfg`` on ``device`` holding the weights of
    ``tree``, a JAX parameter tree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``). Every path, shape and dtype
    (``cfg.param_dtype``) must match the port's ParamDef tree, with no leaf
    missing or left over."""
    return load_lm_params(Model(cfg, device=device), tree)


def opt_state_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The AdamW state of ``train.optimizer`` on ``device`` from ``tree``, a
    JAX optimizer state as numpy arrays: ``m`` and ``v`` with the paths
    and shapes of ``cfg``'s parameter tree, each leaf float32, and
    ``step`` an int32 scalar."""
    if not isinstance(tree, dict) or set(tree) != {"m", "v", "step"}:
        raise ValueError("an optimizer state is {'m', 'v', 'step'}, got "
                         f"{sorted(tree) if isinstance(tree, dict) else type(tree)}")
    dev = resolve_device(device)
    defs = model_defs(cfg)
    out = {}
    for name in ("m", "v"):
        got = _checked_leaves(tree[name], defs, np.dtype(np.float32),
                              f"optimizer state {name!r} of {cfg.name}")
        out[name] = unflatten({path: torch.from_numpy(arr.copy()).to(dev)
                                for path, arr in got.items()})
    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: want () int32, got {step.shape} {step.dtype}")
    out["step"] = torch.from_numpy(step.copy()).to(dev)
    return out
