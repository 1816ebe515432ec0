"""AdamW + global-norm clip + warmup-cosine schedule.

The torch counterpart of ``repro.train.optimizer``. The optimizer state
mirrors the parameter tree leaf for leaf: f32 ``m`` and ``v`` and an int32
``step``, the layout of the JAX package's, so that a checkpoint of either
package resumes in the other. The schedule and the bias corrections are
computed as f32 tensors, as the JAX package computes them (Python doubles
would differ in the last bits), and the update writes the parameters and
the state in place (the JAX package returns new trees).

Over a device mesh (DTensor parameters, ``Model.shard``) ``m`` and ``v``
are DTensors with their parameter's placements: ZeRO-1, the optimizer
state living wherever the parameter's shard lives (12 bytes a parameter
spread over the mesh). Each gradient is first brought to its parameter's
placements, the global norm sums every rank's squares once (one
reduction for the whole tree, not one a leaf), and ``step`` stays a
plain, replicated scalar.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.params import leaves, on_mesh, tree_map

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_at",
           "global_norm"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as an f32 0-d tensor."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, step.device) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: dict) -> dict:
    """Zero f32 ``m`` and ``v`` shaped and placed like ``params`` (DTensors
    with their parameter's placements on a mesh), and ``step`` 0 (int32)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                       memory_format=torch.contiguous_format)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _local_squares(g: DTensor) -> torch.Tensor:
    """This rank's share of the sum of squares of DTensor ``g`` (no
    partial placements): its shard's sum, divided by the ranks that hold
    the same shard (the mesh dims ``g`` is replicated on)."""
    copies = 1
    for i, pl in enumerate(g.placements):
        if isinstance(pl, Replicate):
            copies *= g.device_mesh.size(i)
    return torch.sum(g.to_local().float() ** 2) / copies


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (of a tree, or a list of
    leaves), in f32. Over DTensor leaves (one mesh, none partial) every
    rank sums its own squares and one reduction over the mesh adds them;
    the result is a plain tensor."""
    ls = tree if isinstance(tree, list) else leaves(tree)
    sharded = [g for g in ls if isinstance(g, DTensor)]
    if not sharded:
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in ls))
    if len(sharded) != len(ls):
        raise ValueError("global_norm: a tree of DTensors and plain tensors")
    mesh = sharded[0].device_mesh
    total = sum(_local_squares(g) for g in ls)
    return torch.sqrt(DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                         run_check=False).full_tensor())


def _like_param(g, p):
    """Gradient ``g`` with parameter ``p``'s placements (a plain ``g`` as
    it is)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """One AdamW step with the gradients clipped to ``cfg.clip_norm`` by
    their global norm. Writes ``params`` and ``state`` in place and
    returns ``(params, state, {"grad_norm", "lr"})``. Every leaf with
    ``ndim >= 2`` is decayed (the JAX package's rule: the stacked (L, D)
    norms are decayed too)."""
    grads = [_like_param(g, p) for g, p in zip(leaves(grads), leaves(params))]
    with on_mesh(params):
        return _adamw(params, grads, state, cfg)


def _adamw(params, grads, state, cfg: OptConfig):
    step = state["step"]
    gn = global_norm(grads)
    # a quotient (scalar / tensor would multiply by the reciprocal)
    scale = torch.clamp(torch.div(_f32(cfg.clip_norm, gn.device), gn + 1e-9),
                        max=1.0)
    lr = lr_at(step, cfg)
    t = (step + 1).float()
    bc1 = 1 - _f32(cfg.b1, t.device) ** t
    bc2 = 1 - _f32(cfg.b2, t.device) ** t
    for p, g, m, v in zip(leaves(params), grads, leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:  # decay matrices only (norms/scalars exempt)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step + 1
    return params, state, {"grad_norm": gn, "lr": lr}
