"""The training step: loss → grads → AdamW, with gradient accumulation.

The torch counterpart of ``repro.train.train_step``. ``make_train_step``
builds a ``(params, opt_state, batch) -> (params, opt_state, metrics)``
function over a tree of parameters that require gradients (``Model.
params()`` after ``Model.requires_grad_()``); it writes the parameters and
the state in place and returns them. Microbatching splits the leading
batch axis into ``microbatches`` parts, one backward each, with f32
gradient accumulation (bf16 activations, f32 master weights and optimizer:
mixed precision, as in the JAX package). Under the profiler the step's
work runs in the spans of ``repro_torch.trace``, so that a trace can
attribute the device's time: the model's (``model.attention``,
``kernels.flash_attention``, ``model.mlp``, ``model.head``, each forward
and backward, and remat's ``model.recompute``) and the optimizer's
``adamw_update``. The backward's ranges open on autograd's own thread,
which launches its kernels; a range around the whole backward would not
claim them.

Over a device mesh (DTensor parameters, ``Model.shard``) the step places
each batch tensor split over the mesh's batch axes (``shard_batch``: the
JAX package's ``_batch_specs``), runs the forward and the backward under
``params.on_mesh``, splits each rank's own rows into the microbatches,
and returns its metrics as plain tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import trace
from repro_torch.launch.dryrun import _batch_specs, sanitize_specs
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import transformer as tfm
from repro_torch.models.params import (leaves as tree_leaves, on_mesh,
                                       placements, tree_like)
from repro_torch.models.zoo import Model

from .optimizer import OptConfig, adamw_update

__all__ = ["TrainConfig", "make_train_step", "make_eval_step", "shard_batch"]


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    remat: bool | str = True  # True | False | "dots"


def shard_batch(batch: dict, mesh) -> dict:
    """Each tensor of ``batch`` (the same on every rank) as a DTensor split
    along dim 0 over ``mesh``'s batch axes where they divide it, else
    replicated; a DTensor stays as it is placed."""
    specs = sanitize_specs(mesh, _batch_specs(batch, batch_axes(mesh)), batch)
    return {k: x if isinstance(x, DTensor)
            else distribute_tensor(x, mesh, placements(specs[k], mesh))
            for k, x in batch.items()}


def _micro(x, n: int, i: int):
    """Microbatch ``i`` of ``n``: rows [i·b/n, (i+1)·b/n) of ``x``'s
    local rows (each rank's own, for a DTensor)."""
    if not isinstance(x, DTensor):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
    loc = x.to_local()
    loc = loc.reshape(n, loc.shape[0] // n, *loc.shape[1:])[i]
    return DTensor.from_local(loc, x.device_mesh, x.placements, run_check=False)


def _plain(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(model: Model, tcfg: TrainConfig):
    cfg = model.cfg

    def value_and_grad(leaves, params, batch):
        with on_mesh(params):
            loss, _ = tfm.loss_fn(params, batch, cfg, tcfg.remat)
            return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if isinstance(leaves[0], DTensor):
            batch = shard_batch(batch, leaves[0].device_mesh)
        n = tcfg.microbatches
        if n > 1:
            gsum = [torch.zeros_like(p, dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
                    for p in leaves]
            lsum = 0.0
            for i in range(n):
                loss, g = value_and_grad(
                    leaves, params, {k: _micro(x, n, i) for k, x in batch.items()})
                for a, b in zip(gsum, g):
                    a.add_(b.float())
                lsum = lsum + loss
            grads = [g / n for g in gsum]
            loss = lsum / n
        else:
            loss, grads = value_and_grad(leaves, params, batch)
        with trace.span("adamw_update"):
            new_params, new_state, om = adamw_update(
                params, tree_like(params, grads), opt_state, tcfg.opt)
        return new_params, new_state, {"loss": _plain(loss), **om}

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, (ce, aux) = tfm.loss_fn(params, batch, model.cfg, remat=False)
        return {"loss": loss, "ce": ce, "aux": aux}
    return eval_step
