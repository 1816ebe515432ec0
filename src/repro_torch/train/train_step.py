"""The training step: loss → grads → AdamW, with gradient accumulation.

The torch counterpart of ``repro.train.train_step``. ``make_train_step``
builds a ``(params, opt_state, batch) -> (params, opt_state, metrics)``
function over a tree of parameters that require gradients (``Model.
params()`` after ``Model.requires_grad_()``); it writes the parameters and
the state in place and returns them. Microbatching splits the leading
batch axis into ``microbatches`` parts, one backward each, with f32
gradient accumulation (bf16 activations, f32 master weights and optimizer:
mixed precision, as in the JAX package). Each phase of a step runs in a
``torch.profiler.record_function`` range (``loss_and_grads``,
``adamw_update``) so that a profile can attribute the device's time.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.params import leaves as tree_leaves, tree_like
from repro_torch.models.zoo import Model

from .optimizer import OptConfig, adamw_update

__all__ = ["TrainConfig", "make_train_step", "make_eval_step"]


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    remat: bool | str = True  # True | False | "dots"


def make_train_step(model: Model, tcfg: TrainConfig):
    cfg = model.cfg

    def value_and_grad(leaves, params, batch):
        loss, _ = tfm.loss_fn(params, batch, cfg, tcfg.remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        with torch.profiler.record_function("loss_and_grads"):
            n = tcfg.microbatches
            if n > 1:
                micro = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])
                         for k, x in batch.items()}
                gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                        for p in leaves]
                lsum = 0.0
                for i in range(n):
                    loss, g = value_and_grad(leaves, params,
                                             {k: x[i] for k, x in micro.items()})
                    for a, b in zip(gsum, g):
                        a.add_(b.float())
                    lsum = lsum + loss
                grads = [g / n for g in gsum]
                loss = lsum / n
            else:
                loss, grads = value_and_grad(leaves, params, batch)
        with torch.profiler.record_function("adamw_update"):
            new_params, new_state, om = adamw_update(
                params, tree_like(params, grads), opt_state, tcfg.opt)
        return new_params, new_state, {"loss": loss, **om}

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, (ce, aux) = tfm.loss_fn(params, batch, model.cfg, remat=False)
        return {"loss": loss, "ce": ce, "aux": aux}
    return eval_step
