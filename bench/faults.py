"""Faults planted in the program underneath a run, to show that the
comparison which decides ``correct`` catches them.

Each is a context manager that swaps one function of ``repro_torch`` for
a broken one and puts it back on exit:

- ``stencil_state_unchanged``: every job returns its input state;
- ``stencil_answer_altered``: one site of a job's output is changed;
- ``train_state_unchanged``: a step leaves the weights and AdamW's state
  as they were;
- ``train_state_unchanged_after_setup``: the same, from the first step
  after set-up's three on (a path that sets in after the warm-up);
- ``train_half_batch``: a step's loss and gradients come from the first
  half of its rows, the mean taken over them;
- ``prefill_token_altered``: the served token is the runner-up.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _swapped(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def stencil_state_unchanged():
    from repro_torch.stencil.pipeline import ResidentPipeline

    return _swapped(ResidentPipeline, "run_fn",
                    lambda real: lambda self, n_steps: (lambda store: store.clone()))


def stencil_answer_altered():
    from repro_torch.stencil.pipeline import ResidentPipeline

    def make(real):
        def to_cube(self, store):
            out = real(self, store)
            out.view(-1)[out.numel() // 2] += 1.0
            return out
        return to_cube
    return _swapped(ResidentPipeline, "to_cube", make)


def train_state_unchanged():
    from repro_torch.train import train_step

    def make(real):
        def adamw_update(params, grads, state, cfg):
            return params, state, {"grad_norm": 0.0, "lr": 0.0}
        return adamw_update
    return _swapped(train_step, "adamw_update", make)


def train_state_unchanged_after_setup():
    from repro_torch.train import train_step

    def make(real):
        calls = []

        def adamw_update(params, grads, state, cfg):
            calls.append(1)
            if len(calls) <= 3:
                return real(params, grads, state, cfg)
            return params, state, {"grad_norm": 0.0, "lr": 0.0}
        return adamw_update
    return _swapped(train_step, "adamw_update", make)


def train_half_batch():
    from repro_torch.models import transformer

    def make(real):
        def loss_fn(params, batch, cfg, remat=True):
            n = batch["tokens"].shape[0] // 2
            return real(params, {k: v[:n] for k, v in batch.items()}, cfg, remat)
        return loss_fn
    return _swapped(transformer, "loss_fn", make)


def prefill_token_altered():
    from repro_torch.models import transformer

    def make(real):
        def prefill(params, batch, cfg):
            logits = real(params, batch, cfg)
            top2 = logits.topk(2, dim=-1).indices
            out = logits.clone()
            out.scatter_(-1, top2[..., 1:], logits.max(-1, keepdim=True).values + 1.0)
            return out
        return prefill
    return _swapped(transformer, "prefill", make)


FAULTS = {"stencil_jobs": ("stencil_state_unchanged", "stencil_answer_altered"),
          "train_steps": ("train_state_unchanged", "train_state_unchanged_after_setup",
                         "train_half_batch"),
          "prefill_requests": ("prefill_token_altered",)}
