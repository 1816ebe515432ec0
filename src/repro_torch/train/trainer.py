"""Fault-tolerant training loop: checkpoint/restart, straggler tracking.

The torch counterpart of ``repro.train.trainer``: one process drives one
device (the model's); the loop body is the same as the JAX package's.

Fault-tolerance contract:
- restart-safe: on startup, ``Trainer.run`` restores the newest intact
  checkpoint (atomic dirs ⇒ never a torn one; a corrupt one is skipped)
  and resumes from its step and data cursor. The checkpoint layout is the
  JAX package's (``{"params", "opt_state"}``), so a run of either package
  resumes in the other.
- periodic + final checkpoints, the periodic ones async (copied to the
  host, written in the background).
- straggler mitigation: per-step wall time is tracked; steps slower than
  ``STRAGGLER_FACTOR ×`` the running median are counted and surfaced in
  metrics.

``extra_batch`` (the encdec family's ``frames``, the vlm family's
``patches``: arrays or tensors) is merged into every batch, as in the JAX
package.

A fresh run draws its weights from a ``torch.Generator`` seeded 0 on the
model's device; the JAX package's draw differs, so runs of the two
packages agree only from the same checkpoint.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.interop import load_lm_params, opt_state_from_numpy
from repro_torch.models.zoo import Model

from .optimizer import init_opt_state
from .train_step import TrainConfig, make_train_step

__all__ = ["TrainerConfig", "Trainer"]

STRAGGLER_FACTOR = 3.0  # a step this many times the running median is slow


@dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    log_every: int = 10
    train: TrainConfig = field(default_factory=TrainConfig)


class Trainer:
    def __init__(self, model: Model, pipeline: TokenPipeline,
                 tcfg: TrainerConfig, *, extra_batch=None):
        self.model = model
        self.pipe = pipeline
        self.tcfg = tcfg
        self.extra_batch = {k: torch.as_tensor(v).to(model.device)
                            for k, v in (extra_batch or {}).items()}
        self.step_fn = make_train_step(model, tcfg.train)
        self.metrics_log: list[dict] = []

    def _init_state(self):
        self.model.init(torch.Generator(device=self.model.device).manual_seed(0))
        params = self.model.params()
        return params, init_opt_state(params), 0

    def _restore(self):
        """(params, opt_state, step) of the newest intact checkpoint, the
        parameters copied into the model."""
        tree, meta = ckpt.restore(self.tcfg.ckpt_dir)
        load_lm_params(self.model, tree["params"])
        opt_state = opt_state_from_numpy(tree["opt_state"], self.model.cfg,
                                         self.model.device)
        return self.model.params(), opt_state, int(meta["step"])

    def run(self, resume: bool = True):
        tcfg = self.tcfg
        dev = self.model.device
        self.model.requires_grad_(True)
        if resume and ckpt.latest_step(tcfg.ckpt_dir) is not None:
            params, opt_state, start_step = self._restore()
            print(f"[trainer] resumed from step {start_step}")
        else:
            params, opt_state, start_step = self._init_state()

        times: list[float] = []
        stragglers = 0
        for step in range(start_step, tcfg.total_steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in self.pipe.batch_at(step).items()}
            batch.update(self.extra_batch)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            times.append(dt)
            med = float(np.median(times[-50:]))
            if len(times) > 5 and dt > STRAGGLER_FACTOR * med:
                stragglers += 1
            metrics.update(step=step, step_time=dt, stragglers=stragglers)
            self.metrics_log.append(metrics)
            if step % tcfg.log_every == 0:
                print(f"[trainer] step {step} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f} ms")
            if (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save_async(tcfg.ckpt_dir, step + 1,
                                {"params": params, "opt_state": opt_state},
                                meta={"step": step + 1,
                                      "data_cursor": step + 1})
        ckpt.wait()
        ckpt.save(tcfg.ckpt_dir, tcfg.total_steps,
                  {"params": params, "opt_state": opt_state},
                  meta={"step": tcfg.total_steps,
                        "data_cursor": tcfg.total_steps})
        return params, opt_state, self.metrics_log
