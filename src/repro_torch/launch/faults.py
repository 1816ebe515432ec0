"""Fault-injection harness for the checkpointed stencil pipelines.

The torch counterpart of the stencil half of ``repro.launch.faults``.
Three fault families:

- **Process death**: :class:`FaultPlan` builds the
  :class:`repro_torch.stencil.runner.RunHooks` that kill the run at an
  exact step — either an in-process :class:`SimulatedCrash` (fast, for
  tests) or a hard ``os._exit(KILL_EXIT)`` (a real dead process, for the
  subprocess matrix). The kill fires *before* that step's checkpoint is
  written, so resume restarts from the previous interval.
- **Storage corruption**: helpers that truncate a chunk file, flip one
  bit in it, delete the manifest, or plant a dangling ``.tmp_step_*``
  dir — exercising ckpt.py's crc32 verification, quarantine, and
  newest-valid fallback.
- **State poison**: NaN/Inf (or any value) written into the running
  state at a step boundary — exercising the runner's health guards
  (RunHealthError instead of a poisoned checkpoint).

CLI (the subprocess kill/corrupt/resume matrix), on the card unless
``--device cpu``::

    python -m repro_torch.launch.faults --M 256 --T 8 --S 4 --steps 16 \\
        --interval 4 --kill-at 6 --ckpt-dir /path/ft   # dies with exit 17
    python -m repro_torch.launch.faults ... (same, no --kill-at)
                                                      # resumes

A run that completes prints ``FAULTS_DONE step=<n> crc=<crc32>`` — the
crc of the canonical final state, so a resumed run can be asserted
bit-identical to an uninterrupted one across processes (and across
ordering/T/S/mesh changes, and packages, between the two invocations) —
and then ``FAULTS_LAUNCHES`` with the kernel launches of the run as JSON.
``--mesh px,py,pz`` runs a DistributedPipeline on a local mesh of that
shape (every shard in this process); ``--M`` is then the local edge.
The serving half, :class:`ServeFaultPlan`, injects the ROI-query
service's storage faults (serve/service.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import crc32
from repro_torch.stencil.runner import RunHooks

__all__ = ["FaultPlan", "KILL_EXIT", "ServeFaultPlan", "SimulatedCrash",
           "bitflip_chunk", "drop_manifest", "initial_state",
           "make_dangling_tmp", "state_crc", "truncate_chunk", "wipe"]

KILL_EXIT = 17  # distinguishable from python tracebacks (1) and signals


class SimulatedCrash(RuntimeError):
    """In-process stand-in for a killed worker: aborts the run after the
    fault point with no cleanup, leaving whatever checkpoints exist."""


@dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule compiled to :class:`RunHooks`.

    kill_at_step:  die when the run reaches this step (before its
                   checkpoint is written)
    kill_mode:     "raise" (SimulatedCrash) | "exit" (os._exit(17) — a
                   real process death, nothing is flushed)
    poison_at_step: overwrite one site of the state at this step
    poison_value:  the injected value (default NaN)
    poison_site:   flat index of the poisoned site
    """
    kill_at_step: "int | None" = None
    kill_mode: str = "raise"
    poison_at_step: "int | None" = None
    poison_value: float = float("nan")
    poison_site: int = 0

    def break_steps(self) -> tuple:
        return tuple(s for s in (self.kill_at_step, self.poison_at_step)
                     if s is not None)

    def hooks(self) -> RunHooks:
        def on_boundary(step, canonical):
            if step == self.poison_at_step:
                out = np.array(canonical)
                out.reshape(-1)[self.poison_site] = self.poison_value
                return out
            if step == self.kill_at_step:
                if self.kill_mode == "exit":
                    os._exit(KILL_EXIT)
                raise SimulatedCrash(f"injected kill at step {step}")
            return None

        return RunHooks(break_at=self.break_steps(),
                        on_boundary=on_boundary)


# -- storage-corruption injectors (operate on finished checkpoints) ---------

def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _chunk_files(ckpt_dir: str, step: int) -> list:
    files = sorted(glob.glob(os.path.join(_step_dir(ckpt_dir, step),
                                          "arrays_*.npz")))
    if not files:
        raise FileNotFoundError(
            f"no chunk files under {_step_dir(ckpt_dir, step)}")
    return files


def truncate_chunk(ckpt_dir: str, step: int, keep_bytes: int = 8) -> str:
    """Tear a chunk file down to ``keep_bytes`` — a partial write that
    survived a crash. Restore must refuse it (unreadable npz)."""
    path = _chunk_files(ckpt_dir, step)[0]
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
    return path


def bitflip_chunk(ckpt_dir: str, step: int, offset: "int | None" = None) -> str:
    """Flip one bit mid-file — silent media corruption. The npz may still
    parse; the per-leaf crc32 must catch it."""
    path = _chunk_files(ckpt_dir, step)[0]
    size = os.path.getsize(path)
    if offset is None:
        offset = size * 3 // 4  # inside the payload, past the zip header
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x10]))
    return path


def drop_manifest(ckpt_dir: str, step: int) -> str:
    """Delete a checkpoint's manifest — the dir must stop counting as a
    valid candidate (latest_step skips it)."""
    path = os.path.join(_step_dir(ckpt_dir, step), "manifest.json")
    os.remove(path)
    return path


def make_dangling_tmp(ckpt_dir: str, step: int) -> str:
    """Plant a half-written ``.tmp_step_*`` dir (writer died pre-rename).
    Scans must ignore it entirely."""
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "arrays_00.npz"), "wb") as f:
        f.write(b"partial")
    return tmp


def wipe(ckpt_dir: str) -> None:
    shutil.rmtree(ckpt_dir, ignore_errors=True)


# -- serving fault matrix (serve/service.StencilQueryService) ---------------

@dataclass
class ServeFaultPlan:
    """Declarative fault schedule for the ROI-query service — wraps the
    service's ``fetch`` callable so every storage pathology of the
    serving matrix is injectable per fetch call:

    fail_first:    first N fetch calls raise FetchError (transient
                   storage failure; the service's bounded retry must
                   absorb N <= max_retries, degrade beyond)
    slow_first:    first N fetch calls advance the service clock (or
                   really sleep) by ``slow_s`` before returning — the
                   slow-storage / deadline-pressure fault
    bitflip_first: the N fetch calls after the failed ones return a
                   payload with one bit flipped (byte ``size // 3``,
                   ``^ 0x20``, as the JAX package flips it) — silent media
                   corruption the manifest crc must catch

    Counters are mutable on purpose: one plan instance injects a finite
    burst and then behaves — the recovery path is the object under test.
    ``calls`` records every fetch the wrapped callable saw.
    """
    fail_first: int = 0
    slow_first: int = 0
    slow_s: float = 0.0
    bitflip_first: int = 0
    calls: int = 0

    def wrap_fetch(self, fetch, *, sleep=None):
        """``fetch(start, stop)`` with this plan's faults layered on.
        ``sleep`` (default time.sleep) is injectable so tests can drive
        a fake clock instead of waiting. The wrapped fetch returns a CPU
        tensor (a copy, never the store's own bytes)."""
        from repro_torch.serve.roi import as_host
        from repro_torch.serve.service import FetchError

        do_sleep = time.sleep if sleep is None else sleep

        def faulty(start, stop):
            self.calls += 1
            n = self.calls
            if n <= self.slow_first and self.slow_s > 0:
                do_sleep(self.slow_s)
            if n <= self.fail_first:
                raise FetchError(f"injected fetch failure #{n} "
                                 f"on range [{start}, {stop})")
            data = as_host(fetch(start, stop)).clone()
            if n <= self.fail_first + self.bitflip_first:
                raw = data.reshape(-1).view(torch.uint8)
                raw[raw.numel() // 3] ^= 0x20
            return data

        return faulty


# -- deterministic initial states (shared by CLI runs and tests) ------------

def initial_state(rule: str, shape, seed: int = 0) -> np.ndarray:
    """Deterministic rule-appropriate initial state for a global box
    ``shape`` (int or (Gk,Gi,Gj)); multi-field rules get (C, *shape).
    The JAX package's numbers: the same ``np.random.default_rng`` draws."""
    from repro_torch.kernels.rules import get_rule

    if isinstance(shape, int):
        shape = (shape,) * 3
    C = get_rule(rule).channels
    full = tuple(shape) if C == 1 else (C,) + tuple(shape)
    r = np.random.default_rng(seed)
    if rule == "gol":
        return (r.random(full) < 0.35).astype(np.float32)
    return r.standard_normal(full).astype(np.float32)


def state_crc(state: np.ndarray) -> int:
    """crc32 of the state's bytes in C order (the manifest's state_crc32)."""
    return crc32(state)


# -- CLI driver -------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--mesh", default="",
                    help="px,py,pz for a DistributedPipeline on a local mesh; "
                         "empty = ResidentPipeline")
    ap.add_argument("--ordering", default="hilbert")
    ap.add_argument("--rule", default="gol")
    ap.add_argument("--M", type=int, default=8,
                    help="local (per-shard) / resident cube edge")
    ap.add_argument("--T", type=int, default=8)
    ap.add_argument("--S", type=int, default=1)
    ap.add_argument("--bc", default="periodic")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--kill-mode", default="exit", choices=["exit", "raise"])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(a) -> None:
    from repro_torch.core.device import resolve_device
    from repro_torch.core.orderings import ordering_from_name
    from repro_torch.kernels import _build
    from repro_torch.stencil import (CheckpointedRun, DistributedPipeline,
                                     ResidentPipeline, make_stencil_mesh)

    dev = resolve_device(a.device)
    plan = FaultPlan(kill_at_step=a.kill_at, kill_mode=a.kill_mode)
    if a.mesh:
        procs = tuple(int(x) for x in a.mesh.split(","))
        pipe = DistributedPipeline(
            mesh=make_stencil_mesh(procs, device=dev),
            spec=ordering_from_name(a.ordering), M=a.M, T=a.T, S=a.S,
            rule=a.rule, bc=a.bc)
        shape = pipe.global_shape
    else:
        pipe = ResidentPipeline(M=a.M, T=a.T, S=a.S, rule=a.rule, bc=a.bc,
                                kind=a.ordering, device=dev)
        shape = (a.M,) * 3
    run = CheckpointedRun(pipe, a.ckpt_dir, interval=a.interval,
                          hooks=plan.hooks() if a.kill_at is not None else None,
                          extra_meta={"seed": a.seed})
    state0 = initial_state(a.rule, shape, seed=a.seed)
    _build.reset_launches()
    final = run.run(state0, a.steps)
    print(f"FAULTS_DONE step={a.steps} crc={state_crc(final):#010x}")
    print(f"FAULTS_LAUNCHES {json.dumps(_build.LAUNCHES)}", flush=True)


if __name__ == "__main__":
    main(build_parser().parse_args())
