"""Fault-tolerant checkpointed stencil runs (DESIGN.md §10).

The torch counterpart of ``repro.stencil.runner``. :class:`CheckpointedRun`
wraps both stencil pipelines (resident and distributed) in a driver that

- chunks ``n_steps`` into checkpoint intervals and atomically snapshots
  the **canonical** (curve-independent) state through
  ``repro_torch.checkpoint.ckpt`` — per-leaf crc32s verified on restore —
  with a manifest recording ``{step, rule, C, bc, shape, crc, bounds, …}``;
- on ``resume=True`` restores the newest *valid* checkpoint (corrupt or
  partial dirs fall back to the previous one) and re-blockizes onto
  **this** pipeline — which may use a different ordering, block edge T,
  fused depth S or mesh shape than the run that wrote the checkpoint.
  Because every pipeline form is bit-identical (f32) to every other on
  the same rule, a resumed run is bit-identical to the uninterrupted one
  even across such an elastic reshard;
- guards the state at every checkpoint boundary: a NaN/Inf scan plus
  per-rule invariants (gol states are exactly {0,1}; jacobi — a
  box-filter mean — obeys the discrete maximum principle and stays
  inside the initial range). A violation raises a structured
  :class:`RunHealthError` carrying the last good (checkpointed) step
  instead of checkpointing poison.

The canonical state is a C-contiguous f32 numpy array on the host, as in
the JAX package, so ``state_crc32`` hashes the same bytes in both and a
checkpoint written by either resumes in the other. The resume contract:
*physics* must match (rule, channel count C, boundary contract, global
state shape — validated against the manifest); *layout and machine* may
change (ordering/kind, T, S, mesh shape, device).

Fault injection plugs in through :class:`RunHooks` (launch/faults.py
builds these): extra chunk boundaries plus a callback that may kill the
process, raise, or poison the state mid-run.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.boundary import BoundarySpec, MixedBoundary, as_boundary

from .halo import shard_state, unshard_state
from .pipeline import DistributedPipeline, ResidentPipeline

__all__ = ["CheckpointedRun", "RunHealthError", "RunHooks", "RULE_GUARDS",
           "boundary_to_json", "health_check"]


class RunHealthError(RuntimeError):
    """A runtime guard tripped: the state violates its rule's invariants.

    step:           the step at which the violation was detected
    last_good_step: the newest durable checkpoint (resume from here)
    reason:         human-readable description of the violation
    """

    def __init__(self, reason: str, step: int, last_good_step: int):
        super().__init__(
            f"run health check failed at step {step}: {reason} "
            f"(last good checkpoint: step {last_good_step})")
        self.reason = reason
        self.step = step
        self.last_good_step = last_good_step


@dataclass(frozen=True)
class RunHooks:
    """Fault-injection surface of :class:`CheckpointedRun`.

    break_at:    extra steps the runner must treat as chunk boundaries
                 (so a fault can fire at *any* step k, not only at
                 checkpoint intervals)
    on_boundary: called at every break_at boundary with
                 ``(step, canonical_state)``; may raise (simulated
                 crash), call ``os._exit`` (real process death), or
                 return a replacement state (fault injection into the
                 store — the runner re-blockizes it). ``None`` leaves
                 the state untouched.
    """
    break_at: tuple = ()
    on_boundary: "Callable[[int, np.ndarray], Any] | None" = None


def boundary_to_json(bc: "BoundarySpec | MixedBoundary | str"):
    """JSON-able form of a boundary contract, for the run manifest."""
    bc = as_boundary(bc)
    if isinstance(bc, MixedBoundary):
        return {"kind": "mixed",
                "axes": [boundary_to_json(ax) for ax in bc.axes]}
    return {"kind": bc.kind, "value": bc.value}


# -- runtime guards ---------------------------------------------------------

def _guard_gol(a: np.ndarray, bounds) -> str | None:
    bad = ~((a == 0.0) | (a == 1.0))
    if bad.any():
        return (f"gol state must be exactly {{0, 1}}: "
                f"{int(bad.sum())} violating site(s), "
                f"first value {a[np.unravel_index(np.argmax(bad), a.shape)]!r}")
    return None


def _guard_jacobi(a: np.ndarray, bounds) -> str | None:
    if bounds is None:
        return None
    lo, hi = bounds
    eps = 1e-5 * (abs(lo) + abs(hi) + 1.0)  # f32 tap-sum rounding headroom
    if a.min() < lo - eps or a.max() > hi + eps:
        return (f"jacobi state escaped its maximum-principle range "
                f"[{lo}, {hi}]: observed [{a.min()}, {a.max()}]")
    return None


#: rule name -> extra invariant beyond the NaN/Inf scan (None = finite only)
RULE_GUARDS: dict[str, Callable[[np.ndarray, Any], "str | None"]] = {
    "gol": _guard_gol,
    "jacobi": _guard_jacobi,
}


def health_check(rule: str, state: np.ndarray,
                 bounds=None) -> "str | None":
    """Violation description, or None when the state is healthy.

    Every rule gets the NaN/Inf scan; rules in :data:`RULE_GUARDS` add
    their own invariant (``bounds`` is the rule-specific payload the
    manifest carries, e.g. jacobi's initial [min, max]).
    """
    a = np.asarray(state)
    if not np.isfinite(a).all():
        n = int((~np.isfinite(a)).sum())
        return f"non-finite state: {n} NaN/Inf site(s)"
    extra = RULE_GUARDS.get(rule)
    return extra(a, bounds) if extra else None


# -- the driver -------------------------------------------------------------

@dataclass
class CheckpointedRun:
    """Resumable, guarded K-step driver over a stencil pipeline.

    pipeline:  a :class:`ResidentPipeline` or :class:`DistributedPipeline`
               — the *target* configuration; a resumed run may differ
               from the writer in ordering/T/S/mesh shape/device (the
               elastic reshard contract, DESIGN.md §10)
    ckpt_dir:  checkpoint directory (repro_torch.checkpoint.ckpt layout)
    interval:  steps between checkpoints (the final step always
               checkpoints; ``interval`` need not divide ``n_steps`` —
               chunked and unchunked runs are bit-identical because
               S-deep and sequential launches are)
    guards:    run :func:`health_check` at every checkpoint boundary
               (violations raise :class:`RunHealthError` *before* the
               poisoned state can be checkpointed)
    hooks:     fault-injection surface (:class:`RunHooks`)
    keep:      retain only the newest ``keep`` checkpoints (None = all)
    retries:   save-I/O retry budget (ckpt.save retry-with-backoff)
    extra_meta: caller payload stored in every manifest (e.g. the init
               RNG seed), round-tripped under ``meta["extra"]``
    """
    pipeline: "ResidentPipeline | DistributedPipeline"
    ckpt_dir: str
    interval: int = 16
    guards: bool = True
    hooks: "RunHooks | None" = None
    keep: "int | None" = None
    retries: int = 2
    extra_meta: "dict | None" = None
    _runners: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")

    # -- pipeline adaptation ----------------------------------------------
    @property
    def distributed(self) -> bool:
        return isinstance(self.pipeline, DistributedPipeline)

    @property
    def device(self) -> torch.device:
        p = self.pipeline
        return p.mesh.device if self.distributed else p.device

    def expected_shape(self) -> tuple:
        p = self.pipeline
        box = p.global_shape if self.distributed else (p.M,) * 3
        return box if p.channels == 1 else (p.channels,) + tuple(box)

    def _to_internal(self, canonical: np.ndarray):
        """The canonical host state as this pipeline's state on its
        device: the block store, or the held shards' path-ordered states
        (``mesh.shards`` order)."""
        p = self.pipeline
        cube = torch.from_numpy(np.require(canonical, requirements=["C", "W"]))
        cube = cube.to(self.device)
        if self.distributed:
            st = shard_state(cube, p.spec, p.procs)
            return [st[co] for co in p.mesh.shards]
        return p.to_blocks(cube)

    def _to_canonical(self, internal) -> np.ndarray:
        """The pipeline's state as the canonical C-contiguous host array
        (a process-group mesh all-gathers the shards, so every rank holds
        the whole state)."""
        p = self.pipeline
        if self.distributed:
            out = p.mesh.all_gather(internal)
            full = torch.stack(out).view(p.procs + tuple(out[0].shape))
            cube = unshard_state(full, p.spec, p.global_shape)
        else:
            cube = p.to_cube(internal)
        return np.ascontiguousarray(cube.cpu().numpy())

    def _advance(self, internal, k: int):
        if k not in self._runners:
            self._runners[k] = self.pipeline.run_fn(k)
        return self._runners[k](internal)

    # -- manifest ----------------------------------------------------------
    def _meta(self, step: int, canonical: np.ndarray, bounds) -> dict:
        p = self.pipeline
        return {
            "step": step,
            "rule": p.rule,
            "fields": p.channels,
            "bc": boundary_to_json(p.bc),
            "shape": list(canonical.shape),
            "dtype": str(canonical.dtype),
            "state_crc32": ckpt.crc32(canonical),
            "bounds": bounds,
            "interval": self.interval,
            "extra": self.extra_meta or {},
        }

    def _validate_meta(self, meta: dict, exp_shape: tuple) -> None:
        """The resume contract: physics must match, layout may change."""
        p = self.pipeline
        checks = [
            ("rule", meta.get("rule"), p.rule),
            ("fields", meta.get("fields"), p.channels),
            ("bc", meta.get("bc"), boundary_to_json(p.bc)),
            ("shape", tuple(meta.get("shape", ())), tuple(exp_shape)),
        ]
        bad = [f"{k}: checkpoint has {a!r}, pipeline wants {b!r}"
               for k, a, b in checks if a != b]
        if bad:
            raise ValueError(
                "checkpoint is for different physics — resume may change "
                "ordering/T/S/mesh but not rule/C/bc/shape: "
                + "; ".join(bad))

    # -- the run -----------------------------------------------------------
    def run(self, state, n_steps: int, *, resume: bool = True) -> np.ndarray:
        """Advance ``state`` (canonical, curve-independent form: a numpy
        array, or a tensor on any device) by ``n_steps``, checkpointing
        every ``interval`` steps; returns the canonical host array. With
        ``resume=True`` an existing valid checkpoint overrides ``state``
        and the run continues from its step — bit-identical (f32) to the
        uninterrupted run regardless of which pipeline (or package) wrote
        it."""
        if isinstance(state, torch.Tensor):
            state = state.detach().cpu().numpy()
        state = np.ascontiguousarray(state)
        exp_shape = self.expected_shape()
        if state.shape != tuple(exp_shape):
            raise ValueError(f"state shape {state.shape} does not match "
                             f"pipeline ({tuple(exp_shape)})")
        start, bounds, restored = 0, None, False
        if resume:
            try:
                tree, meta = ckpt.restore(self.ckpt_dir)
            except FileNotFoundError:
                pass
            else:
                self._validate_meta(meta, exp_shape)
                state = np.ascontiguousarray(tree["state"])
                start, bounds = int(meta["step"]), meta.get("bounds")
                restored = True
        if start > n_steps:
            raise ValueError(f"checkpoint at step {start} is beyond the "
                             f"requested n_steps={n_steps}")
        if bounds is None:
            bounds = [float(state.min()), float(state.max())]
        if not restored:
            self._checkpoint(start, state, bounds, last_good=start)
        if start == n_steps:
            return state

        breaks = set(self.hooks.break_at) if self.hooks else set()
        bounds_steps = sorted(
            {s for s in range(start + 1, n_steps + 1)
             if s % self.interval == 0 or s == n_steps} |
            {s for s in breaks if start < s <= n_steps})
        internal = self._to_internal(state)
        step, last_good = start, start
        canonical = state
        for stop in bounds_steps:
            internal = self._advance(internal, stop - step)
            step = stop
            fresh = None
            if step in breaks:
                fresh = self._to_canonical(internal)
                repl = self.hooks.on_boundary(step, fresh) \
                    if self.hooks.on_boundary else None
                if repl is not None:  # injected state (e.g. NaN poison)
                    fresh = np.ascontiguousarray(repl)
                    internal = self._to_internal(fresh)
            if step % self.interval == 0 or step == n_steps:
                canonical = self._to_canonical(internal) \
                    if fresh is None else fresh
                self._checkpoint(step, canonical, bounds, last_good)
                last_good = step
            elif fresh is not None:
                canonical = fresh
        return canonical

    def _checkpoint(self, step: int, canonical: np.ndarray, bounds,
                    last_good: int) -> None:
        if self.guards:
            reason = health_check(self.pipeline.rule, canonical, bounds)
            if reason is not None:
                raise RunHealthError(reason, step, last_good)
        ckpt.save(self.ckpt_dir, step, {"state": canonical},
                  meta=self._meta(step, canonical, bounds),
                  retries=self.retries)
        if self.keep is not None:
            for old in ckpt.valid_steps(self.ckpt_dir)[:-self.keep]:
                shutil.rmtree(
                    os.path.join(self.ckpt_dir, f"step_{old:08d}"),
                    ignore_errors=True)
