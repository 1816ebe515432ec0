"""Fused resident-block-store stencil pipeline (DESIGN.md §3–§4, §9).

The torch counterpart of ``repro.stencil.pipeline.ResidentPipeline``:

    blockize once  →  K timesteps in curve-ordered block form (halo
                      assembled in the kernel from the neighbour tables)
                   →  unblockize once.

The state is one ``(nb, T, T, T)`` store (``(C, nb, T, T, T)`` for
multi-field rules). Launches ping-pong between two preallocated stores
through the kernel's ``out=``, updating them in place; this takes the
place of jit donation. With ``S`` substeps per launch, K timesteps cost
``ceil(K/S)`` launches of ``stencil_step_fused``.

The ``*_items_per_*`` and ``*_bytes_per_step`` helpers are the modelled
device-memory traffic, integer arithmetic equal to the JAX package's.
``plan()`` picks (T, S) under the fused kernel's shared-memory limit
(kernels/stencil3d.fused_smem_bytes).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.boundary import (PERIODIC, BoundarySpec, MixedBoundary,
                                       as_boundary, axes_periodic)
from repro_torch.core.device import resolve_device
from repro_torch.core.layout import (blockize, blockize_fields, unblockize,
                                     unblockize_fields)
from repro_torch.core.neighbors import (boundary_face_table_device,
                                        neighbor_table_device)
from repro_torch.kernels.ops import uniform_weights
from repro_torch.kernels.rules import get_rule
from repro_torch.kernels.stencil3d import (SMEM_LIMIT_BYTES, fused_smem_bytes,
                                           stencil_step_fused)

__all__ = [
    "ResidentPipeline", "SMEM_LIMIT_BYTES", "fused_smem_bytes",
    "repack_items_per_step", "repack_bytes_per_step",
    "fused_items_per_launch", "resident_bytes_per_step",
    "resident_unfused_items_per_step", "resident_unfused_bytes_per_step",
]


@dataclass(frozen=True)
class ResidentPipeline:
    """Stencil updates over a persistent curve-ordered block store.

    M:      cube edge (power of 2)
    T:      block edge (T | M; S·g | T)
    g:      stencil radius
    kind:   block-grid curve — "morton" | "hilbert" | "row_major" |
            "column_major"
    S:      substeps fused into one kernel launch (temporal blocking)
    rule:   update rule registry key (kernels/rules.py); its ``channels``
            (C) selects the plain (nb, T³) or stacked (C, nb, T³) store
    bc:     boundary contract (core.boundary): periodic, dirichlet,
            neumann0 or a per-axis MixedBoundary
    device: where the store lives and the kernels run ("cuda" or "cpu")
    """
    M: int
    T: int = 8
    g: int = 1
    kind: str = "morton"
    S: int = 1
    rule: str = "gol"
    bc: BoundarySpec | MixedBoundary = PERIODIC
    device: torch.device | str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "bc", as_boundary(self.bc))
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.M % self.T:
            raise ValueError(f"block edge T={self.T} does not tile M={self.M}")
        if not self._valid_S(self.S):
            raise ValueError(
                f"temporal blocking needs 1 <= S*g <= T and S*g | T, "
                f"got T={self.T}, g={self.g}, S={self.S}")

    def _valid_S(self, S: int) -> bool:
        h = S * self.g
        return S >= 1 and h <= self.T and self.T % h == 0

    @property
    def nt(self) -> int:
        return self.M // self.T

    @property
    def nb(self) -> int:
        return self.nt ** 3

    @property
    def channels(self) -> int:
        """C of the rule's store — the ×C factor of every byte model."""
        return get_rule(self.rule).channels

    # -- autotuner ---------------------------------------------------------
    @classmethod
    def plan(cls, M: int, g: int = 1, kind: str = "morton",
             rule: str = "gol", n_steps: int = 10, *,
             bc: BoundarySpec | MixedBoundary | str = PERIODIC,
             smem_limit: int = SMEM_LIMIT_BYTES, max_S: int = 8,
             itemsize: int = 4, device="cuda") -> "ResidentPipeline":
        """Pick (T, S) minimising modelled bytes/timestep under the fused
        kernel's shared-memory limit: the JAX package's search, with the
        H100's per-block shared memory in place of the TPU's VMEM."""
        C = get_rule(rule).channels
        T, S = _plan_search(
            M, g, max_S, smem_limit, itemsize,
            lambda T, S: resident_bytes_per_step(M, T, g, n_steps,
                                                 itemsize, S=S, fields=C),
            fields=C)
        return cls(M=M, T=T, g=g, kind=kind, S=S, rule=rule, bc=bc,
                   device=device)

    # -- layout boundary (paid once per K-step run) ------------------------
    def to_blocks(self, cube: torch.Tensor) -> torch.Tensor:
        """Blockize an (M,M,M) cube (C=1) or stacked (C,M,M,M) fields."""
        if cube.ndim == 3:
            return blockize(cube, self.T, kind=self.kind)
        return blockize_fields(cube, self.T, kind=self.kind)

    def to_cube(self, store: torch.Tensor) -> torch.Tensor:
        if store.ndim == 4:
            return unblockize(store, self.M, kind=self.kind)
        return unblockize_fields(store, self.M, kind=self.kind)

    # -- the resident step -------------------------------------------------
    def step_fn(self, substeps: int | None = None):
        """``step(store, out)``: ``substeps`` (default S) fused updates in
        one ``stencil_step_fused`` launch, written into ``out``. Clamped
        runs feed the non-wrapping neighbour table (per axis for mixed
        contracts) and the block boundary flags."""
        S = self.S if substeps is None else substeps
        if not self._valid_S(S):
            raise ValueError(f"S*g must divide T, got T={self.T}, g={self.g}, S={S}")
        g, bc, dev = self.g, self.bc, self.device
        w = uniform_weights(g, dev)
        nbr = neighbor_table_device(self.kind, self.nt,
                                    periodic=axes_periodic(bc), device=dev)
        bnd = boundary_face_table_device(self.kind, self.nt, dev) \
            if bc.clamped else None
        rule = self.rule

        def step(store: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
            return stencil_step_fused(store, w, nbr, bnd, g=g, S=S, rule=rule,
                                      bc=bc, out=out)

        return step

    def run_fn(self, n_steps: int):
        """K-step runner: ceil(K/S) fused launches ping-ponging between the
        given store and one spare; a K % S remainder runs as one smaller
        fused launch when S·g-divisibility allows, else step by step.
        The runner overwrites the store it is given (in place of jit
        donation) and returns the one holding the result."""
        full, rem = divmod(n_steps, self.S)
        step = self.step_fn()
        if rem and self._valid_S(rem):
            tail_steps, tail = 1, self.step_fn(rem)
        else:
            tail_steps, tail = rem, (self.step_fn(1) if rem else None)

        def run(store: torch.Tensor) -> torch.Tensor:
            cur, spare = store, torch.empty_like(store)
            for fn, count in ((step, full), (tail, tail_steps)):
                for _ in range(count):
                    fn(cur, spare)
                    cur, spare = spare, cur
            return cur

        return run

    def run(self, cube: torch.Tensor, n_steps: int) -> torch.Tensor:
        """blockize once → n_steps fused curve-ordered updates → unblockize.
        ``cube`` is (M,M,M) for C=1 rules, stacked (C,M,M,M) otherwise; it
        is not modified."""
        if cube.device.type != self.device.type:
            raise ValueError(f"cube is on {cube.device}, the pipeline on {self.device}")
        store = self.to_blocks(cube)
        return self.to_cube(self.run_fn(n_steps)(store))

    # -- modelled device-memory traffic ------------------------------------
    def bytes_per_step(self, n_steps: int, itemsize: int = 4) -> float:
        return resident_bytes_per_step(self.M, self.T, self.g, n_steps,
                                       itemsize, S=self.S,
                                       fields=self.channels)

    def smem_bytes(self, itemsize: int = 4) -> int:
        return fused_smem_bytes(self.T, self.g, self.S, fields=self.channels,
                                itemsize=itemsize)


def _plan_search(M: int, g: int, max_S: int, smem_limit: int, itemsize: int,
                 cost_fn, fields: int = 1) -> tuple[int, int]:
    """Enumerate valid power-of-two (T, S) whose fused working set fits
    ``smem_limit`` and pick the ``cost_fn(T, S)``-cheapest pair (ties
    toward smaller working sets)."""
    best = None
    T = 1
    while T <= M:
        if M % T == 0 and T % g == 0:
            S = 1
            while S <= max_S:
                h = S * g
                if h <= T and T % h == 0:
                    sm = fused_smem_bytes(T, g, S, fields=fields,
                                          itemsize=itemsize)
                    if sm <= smem_limit:
                        cost = cost_fn(T, S)
                        if best is None or (cost, sm) < best[0]:
                            best = ((cost, sm), T, S)
                S *= 2
        T *= 2
    if best is None:
        raise ValueError(
            f"no (T, S) fits smem_limit={smem_limit} for M={M}, g={g}, "
            f"fields={fields}")
    return best[1], best[2]


# ---------------------------------------------------------------------------
# Device-memory traffic accounting. ``*_items_per_*`` count array elements;
# ``*_bytes_per_step`` scale by itemsize and amortise the one-off layout
# boundary over the run. ``fields`` is the multi-field ×C factor.
# ---------------------------------------------------------------------------

def repack_items_per_step(M: int, T: int, g: int) -> int:
    """Items per step of the repack pipeline (ops.gol3d_step): read the
    cube, write and re-read the halo-duplicated store, write the sums,
    read them with the centre for the rule, write the cube back."""
    nb = (M // T) ** 3
    W3 = (T + 2 * g) ** 3
    cube, halo, out = M ** 3, nb * W3, nb * T ** 3
    return cube + halo + halo + out + 2 * out + out + cube


def repack_bytes_per_step(M: int, T: int, g: int, itemsize: int = 4) -> float:
    return itemsize * float(repack_items_per_step(M, T, g))


def resident_unfused_items_per_step(M: int, T: int, g: int) -> int:
    """Items per step of the unfused resident path: the kernel reads
    (T+2g)³ per block and writes f32 sums; a rule pass reads store + sums
    and writes the next store."""
    nb = (M // T) ** 3
    return nb * (T + 2 * g) ** 3 + 3 * nb * T ** 3


def resident_unfused_bytes_per_step(M: int, T: int, g: int, n_steps: int,
                                    itemsize: int = 4) -> float:
    per_step = resident_unfused_items_per_step(M, T, g)
    return itemsize * (per_step + _boundary_items(M) / max(n_steps, 1))


def fused_items_per_launch(M: int, T: int, g: int, S: int, *,
                           fields: int = 1) -> int:
    """Items of one fused launch: read C·(T+2·S·g)³ + write C·T³ per block."""
    nb = (M // T) ** 3
    return fields * (nb * (T + 2 * S * g) ** 3 + nb * T ** 3)


def resident_bytes_per_step(M: int, T: int, g: int, n_steps: int,
                            itemsize: int = 4, *, S: int = 1,
                            fields: int = 1) -> float:
    """Modelled bytes per timestep of the fused resident pipeline: the
    per-launch stream amortised over S timesteps, plus the one-off
    blockize/unblockize amortised over the K-step run."""
    per_substep = fused_items_per_launch(M, T, g, S, fields=fields) / S
    return itemsize * (per_substep
                       + fields * _boundary_items(M) / max(n_steps, 1))


def _boundary_items(M: int) -> int:
    # blockize + unblockize: read M³ + write M³ each, once per run
    return 4 * M ** 3
