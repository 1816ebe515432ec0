"""gol3d — the paper's stencil application (§4), in torch.

The torch counterpart of ``repro.stencil.gol3d``: Game of Life in 3-D
with stencil radius g, state stored under a selectable ordering. Two
execution modes (DESIGN.md §3):

- per-step *repack* (``run``): each step rebuilds the halo-extended
  block store from the canonical cube (the ``stencil_sum_blocks`` kernel);
- fused *resident* (``run_resident``): blockize once, run K steps on the
  curve-ordered store (``stencil_step_fused``, S timesteps per launch),
  unblockize once. ``substeps=0`` lets ``ResidentPipeline.plan()`` pick
  (T, S).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.boundary import PERIODIC, BoundarySpec, as_boundary
from repro_torch.core.device import resolve_device
from repro_torch.core.layout import apply_ordering, undo_ordering
from repro_torch.core.neighbors import block_kind_of
from repro_torch.core.orderings import ROW_MAJOR, OrderingSpec
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

from .pipeline import ResidentPipeline

__all__ = ["Gol3dConfig", "Gol3d", "stencil_block_kind"]


def stencil_block_kind(spec: OrderingSpec) -> str:
    """Block-grid curve the stencil pipelines use for an element ordering:
    the ordering's own curve when it has one, else Morton (the pipelines
    are SFC-blocked even when the state ordering is row-major)."""
    kind = block_kind_of(spec)
    return kind if kind in ("morton", "hilbert") else "morton"


@dataclass(frozen=True)
class Gol3dConfig:
    """Static configuration of one gol3d run.

    M:        cube edge (power of 2)
    g:        stencil radius — the update reads a (2g+1)³ tap cube
    ordering: storage ordering of the public path state (core.orderings)
    block_T:  SFC block edge of the kernel pipelines (T | M)
    substeps: S fused timesteps per launch; 0 delegates (T, S) to plan()
    density:  initial live fraction of the random seed state
    seed:     RNG seed of the initial state (numpy default_rng)
    bc:       boundary contract (core.boundary)
    device:   where the state lives and the kernels run ("cuda" or "cpu")
    """
    M: int = 64
    g: int = 1
    ordering: OrderingSpec = ROW_MAJOR
    block_T: int = 8
    substeps: int = 1
    density: float = 0.3
    seed: int = 0
    bc: BoundarySpec = PERIODIC
    device: str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "bc", as_boundary(self.bc))


@dataclass
class Gol3d:
    """One gol3d run, on ``cfg.device``."""
    cfg: Gol3dConfig
    device: torch.device = field(init=False)
    state_path: torch.Tensor = field(init=False)  # (M³,) in ordering order

    def __post_init__(self):
        self.device = resolve_device(self.cfg.device)
        rng = np.random.default_rng(self.cfg.seed)
        cube = (rng.random((self.cfg.M,) * 3) < self.cfg.density).astype(np.float32)
        self.state_path = apply_ordering(torch.from_numpy(cube).to(self.device),
                                         self.cfg.ordering)

    @property
    def cube(self) -> torch.Tensor:
        return undo_ordering(self.state_path, self.cfg.ordering, self.cfg.M)

    @property
    def block_kind(self) -> str:
        return stencil_block_kind(self.cfg.ordering)

    def run(self, n_steps: int) -> torch.Tensor:
        """Repack mode: every step rebuilds the halo-extended blocks."""
        cfg, kind = self.cfg, self.block_kind
        s = self.state_path
        for _ in range(n_steps):
            cube = undo_ordering(s, cfg.ordering, cfg.M)
            nxt = ops.gol3d_step(cube, g=cfg.g, T=cfg.block_T, block_kind=kind,
                                 bc=cfg.bc)
            s = apply_ordering(nxt, cfg.ordering)
        self.state_path = s
        return s

    def resident_pipeline(self) -> ResidentPipeline:
        """The fused pipeline over this app's block layout (DESIGN.md §3–§4);
        ``substeps=0`` delegates (T, S) to ``ResidentPipeline.plan``."""
        cfg = self.cfg
        if cfg.substeps == 0:
            return ResidentPipeline.plan(cfg.M, g=cfg.g, kind=self.block_kind,
                                         bc=cfg.bc, device=self.device)
        return ResidentPipeline(M=cfg.M, T=cfg.block_T, g=cfg.g,
                                kind=self.block_kind, S=cfg.substeps,
                                bc=cfg.bc, device=self.device)

    def run_resident(self, n_steps: int) -> torch.Tensor:
        """Fused multi-step run: the curve-ordered block store is the
        state for all n_steps; layout conversions happen once at each
        end. Bit-identical to ``run`` (same block kind, same rule)."""
        cube = self.resident_pipeline().run(self.cube, n_steps)
        self.state_path = apply_ordering(cube, self.cfg.ordering)
        return self.state_path

    def reference_run(self, n_steps: int) -> torch.Tensor:
        """Ordering-independent plain oracle on the canonical cube (same
        bc); returns the cube and leaves the state as it was."""
        cube = self.cube
        for _ in range(n_steps):
            cube = kref.gol3d_step_ref(cube, self.cfg.g, bc=self.cfg.bc)
        return cube
