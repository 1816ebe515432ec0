"""Fused resident-block-store stencil pipelines (DESIGN.md §3–§4, §7, §9).

The torch counterparts of ``repro.stencil.pipeline.ResidentPipeline`` and
``DistributedPipeline``. The resident one:

    blockize once  →  K timesteps in curve-ordered block form (halo
                      assembled in the kernel from the neighbour tables)
                   →  unblockize once.

The state is one ``(nb, T, T, T)`` store (``(C, nb, T, T, T)`` for
multi-field rules). Launches ping-pong between two preallocated stores
through the kernel's ``out=``, updating them in place; this takes the
place of jit donation. With ``S`` substeps per launch, K timesteps cost
``ceil(K/S)`` launches of ``stencil_step_fused``.

The distributed one runs the same loop on every shard of a
:class:`~repro_torch.stencil.domain.StencilMesh`, with one deep halo
exchange (stencil/halo.py) per S fused substeps.

The ``*_items_per_*`` and ``*_bytes_per_step`` helpers are the modelled
device-memory and exchange traffic, integer arithmetic equal to the JAX
package's. ``plan()`` picks (T, S) under the fused kernel's shared-memory
limit (kernels/stencil3d.fused_smem_bytes).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch import trace
from repro_torch.core.boundary import (PERIODIC, BoundarySpec, MixedBoundary,
                                       as_boundary, axes_periodic)
from repro_torch.core.device import resolve_device
from repro_torch.core.layout import (blockize, blockize_fields, unblockize,
                                     unblockize_fields)
from repro_torch.core.neighbors import (boundary_face_table_device,
                                        neighbor_table_device,
                                        shell_block_count)
from repro_torch.core.orderings import OrderingSpec
from repro_torch.kernels.ops import uniform_weights
from repro_torch.kernels.rules import get_rule
from repro_torch.kernels.stencil3d import (SMEM_LIMIT_BYTES, fused_smem_bytes,
                                           stencil_step_fused)

from .domain import StencilMesh
from .halo import (_round, core_of, from_store, shard_state,
                   stencil_block_kind, to_store, unshard_state)

__all__ = [
    "ResidentPipeline", "DistributedPipeline", "SMEM_LIMIT_BYTES",
    "fused_smem_bytes",
    "repack_items_per_step", "repack_bytes_per_step",
    "fused_items_per_launch", "resident_bytes_per_step",
    "resident_unfused_items_per_step", "resident_unfused_bytes_per_step",
    "exchange_face_items", "exchange_items_per_exchange",
    "exchange_bytes_per_step", "distributed_bytes_per_step",
    "checkpoint_bytes_per_interval", "checkpoint_traffic_fraction",
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
        is not modified. The curve layout into blocks and back runs in the
        spans ``stencil.blockize`` and ``stencil.unblockize``."""
        if cube.device.type != self.device.type:
            raise ValueError(f"cube is on {cube.device}, the pipeline on {self.device}")
        with trace.span("stencil.blockize"):
            store = self.to_blocks(cube)
        store = self.run_fn(n_steps)(store)
        with trace.span("stencil.unblockize"):
            return self.to_cube(store)

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


def checkpoint_bytes_per_interval(M, *, fields: int = 1,
                                  itemsize: int = 4) -> int:
    """Bytes one checkpoint writes: the canonical (curve-independent)
    C-channel state of an M³ cube — or a non-cubic (Gk,Gi,Gj) box —
    once per interval (stencil/runner.CheckpointedRun, DESIGN.md §10).

    The snapshot is the *logical* state, so its size is ordering-, T-,
    S- and mesh-independent: exactly ``C · ∏(shape) · itemsize`` payload
    bytes (the npz container and manifest add O(KiB), not modelled).
    """
    gk, gi, gj = (M, M, M) if isinstance(M, int) else M
    return fields * gk * gi * gj * itemsize


def checkpoint_traffic_fraction(M: int, T: int, g: int, interval: int, *,
                                S: int = 1, fields: int = 1,
                                itemsize: int = 4) -> float:
    """Modelled fraction of per-interval data movement spent on the
    checkpoint: snapshot bytes (plus the unblockize read that produces
    the canonical state) over snapshot + the interval's fused stream of
    device memory. A byte model only: it counts no host copy, hashing,
    file write or fsync."""
    snap = checkpoint_bytes_per_interval(M, fields=fields, itemsize=itemsize) \
        + fields * M ** 3 * itemsize  # unblockize read of the store
    compute = interval * fused_items_per_launch(M, T, g, S, fields=fields) \
        / S * itemsize
    return snap / (snap + compute)


def exchange_face_items(M: int, g: int, S: int = 1) -> tuple[int, int, int]:
    """Per-axis items of ONE sent face at exchange depth h = S·g (single
    channel — the exchange helpers apply the ×C ``fields`` factor).

    Axis-sequential corner-correct extents (stencil/halo.exchange_shell):
    the k faces are bare h·M² slabs, the i faces carry the k-received
    edges (h·(M+2h)·M), the j faces both (h·(M+2h)²). These are exactly
    the packed slab shapes (core/surfaces.shell_slab_shapes), so the
    model *is* the wire format.
    """
    h = S * g
    e = M + 2 * h
    return (h * M * M, h * e * M, h * e * e)


def exchange_items_per_exchange(M: int, g: int, S: int = 1, *,
                                bc: BoundarySpec | MixedBoundary | str = PERIODIC,
                                procs: tuple[int, int, int] | None = None,
                                coords: tuple[int, int, int] | None = None,
                                fields: int = 1) -> float:
    """Items one shard moves per deep halo exchange (h = S·g).

    Periodic (default): every shard sends both faces on all three axes —
    ``C·2h·[M² + (M+2h)·M + (M+2h)²]`` items (C = ``fields``: every
    channel packs into the same messages, DESIGN.md §9).

    Clamped (``bc`` dirichlet/neumann0, or a per-axis mixed contract):
    clamped-axis rings are open, so a send happens only where a neighbour
    exists — pass the mesh shape ``procs`` and either a shard's mesh
    ``coords`` (that shard's exact items: each clamped axis contributes
    its face size once per existing neighbour) or ``coords=None`` for the
    mesh-wide mean (``2(p-1)/p`` faces per clamped axis). Periodic axes
    of a mixed contract keep the full 2-face volume.
    """
    sizes = exchange_face_items(M, g, S)
    periodic = axes_periodic(bc)
    total = 0.0
    for ax, sz in enumerate(sizes):
        if periodic[ax]:
            total += 2 * sz
            continue
        if procs is None:
            raise ValueError("clamped exchange accounting needs the mesh "
                             "shape (procs=(px, py, pz))")
        p = procs[ax]
        if coords is None:
            total += sz * 2 * (p - 1) / p
        else:
            total += sz * ((coords[ax] > 0) + (coords[ax] < p - 1))
    return fields * total


def exchange_bytes_per_step(M: int, g: int, S: int = 1, itemsize: int = 4, *,
                            bc: BoundarySpec | MixedBoundary | str = PERIODIC,
                            procs: tuple[int, int, int] | None = None,
                            coords: tuple[int, int, int] | None = None,
                            fields: int = 1) -> float:
    """Modelled exchange bytes per *timestep*: one width-S·g exchange
    funds S (keywords as in exchange_items_per_exchange)."""
    items = exchange_items_per_exchange(M, g, S, bc=bc, procs=procs,
                                        coords=coords, fields=fields)
    return itemsize * items / S


def distributed_bytes_per_step(M: int, T: int, g: int, n_steps: int,
                               itemsize: int = 4, *, S: int = 1,
                               bc: BoundarySpec | MixedBoundary | str = PERIODIC,
                               procs: tuple[int, int, int] | None = None,
                               coords: tuple[int, int, int] | None = None,
                               fields: int = 1) -> float:
    """Total modelled data movement per timestep of one mesh shard:
    device memory (fused resident model) + exchange (deep-exchange
    model), both carrying the ×C ``fields`` factor. The memory term is
    boundary-independent; the exchange term shrinks on clamped meshes
    (edge shards skip faces)."""
    return (resident_bytes_per_step(M, T, g, n_steps, itemsize, S=S,
                                    fields=fields)
            + exchange_bytes_per_step(M, g, S, itemsize, bc=bc, procs=procs,
                                      coords=coords, fields=fields))


# ---------------------------------------------------------------------------
# Communication-avoiding distributed pipeline (DESIGN.md §7)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DistributedPipeline:
    """K-step distributed stencil over a mesh of resident block stores.

    Every shard keeps its local state as the curve-ordered
    ``(nb, T, T, T)`` block store — stacked ``(C, nb, T, T, T)`` for a
    multi-field rule — for the whole K-step loop (one permutation gather
    in, one out), packs *deep* width-S·g faces of every channel straight
    from that store via the precomputed index lists, and advances S
    whole timesteps per exchange through the fused kernel
    (halo.fill_shells + stencil_step_fused). Bit-identical (f32) to S
    sequential :func:`~repro_torch.stencil.halo.make_distributed_step`
    steps.

    mesh:  the shards and their transport (domain.make_stencil_mesh);
           its device is where the stores live and the kernels run
    spec:  element ordering of the public sharded state (shard_state)
    M:     local shard edge (power of 2); T: block edge (T | M, S·g | T)
    g:     stencil radius; S: substeps per exchange; rule: rules.py key
           (its ``channels`` selects the C of the store and state layout)
    bc:    boundary contract (core.boundary); clamped axes open their
           exchange rings, and ghost layers refresh per substep
    """
    mesh: StencilMesh = field(compare=False)
    spec: OrderingSpec = field(default=None)  # type: ignore[assignment]
    M: int = 16
    T: int = 8
    g: int = 1
    S: int = 1
    rule: str = "gol"
    bc: BoundarySpec | MixedBoundary = PERIODIC

    def __post_init__(self):
        object.__setattr__(self, "bc", as_boundary(self.bc))
        if self.spec is None:
            raise ValueError("DistributedPipeline needs an OrderingSpec")
        if self.M % self.T:
            raise ValueError(f"block edge T={self.T} does not tile M={self.M}")
        if not self._valid_S(self.S):
            raise ValueError(
                f"distributed temporal blocking needs 1 <= S*g <= T and "
                f"S*g | T, got T={self.T}, g={self.g}, S={self.S}")

    _valid_S = ResidentPipeline._valid_S

    @property
    def kind(self) -> str:
        return stencil_block_kind(self.spec)

    @property
    def channels(self) -> int:
        return get_rule(self.rule).channels

    @property
    def procs(self) -> tuple[int, int, int]:
        return self.mesh.shape

    @property
    def global_shape(self) -> tuple[int, int, int]:
        """Per-axis global extents: the mesh may be non-cubic (4×2×1 …,
        DESIGN.md §10) as long as every *local* shard is a cubic
        power-of-2 block."""
        px, py, pz = self.procs
        return (px * self.M, py * self.M, pz * self.M)

    @property
    def global_M(self) -> int:
        """The global cube edge; a non-cubic mesh has none and raises."""
        px, py, pz = self.procs
        if not px == py == pz:
            raise ValueError(f"global_M needs a cubic mesh, got {self.procs}; "
                             "use global_shape")
        return px * self.M

    # -- autotuner ---------------------------------------------------------
    @classmethod
    def plan(cls, mesh: StencilMesh, spec: OrderingSpec, M: int, g: int = 1,
             rule: str = "gol", n_steps: int = 10, *,
             bc: BoundarySpec | MixedBoundary | str = PERIODIC,
             smem_limit: int = SMEM_LIMIT_BYTES, max_S: int = 8,
             itemsize: int = 4) -> "DistributedPipeline":
        """Pick (T, S) minimising modelled memory **plus exchange**
        bytes/step under the fused kernel's shared-memory limit: the JAX
        package's search, with the H100's per-block shared memory in
        place of the TPU's VMEM. Clamped ``bc`` counts the mesh-wide mean
        exchange surface of this mesh's shape."""
        procs = mesh.shape
        C = get_rule(rule).channels
        T, S = _plan_search(
            M, g, max_S, smem_limit, itemsize,
            lambda T, S: distributed_bytes_per_step(M, T, g, n_steps,
                                                    itemsize, S=S, bc=bc,
                                                    procs=procs, fields=C),
            fields=C)
        return cls(mesh=mesh, spec=spec, M=M, T=T, g=g, S=S, rule=rule, bc=bc)

    # -- the K-step runner -------------------------------------------------
    def run_fn(self, n_steps: int):
        """``run(shards) -> shards``: ceil(K/S) exchange+compute rounds on
        the ``([C,] M³)`` path-ordered states of the held shards
        (``mesh.shards`` order).

        Each shard's store lives in the core of one of two preallocated
        extended stores (core + shell blocks); a round fills the current
        one's shell and the fused kernel writes the next one's core, and
        the two swap. A K % S remainder runs as one shallower round when
        S·g-divisibility allows, else step by step — as
        ResidentPipeline.run_fn.
        """
        full, rem = divmod(n_steps, self.S)
        if rem and not self._valid_S(rem):
            tail_rounds, tail_S = rem, 1
        else:
            tail_rounds, tail_S = (1, rem) if rem else (0, 0)
        mesh, spec, kind, M, T = self.mesh, self.spec, self.kind, self.M, self.T
        nt = M // T
        nb = nt ** 3
        C = self.channels
        shape = ((C,) if C > 1 else ()) + (nb + shell_block_count(nt), T, T, T)
        kw = dict(kind=kind, M=M, g=self.g, rule=self.rule, bc=self.bc)

        def run(shards: list[torch.Tensor]) -> list[torch.Tensor]:
            want = ((C,) if C > 1 else ()) + (M ** 3,)
            if len(shards) != len(mesh.shards) or any(
                    tuple(s.shape) != want for s in shards):
                raise ValueError(f"run needs {len(mesh.shards)} shard states "
                                 f"of shape {want}")
            cur, spare = [], []
            for s in shards:
                ext = torch.zeros(shape, dtype=s.dtype, device=mesh.device)
                core_of(ext, nb).copy_(to_store(s, spec, kind, T, M))
                cur.append(ext)
                spare.append(torch.zeros_like(ext))
            for S, count in ((self.S, full), (tail_S, tail_rounds)):
                for _ in range(count):
                    _round(mesh, cur, [core_of(e, nb) for e in spare], S=S,
                           **kw)
                    cur, spare = spare, cur
            return [from_store(core_of(e, nb), spec, kind, T, M) for e in cur]

        return run

    def run(self, shards: list[torch.Tensor], n_steps: int) -> list[torch.Tensor]:
        """Advance the held shards' ``([C,] M³)`` path-ordered states K
        steps."""
        return self.run_fn(n_steps)(shards)

    def run_cube(self, cube: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Shard a canonical global state — (Gk,Gi,Gj), or stacked
        (C,Gk,Gi,Gj) fields for a multi-field rule — run, and gather it
        back. On a process-group mesh every rank passes the same cube,
        runs its own shard, and all-gathers the shards, so every rank
        returns the global cube."""
        if cube.device.type != self.mesh.device.type:
            raise ValueError(f"cube is on {cube.device}, the mesh on "
                             f"{self.mesh.device}")
        st = shard_state(cube.to(self.mesh.device), self.spec, self.procs)
        held = [st[co] for co in self.mesh.shards]
        out = self.mesh.all_gather(self.run(held, n_steps))
        full = torch.stack(out).view(self.procs + tuple(out[0].shape))
        return unshard_state(full, self.spec, self.global_shape)

    # -- modelled traffic --------------------------------------------------
    def bytes_per_step(self, n_steps: int, itemsize: int = 4,
                       coords: tuple[int, int, int] | None = None) -> float:
        """Memory + exchange bytes per timestep: the mesh-wide mean shard
        by default, or the shard at mesh ``coords``."""
        return distributed_bytes_per_step(self.M, self.T, self.g, n_steps,
                                          itemsize, S=self.S, bc=self.bc,
                                          procs=self.procs, coords=coords,
                                          fields=self.channels)

    def exchange_bytes_per_step(self, itemsize: int = 4,
                                coords: tuple[int, int, int] | None = None
                                ) -> float:
        return exchange_bytes_per_step(self.M, self.g, self.S, itemsize,
                                       bc=self.bc, procs=self.procs,
                                       coords=coords, fields=self.channels)

    def smem_bytes(self, itemsize: int = 4) -> int:
        return fused_smem_bytes(self.T, self.g, self.S, fields=self.channels,
                                itemsize=itemsize)
