"""Distributed halo exchange with SFC pack/unpack (paper §3.2/§4, on a mesh).

The torch counterpart of ``repro.stencil.halo``. The paper's halo
pattern — pack faces into contiguous buffers via precomputed index
lists, exchange with neighbours, unpack — on a :class:`~repro_torch.
stencil.domain.StencilMesh`: per-axis ring shifts (axis-sequential,
corner-correct) between the shards, which a process holds as a list.

Communication-avoiding form (DESIGN.md §7): each shard keeps its state
as the resident curve-ordered ``(nb, T, T, T)`` block store for the
whole K-step loop — the store *is* path-ordered state under the hybrid
ordering ``layout.store_spec(kind, T)``, so every face packs straight
from storage via ``ops.pack_surface`` (on the card, the ``gather_rows``
kernel). One exchange moves *deep* faces of width ``h = S·g`` and funds
S fused substeps: the received shell scatters into shell blocks appended
after the core store (core/neighbors.extended_neighbor_table addresses
them), and ``stencil_step_fused`` advances S whole timesteps per
device-memory round trip.

Multi-field stores (DESIGN.md §9): a C-channel workload keeps the
stacked ``(C, nb, T, T, T)`` store; every channel packs through the same
index lists into the same six messages.

Physical (clamped) boundaries — DESIGN.md §8: a clamped axis has an open
ring (no wrap pairs, so nothing crosses a domain face), mesh-edge shards
fill their unserved shell slabs with boundary values, and the fused
substeps refresh ghost layers per substep from the shard's mesh-masked
block flags. A per-axis ``MixedBoundary`` opens only its clamped axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.boundary import (PERIODIC, BoundarySpec, MixedBoundary,
                                       as_boundary, axes_periodic)
from repro_torch.core.cache_model import face_mask
from repro_torch.core.layout import _perm_device, device_constant, store_spec
from repro_torch.core.neighbors import (block_kind_of, boundary_face_table,
                                        extended_neighbor_table_device,
                                        ring_perms, shell_block_count)
from repro_torch.core.orderings import OrderingSpec, path_to_rmo, rmo_to_path
from repro_torch.core.surfaces import shell_slab_positions, shell_slab_shapes
from repro_torch.kernels.ops import pack_surface, uniform_weights
from repro_torch.kernels.rules import get_rule
from repro_torch.kernels.stencil3d import stencil_step_fused

from .domain import StencilMesh

__all__ = ["surface_slab_scatter", "exchange_shell", "fill_shells",
           "extended_store", "core_of", "shard_substeps",
           "shard_boundary_flags", "make_distributed_step",
           "stencil_block_kind", "shard_state", "unshard_state",
           "to_store", "from_store"]


@functools.lru_cache(maxsize=256)
def surface_slab_scatter(spec: OrderingSpec, M: int, g: int, face: str) -> np.ndarray:
    """Positions mapping a path-ordered face buffer into its (g,M,M)-like slab.

    ``slab.ravel()[pos[t]] = buf[t]`` reconstructs the face in canonical
    (row-major, face-local) layout. Works for any of the six faces and
    any width ``g`` (the deep exchange passes h = S·g); the slab spans
    the face's two free axes plus the g-width axis, in (k,i,j) order with
    the face axis collapsed to width g.
    """
    q = path_to_rmo(spec, M)
    mask = face_mask(face, M, g)
    # rmo indices of face points, in path order (matches pack order)
    rmo = q[mask[q]]
    M2 = M * M
    k, i, j = rmo // M2, (rmo // M) % M, rmo % M
    ax, side = face[0], face[1]
    if ax == "k":
        kk = k if side == "0" else k - (M - g)
        pos = (kk * M + i) * M + j
    elif ax == "i":
        ii = i if side == "0" else i - (M - g)
        pos = (k * g + ii) * M + j
    else:
        jj = j if side == "0" else j - (M - g)
        pos = (k * M + i) * g + jj
    pos = pos.astype(np.int32)  # int32: M³ < 2³¹ (core.orderings._check_int32)
    pos.setflags(write=False)
    return pos


def stencil_block_kind(spec: OrderingSpec) -> str:
    """Block-grid curve the stencil pipelines use for an element ordering:
    the ordering's own curve when it has one, else Morton (the pipelines
    are SFC-blocked even when the state ordering is row-major)."""
    kind = block_kind_of(spec)
    return kind if kind in ("morton", "hilbert") else "morton"


def _slab_scatter_device(spec: OrderingSpec, M: int, h: int, face: str, device):
    return device_constant(
        ("slabscatter", spec, M, h, face),
        lambda: surface_slab_scatter(spec, M, h, face).astype(np.int64), device)


def _unpack_recv(buf: torch.Tensor, hspec, M: int, h: int, face: str,
                 shape) -> torch.Tensor:
    """Scatter a (C, L) deep-face buffer, in its sender's pack order, into
    the canonical (C, *shape) slab — sender and receiver share the index
    lists. The positions are a permutation of the slab, so every element
    is written once."""
    pos = _slab_scatter_device(hspec, M, h, face, buf.device)
    C = buf.shape[0]
    return buf.new_empty((C, h * M * M)).index_copy_(-1, pos, buf) \
        .view((C,) + tuple(shape))


def _pack_to_slab(store_flat: torch.Tensor, hspec, M: int, h: int, face: str,
                  shape) -> torch.Tensor:
    """Pack one deep face from the (C, nb·T³) store, canonical slab layout."""
    return _unpack_recv(pack_surface(store_flat, hspec, M, h, face), hspec,
                        M, h, face, shape)


def _bc_face_fill(face: torch.Tensor, axis: int, side: str,
                  bc: BoundarySpec) -> torch.Tensor:
    """Boundary values for one shell slab of a clamped domain face.

    ``face`` is the slab the shard *would* send outward on that side (own
    deep face, already carrying any previously filled edge data, with the
    leading channel axis); ``axis`` indexes the spatial axis (0..2) and
    ``bc`` is that axis's own contract. Returns the dirichlet constant,
    or — neumann0 — the outermost in-domain plane of ``face`` replicated
    across the slab's ``h`` width, per channel.
    """
    if bc.kind == "dirichlet":
        return torch.full_like(face, bc.value)
    ax = axis - 3  # spatial axes are the last three (leading C rides along)
    edge = 0 if side == "lo" else face.shape[ax] - 1
    return face.narrow(ax, edge, 1).expand_as(face)


def exchange_shell(mesh: StencilMesh, stores_flat: list[torch.Tensor],
                   kind: str, M: int, T: int, h: int,
                   bc: BoundarySpec | MixedBoundary | str = PERIODIC):
    """Deep (width-h) corner-correct shell exchange from the block stores.

    ``stores_flat`` holds one ravelled curve-ordered block store per shard
    this process holds (``mesh.shards`` order): ``(nb·T³,)``, or the
    stacked ``(C, nb·T³)`` store of a multi-field rule — path-ordered
    state under ``store_spec(kind, T)``, so all six faces pack via the
    paper's precomputed index lists, none from a materialised cube.
    Axis-sequential scheme: the k faces are the bare M² surfaces; the i
    faces carry the k-received edges; the j faces carry both — after
    three ring shifts the six returned slabs of each shard tile the shell
    of its (M+2h)³ extended domain exactly (shapes:
    core/surfaces.shell_slab_shapes; C-stacked input gives slabs with the
    leading channel axis).

    Each shard packs six faces (six ``pack_surface`` calls, one
    ``gather_rows`` launch each on the card), whatever the boundary: a
    mesh-edge shard on a clamped axis fills its unserved slabs from its
    own k faces, unpacked from the buffers it already packed, or from the
    i and j faces it sends. Those fills replace the zeros an open ring
    delivers (dirichlet constant or neumann0 clamp-copy of the shard's
    own outermost plane) before the next axis forwards them, which keeps
    corner regions composed exactly like the padded-cube oracle.

    Per-axis volume is C·2h·M², C·2h·(M+2h)·M, C·2h·(M+2h)² items — the
    ``exchange_items_per_exchange`` model in stencil/pipeline.py.
    """
    bc = as_boundary(bc)
    periodic = axes_periodic(bc)
    ax_bcs = bc.axes
    hspec = store_spec(kind, T)
    squeeze = stores_flat[0].ndim == 1
    flats = [s[None] if squeeze else s for s in stores_flat]
    shp_k = shell_slab_shapes(M, h)[0]
    coords = mesh.shards

    def fill_edges(lo, hi, face_lo, face_hi, axis):
        """On mesh-edge shards, replace received zeros with boundary data;
        ``face_lo(s)``/``face_hi(s)`` give shard s's own outward faces."""
        n = mesh.shape[axis]
        for s, co in enumerate(coords):
            if co[axis] == 0:
                lo[s] = _bc_face_fill(face_lo(s), axis, "lo", ax_bcs[axis])
            if co[axis] == n - 1:
                hi[s] = _bc_face_fill(face_hi(s), axis, "hi", ax_bcs[axis])

    # --- k axis: pack the deep slab faces, ring-shift, unpack
    buf_k0 = [pack_surface(f, hspec, M, h, "k0") for f in flats]
    buf_k1 = [pack_surface(f, hspec, M, h, "k1") for f in flats]
    fwd, bwd = ring_perms(mesh.shape[0], periodic=periodic[0])
    recv_lo = mesh.shift(buf_k1, 0, fwd, tag=0)  # prev's high face
    recv_hi = mesh.shift(buf_k0, 0, bwd, tag=1)  # next's low face
    k_lo = [_unpack_recv(b, hspec, M, h, "k1", shp_k) for b in recv_lo]
    k_hi = [_unpack_recv(b, hspec, M, h, "k0", shp_k) for b in recv_hi]
    if not periodic[0]:
        fill_edges(k_lo, k_hi,
                   lambda s: _unpack_recv(buf_k0[s], hspec, M, h, "k0", shp_k),
                   lambda s: _unpack_recv(buf_k1[s], hspec, M, h, "k1", shp_k),
                   0)

    # --- i axis: core faces + k-received edges (corner-correct)
    face_i0, face_i1 = [], []
    for s, f in enumerate(flats):
        my_i0 = _pack_to_slab(f, hspec, M, h, "i0", (M, h, M))
        my_i1 = _pack_to_slab(f, hspec, M, h, "i1", (M, h, M))
        face_i0.append(torch.cat(
            [k_lo[s][..., :h, :], my_i0, k_hi[s][..., :h, :]], dim=-3))
        face_i1.append(torch.cat(
            [k_lo[s][..., M - h:, :], my_i1, k_hi[s][..., M - h:, :]], dim=-3))
    fwd, bwd = ring_perms(mesh.shape[1], periodic=periodic[1])
    i_lo = mesh.shift(face_i1, 1, fwd, tag=2)
    i_hi = mesh.shift(face_i0, 1, bwd, tag=3)
    if not periodic[1]:
        fill_edges(i_lo, i_hi, face_i0.__getitem__, face_i1.__getitem__, 1)

    # --- j axis: core faces + both received edge sets
    def j_face(s, mine, sl):
        mid = torch.cat([k_lo[s][..., sl], mine, k_hi[s][..., sl]], dim=-3)
        return torch.cat([i_lo[s][..., sl], mid, i_hi[s][..., sl]], dim=-2)

    face_j0, face_j1 = [], []
    for s, f in enumerate(flats):
        face_j0.append(j_face(s, _pack_to_slab(f, hspec, M, h, "j0", (M, M, h)),
                              slice(0, h)))
        face_j1.append(j_face(s, _pack_to_slab(f, hspec, M, h, "j1", (M, M, h)),
                              slice(M - h, M)))
    fwd, bwd = ring_perms(mesh.shape[2], periodic=periodic[2])
    j_lo = mesh.shift(face_j1, 2, fwd, tag=4)
    j_hi = mesh.shift(face_j0, 2, bwd, tag=5)
    if not periodic[2]:
        fill_edges(j_lo, j_hi, face_j0.__getitem__, face_j1.__getitem__, 2)

    out = []
    for s in range(len(flats)):
        slabs = (k_lo[s], k_hi[s], i_lo[s], i_hi[s], j_lo[s], j_hi[s])
        out.append(tuple(x[0] for x in slabs) if squeeze else slabs)
    return out


def _shell_positions_device(nt: int, T: int, h: int, device):
    return device_constant(
        ("shellpos", nt, T, h),
        lambda: shell_slab_positions(nt, T, h).astype(np.int64), device)


def _stacked(store: torch.Tensor) -> torch.Tensor:
    """A (C, nb, T, T, T) view of a plain or stacked store."""
    return store if store.ndim == 5 else store[None]


def core_of(ext: torch.Tensor, nb: int) -> torch.Tensor:
    """The core ``([C,] nb, T, T, T)`` view of an extended store, where
    the shard's state lives; shell blocks follow it."""
    return ext[:nb] if ext.ndim == 4 else ext[:, :nb]


def extended_store(store: torch.Tensor, nt: int) -> torch.Tensor:
    """A new ``([C,] nt³ + shell, T, T, T)`` store: ``store`` as its core,
    zeros in the shell blocks."""
    T = store.shape[-1]
    nsh = shell_block_count(nt)
    lead = store.shape[:-4]
    ext = torch.zeros(lead + (nt ** 3 + nsh, T, T, T), dtype=store.dtype,
                      device=store.device)
    core_of(ext, nt ** 3).copy_(store)
    return ext


def fill_shells(mesh: StencilMesh, exts: list[torch.Tensor], *, kind: str,
                M: int, h: int, bc=PERIODIC) -> None:
    """One deep exchange: pack the six width-h faces from each extended
    store's core, shift them around the mesh, and scatter the received
    shell into the store's shell blocks, in place. Shell elements outside
    the h-deep slabs are not written (the fused kernel never reads
    them)."""
    T = exts[0].shape[-1]
    nt = M // T
    nb = nt ** 3
    views = [_stacked(e) for e in exts]
    C = views[0].shape[0]
    flats = [v[:, :nb].reshape(C, -1) for v in views]
    slabs = exchange_shell(mesh, flats, kind, M, T, h, bc=bc)
    pos = _shell_positions_device(nt, T, h, exts[0].device)
    for v, sl in zip(views, slabs):
        vals = torch.cat([x.reshape(C, -1) for x in sl], dim=1)
        v[:, nb:].view(C, -1).index_copy_(-1, pos, vals)


@functools.lru_cache(maxsize=128)
def _shard_flags(kind: str, nt: int, coords: tuple[int, int, int],
                 procs: tuple[int, int, int]) -> np.ndarray:
    edge = []
    for c, n in zip(coords, procs):
        edge += [c == 0, c == n - 1]
    tab = boundary_face_table(kind, nt) * np.asarray(edge, np.int32)[None, :]
    tab.setflags(write=False)
    return tab


def shard_boundary_flags(kind: str, nt: int, coords: tuple[int, int, int],
                         procs: tuple[int, int, int], device="cuda"):
    """(nb, 6) clamped-domain-face flags for the blocks of the shard at
    mesh ``coords`` of a ``procs`` mesh.

    The base table (core.neighbors.boundary_face_table) marks blocks on
    the *local* grid edge; a face is a physical domain face only when the
    shard also sits on the mesh edge of that axis, so each column pair
    (k∓, i∓, j∓) is AND-masked with the shard's position on mesh axis
    (dx, dy, dz). On mixed contracts the refresh (rules.apply_window_bc)
    skips periodic axes by itself, so the table needs no bc masking.
    """
    kind = block_kind_of(kind)
    coords, procs = tuple(coords), tuple(procs)
    return device_constant(("shardbnd", kind, nt, coords, procs),
                           lambda: _shard_flags(kind, nt, coords, procs), device)


def _round(mesh: StencilMesh, exts: list[torch.Tensor], outs, *, kind: str,
           M: int, g: int, S: int, rule="gol", bc=PERIODIC) -> list[torch.Tensor]:
    """One deep exchange + S fused substeps on every held shard's
    extended store; the new cores go into ``outs`` (None: allocated)."""
    bc = as_boundary(bc)
    dev = exts[0].device
    nt = M // exts[0].shape[-1]
    fill_shells(mesh, exts, kind=kind, M=M, h=S * g, bc=bc)
    nbr = extended_neighbor_table_device(kind, nt, dev)
    w = uniform_weights(g, dev)
    res = []
    for co, ext, out in zip(mesh.shards, exts, outs):
        bnd = shard_boundary_flags(kind, nt, co, mesh.shape, dev) \
            if bc.clamped else None
        res.append(stencil_step_fused(ext, w, nbr, bnd, g=g, S=S, rule=rule,
                                      bc=bc, out=out))
    return res


def shard_substeps(mesh: StencilMesh, stores: list[torch.Tensor], *,
                   kind: str, M: int, g: int, S: int, rule="gol",
                   bc: BoundarySpec | MixedBoundary | str = PERIODIC
                   ) -> list[torch.Tensor]:
    """One deep exchange + S fused substeps on the resident shard stores.

    ``stores`` holds one ``(nb, T, T, T)`` curve-ordered local block store
    per held shard (``mesh.shards`` order), or the stacked multi-field
    ``(C, nb, T, T, T)`` store when the rule declares C > 1. Exchanges
    width S·g once — all C channels in the same six messages — scatters
    the shell into shell blocks appended after the core, and runs S whole
    timesteps through ``stencil_step_fused`` with the extended neighbour
    table: the distributed counterpart of one ResidentPipeline launch. S
    sequential S=1 calls are bit-identical (f32) to one S-deep call.

    On clamped runs the exchange fills mesh-edge shell blocks with
    boundary values instead of ghost data, and the fused substeps refresh
    those ghost layers per substep via the shard's mesh-masked face flags
    (:func:`shard_boundary_flags`). Returns the new stores.
    """
    T = stores[0].shape[-1]
    nt = M // T
    if stores[0].shape[-4] != nt ** 3:
        raise ValueError(f"store {tuple(stores[0].shape)} is not the "
                         f"block store of an M={M} shard")
    exts = [extended_store(st, nt) for st in stores]
    return _round(mesh, exts, [None] * len(exts), kind=kind, M=M, g=g, S=S,
                  rule=rule, bc=bc)


def _store_perm(spec: OrderingSpec, kind: str, T: int, M: int,
                inverse: bool) -> np.ndarray:
    """Permutation between spec-path-ordered state and the block store.

    Forward: ``store_flat = state_path[perm]``; inverse:
    ``state_path = store_flat[perm_inv]``. Applied once per K-step run
    (the layout boundary), never per step.
    """
    hspec = store_spec(kind, T)
    if inverse:
        return rmo_to_path(hspec, M)[path_to_rmo(spec, M)]
    return rmo_to_path(spec, M)[path_to_rmo(hspec, M)]


def _store_perm_device(spec: OrderingSpec, kind: str, T: int, M: int,
                       inverse: bool, device):
    return device_constant(("storeperm", spec, kind, T, M, inverse),
                           lambda: _store_perm(spec, kind, T, M, inverse),
                           device)


def to_store(state: torch.Tensor, spec: OrderingSpec, kind: str, T: int,
             M: int) -> torch.Tensor:
    """A shard's ([C,] M³) spec-path-ordered state -> its ([C,] nb, T³)
    block store (one permutation gather)."""
    perm = _store_perm_device(spec, kind, T, M, False, state.device)
    nb = (M // T) ** 3
    return state.index_select(-1, perm).view(state.shape[:-1] + (nb, T, T, T))


def from_store(store: torch.Tensor, spec: OrderingSpec, kind: str, T: int,
               M: int) -> torch.Tensor:
    """Inverse of :func:`to_store`."""
    iperm = _store_perm_device(spec, kind, T, M, True, store.device)
    return store.reshape(store.shape[:-4] + (-1,)).index_select(-1, iperm)


def make_distributed_step(mesh: StencilMesh, spec: OrderingSpec,
                          local_M: int, g: int, *, T: int | None = None,
                          rule: str = "gol",
                          bc: BoundarySpec | MixedBoundary | str = PERIODIC):
    """Distributed stencil step on a sharded (P·M)³ global state.

    Returns ``step(shards) -> shards``, where ``shards`` holds one
    ``([C,] M³)`` local path-ordered state under ``spec`` per held shard
    (``mesh.shards`` order; see :func:`shard_state`). The per-step
    reference for DistributedPipeline, which runs the same
    :func:`shard_substeps` round at depth S: the state converts to the
    block store and back (one permutation gather each way), all six
    faces pack from the store via the index lists, and the compute is
    the fused S=1 path. Bit-identical to the pipeline at every S (f32).
    """
    if T is None:
        T = min(8, local_M)
    get_rule(rule)
    kind = stencil_block_kind(spec)

    def step(shards: list[torch.Tensor]) -> list[torch.Tensor]:
        stores = [to_store(s, spec, kind, T, local_M) for s in shards]
        stores = shard_substeps(mesh, stores, kind=kind, M=local_M, g=g, S=1,
                                rule=rule, bc=bc)
        return [from_store(s, spec, kind, T, local_M) for s in stores]

    return step


# ----------------------------------------------------------------------
# Global-state layout helpers (tests, demos, Gol3d.run_distributed)
# ----------------------------------------------------------------------

def shard_state(cube: torch.Tensor, spec: OrderingSpec,
                procs: tuple[int, int, int]) -> torch.Tensor:
    """(Gk,Gi,Gj) canonical state -> (px,py,pz,M³) per-shard path state.

    Stacked multi-field input (C,Gk,Gi,Gj) -> (px,py,pz,C,M³): every
    channel shards identically and is path-ordered under ``spec``. The
    global box may be non-cubic (a 4×2×1 mesh decomposes a (4M, 2M, M)
    domain, DESIGN.md §10) — only the *local* shard must be a cubic
    power-of-2 block, because that is what the SFC machinery orders.
    """
    squeeze = cube.ndim == 3
    if squeeze:
        cube = cube[None]
    C = cube.shape[0]
    gk, gi, gj = cube.shape[1:]
    px, py, pz = procs
    if gk % px or gi % py or gj % pz:
        raise ValueError(f"global shape {(gk, gi, gj)} does not divide "
                         f"over procs {procs}")
    lk, li, lj = gk // px, gi // py, gj // pz
    if not (lk == li == lj):
        raise ValueError(f"local block must be cubic, got {(lk, li, lj)} "
                         f"from global {(gk, gi, gj)} over procs {procs}")
    parts = cube.reshape(C, px, lk, py, li, pz, lj) \
        .permute(1, 3, 5, 0, 2, 4, 6)  # (px,py,pz,C,lk,li,lj)
    q = _perm_device(spec, lk, False, cube.device)  # path pos -> rmo
    out = parts.reshape(px, py, pz, C, -1).index_select(-1, q)
    return out[:, :, :, 0] if squeeze else out


def unshard_state(state: torch.Tensor, spec: OrderingSpec,
                  global_M=None) -> torch.Tensor:
    """Inverse of :func:`shard_state` (C-stacked state comes back as
    (C, Gk, Gi, Gj)). ``global_M`` — a cube edge or (Gk,Gi,Gj) triple —
    is optional: the global box follows from the state shape and the
    argument is only checked against it when given."""
    squeeze = state.ndim == 4
    if squeeze:
        state = state[:, :, :, None]
    px, py, pz, C = state.shape[:4]
    n = state.shape[4]
    lk = round(n ** (1 / 3))
    lk = next(m for m in (lk - 1, lk, lk + 1) if m ** 3 == n)
    shape = (px * lk, py * lk, pz * lk)
    if global_M is not None:
        want = (global_M,) * 3 if isinstance(global_M, int) else tuple(global_M)
        if want != shape:
            raise ValueError(f"state {tuple(state.shape)} implies global "
                             f"{shape}, caller said {want}")
    p = _perm_device(spec, lk, True, state.device)  # rmo -> path pos
    parts = state.index_select(-1, p).reshape(px, py, pz, C, lk, lk, lk)
    out = parts.permute(3, 0, 4, 1, 5, 2, 6).reshape(C, *shape)
    return out[0] if squeeze else out
