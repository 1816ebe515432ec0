"""Precomputed SFC block-neighbour tables (DESIGN.md §3).

The torch counterpart of ``repro.core.neighbors``. For the block at path
position ``t`` of the curve-ordered ``(nb, T, T, T)`` store, the tables
give the path positions of its 26 grid neighbours (int32, built once per
``(ordering, nt)`` in numpy) and which of its faces lie on the domain
edge. Column ``(a·9 + b·3 + c)`` of a full table is the neighbour at
offset ``(a-1, b-1, c-1)``, the order in which the CUDA kernels assemble
their windows; column :data:`SELF_COL` (= 13) is the block itself.
"""

from __future__ import annotations

import functools

import numpy as np

from .layout import block_order, device_constant
from .orderings import OrderingSpec

__all__ = [
    "OFFSETS_FULL", "OFFSETS_FACE", "FACE_COLS", "SELF_COL",
    "block_kind_of", "neighbor_table", "neighbor_table_device",
    "boundary_face_table", "boundary_face_table_device",
    "shell_block_count", "shell_block_index", "extended_neighbor_table",
    "extended_neighbor_table_device", "ring_perms",
]

OFFSETS_FULL = tuple((a - 1, b - 1, c - 1)
                     for a in range(3) for b in range(3) for c in range(3))
SELF_COL = OFFSETS_FULL.index((0, 0, 0))  # 13

# face (von-Neumann) neighbours in [k-, k+, i-, i+, j-, j+] order
OFFSETS_FACE = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                (0, 0, -1), (0, 0, 1))
FACE_COLS = tuple(OFFSETS_FULL.index(o) for o in OFFSETS_FACE)


def block_kind_of(spec: OrderingSpec | str) -> str:
    """Block-granularity curve induced by an ordering: the element
    ordering's own kind (Morton and Hilbert are hierarchical), a hybrid
    ordering's ``outer`` curve, or the block-kind string itself."""
    if isinstance(spec, str):
        return spec
    if spec.kind == "hybrid":
        return spec.outer
    return spec.kind


def _periodic_axes(periodic) -> tuple[bool, bool, bool]:
    """A bool applies to all three axes; a 3-sequence gives per-axis wrap
    flags (mixed boundary contracts, DESIGN.md §8)."""
    if isinstance(periodic, bool):
        return (periodic,) * 3
    per = tuple(bool(p) for p in periodic)
    if len(per) != 3:
        raise ValueError(f"periodic must be a bool or 3 flags, got {periodic!r}")
    return per


def neighbor_table(spec: OrderingSpec | str, nt: int, *,
                   connectivity: str = "full",
                   periodic=True) -> np.ndarray:
    """Path-position → neighbour path-positions, int32, read-only.

    connectivity: "full" → (nt³, 27) over OFFSETS_FULL; "face" → (nt³, 6)
                  over OFFSETS_FACE
    periodic:     wrap at the grid boundary, else clamp to the edge block;
                  a per-axis 3-tuple realises mixed contracts.
    """
    return _neighbor_table_cached(spec, nt, connectivity,
                                  _periodic_axes(periodic))


@functools.lru_cache(maxsize=128)
def _neighbor_table_cached(spec: OrderingSpec | str, nt: int,
                           connectivity: str,
                           periodic: tuple[bool, bool, bool]) -> np.ndarray:
    if connectivity not in ("full", "face"):
        raise ValueError(f"unknown connectivity {connectivity!r}")
    full = _full_table(block_kind_of(spec), nt, periodic)
    if connectivity == "face":
        face = full[:, FACE_COLS]
        face.setflags(write=False)
        return face
    return full


@functools.lru_cache(maxsize=128)
def _full_table(kind: str, nt: int,
                periodic: tuple[bool, bool, bool]) -> np.ndarray:
    bo = block_order(kind, nt)  # (nb, 3): path pos -> block coords
    nb = nt ** 3
    lin = bo[:, 0] * nt * nt + bo[:, 1] * nt + bo[:, 2]
    lin_to_path = np.empty(nb, dtype=np.int64)
    lin_to_path[lin] = np.arange(nb)
    offs = np.asarray(OFFSETS_FULL, dtype=np.int64)  # (27, 3)
    co = bo[:, None, :] + offs[None, :, :]           # (nb, 27, 3)
    for ax in range(3):
        if periodic[ax]:
            co[..., ax] %= nt
        else:
            np.clip(co[..., ax], 0, nt - 1, out=co[..., ax])
    tab = lin_to_path[(co[..., 0] * nt + co[..., 1]) * nt + co[..., 2]]
    tab = tab.astype(np.int32)
    tab.setflags(write=False)
    return tab


def neighbor_table_device(spec: OrderingSpec | str, nt: int, *,
                          connectivity: str = "full",
                          periodic=True, device="cuda"):
    """Cached device-resident copy (the fused kernel's index operand)."""
    kind = block_kind_of(spec)
    per = _periodic_axes(periodic)
    return device_constant(
        ("nbrtab", kind, nt, connectivity, per),
        lambda: neighbor_table(kind, nt, connectivity=connectivity,
                               periodic=per), device)


@functools.lru_cache(maxsize=128)
def boundary_face_table(spec: OrderingSpec | str, nt: int) -> np.ndarray:
    """(nb, 6) int32 flags: which faces of each block lie on the domain
    edge, in :data:`OFFSETS_FACE` order ``[k-, k+, i-, i+, j-, j+]`` — the
    faces the fused kernel's ghost refresh masks."""
    bo = block_order(block_kind_of(spec), nt)  # (nb, 3)
    cols = []
    for ax in range(3):
        cols += [bo[:, ax] == 0, bo[:, ax] == nt - 1]
    tab = np.stack(cols, axis=1).astype(np.int32)
    tab.setflags(write=False)
    return tab


def boundary_face_table_device(spec: OrderingSpec | str, nt: int,
                               device="cuda"):
    """Cached device-resident copy of :func:`boundary_face_table`."""
    kind = block_kind_of(spec)
    return device_constant(("bndtab", kind, nt),
                           lambda: boundary_face_table(kind, nt), device)


def shell_block_count(nt: int) -> int:
    """Blocks in the one-block-thick shell around an nt³ core grid."""
    return (nt + 2) ** 3 - nt ** 3


@functools.lru_cache(maxsize=128)
def shell_block_index(nt: int) -> np.ndarray:
    """Extended-grid block coords -> shell enumeration id (core = -1).

    The distributed pipeline (stencil/halo.py) appends the exchanged halo
    as *shell blocks* after the nt³ core store: a block at extended
    coords ``(bk, bi, bj) ∈ [-1, nt]³`` outside the core gets id
    ``shell_block_index(nt)[bk+1, bi+1, bj+1]`` (row-major enumeration of
    the shell), and lives at store row ``nt³ + id``. Core coords map to
    -1 — core rows are addressed by the block curve's own path positions.
    """
    e = nt + 2
    kk, ii, jj = np.meshgrid(*(np.arange(e),) * 3, indexing="ij")
    core = ((kk >= 1) & (kk <= nt) & (ii >= 1) & (ii <= nt)
            & (jj >= 1) & (jj <= nt))
    idx = np.full((e, e, e), -1, dtype=np.int32)
    idx[~core] = np.arange(shell_block_count(nt), dtype=np.int32)
    idx.setflags(write=False)
    return idx


@functools.lru_cache(maxsize=128)
def extended_neighbor_table(spec: OrderingSpec | str, nt: int) -> np.ndarray:
    """(nt³, 27) int32 neighbour table over the core+shell extended store.

    Row ``t`` (the core block the curve visits at path position ``t``)
    holds, per OFFSETS_FULL column, either the path position of a core
    neighbour or ``nt³ + shell_id`` of the shell block that carries the
    exchanged halo in that direction — the neighbour operand of the
    distributed fused step (stencil/halo.py). Column :data:`SELF_COL` is
    ``t`` itself, as in :func:`neighbor_table`.
    """
    kind = block_kind_of(spec)
    bo = block_order(kind, nt)  # (nb, 3): path pos -> block coords
    nb = nt ** 3
    lin = bo[:, 0] * nt * nt + bo[:, 1] * nt + bo[:, 2]
    lin_to_path = np.empty(nb, dtype=np.int64)
    lin_to_path[lin] = np.arange(nb)
    offs = np.asarray(OFFSETS_FULL, dtype=np.int64)  # (27, 3)
    co = bo[:, None, :] + offs[None, :, :]           # (nb, 27, 3)
    inside = ((co >= 0) & (co < nt)).all(axis=-1)
    coc = np.clip(co, 0, nt - 1)
    core_ids = lin_to_path[(coc[..., 0] * nt + coc[..., 1]) * nt + coc[..., 2]]
    shell_ids = shell_block_index(nt)[co[..., 0] + 1, co[..., 1] + 1,
                                      co[..., 2] + 1]
    tab = np.where(inside, core_ids, nb + shell_ids).astype(np.int32)
    tab.setflags(write=False)
    return tab


def extended_neighbor_table_device(spec: OrderingSpec | str, nt: int,
                                   device="cuda"):
    """Cached device-resident copy of :func:`extended_neighbor_table`."""
    kind = block_kind_of(spec)
    return device_constant(("extnbrtab", kind, nt),
                           lambda: extended_neighbor_table(kind, nt), device)


def ring_perms(n: int, periodic: bool = True
               ) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(forward, backward) ``(source, destination)`` pairs for a ring of n
    shards along one mesh axis: shard ``i``'s +axis neighbour is
    ``i+1 mod n``.

    ``periodic=False`` is the clamped-boundary ring: the wrapping pairs
    ``(n-1, 0)`` / ``(0, n-1)`` are absent, so no bytes cross a clamped
    domain face — a shard with no source receives zeros
    (stencil/domain.StencilMesh.shift) and stencil/halo.exchange_shell
    substitutes boundary values there instead.
    """
    if not periodic:
        return ([(i, i + 1) for i in range(n - 1)],
                [(i, i - 1) for i in range(1, n)])
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd
