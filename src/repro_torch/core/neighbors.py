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
