"""Data-ordering specifications and permutation builders (paper §2).

An ordering ``O`` of an ``M×M×M`` cube is a bijection between row-major
indices and *path* positions.  Following the paper:

- ``p(k,i,j)`` — position in the ordering of array location (k,i,j);
  materialised as ``rmo_to_path`` (array of length M³ indexed by row-major
  index).
- ``q(r)``    — row-major index of path position r; materialised as
  ``path_to_rmo`` (the inverse permutation).

Supported orderings:

- ``row_major``           — the baseline.
- ``column_major``        — for completeness (paper compares row/column).
- ``morton`` (level r)    — paper §2.1; ``level=None`` means full depth
                            (2×2×2 blocks, r = m), otherwise Morton between
                            ``2^{m-r}``-cubes, row-major inside (Fig. 2).
- ``hilbert``             — paper §2.2, full depth.
- ``hybrid``              — paper §2.3: ``outer`` ordering between T³ tiles,
                            ``inner`` ordering within each tile.

Permutations are cached (they are pure functions of (spec, M)).

A numpy-only copy of ``repro.core.orderings``: the torch package imports
nothing of the JAX package, and its tests hold the two array-equal.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .hilbert import hilbert_encode, hilbert_encode3
from .morton import morton_encode2, morton_encode3, morton_encode3_level

__all__ = ["OrderingSpec", "ROW_MAJOR", "COLUMN_MAJOR", "MORTON", "HILBERT",
           "rmo_to_path", "path_to_rmo", "path_index_2d", "block_index_3d",
           "ordering_from_name"]


@dataclass(frozen=True)
class OrderingSpec:
    kind: str  # row_major | column_major | morton | hilbert | hybrid
    level: int | None = None  # morton recursion depth r (None = full)
    tile: int | None = None  # hybrid tile edge T
    outer: str | None = None  # hybrid: ordering between tiles
    inner: str | None = None  # hybrid: ordering within tiles

    def __post_init__(self):
        kinds = {"row_major", "column_major", "morton", "hilbert", "hybrid"}
        if self.kind not in kinds:
            raise ValueError(f"unknown ordering kind {self.kind!r}")
        if self.kind == "hybrid":
            if self.tile is None or self.outer is None or self.inner is None:
                raise ValueError("hybrid ordering needs tile, outer, inner")

    @property
    def name(self) -> str:
        if self.kind == "morton" and self.level is not None:
            return f"morton_r{self.level}"
        if self.kind == "hybrid":
            return f"hybrid_{self.outer}_{self.inner}_T{self.tile}"
        return self.kind


ROW_MAJOR = OrderingSpec("row_major")
COLUMN_MAJOR = OrderingSpec("column_major")
MORTON = OrderingSpec("morton")
HILBERT = OrderingSpec("hilbert")


def ordering_from_name(name: str) -> OrderingSpec:
    """Parse a CLI-friendly ordering name."""
    if name in ("row_major", "rm"):
        return ROW_MAJOR
    if name in ("column_major", "cm"):
        return COLUMN_MAJOR
    if name == "morton":
        return MORTON
    if name == "hilbert":
        return HILBERT
    if name.startswith("morton_r"):
        return OrderingSpec("morton", level=int(name[len("morton_r"):]))
    if name.startswith("hybrid_"):
        _, outer, inner, t = name.split("_")
        return OrderingSpec("hybrid", tile=int(t[1:]), outer=outer, inner=inner)
    raise ValueError(f"unknown ordering {name!r}")


def _check_pow2(M: int) -> int:
    m = int(M).bit_length() - 1
    if (1 << m) != M:
        raise ValueError(f"M must be a power of 2, got {M}")
    return m


def _check_int32(n: int) -> None:
    """Permutations are int32 (DESIGN.md §2): half the gather-index traffic
    of int64, and the CUDA kernels read their tables as int32. Fine while
    indices fit."""
    if n >= 2 ** 31:
        raise ValueError(f"index space {n} overflows int32 permutations; "
                         "int32 is required for the gather and kernel tables")


def _flat_index(kind: str, k, i, j, M: int) -> np.ndarray:
    """Path index of each (k,i,j) under a *simple* (non-hybrid) ordering."""
    m = _check_pow2(M)
    k = np.asarray(k, dtype=np.uint64)
    i = np.asarray(i, dtype=np.uint64)
    j = np.asarray(j, dtype=np.uint64)
    if M == 1:  # single-cell grid: every ordering is trivial (and the
        if kind not in ("row_major", "column_major", "morton", "hilbert"):
            raise ValueError(f"unknown simple ordering {kind!r}")
        return k * i * j  # hilbert codec rejects bit-width 0)
    MM = np.uint64(M)
    if kind == "row_major":
        return (k * MM + i) * MM + j
    if kind == "column_major":
        return (j * MM + i) * MM + k
    if kind == "morton":
        return morton_encode3(k, i, j)
    if kind == "hilbert":
        return hilbert_encode3(k, i, j, m)
    raise ValueError(f"unknown simple ordering {kind!r}")


def block_index_3d(kind: str, k, i, j, n: int) -> np.ndarray:
    """Curve index of 3-D grid coordinates under a *simple* ordering.

    The public form of the block-grid path index: serve/roi.py maps the
    block box of an ROI through this to get curve indices over the nt³
    block grid (DESIGN.md §11), the same function the block store's
    permutation is built from — so a range of these indices IS a
    contiguous run of blocks in HBM. ``kind`` is one of
    row_major | column_major | morton | hilbert; ``n`` the grid edge
    (power of 2). Accepts scalars or arrays; returns int64.
    """
    return _flat_index(kind, k, i, j, n).astype(np.int64)


@functools.lru_cache(maxsize=128)
def rmo_to_path(spec: OrderingSpec, M: int) -> np.ndarray:
    """p: row-major index -> path position. int32 array of length M³."""
    m = _check_pow2(M)
    _check_int32(M ** 3)
    if spec.kind == "hybrid":
        p = _hybrid_index(spec, M).astype(np.int32)
        p.setflags(write=False)
        return p
    kk, ii, jj = np.meshgrid(
        np.arange(M, dtype=np.uint64),
        np.arange(M, dtype=np.uint64),
        np.arange(M, dtype=np.uint64),
        indexing="ij",
    )
    kk, ii, jj = kk.ravel(), ii.ravel(), jj.ravel()
    if spec.kind in ("row_major", "column_major", "hilbert"):
        p = _flat_index(spec.kind, kk, ii, jj, M)
    elif spec.kind == "morton":
        r = m if spec.level is None else spec.level
        p = morton_encode3_level(kk, ii, jj, m, r)
    else:  # pragma: no cover
        raise ValueError(spec.kind)
    p = p.astype(np.int32)
    p.setflags(write=False)
    return p


def _grid_index(kind: str, n: int) -> np.ndarray:
    """(n, n, n) path index of every cell of an n³ grid under ``kind``."""
    c = np.arange(n, dtype=np.uint64)
    k, i, j = np.meshgrid(c, c, c, indexing="ij")
    return _flat_index(kind, k.ravel(), i.ravel(), j.ravel(), n).reshape(n, n, n)


def _hybrid_index(spec: OrderingSpec, M: int) -> np.ndarray:
    """p for a hybrid ordering: the ``outer`` index of a cell's T³ tile
    times T³ plus the ``inner`` index within the tile, each computed once
    on its own grid (nt³ tiles, T³ cells) and broadcast over the
    (k-tile, k, i-tile, i, j-tile, j) axes of the row-major cube."""
    T = spec.tile
    if T is None or M % T:
        raise ValueError(f"tile {T} must divide M={M}")
    outer = _grid_index(spec.outer, M // T)
    inner = _grid_index(spec.inner, T)
    p = (outer[:, None, :, None, :, None] * np.uint64(T * T * T)
         + inner[None, :, None, :, None, :])
    return p.reshape(-1)


@functools.lru_cache(maxsize=128)
def path_to_rmo(spec: OrderingSpec, M: int) -> np.ndarray:
    """q: path position -> row-major index (inverse permutation of p)."""
    p = rmo_to_path(spec, M)
    q = np.empty_like(p)
    q[p] = np.arange(p.size, dtype=np.int32)
    q.setflags(write=False)
    return q


@functools.lru_cache(maxsize=64)
def path_index_2d(kind: str, n: int) -> np.ndarray:
    """2D path index grid (n×n, n=2^b) for morton/hilbert/row_major.

    Used by the flash-attention kernel to traverse the (q-block, kv-block)
    grid along a space-filling curve (DESIGN.md §5, applicability level 2).
    Returns an int32 (n*n,) array: sequence of row-major block ids in path
    order.
    """
    b = _check_pow2(n)
    ii, jj = np.meshgrid(np.arange(n, dtype=np.uint64),
                         np.arange(n, dtype=np.uint64), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    if kind == "row_major":
        p = ii * np.uint64(n) + jj
    elif kind == "morton":
        p = morton_encode2(ii, jj)
    elif kind == "hilbert":
        p = hilbert_encode([ii, jj], b)
    else:
        raise ValueError(f"unknown 2D ordering {kind!r}")
    q = np.empty(n * n, dtype=np.int32)
    q[p.astype(np.int64)] = np.arange(n * n, dtype=np.int32)
    q.setflags(write=False)
    return q
