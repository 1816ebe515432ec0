"""Memory-offset histograms and the paper's LRU cache model (Alg. 1).

Reproduces:
- ``h_O(x)`` — accumulated memory offsets over all interior stencils
  (paper §3.1, Figs 5–7).
- ``cacheModel`` — the fully-associative LRU miss counter with cache-line
  size ``b`` (items) and capacity ``c`` (lines), Alg. 1.
- The surface variant (§3.2): the border conditional negated / restricted
  to one of the six faces, modelling pack-buffer reads.

A numpy-only copy of ``repro.core.cache_model``: the torch package
imports nothing of the JAX package, and its tests hold the two
array-equal. :func:`face_mask` selects the faces that the halo exchange
packs (core/surfaces.py).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from .orderings import OrderingSpec, path_to_rmo, rmo_to_path

__all__ = [
    "stencil_offsets",
    "offset_histogram",
    "offset_summary",
    "simulate_lru",
    "cache_misses",
    "surface_cache_misses",
    "OffsetSummary",
    "face_mask",
]


def stencil_offsets(g: int) -> np.ndarray:
    """(2g+1)³ × 3 array of (dk,di,dj) stencil offsets, row-major order."""
    r = np.arange(-g, g + 1)
    dk, di, dj = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([dk.ravel(), di.ravel(), dj.ravel()], axis=1)


def _path_grid(spec: OrderingSpec, M: int) -> np.ndarray:
    """(M,M,M) grid of path positions p(k,i,j)."""
    return rmo_to_path(spec, M).reshape(M, M, M)


def offset_histogram(spec: OrderingSpec, M: int, g: int):
    """h_O(x): counts of path-offset x over all interior stencil accesses.

    Returns (offsets, counts) with offsets sorted ascending. For row-major
    ordering this reproduces the closed form: (2g+1)³ distinct offsets each
    with count (M-2g)³ (paper §3.1 / Fig. 4).
    """
    pos = _path_grid(spec, M)
    interior = pos[g:M - g, g:M - g, g:M - g]
    offs: dict[int, int] = {}
    for dk, di, dj in stencil_offsets(g):
        nb = pos[g + dk:M - g + dk, g + di:M - g + di, g + dj:M - g + dj]
        x = (nb.astype(np.int64) - interior.astype(np.int64)).ravel()
        vals, cnts = np.unique(x, return_counts=True)
        for v, c in zip(vals.tolist(), cnts.tolist()):
            offs[v] = offs.get(v, 0) + c
    keys = np.array(sorted(offs), dtype=np.int64)
    return keys, np.array([offs[k] for k in keys.tolist()], dtype=np.int64)


@dataclass(frozen=True)
class OffsetSummary:
    ordering: str
    M: int
    g: int
    n_distinct: int            # distinct offsets with h_O(x) > 0
    mean_abs: float            # mean |x| weighted by h_O(x)
    p99_abs: float             # 99th percentile of |x|
    frac_within_line: float    # fraction of accesses with |x| < b_ref (64)


def offset_summary(spec: OrderingSpec, M: int, g: int, b_ref: int = 64) -> OffsetSummary:
    keys, cnts = offset_histogram(spec, M, g)
    a = np.abs(keys)
    w = cnts / cnts.sum()
    order = np.argsort(a)
    cw = np.cumsum(w[order])
    p99 = float(a[order][np.searchsorted(cw, 0.99)])
    return OffsetSummary(
        ordering=spec.name, M=M, g=g,
        n_distinct=int(len(keys)),
        mean_abs=float((a * w).sum()),
        p99_abs=p99,
        frac_within_line=float(w[a < b_ref].sum()),
    )


def simulate_lru(lines: np.ndarray, c: int) -> int:
    """Count misses of a fully-associative LRU cache of ``c`` lines.

    ``lines`` is the access sequence of cache-line ids.
    """
    cache: OrderedDict[int, None] = OrderedDict()
    misses = 0
    for ln in lines.tolist():
        if ln in cache:
            cache.move_to_end(ln)
        else:
            misses += 1
            cache[ln] = None
            if len(cache) > c:
                cache.popitem(last=False)
    return misses


def _access_lines(spec: OrderingSpec, M: int, g: int, b: int,
                  centers_rmo: np.ndarray) -> np.ndarray:
    """Cache-line id sequence for stencil sweeps over the given centers.

    ``centers_rmo`` is already in *path* (update) order; for each center the
    (2g+1)³ stencil locations are accessed in row-major offset order
    (Alg. 1 line 6), each mapped to its path address then line id.
    """
    p = rmo_to_path(spec, M)
    M2 = M * M
    k = centers_rmo // M2
    i = (centers_rmo // M) % M
    j = centers_rmo % M
    offs = stencil_offsets(g)
    # (n_centers, n_offsets) neighbour row-major indices
    nk = k[:, None] + offs[None, :, 0]
    ni = i[:, None] + offs[None, :, 1]
    nj = j[:, None] + offs[None, :, 2]
    nrmo = (nk * M + ni) * M + nj
    lines = p[nrmo.ravel()] // b
    return lines


def cache_misses(spec: OrderingSpec, M: int, g: int, b: int, c: int) -> int:
    """Alg. 1: LRU misses for a full interior sweep in path order."""
    q = path_to_rmo(spec, M)
    M2 = M * M
    k = q // M2
    i = (q // M) % M
    j = q % M
    interior = (k >= g) & (k < M - g) & (i >= g) & (i < M - g) & (j >= g) & (j < M - g)
    centers = q[interior]  # visits in path order, border excluded (line 5)
    lines = _access_lines(spec, M, g, b, centers)
    return simulate_lru(lines, c)


_FACES = ("k0", "k1", "i0", "i1", "j0", "j1")


def face_mask(face: str, M: int, g: int) -> np.ndarray:
    """Boolean (M³,) row-major mask of one of the six width-g faces.

    Face naming: ``k0`` = (0:g, :, :) — the paper's slab-row front surface
    pair is (j0,j1) in this notation? No: the paper names surfaces by the
    two axes that span them.  Mapping (paper → here):
      row-column  (rc) spanned by rows+cols   → k0/k1 (front/back slabs)
      column-slab (cs) spanned by cols+slabs  → i0/i1
      slab-row    (sr) spanned by slabs+rows  → j0/j1
    """
    if face not in _FACES:
        raise ValueError(f"face must be one of {_FACES}")
    idx = np.arange(M * M * M, dtype=np.int64)
    M2 = M * M
    k = idx // M2
    i = (idx // M) % M
    j = idx % M
    ax, side = face[0], face[1]
    coord = {"k": k, "i": i, "j": j}[ax]
    return (coord < g) if side == "0" else (coord >= M - g)


def surface_cache_misses(spec: OrderingSpec, M: int, g: int, b: int, c: int,
                         face: str, stencil: bool = False) -> int:
    """§3.2 variant: sweep only the points of one face, in path order.

    With ``stencil=False`` each visit touches just the face point (models
    reading the surface into a pack buffer); with ``stencil=True`` the full
    Alg.-1-negated behaviour (stencil accesses centred on border points).
    """
    q = path_to_rmo(spec, M)
    mask = face_mask(face, M, g)
    centers = q[mask[q]]  # face points in path order
    if stencil:
        # clip stencil to the array (border stencils reach outside otherwise)
        p = rmo_to_path(spec, M)
        M2 = M * M
        k = centers // M2
        i = (centers // M) % M
        j = centers % M
        offs = stencil_offsets(g)
        nk = np.clip(k[:, None] + offs[None, :, 0], 0, M - 1)
        ni = np.clip(i[:, None] + offs[None, :, 1], 0, M - 1)
        nj = np.clip(j[:, None] + offs[None, :, 2], 0, M - 1)
        lines = p[((nk * M + ni) * M + nj).ravel()] // b
    else:
        p = rmo_to_path(spec, M)
        lines = p[centers] // b
    return simulate_lru(lines, c)
