"""Surface (face) index lists for halo pack/unpack (paper §3.2, §4).

The paper packs each of the six width-``g`` faces of the cube into a
contiguous buffer using *precomputed lists of path indices* (one initial
traversal, memory cost 6gM² integers). This module builds those lists for
any ordering, plus run-length statistics that quantify how contiguous the
pack reads are — the structural quantity behind Figs 11/15: row-major
layouts read the sr faces at stride M² (runs of length 1) while SFC
layouts read every face in runs of whole curve blocks.

A numpy-only copy of ``repro.core.surfaces``: the torch package imports
nothing of the JAX package, and its tests hold the two array-equal.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .cache_model import face_mask
from .orderings import OrderingSpec, rmo_to_path

__all__ = ["FACES", "PAPER_SURFACE_NAMES", "surface_path_indices",
           "run_lengths", "RunStats", "run_stats", "surface_runs",
           "shell_slab_shapes", "shell_slab_positions"]

FACES = ("k0", "k1", "i0", "i1", "j0", "j1")

# paper's surface naming (Figs 11/15): rc = row-column, cs = column-slab,
# sr = slab-row; F/B = front/back.
PAPER_SURFACE_NAMES = {
    "k0": "rcF", "k1": "rcB",
    "i0": "csF", "i1": "csB",
    "j0": "srF", "j1": "srB",
}


@functools.lru_cache(maxsize=256)
def surface_path_indices(spec: OrderingSpec, M: int, g: int, face: str) -> np.ndarray:
    """Path indices (positions in the ordering) of one face, ascending.

    Ascending path order == the order in which the curve visits the face,
    which is the pack order used by the paper (p_t in §3.2). Length gM².
    """
    p = rmo_to_path(spec, M)
    idx = p[face_mask(face, M, g)]
    idx = np.sort(idx)
    idx.setflags(write=False)
    return idx


def run_lengths(sorted_idx: np.ndarray) -> np.ndarray:
    """Lengths of maximal runs of consecutive integers in a sorted array."""
    if sorted_idx.size == 0:
        return np.zeros(0, dtype=np.int64)
    breaks = np.flatnonzero(np.diff(sorted_idx) != 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks + 1, [sorted_idx.size]])
    return (ends - starts).astype(np.int64)


@dataclass(frozen=True)
class RunStats:
    face: str
    paper_name: str
    n_elems: int
    n_runs: int
    mean_run: float
    min_run: int
    max_run: int


def run_stats(spec: OrderingSpec, M: int, g: int, face: str) -> RunStats:
    idx = surface_path_indices(spec, M, g, face)
    rl = run_lengths(idx)
    return RunStats(
        face=face, paper_name=PAPER_SURFACE_NAMES[face],
        n_elems=int(idx.size), n_runs=int(rl.size),
        mean_run=float(rl.mean()) if rl.size else 0.0,
        min_run=int(rl.min()) if rl.size else 0,
        max_run=int(rl.max()) if rl.size else 0,
    )


def shell_slab_shapes(M: int, h: int) -> tuple[tuple[int, int, int], ...]:
    """Canonical shapes of the six exchanged shell slabs, width ``h``.

    Order is (k-lo, k-hi, i-lo, i-hi, j-lo, j-hi) — the axis-sequential
    corner-correct exchange: the k slabs span the bare M² face, the i
    slabs the k-extended face, the j slabs the fully extended face. Their
    union is exactly the shell of the (M+2h)³ extended cube.
    """
    e = M + 2 * h
    return ((h, M, M), (h, M, M), (e, h, M), (e, h, M), (e, e, h), (e, e, h))


@functools.lru_cache(maxsize=128)
def shell_slab_positions(nt: int, T: int, h: int) -> np.ndarray:
    """Scatter positions of the six shell slabs into the shell block store.

    The distributed pipeline holds the exchanged halo as *shell blocks*
    appended after the core store (core/neighbors.shell_block_index):
    ``shell.ravel()[pos] = concat(slab.ravel() for six slabs)`` fills an
    ``(shell_block_count(nt), T, T, T)`` array so that the fused kernel's
    neighbour-slice addressing (the window assembly of the fused kernel,
    kernels/ref.assemble_halo_ref) reads the
    halo exactly where a periodic in-store neighbour would hold it: a
    low-side shell block carries its data in its *last* h-slab, a
    high-side one in its first. Slab order matches
    :func:`shell_slab_shapes`; h ≤ T.
    """
    from .neighbors import shell_block_index

    assert h <= T, (h, T)
    M = nt * T
    sid = shell_block_index(nt)

    def _axis(e):
        # extended-domain coord e ∈ [-h, M+h) -> (block coord, in-block offset)
        blk = np.where(e < 0, -1, np.where(e >= M, nt, e // T))
        off = np.where(e < 0, T + e, np.where(e >= M, e - M, e % T))
        return blk, off

    lo, hi = np.arange(-h, 0), np.arange(M, M + h)
    core, ext = np.arange(M), np.arange(-h, M + h)
    regions = ((lo, core, core), (hi, core, core),
               (ext, lo, core), (ext, hi, core),
               (ext, ext, lo), (ext, ext, hi))
    parts = []
    for kr, ir, jr in regions:
        ek, ei, ej = np.meshgrid(kr, ir, jr, indexing="ij")
        (bk, ok), (bi, oi), (bj, oj) = _axis(ek), _axis(ei), _axis(ej)
        s = sid[bk + 1, bi + 1, bj + 1]
        parts.append((s.astype(np.int64) * T ** 3
                      + (ok * T + oi) * T + oj).ravel())
    pos = np.concatenate(parts).astype(np.int32)
    pos.setflags(write=False)
    return pos


def surface_runs(spec: OrderingSpec, M: int, g: int, face: str):
    """(starts, lengths) of contiguous path-index runs for one face.

    This is the compressed form of the paper's precomputed index lists:
    a pack is then ``concatenate(data[start:start+len] for runs)`` — each
    run is one contiguous stretch of device memory (kernels/sfc_gather.py
    copies whole lines that cover them).
    """
    idx = surface_path_indices(spec, M, g, face)
    rl = run_lengths(idx)
    ends = np.cumsum(rl)
    starts_in_list = ends - rl
    starts = idx[starts_in_list]
    return starts.astype(np.int64), rl
