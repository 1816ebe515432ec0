"""ROI → contiguous curve-range decomposition over the block store.

The torch counterpart of ``repro.serve.roi``. An axis-aligned region of
interest (ROI) over the curve-ordered ``(C, nb, T³)`` block store
decomposes into a handful of **contiguous** curve-index ranges, so a
bounding-box query is a few sequential reads instead of nb scattered
ones. Curves that preserve 3-D locality need fewer ranges: an aligned
power-of-two block cube is exactly *one* Hilbert/Morton range (a complete
octree subtree is a contiguous index interval for any bit-hierarchical
curve) where row-major needs one range per (bk, bi) line.

Pieces:

- :class:`ROI` — a half-open axis-aligned element box ``[lo, hi)``.
- :class:`StoreLayout` — the (M, T, kind, C) identity of a block store
  (``StoreLayout.from_pipeline`` lifts it off a ResidentPipeline).
- :func:`roi_to_ranges` — minimal sorted disjoint ``(start, stop)``
  curve-index ranges covering every block the ROI intersects.
- :func:`extract_roi` — decode *only* those blocks into a dense
  ``(C,) + roi.shape`` tensor, bit-identical to slicing the unblockized
  cube.
- :func:`roi_model` — blocks-touched / bytes-read / range-count
  accounting, equal as integers to the JAX package's.

The range math is host-side numpy, as in the reference. The store is a
CPU tensor in its own dtype (f32, bf16, f16 or fp8: the stores the
port's kernels write), or a numpy array; a CUDA store is copied to the
host once. The serving path reads a snapshot of the store; it launches
no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.layout import block_order
from repro_torch.core.orderings import block_index_3d

__all__ = ["ROI", "StoreLayout", "roi_to_ranges", "ranges_to_blocks",
           "merge_blocks_to_ranges", "extract_roi", "roi_model"]


@dataclass(frozen=True)
class ROI:
    """Half-open axis-aligned element box ``[lo, hi)`` in cube coords."""
    lo: tuple[int, int, int]
    hi: tuple[int, int, int]

    def __post_init__(self):
        lo = tuple(int(v) for v in self.lo)
        hi = tuple(int(v) for v in self.hi)
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)
        if len(lo) != 3 or len(hi) != 3:
            raise ValueError(f"ROI needs 3-D lo/hi, got {lo}, {hi}")
        if any(l < 0 or l >= h for l, h in zip(lo, hi)):
            raise ValueError(f"empty or negative ROI [{lo}, {hi})")

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    def items(self) -> int:
        s = self.shape
        return s[0] * s[1] * s[2]

    def clipped(self, M: int) -> "ROI":
        if any(h > M for h in self.hi):
            raise ValueError(f"ROI {self.lo}..{self.hi} exceeds cube edge {M}")
        return self


@dataclass(frozen=True)
class StoreLayout:
    """Identity of a curve-ordered block store: cube edge M, block edge
    T (T | M), block-grid curve ``kind``, channel count C."""
    M: int
    T: int
    kind: str = "morton"
    channels: int = 1

    def __post_init__(self):
        if self.M % self.T or self.M < self.T:
            raise ValueError(f"block edge T={self.T} does not tile "
                             f"cube edge M={self.M}")
        if self.channels < 1:
            raise ValueError(f"channels must be >= 1, got {self.channels}")

    @classmethod
    def from_pipeline(cls, pipeline) -> "StoreLayout":
        """Lift the layout off a ResidentPipeline (or anything with
        M/T/kind/channels)."""
        return cls(M=pipeline.M, T=pipeline.T, kind=pipeline.kind,
                   channels=pipeline.channels)

    @property
    def nt(self) -> int:
        return self.M // self.T

    @property
    def nb(self) -> int:
        return self.nt ** 3

    def block_bytes(self, itemsize: int = 4) -> int:
        """Payload bytes of one block across all channels — the unit of
        both the cache and the bytes-read model."""
        return self.channels * self.T ** 3 * itemsize

    def block_box(self, roi: ROI) -> tuple[tuple, tuple]:
        """Half-open block-coordinate box the ROI intersects."""
        roi.clipped(self.M)
        lo = tuple(l // self.T for l in roi.lo)
        hi = tuple((h + self.T - 1) // self.T for h in roi.hi)
        return lo, hi


def merge_blocks_to_ranges(indices) -> list[tuple[int, int]]:
    """Sorted unique curve indices → minimal disjoint ``(start, stop)``
    half-open ranges (consecutive indices merge)."""
    idx = np.unique(np.asarray(indices, dtype=np.int64))
    if idx.size == 0:
        return []
    breaks = np.nonzero(np.diff(idx) != 1)[0]
    starts = np.concatenate(([0], breaks + 1))
    stops = np.concatenate((breaks, [idx.size - 1]))
    return [(int(idx[a]), int(idx[b]) + 1) for a, b in zip(starts, stops)]


def roi_to_ranges(layout: StoreLayout, roi: ROI) -> list[tuple[int, int]]:
    """Minimal sorted disjoint contiguous curve-index ranges covering
    every block the ROI intersects: their union is exactly the set of
    curve indices of blocks whose T³ extent meets ``roi``, and no two
    returned ranges are adjacent."""
    (bk0, bi0, bj0), (bk1, bi1, bj1) = layout.block_box(roi)
    kk, ii, jj = np.meshgrid(np.arange(bk0, bk1), np.arange(bi0, bi1),
                             np.arange(bj0, bj1), indexing="ij")
    idx = block_index_3d(layout.kind, kk.ravel(), ii.ravel(), jj.ravel(),
                         layout.nt)
    return merge_blocks_to_ranges(idx)


def ranges_to_blocks(ranges) -> np.ndarray:
    """Flatten ``(start, stop)`` ranges back to sorted curve indices."""
    if not ranges:
        return np.empty(0, dtype=np.int64)
    return np.concatenate([np.arange(a, b, dtype=np.int64)
                           for a, b in ranges])


def as_host(store) -> torch.Tensor:
    """``store`` as a contiguous CPU tensor: a numpy array is wrapped (no
    copy where it is contiguous), a CUDA tensor copied to the host once."""
    if not isinstance(store, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(store))
    return store.detach().cpu().contiguous()


def _as_store5(store, layout: StoreLayout) -> torch.Tensor:
    """View any store as a CPU ``(C, nb, T, T, T)`` tensor (C=1 stores
    are 4-D)."""
    store = as_host(store)
    if store.ndim == 4:
        store = store[None]
    C, nb, T = store.shape[0], store.shape[1], store.shape[2]
    if (C, nb, T) != (layout.channels, layout.nb, layout.T) or \
            tuple(store.shape[2:]) != (T, T, T):
        raise ValueError(f"store shape {tuple(store.shape)} does not match "
                         f"layout {layout}")
    return store


# the integer type of each element width: blocks are moved as their bits
# (index_put has no fp8 kernel on the CPU)
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def decode_blocks(blocks, layout: StoreLayout, roi: ROI, ranges, dtype, *,
                  fill_value: float = float("nan")) -> torch.Tensor:
    """The dense ``(C,) + roi.shape`` box from the blocks of ``ranges``
    that ``blocks`` holds (a mapping from curve index to a ``(C, T, T,
    T)`` tensor); every other footprint stays at ``fill_value``.

    The blocks are written whole, as their bits, into a box of the ROI's
    block extent by one indexed copy, and the ROI cropped from it: the
    same values as the JAX package's block-by-block copy of each block's
    intersection with the ROI."""
    T, C = layout.T, layout.channels
    lo, hi = layout.block_box(roi)
    nk, ni, nj = (h - l for l, h in zip(lo, hi))
    bo = block_order(layout.kind, layout.nt)
    idx, blks = [], []
    for b in ranges_to_blocks(ranges):
        blk = blocks.get(int(b))
        if blk is not None:
            idx.append(int(b))
            blks.append(blk.reshape(C, T, T, T))
    box = torch.full((C, nk * T, ni * T, nj * T), fill_value, dtype=dtype)
    coords = bo[np.asarray(idx, dtype=np.int64)] - np.asarray(lo) if idx \
        else np.empty((0, 3), dtype=np.int64)
    # blocks of ranges outside the ROI's block box are not part of it
    inside = ((coords >= 0) & (coords < (nk, ni, nj))).all(axis=1)
    if inside.any():
        width = _BITS[box.element_size()]
        cells = box.view(width).view(C, nk, T, ni, T, nj, T).permute(1, 3, 5, 0, 2, 4, 6)
        k, i, j = (torch.from_numpy(coords[inside, a]) for a in range(3))
        cells[k, i, j] = torch.stack([blk.view(width) for blk, keep
                                      in zip(blks, inside) if keep])
    o = [l - b * T for l, b in zip(roi.lo, lo)]
    return box[:, o[0]:o[0] + roi.shape[0], o[1]:o[1] + roi.shape[1],
               o[2]:o[2] + roi.shape[2]].contiguous()


def extract_roi(store, layout: StoreLayout, roi: ROI, ranges=None, *,
                fill_value: float = float("nan"),
                skip_blocks=()) -> torch.Tensor:
    """Decode only the ROI's blocks into a dense ``(C,) + roi.shape``
    CPU tensor in the store's dtype (C=1 inputs return the plain 3-D box).

    ``ranges`` (default: :func:`roi_to_ranges`) restricts which curve
    ranges are materialised; blocks listed in ``skip_blocks`` (or blocks
    absent from ``ranges``) leave their footprint at ``fill_value`` (NaN
    in the store's dtype) — the degraded-response path of
    serve/service.py, where the ``missing_ranges`` manifest names exactly
    the unfilled blocks.
    """
    squeeze = store.ndim == 4
    store5 = _as_store5(store, layout)
    if ranges is None:
        ranges = roi_to_ranges(layout, roi)
    skip = set(int(b) for b in skip_blocks)
    blocks = {int(b): store5[:, b] for b in ranges_to_blocks(ranges)
              if int(b) not in skip}
    out = decode_blocks(blocks, layout, roi, ranges, store5.dtype,
                        fill_value=fill_value)
    return out[0] if squeeze else out


def roi_model(layout: StoreLayout, roi: ROI, itemsize: int = 4) -> dict:
    """Deterministic accounting of one ROI query, equal to the JAX
    package's as integers.

    blocks_touched: blocks whose extent intersects the ROI (= the block
                    box volume — curve-independent)
    ranges:         contiguous curve ranges (curve-dependent: the
                    locality signal)
    bytes_read:     blocks_touched · C · T³ · itemsize — a range read
                    always moves whole blocks
    payload_bytes:  C · |roi| · itemsize — the useful bytes
    utilization:    payload / read
    """
    (bk0, bi0, bj0), (bk1, bi1, bj1) = layout.block_box(roi)
    blocks = (bk1 - bk0) * (bi1 - bi0) * (bj1 - bj0)
    ranges = roi_to_ranges(layout, roi)
    bytes_read = blocks * layout.block_bytes(itemsize)
    payload = layout.channels * roi.items() * itemsize
    return {
        "blocks_touched": blocks,
        "ranges": len(ranges),
        "bytes_read": bytes_read,
        "payload_bytes": payload,
        "utilization": payload / bytes_read,
    }
