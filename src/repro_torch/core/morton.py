"""3D/2D Morton (Z-order) encoding via dilated integers.

Vectorised numpy implementation of the bit-interleaving described in the
paper §2.1 (a 3D extension of Raman & Wise's dilated-integer technique).

Conventions follow the paper: an array location is ``(k, i, j)`` where ``j``
is the column (fastest-varying in row-major), ``i`` the row, ``k`` the slab.
The Morton index at full depth interleaves bits as ``... k_b i_b j_b`` with
``j`` in the least-significant position, so that Morton order of a
``2x2x2`` block visits it in row-major order — matching Fig. 1.

Level-``r`` Morton ordering (paper Fig. 2): the upper ``r`` bits of each of
``k,i,j`` are interleaved to form the top ``3r`` bits; the lower ``m-r``
bits of ``k``, then ``i``, then ``j`` follow — i.e. Morton between
``2^{m-r}``-cubes, row-major within.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "dilate3",
    "undilate3",
    "dilate2",
    "undilate2",
    "morton_encode3",
    "morton_decode3",
    "morton_encode2",
    "morton_decode2",
    "morton_encode3_level",
    "morton_decode3_level",
]

_U = np.uint64


def dilate3(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of ``x``: bit b -> bit 3b (dilated integer)."""
    x = np.asarray(x).astype(_U)  # astype copies: never mutate caller
    x &= _U(0x1FFFFF)  # 21 bits
    x = (x | (x << _U(32))) & _U(0x1F00000000FFFF)
    x = (x | (x << _U(16))) & _U(0x1F0000FF0000FF)
    x = (x | (x << _U(8))) & _U(0x100F00F00F00F00F)
    x = (x | (x << _U(4))) & _U(0x10C30C30C30C30C3)
    x = (x | (x << _U(2))) & _U(0x1249249249249249)
    return x


def undilate3(x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`dilate3` (keeps every 3rd bit)."""
    x = np.asarray(x).astype(_U)  # astype copies: never mutate caller
    x &= _U(0x1249249249249249)
    x = (x | (x >> _U(2))) & _U(0x10C30C30C30C30C3)
    x = (x | (x >> _U(4))) & _U(0x100F00F00F00F00F)
    x = (x | (x >> _U(8))) & _U(0x1F0000FF0000FF)
    x = (x | (x >> _U(16))) & _U(0x1F00000000FFFF)
    x = (x | (x >> _U(32))) & _U(0x1FFFFF)
    return x


def dilate2(x: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of ``x``: bit b -> bit 2b."""
    x = np.asarray(x).astype(_U)  # astype copies: never mutate caller
    x &= _U(0xFFFFFFFF)
    x = (x | (x << _U(16))) & _U(0x0000FFFF0000FFFF)
    x = (x | (x << _U(8))) & _U(0x00FF00FF00FF00FF)
    x = (x | (x << _U(4))) & _U(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << _U(2))) & _U(0x3333333333333333)
    x = (x | (x << _U(1))) & _U(0x5555555555555555)
    return x


def undilate2(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x).astype(_U)  # astype copies: never mutate caller
    x &= _U(0x5555555555555555)
    x = (x | (x >> _U(1))) & _U(0x3333333333333333)
    x = (x | (x >> _U(2))) & _U(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> _U(4))) & _U(0x00FF00FF00FF00FF)
    x = (x | (x >> _U(8))) & _U(0x0000FFFF0000FFFF)
    x = (x | (x >> _U(16))) & _U(0xFFFFFFFF)
    return x


def morton_encode3(k, i, j) -> np.ndarray:
    """Full-depth 3D Morton index of location ``(k,i,j)`` (j least significant)."""
    return (dilate3(k) << _U(2)) | (dilate3(i) << _U(1)) | dilate3(j)


def morton_decode3(idx) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    idx = np.asarray(idx, dtype=_U)
    return (
        undilate3(idx >> _U(2)),
        undilate3(idx >> _U(1)),
        undilate3(idx),
    )


def morton_encode2(i, j) -> np.ndarray:
    return (dilate2(i) << _U(1)) | dilate2(j)


def morton_decode2(idx) -> tuple[np.ndarray, np.ndarray]:
    idx = np.asarray(idx, dtype=_U)
    return undilate2(idx >> _U(1)), undilate2(idx)


def morton_encode3_level(k, i, j, m: int, r: int) -> np.ndarray:
    """Level-``r`` Morton index for an ``M^3`` array, ``M = 2^m`` (paper Fig. 2).

    The top ``r`` bits of each coordinate are interleaved (Morton between
    ``2^{m-r}``-cubes); the low ``m-r`` bits of ``k``, ``i``, ``j`` follow in
    row-major order within the cube. ``r = m`` is full-depth Morton,
    ``r = 0`` is plain row-major.
    """
    if not (0 <= r <= m):
        raise ValueError(f"need 0 <= r <= m, got r={r}, m={m}")
    k = np.asarray(k, dtype=_U)
    i = np.asarray(i, dtype=_U)
    j = np.asarray(j, dtype=_U)
    low = m - r
    hi = morton_encode3(k >> _U(low), i >> _U(low), j >> _U(low))
    mask = _U((1 << low) - 1)
    return (
        (hi << _U(3 * low))
        | ((k & mask) << _U(2 * low))
        | ((i & mask) << _U(low))
        | (j & mask)
    )


def morton_decode3_level(idx, m: int, r: int):
    """Inverse of :func:`morton_encode3_level`."""
    if not (0 <= r <= m):
        raise ValueError(f"need 0 <= r <= m, got r={r}, m={m}")
    idx = np.asarray(idx, dtype=_U)
    low = m - r
    mask = _U((1 << low) - 1)
    j_lo = idx & mask
    i_lo = (idx >> _U(low)) & mask
    k_lo = (idx >> _U(2 * low)) & mask
    k_hi, i_hi, j_hi = morton_decode3(idx >> _U(3 * low))
    return (
        (k_hi << _U(low)) | k_lo,
        (i_hi << _U(low)) | i_lo,
        (j_hi << _U(low)) | j_lo,
    )
