"""2D/3D Hilbert curve encoding, vectorised.

The paper (§2.2) generates the 3D Hilbert ordering from a Lindenmayer
system. We use Skilling's transpose algorithm ("Programming the Hilbert
curve", AIP Conf. Proc. 707, 2004), which produces the same curve family
(bijective, unit-stride between consecutive path positions, starts at the
origin) and vectorises cleanly over numpy arrays. Orientation may differ
from a specific L-system realisation; locality statistics are identical
by symmetry. Bijectivity and the unit-neighbour property are enforced by
tests (tests/test_sfc_properties.py).

``b`` is bits per coordinate (M = 2**b); n=2 or 3 dimensions.
"""

from __future__ import annotations

import numpy as np

from .morton import dilate2, dilate3, undilate2, undilate3

__all__ = ["hilbert_encode", "hilbert_decode", "hilbert_encode3", "hilbert_decode3"]

_U = np.uint64


def _axes_to_transpose(coords: list[np.ndarray], b: int) -> list[np.ndarray]:
    """Skilling AxestoTranspose, vectorised. coords: list of n uint64 arrays."""
    n = len(coords)
    x = [c.astype(_U).copy() for c in coords]
    q = _U(1) << _U(b - 1)
    # Inverse undo excess work
    while q > _U(1):
        p = q - _U(1)
        for i in range(n):
            cond = (x[i] & q) != 0
            # if set: invert low bits of x[0]; else swap low bits of x[0], x[i]
            t = (x[0] ^ x[i]) & p
            x0_if = x[0] ^ p
            x0_else = x[0] ^ t
            xi_else = x[i] ^ t
            x[0] = np.where(cond, x0_if, x0_else)
            x[i] = np.where(cond, x[i], xi_else)
        q >>= _U(1)
    # Gray encode
    for i in range(1, n):
        x[i] = x[i] ^ x[i - 1]
    t = np.zeros_like(x[0])
    q = _U(1) << _U(b - 1)
    while q > _U(1):
        cond = (x[n - 1] & q) != 0
        t = np.where(cond, t ^ (q - _U(1)), t)
        q >>= _U(1)
    for i in range(n):
        x[i] = x[i] ^ t
    return x


def _transpose_to_axes(x: list[np.ndarray], b: int) -> list[np.ndarray]:
    """Skilling TransposetoAxes, vectorised (inverse of _axes_to_transpose)."""
    n = len(x)
    x = [c.astype(_U).copy() for c in x]
    big = _U(2) << _U(b - 1)
    # Gray decode by H ^ (H/2)
    t = x[n - 1] >> _U(1)
    for i in range(n - 1, 0, -1):
        x[i] = x[i] ^ x[i - 1]
    x[0] = x[0] ^ t
    # Undo excess work
    q = _U(2)
    while q != big:
        p = q - _U(1)
        for i in range(n - 1, -1, -1):
            cond = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0_if = x[0] ^ p
            x0_else = x[0] ^ t
            xi_else = x[i] ^ t
            x[0] = np.where(cond, x0_if, x0_else)
            x[i] = np.where(cond, x[i], xi_else)
        q <<= _U(1)
    return x


def hilbert_encode(coords, b: int) -> np.ndarray:
    """Hilbert index of ``coords`` (list/tuple of n arrays), b bits per axis.

    coords[0] is the most-significant axis (the paper's slab index k for 3D).
    """
    n = len(coords)
    xt = _axes_to_transpose([np.asarray(c) for c in coords], b)
    if n == 3:
        return (dilate3(xt[0]) << _U(2)) | (dilate3(xt[1]) << _U(1)) | dilate3(xt[2])
    if n == 2:
        return (dilate2(xt[0]) << _U(1)) | dilate2(xt[1])
    raise ValueError(f"unsupported ndim {n}")


def hilbert_decode(idx, n: int, b: int) -> list[np.ndarray]:
    """Inverse of :func:`hilbert_encode`: Hilbert index -> n coordinates."""
    idx = np.asarray(idx, dtype=_U)
    if n == 3:
        xt = [undilate3(idx >> _U(2)), undilate3(idx >> _U(1)), undilate3(idx)]
    elif n == 2:
        xt = [undilate2(idx >> _U(1)), undilate2(idx)]
    else:
        raise ValueError(f"unsupported ndim {n}")
    return _transpose_to_axes(xt, b)


def hilbert_encode3(k, i, j, m: int) -> np.ndarray:
    """3D Hilbert index of (k,i,j) in an ``2^m``-cube (paper convention)."""
    return hilbert_encode([k, i, j], m)


def hilbert_decode3(idx, m: int):
    k, i, j = hilbert_decode(idx, 3, m)
    return k, i, j
