"""Relayout operations in torch: apply an ordering to real tensors.

The torch counterpart of ``repro.core.layout``. The cube is stored as an
``(nb, T, T, T)`` block store with blocks ordered along a curve
(DESIGN.md §2): the curve ordering is a property of the memory layout, so
a kernel that walks blocks in order walks device memory contiguously.
Permutations are built in numpy (core/orderings.py) and copied to the
device once (:func:`device_constant`).
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .boundary import PERIODIC, pad_cube
from .orderings import OrderingSpec, _check_pow2, _flat_index, path_to_rmo, rmo_to_path

__all__ = [
    "apply_ordering", "undo_ordering", "device_constant",
    "block_order", "blockize", "unblockize", "blockize_with_halo",
    "blockize_fields", "unblockize_fields", "store_spec",
]


_DEVICE_CONSTANTS: dict = {}
_DEVICE_CONSTANTS_CAP = 256
# Every read-modify-write of the LRU dict holds this lock (move-to-end and
# eviction are not atomic).
_DEVICE_CONSTANTS_LOCK = threading.RLock()


def device_constant(key, build, device) -> torch.Tensor:
    """Memoised device copy of a precomputed (numpy) table.

    key:    hashable identity of the table
    build:  zero-arg callable producing the numpy array (cheap: the numpy
            side is lru_cached upstream)
    device: where the copy lives; the cache is keyed on ``(key, device)``

    Eviction is LRU: a hit moves the entry to the back of the
    (insertion-ordered) dict; eviction pops the front. Device buffers are
    large (an M=256 permutation is 64 MiB), hence the cap. Concurrent
    misses on one key may both build (the build is pure, last insert
    wins); the dict itself only changes under the lock. Callers must not
    write to the returned tensor.
    """
    full_key = (key, str(torch.device(device)))
    with _DEVICE_CONSTANTS_LOCK:
        hit = _DEVICE_CONSTANTS.get(full_key)
        if hit is not None:
            _DEVICE_CONSTANTS[full_key] = _DEVICE_CONSTANTS.pop(full_key)
            return hit
    arr = torch.from_numpy(np.array(build())).to(device)
    with _DEVICE_CONSTANTS_LOCK:
        while len(_DEVICE_CONSTANTS) >= _DEVICE_CONSTANTS_CAP:
            _DEVICE_CONSTANTS.pop(next(iter(_DEVICE_CONSTANTS)))
        _DEVICE_CONSTANTS[full_key] = arr
    return arr


def _perm_device(spec: OrderingSpec, M: int, inverse: bool, device):
    """Device-resident copy of the (int32) permutation, created once."""
    return device_constant(
        ("perm", spec, M, inverse),
        lambda: rmo_to_path(spec, M) if inverse else path_to_rmo(spec, M),
        device)


def apply_ordering(x: torch.Tensor, spec: OrderingSpec) -> torch.Tensor:
    """Reorder an (M,M,M) cube into a flat (M³,) path-ordered vector."""
    M = x.shape[0]
    if tuple(x.shape) != (M, M, M):
        raise ValueError(f"apply_ordering needs an (M,M,M) cube, got {tuple(x.shape)}")
    q = _perm_device(spec, M, False, x.device)  # path pos -> rmo
    return x.reshape(-1).index_select(0, q)


def undo_ordering(v: torch.Tensor, spec: OrderingSpec, M: int) -> torch.Tensor:
    """Inverse of :func:`apply_ordering`."""
    p = _perm_device(spec, M, True, v.device)  # rmo -> path pos
    return v.index_select(0, p).reshape(M, M, M)


@functools.lru_cache(maxsize=64)
def block_order(kind: str, nt: int) -> np.ndarray:
    """Order of T³-tile *block coordinates* along a curve.

    Returns (nt³, 3) int array: row t holds the (bk,bi,bj) visited at path
    position t by ordering ``kind`` over the nt×nt×nt block grid.
    """
    _check_pow2(nt)
    if nt == 1:  # single-block grid: every curve is trivial
        if kind not in ("row_major", "column_major", "morton", "hilbert"):
            raise ValueError(f"unknown simple ordering {kind!r}")
        out = np.zeros((1, 3), dtype=np.int64)
        out.setflags(write=False)
        return out
    kk, ii, jj = np.meshgrid(*(np.arange(nt, dtype=np.uint64),) * 3, indexing="ij")
    kk, ii, jj = kk.ravel(), ii.ravel(), jj.ravel()
    pidx = _flat_index(kind, kk, ii, jj, nt).astype(np.int64)
    out = np.empty((nt ** 3, 3), dtype=np.int64)
    out[pidx, 0] = kk
    out[pidx, 1] = ii
    out[pidx, 2] = jj
    out.setflags(write=False)
    return out


def _block_perm(kind: str, nt: int, inverse: bool) -> np.ndarray:
    bo = block_order(kind, nt)
    lin = (bo[:, 0] * nt * nt + bo[:, 1] * nt + bo[:, 2]).astype(np.int32)
    if not inverse:
        return lin
    inv = np.empty(nt ** 3, dtype=np.int32)
    inv[lin] = np.arange(nt ** 3, dtype=np.int32)
    return inv


def _block_perm_device(kind: str, nt: int, inverse: bool, device):
    """Cached device copy of the block permutation (path↔linear), int32."""
    return device_constant(("blockperm", kind, nt, inverse),
                           lambda: _block_perm(kind, nt, inverse), device)


def store_spec(kind: str, T: int) -> OrderingSpec:
    """The element ordering realised by the ``(nb, T, T, T)`` block store:
    blocks follow the ``kind`` curve, elements inside a block are
    row-major — a hybrid ordering (paper §2.3)."""
    return OrderingSpec("hybrid", tile=T, outer=kind, inner="row_major")


def _check_blockable(M: int, T: int) -> int:
    nt, rem = divmod(M, T)
    if rem or nt < 1:
        raise ValueError(f"block edge T={T} does not tile cube edge M={M}")
    return nt


def blockize(x: torch.Tensor, T: int, kind: str = "morton") -> torch.Tensor:
    """(M,M,M) -> (nb, T, T, T) with blocks in ``kind`` curve order."""
    M = x.shape[0]
    if tuple(x.shape) != (M, M, M):
        raise ValueError(f"blockize needs a cubic (M,M,M) state, "
                         f"got {tuple(x.shape)}")
    nt = _check_blockable(M, T)
    x6 = x.reshape(nt, T, nt, T, nt, T).permute(0, 2, 4, 1, 3, 5)
    flat = x6.reshape(nt ** 3, T, T, T)
    return flat.index_select(0, _block_perm_device(kind, nt, False, x.device))


def unblockize(blocks: torch.Tensor, M: int, kind: str = "morton") -> torch.Tensor:
    """Inverse of :func:`blockize`."""
    nb, T = blocks.shape[0], blocks.shape[1]
    nt = _check_blockable(M, T)
    if nb != nt ** 3:
        raise ValueError(f"store has {nb} blocks, M={M}, T={T} "
                         f"implies {nt ** 3}")
    x6 = blocks.index_select(0, _block_perm_device(kind, nt, True, blocks.device))
    x6 = x6.reshape(nt, nt, nt, T, T, T).permute(0, 3, 1, 4, 2, 5)
    return x6.reshape(M, M, M)


def blockize_fields(fields: torch.Tensor, T: int,
                    kind: str = "morton") -> torch.Tensor:
    """(C,M,M,M) stacked fields -> (C, nb, T, T, T) multi-field block store
    (DESIGN.md §9): every channel shares one block permutation. A 3-D
    input is promoted to C=1."""
    if fields.ndim == 3:
        fields = fields[None]
    C, M = fields.shape[0], fields.shape[1]
    if tuple(fields.shape) != (C, M, M, M):
        raise ValueError(f"blockize_fields needs (C,M,M,M) stacked "
                         f"fields, got {tuple(fields.shape)}")
    nt = _check_blockable(M, T)
    x7 = fields.reshape(C, nt, T, nt, T, nt, T).permute(0, 1, 3, 5, 2, 4, 6)
    flat = x7.reshape(C, nt ** 3, T, T, T)
    return flat.index_select(1, _block_perm_device(kind, nt, False, fields.device))


def unblockize_fields(store: torch.Tensor, M: int,
                      kind: str = "morton") -> torch.Tensor:
    """Inverse of :func:`blockize_fields`: (C, nb, T³) -> (C, M, M, M)."""
    C, nb, T = store.shape[0], store.shape[1], store.shape[2]
    nt = _check_blockable(M, T)
    if nb != nt ** 3:
        raise ValueError(f"store has {nb} blocks, M={M}, T={T} "
                         f"implies {nt ** 3}")
    x7 = store.index_select(1, _block_perm_device(kind, nt, True, store.device))
    x7 = x7.reshape(C, nt, nt, nt, T, T, T).permute(0, 1, 4, 2, 5, 3, 6)
    return x7.reshape(C, M, M, M)


def blockize_with_halo(x: torch.Tensor, T: int, g: int, kind: str = "morton",
                       bc=PERIODIC) -> torch.Tensor:
    """(M,M,M) -> (nb, T+2g, T+2g, T+2g), curve-ordered, halos included.

    The pack step of the repack pipeline: each block carries its own halo
    (duplication factor ((T+2g)/T)³), ghost-extended under ``bc`` (a
    boundary spec or kind string).
    """
    M = x.shape[0]
    nt = _check_blockable(M, T)
    xp = pad_cube(x, g, bc)
    w = T + 2 * g
    # window b along each axis starts at b*T of the padded cube
    win = xp.unfold(0, w, T).unfold(1, w, T).unfold(2, w, T)  # (nt,nt,nt,w,w,w)
    flat = win.reshape(nt ** 3, w, w, w)
    return flat.index_select(0, _block_perm_device(kind, nt, False, x.device))
