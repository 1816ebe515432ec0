"""Row gather, the paper's pack-by-index-list primitive: the wrapper of
the CUDA kernel.

The torch counterpart of ``repro.kernels.sfc_gather.gather_rows``, with
the same signature minus ``interpret``, plus ``out=``. The kernel lives
in ``csrc/sfc_gather.cu``. The device decides the path: a CUDA tensor
launches the kernel or raises, a CPU tensor runs the plain version
(kernels/ref.gather_rows_ref). Each launch adds one to
``LAUNCHES["gather_rows"]`` (kernels/_build.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["gather_rows"]

_UNITS = (16, 8, 4, 2, 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("sfc_gather")
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.repro_gather_rows.argtypes = [p, p, p, i64, i64, i64, i, p]
    lib.repro_gather_rows.restype = ctypes.c_int
    return lib


def _unit(row_bytes: int, *ptrs: int) -> int:
    """The widest copy unit dividing the row and every base address."""
    return next(u for u in _UNITS
                if row_bytes % u == 0 and all(p % u == 0 for p in ptrs))


def gather_rows(src: torch.Tensor, idx: torch.Tensor, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """out[r] = src[idx[r]].  src: (N, L); idx: (R,) int32; out: (R, L).

    src:  2-D contiguous, any dtype of 1, 2, 4 or 8 bytes (the kernel
          copies bytes)
    idx:  1-D int32 on src's device; every entry in [0, N) — the kernel
          traps on one outside
    out:  optional contiguous (R, L) of src's dtype, not sharing memory
          with src or idx
    """
    if src.ndim != 2 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (N, L) tensor, got shape "
                         f"{tuple(src.shape)}")
    if src.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"src element size {src.element_size()} is not "
                        "1, 2, 4 or 8 bytes")
    if idx.ndim != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be 1-D int32, got {idx.dtype} of shape "
                        f"{tuple(idx.shape)}")
    dev = src.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"src is on {dev}; use cuda or cpu")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, src on {dev}")
    n, L = src.shape
    r = idx.shape[0]
    if out is not None:
        if tuple(out.shape) != (r, L) or out.dtype != src.dtype \
                or out.device != dev or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous ({r}, {L}) {src.dtype} "
                             f"tensor on {dev}")
        mine = out.untyped_storage().data_ptr()
        if mine in (src.untyped_storage().data_ptr(),
                    idx.untyped_storage().data_ptr()):
            raise ValueError("out must not share memory with src or idx")
    if dev.type == "cpu":
        got = ref.gather_rows_ref(src, idx)
        return got if out is None else out.copy_(got)
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if out is None:
        out = torch.empty((r, L), dtype=src.dtype, device=dev)
    if r == 0 or L == 0:
        return out
    row_bytes = L * src.element_size()
    lib = _lib()
    _build.launch(lib, "gather_rows", lib.repro_gather_rows, dev,
                  src.data_ptr(), out.data_ptr(), idx.data_ptr(), n, r,
                  row_bytes, _unit(row_bytes, src.data_ptr(), out.data_ptr()))
    return out
