"""SFC-blocked 3-D weighted stencil: wrappers of the CUDA kernels.

The torch counterparts of the three Pallas kernels of
``repro.kernels.stencil3d`` (DESIGN.md §2–§4), with the same signatures
minus ``interpret``, plus ``out=``:

``stencil_step_fused``   S fused timesteps (ghost refresh + tap sum + rule)
                         per launch over the resident curve-ordered store;
``stencil_sum_resident`` the f32 tap sum over the periodic store, halo
                         assembled in the kernel from the neighbour table;
``stencil_sum_blocks``   the repack form's tap sum over halo-extended blocks.

The kernels live in ``csrc/stencil3d.cu`` (one thread block per output
block, the window in shared memory). The device decides the path: a CUDA
tensor launches the kernel or raises, a CPU tensor runs the plain version
in kernels/ref.py. Each launch adds one to ``LAUNCHES[name]``. Stores are
f32 only; every other dtype raises. Outputs are allocated here (or passed
as ``out=``, which must not share memory with the input) and kernels run
on the current stream without synchronising.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.boundary import (PERIODIC, BoundarySpec, MixedBoundary,
                                       as_boundary)

from . import _build, ref
from .rules import RULES, get_rule

__all__ = ["stencil_sum_blocks", "stencil_sum_resident", "stencil_step_fused",
           "LAUNCHES", "reset_launches", "SMEM_LIMIT_BYTES",
           "fused_smem_bytes", "halo_smem_bytes"]

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"stencil_step_fused": 0, "stencil_sum_resident": 0,
            "stencil_sum_blocks": 0}

# Shared memory one thread block may use on an H100 (dynamic + static).
SMEM_LIMIT_BYTES = 232_448
# The fused kernel's static tables: 27 neighbour ids and 6 face flags.
_TABLE_SMEM_BYTES = 4 * (27 + 6)

_RULE_IDS = {"gol": 0, "jacobi": 1, "identity": 2, "wave": 3}
_BC_IDS = {"periodic": 0, "dirichlet": 1, "neumann0": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_smem_bytes(T: int, g: int, S: int, *, fields: int = 1,
                     itemsize: int = 4) -> int:
    """Shared memory of one fused-kernel thread block: two C·(T+2Sg)³
    windows that the substeps ping-pong between, plus the index tables."""
    return itemsize * 2 * fields * (T + 2 * S * g) ** 3 + _TABLE_SMEM_BYTES


def halo_smem_bytes(T: int, g: int, itemsize: int = 4) -> int:
    """Shared memory of one stencil_sum_blocks thread block: one (T+2g)³
    halo-extended block."""
    return itemsize * (T + 2 * g) ** 3


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("stencil3d")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_stencil_step_fused_f32.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, f, p]
    lib.repro_stencil_sum_resident_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.repro_stencil_sum_blocks_f32.argtypes = [p, p, p, i, i, i, p]
    for fn in (lib.repro_stencil_step_fused_f32,
               lib.repro_stencil_sum_resident_f32,
               lib.repro_stencil_sum_blocks_f32):
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the store on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_store(store: torch.Tensor, name: str) -> None:
    if store.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (the only store dtype the "
                        f"kernels take), got {store.dtype}")
    if store.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {store.device}; use cuda or cpu")
    if not store.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_smem(nbytes: int, what: str) -> None:
    if nbytes > SMEM_LIMIT_BYTES:
        raise ValueError(f"{what} needs {nbytes} B of shared memory per "
                         f"thread block, over the {SMEM_LIMIT_BYTES} B limit")


def _output(out: torch.Tensor | None, shape: tuple, src: torch.Tensor,
            src_name: str) -> torch.Tensor | None:
    if out is None:
        return None
    _check(out, "out", shape, torch.float32, src.device)
    if out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        raise ValueError(f"out must not share memory with {src_name}")
    return out


def _emit(result: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """The plain version's result, written into ``out`` when given."""
    if out is None:
        return result
    out.copy_(result)
    return out


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def stencil_step_fused(store: torch.Tensor, weights: torch.Tensor,
                       nbr: torch.Tensor, bnd: torch.Tensor | None = None,
                       *, g: int, S: int = 1, rule: str = "gol",
                       bc: BoundarySpec | MixedBoundary | str = PERIODIC,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """S fused timesteps over the resident store, one device-memory
    round trip.

    store:   (nb_src, T, T, T) f32, or the stacked (C, nb_src, T, T, T)
             store when the rule declares C > 1 (DESIGN.md §9)
    weights: (2g+1, 2g+1, 2g+1) f32 tap weights
    nbr:     (nb, 27) int32 neighbour table (core.neighbors), nb ≤ nb_src
    bnd:     (nb, 6) int32 clamped-face flags; required when ``bc`` is
             clamped, ignored for periodic
    g, S:    stencil radius and substeps per launch; S·g must divide T
    rule:    "gol" | "jacobi" | "identity" | "wave" (kernels/rules.py)
    bc:      boundary contract (core.boundary), uniform or mixed
    out:     optional (C,) nb, T, T, T f32 output, not sharing memory
             with ``store``
    returns: the store's computed core after S timesteps, f32
    """
    r = get_rule(rule)
    if store.ndim not in (4, 5):
        raise ValueError(f"store must be (nb,T,T,T) or (C,nb,T,T,T), "
                         f"got {tuple(store.shape)}")
    _check_store(store, "store")
    multi = store.ndim == 5
    C = store.shape[0] if multi else 1
    if C != r.channels:
        raise ValueError(
            f"rule {r.name!r} advances {r.channels} channel(s) but the store "
            f"carries {C} (shape {tuple(store.shape)}); stack the fields on "
            "the leading axis (core.layout.blockize_fields)")
    nb_src, T = store.shape[-4], store.shape[-3]
    if tuple(store.shape[-4:]) != (nb_src, T, T, T):
        raise ValueError(f"store blocks must be cubic, got {tuple(store.shape)}")
    h = S * g
    if g < 1 or S < 1 or h > T or T % h:
        raise ValueError(
            f"fused kernel needs 1 <= S and S*g | T, got T={T}, g={g}, S={S}")
    s = 2 * g + 1
    dev = store.device
    nb = nbr.shape[0]
    _check(weights, "weights", (s, s, s), torch.float32, dev)
    _check(nbr, "nbr", (nb, 27), torch.int32, dev)
    if not 1 <= nb <= nb_src:
        raise ValueError(f"nbr has {nb} rows for a store of {nb_src} blocks")
    bc = as_boundary(bc)
    if bc.clamped and bnd is None:
        raise ValueError(f"bc={bc.kind!r} needs the (nb, 6) bnd flag table "
                         "(core.neighbors.boundary_face_table)")
    if bnd is not None:
        _check(bnd, "bnd", (nb, 6), torch.int32, dev)
    _check_smem(fused_smem_bytes(T, g, S, fields=C),
                f"fused step T={T}, g={g}, S={S}, C={C}")
    out_shape = (C, nb, T, T, T) if multi else (nb, T, T, T)
    out = _output(out, out_shape, store, "store")
    if dev.type == "cpu":
        return _emit(ref.stencil_fused_ref(store, weights, nbr, S=S, rule=r,
                                           bc=bc, bnd=bnd), out)
    if RULES.get(r.name) is not r:
        raise ValueError(f"rule {r.name!r} has no CUDA kernel; known: "
                         f"{sorted(_RULE_IDS)}")
    if out is None:
        out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    axes = bc.axes
    _launch("stencil_step_fused", _lib().repro_stencil_step_fused_f32, dev,
            store.data_ptr(), out.data_ptr(), weights.data_ptr(),
            nbr.data_ptr(), bnd.data_ptr() if bc.clamped else None,
            nb, nb_src, T, g, S, _RULE_IDS[r.name],
            *(_BC_IDS[a.kind] for a in axes), *(float(a.value) for a in axes))
    return out


def stencil_sum_resident(store: torch.Tensor, weights: torch.Tensor,
                         nbr: torch.Tensor, *, g: int,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """In-kernel halo streaming over the persistent block store.

    store:   (nb, T, T, T) f32 — SFC-ordered, no halo duplication
    weights: (2g+1, 2g+1, 2g+1) f32
    nbr:     (nb, 27) int32 periodic neighbour table of the same ordering
    returns: (nb, T, T, T) f32, bit-identical to
             stencil_sum_blocks(blockize_with_halo(...), ...)

    g must divide T (halo pieces are whole slabs of the neighbours).
    """
    if store.ndim != 4:
        raise ValueError(f"store must be (nb,T,T,T), got {tuple(store.shape)}")
    _check_store(store, "store")
    nb, T = store.shape[0], store.shape[1]
    if tuple(store.shape) != (nb, T, T, T):
        raise ValueError(f"store blocks must be cubic, got {tuple(store.shape)}")
    if g < 1 or g > T or T % g:
        raise ValueError(f"resident kernel needs g | T, got T={T}, g={g}")
    s = 2 * g + 1
    dev = store.device
    _check(weights, "weights", (s, s, s), torch.float32, dev)
    _check(nbr, "nbr", (nb, 27), torch.int32, dev)
    _check_smem(fused_smem_bytes(T, g, 1), f"resident sum T={T}, g={g}")
    out = _output(out, (nb, T, T, T), store, "store")
    if dev.type == "cpu":
        return _emit(ref.stencil_sum_resident_ref(store, weights, nbr), out)
    if out is None:
        out = torch.empty((nb, T, T, T), dtype=torch.float32, device=dev)
    _launch("stencil_sum_resident", _lib().repro_stencil_sum_resident_f32, dev,
            store.data_ptr(), out.data_ptr(), weights.data_ptr(),
            nbr.data_ptr(), nb, T, g)
    return out


def stencil_sum_blocks(blocks: torch.Tensor, weights: torch.Tensor, *,
                       g: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """acc[b] = sum_d w[d] * blocks[b, z+d] for every block b.

    blocks:  (nb, T+2g, T+2g, T+2g) f32 — SFC-ordered, halo-extended
    weights: (2g+1, 2g+1, 2g+1) f32
    returns: (nb, T, T, T) f32
    """
    if blocks.ndim != 4:
        raise ValueError(f"blocks must be (nb,W,W,W), got {tuple(blocks.shape)}")
    _check_store(blocks, "blocks")
    nb, W = blocks.shape[0], blocks.shape[1]
    T = W - 2 * g
    if tuple(blocks.shape) != (nb, W, W, W) or g < 1 or T < 1 or nb < 1:
        raise ValueError(f"blocks {tuple(blocks.shape)} are not halo-extended "
                         f"cubes for g={g}")
    s = 2 * g + 1
    dev = blocks.device
    _check(weights, "weights", (s, s, s), torch.float32, dev)
    _check_smem(halo_smem_bytes(T, g), f"repack sum T={T}, g={g}")
    out = _output(out, (nb, T, T, T), blocks, "blocks")
    if dev.type == "cpu":
        return _emit(ref.stencil_sum_ref(blocks, weights), out)
    if out is None:
        out = torch.empty((nb, T, T, T), dtype=torch.float32, device=dev)
    _launch("stencil_sum_blocks", _lib().repro_stencil_sum_blocks_f32, dev,
            blocks.data_ptr(), out.data_ptr(), weights.data_ptr(), nb, T, g)
    return out
