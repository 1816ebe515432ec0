"""SFC-blocked 3-D weighted stencil: wrappers of the CUDA kernels.

The torch counterparts of the three Pallas kernels of
``repro.kernels.stencil3d`` (DESIGN.md §2–§4), with the same signatures
minus ``interpret``, plus ``out=``:

``stencil_step_fused``   S fused timesteps (ghost refresh + tap sum + rule)
                         per launch over the resident curve-ordered store;
``stencil_sum_resident`` the f32 tap sum over the periodic store, halo
                         assembled in the kernel from the neighbour table;
``stencil_sum_blocks``   the repack form's tap sum over halo-extended blocks.

The fused step and the resident sum have three CUDA designs, and
:func:`fused_design` (a pure function of T, g, S, C, the dtype and whether
the launch steps a whole periodic cube) picks one: the group design of
``csrc/stencil3d_sm90.cu`` (one thread block steps an aligned 2×2×2 group
of blocks as one tile, from the group table of core/neighbors) where the
launch steps a whole periodic cube of an even number of blocks per edge,
f32, T=8, S·g ≥ 2; the same file's block design (compile-time shapes,
register tiling along k, and, where that costs no thread block per SM,
persistent thread blocks that prefetch the next window with cp.async) for
the other f32 stores with T ∈ {8, 16}, g ∈ {1, 2}, S·g | T, C ∈ {1, 2}
where its shared memory fits; ``csrc/stencil3d.cu`` (one thread block per
output block, the window in shared memory) for every other shape and
dtype. The repack form's tap sum
has two as well, and :func:`blocks_design` (T, g and the dtype) picks
one: ``csrc/stencil3d_blocks_sm90.cu`` (persistent thread blocks fed by
bulk copies into a ring, columns of sites in registers) for T ∈ {8, 16},
g ∈ {1, 2}; the first design's ``halo_sum_kernel`` for the rest.
The device decides the path: a CUDA tensor launches a kernel or raises,
a CPU tensor runs the plain version in kernels/ref.py. Each launch adds
one to ``LAUNCHES[name]`` (the port's one counter, kernels/_build.py), the
fused and resident launches one to ``STENCIL_DESIGN_LAUNCHES[design]`` and
the repack launches one to ``BLOCKS_DESIGN_LAUNCHES[design]``.
Stores and blocks are f32, bf16, f16, float8_e4m3fn or float8_e5m2
(:data:`DTYPES`); every other dtype raises. The arithmetic is f32 in every
dtype: the fused step writes in the store's dtype, rounded once as XLA
rounds (kernels/ref.round_to: an fp8 e4m3fn result above 464 in magnitude
is NaN), the two tap sums in f32. The Hopper designs take f32 (the fused
step) and f32, bf16 and f16 (the repack sum): fp8 stores take the first
design. Outputs are allocated here
(or passed as ``out=``, which must not share memory with the input) and
kernels run on the current stream without synchronising.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.boundary import (PERIODIC, BoundarySpec, MixedBoundary,
                                       as_boundary)
from repro_torch.core.neighbors import GROUP_COLS, group_table_device

from . import _build, ref
from .rules import RULES, get_rule

__all__ = ["stencil_sum_blocks", "stencil_sum_resident", "stencil_step_fused",
           "DTYPES", "LAUNCHES", "reset_launches", "SMEM_LIMIT_BYTES",
           "blocks_design", "blocks_sm90_smem_bytes", "fused_design",
           "fused_smem_bytes", "group_smem_bytes", "halo_smem_bytes",
           "sm90_smem_bytes"]

LAUNCHES, reset_launches = _build.LAUNCHES, _build.reset_launches

# Shared memory one thread block may use on an H100 (dynamic + static).
SMEM_LIMIT_BYTES = 232_448
# The fused kernel's static tables: 27 neighbour ids and 6 face flags.
_TABLE_SMEM_BYTES = 4 * (27 + 6)
# What the Hopper design (csrc/stencil3d_sm90.cu) takes.
_SM90_T, _SM90_G, _SM90_C = (8, 16), (1, 2), (1, 2)
# The block edge of its group design: a group is a tile of 2T.
_GROUP_T = 8
# The store dtypes every kernel takes, by the code its C entry point reads.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
# The block dtypes of the Hopper repack design (csrc/stencil3d_blocks_sm90.cu).
_BLOCKS_SM90_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# csrc/stencil3d_blocks_sm90.cu: threads per thread block, and each
# thread's column of sites along k (NZ) times along j (NX)
_BLOCKS_NT, _BLOCKS_NZ, _BLOCKS_NX = 128, 4, 4

_RULE_IDS = {"gol": 0, "jacobi": 1, "identity": 2, "wave": 3}
_BC_IDS = {"periodic": 0, "dirichlet": 1, "neumann0": 2}


def fused_smem_bytes(T: int, g: int, S: int, *, fields: int = 1,
                     itemsize: int = 4) -> int:
    """Shared memory of one fused-kernel thread block: two C·(T+2Sg)³
    windows that the substeps ping-pong between, plus the index tables."""
    return itemsize * 2 * fields * (T + 2 * S * g) ** 3 + _TABLE_SMEM_BYTES


def sm90_smem_bytes(T: int, g: int, S: int, *, fields: int = 1,
                    itemsize: int = 4) -> int:
    """Shared memory of one thread block of the Hopper design: three
    C·(T+2Sg)³ windows (the current block's, its substep partner, the next
    block's, prefetched) plus two rows of the index tables."""
    return itemsize * 3 * fields * (T + 2 * S * g) ** 3 + 2 * _TABLE_SMEM_BYTES


def group_smem_bytes(T: int, g: int, S: int, *, fields: int = 1,
                     windows: int = 2, itemsize: int = 4) -> int:
    """Shared memory of one thread block of the group design: ``windows``
    C·(2T+2Sg)³ windows (two that the substeps ping-pong between, and a
    third, the next group's, prefetched where it fits) plus two rows of
    the group table (72 int32 each)."""
    return itemsize * windows * fields * (2 * T + 2 * S * g) ** 3 + 2 * 4 * GROUP_COLS


def fused_design(T: int, g: int, S: int, C: int,
                 dtype: torch.dtype = torch.float32, *,
                 cube: bool = False) -> str:
    """The CUDA design ``stencil_step_fused`` launches for a ``dtype`` store
    of blocks of edge T, radius g, S substeps and C channels
    (``stencil_sum_resident`` is S=1, C=1). ``cube``: the launch steps a
    whole periodic cube of an even number of blocks per edge (nb == nb_src
    == nt³, the periodic contract, a neighbour table of which
    core.neighbors.group_table finds the groups).

    ``"sm90_group"`` (``csrc/stencil3d_sm90.cu``, one thread block a 2×2×2
    group of blocks) for such a cube in f32 with T=8, g ∈ {1, 2}, C ∈ {1,
    2}, S·g | T and S·g ≥ 2 (a recomputed halo to cut) where two windows
    of :func:`group_smem_bytes` fit in :data:`SMEM_LIMIT_BYTES`;
    ``"sm90"`` (the same file, one thread block a block) for the other f32
    cases with T ∈ {8, 16}, g ∈ {1, 2}, S·g | T and C ∈ {1, 2} where
    :func:`sm90_smem_bytes` fits; ``"simple"`` (``csrc/stencil3d.cu``) for
    every other case, bf16, f16 and fp8 stores among them. Nothing else,
    and never a failure, decides it."""
    if dtype != torch.float32 or g not in _SM90_G or C not in _SM90_C \
            or S < 1 or T % (S * g):
        return "simple"
    if cube and T == _GROUP_T and S * g >= 2 \
            and group_smem_bytes(T, g, S, fields=C) <= SMEM_LIMIT_BYTES:
        return "sm90_group"
    if T in _SM90_T and sm90_smem_bytes(T, g, S, fields=C) <= SMEM_LIMIT_BYTES:
        return "sm90"
    return "simple"


def _blocks_plan(T: int) -> tuple[int, int]:
    """(blocks per round, ring stages) of csrc/stencil3d_blocks_sm90.cu at
    block edge T: a round gives each block (T/NZ)·T·(T/NX) columns of the
    thread block's 128 threads, and the ring holds two rounds (four stages
    at least)."""
    ncol = (T // _BLOCKS_NZ) * T * (T // _BLOCKS_NX)
    r = 1 if ncol >= _BLOCKS_NT else _BLOCKS_NT // ncol
    return r, max(2 * r, 4)


def blocks_sm90_smem_bytes(T: int, g: int, itemsize: int = 4) -> int:
    """Shared memory of one thread block of the Hopper repack design: a
    ring of :func:`_blocks_plan` stages, each one (T+2g)³ window in the
    blocks' dtype, and an 8-byte mbarrier per stage."""
    stages = _blocks_plan(T)[1]
    return stages * (T + 2 * g) ** 3 * itemsize + 8 * stages


def blocks_design(T: int, g: int, dtype: torch.dtype = torch.float32) -> str:
    """The CUDA design ``stencil_sum_blocks`` launches for ``dtype`` blocks
    of core edge T and radius g: ``"sm90"`` (``csrc/stencil3d_blocks_sm90.cu``)
    for T ∈ {8, 16}, g ∈ {1, 2} and f32, bf16 or f16, where one (T+2g)³
    window is a multiple of 16 bytes (a bulk copy's unit) and
    :func:`blocks_sm90_smem_bytes` fits in :data:`SMEM_LIMIT_BYTES`;
    ``"simple"`` (``csrc/stencil3d.cu`` ``halo_sum_kernel``) for every
    other case, fp8 blocks among them. Nothing else, and never a failure,
    decides it."""
    if dtype not in _BLOCKS_SM90_DTYPES or T not in _SM90_T or g not in _SM90_G:
        return "simple"
    item = torch.empty((), dtype=dtype).element_size()
    if (T + 2 * g) ** 3 * item % 16 == 0 \
            and blocks_sm90_smem_bytes(T, g, item) <= SMEM_LIMIT_BYTES:
        return "sm90"
    return "simple"


def halo_smem_bytes(T: int, g: int, itemsize: int = 4) -> int:
    """Shared memory of one thread block of the first repack design: one
    (T+2g)³ halo-extended block, widened to f32 whatever the blocks'
    dtype."""
    return itemsize * (T + 2 * g) ** 3


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("stencil3d")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_stencil_step_fused.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, f, i, p]
    lib.repro_stencil_sum_resident.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.repro_stencil_sum_blocks.argtypes = [p, p, p, i, i, i, i, p]
    for fn in (lib.repro_stencil_step_fused, lib.repro_stencil_sum_resident,
               lib.repro_stencil_sum_blocks):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_sm90() -> ctypes.CDLL:
    lib = _build.library("stencil3d_sm90")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_stencil_step_fused_sm90_f32.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, f, i, p]
    lib.repro_stencil_sum_resident_sm90_f32.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.repro_stencil_step_fused_group_sm90_f32.argtypes = [
        p, p, p, p, i, i, i, i, i, i, i, i, p]
    for fn in (lib.repro_stencil_step_fused_sm90_f32,
               lib.repro_stencil_sum_resident_sm90_f32,
               lib.repro_stencil_step_fused_group_sm90_f32):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_blocks_sm90() -> ctypes.CDLL:
    lib = _build.library("stencil3d_blocks_sm90")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_stencil_sum_blocks_sm90.argtypes = [p, p, p, i, i, i, i, p]
    lib.repro_stencil_sum_blocks_sm90.restype = ctypes.c_int
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
    if store.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32, bfloat16, float16, "
                        f"float8_e4m3fn or float8_e5m2 (the dtypes the "
                        f"kernels take), got {store.dtype}")
    if store.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {store.device}; use cuda or cpu")
    if not store.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_smem(nbytes: int, what: str) -> None:
    if nbytes > SMEM_LIMIT_BYTES:
        raise ValueError(f"{what} needs {nbytes} B of shared memory per "
                         f"thread block, over the {SMEM_LIMIT_BYTES} B limit")


def _output(out: torch.Tensor | None, shape: tuple, dtype: torch.dtype,
            src: torch.Tensor, src_name: str) -> torch.Tensor | None:
    if out is None:
        return None
    _check(out, "out", shape, dtype, src.device)
    if out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        raise ValueError(f"out must not share memory with {src_name}")
    return out


def _core_output(out: torch.Tensor | None, shape: tuple,
                 store: torch.Tensor) -> tuple[torch.Tensor | None, int]:
    """Check the fused step's ``out`` (in the store's dtype) and return it
    with its channel stride in blocks. A stacked ``(C, nb, T, T, T)`` out
    may be the core of a larger store (``ext[:, :nb]``): each channel
    contiguous, the channels ``out_nb >= nb`` blocks apart. Any other out
    is contiguous."""
    nb, T3 = shape[-4], shape[-1] ** 3
    if out is None or out.is_contiguous() or out.ndim != 5:
        return _output(out, shape, store.dtype, store, "store"), nb
    if tuple(out.shape) != shape or out.dtype != store.dtype \
            or out.device != store.device:
        _check(out, "out", shape, store.dtype, store.device)
    out_nb, rem = divmod(out.stride(0), T3)
    if rem or out_nb < nb or not out[0].is_contiguous():
        raise ValueError("out must be contiguous, or the core (C, nb, T, T, T) "
                         "of a larger contiguous store")
    if out.untyped_storage().data_ptr() == store.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with store")
    return out, out_nb


def _emit(result: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """The plain version's result, written into ``out`` when given."""
    if out is None:
        return result
    out.copy_(result)
    return out


def _launch(name: str, design: str, device: torch.device, *args) -> None:
    """Launch ``name``'s kernel of ``design`` ("sm90", "sm90_group" or
    "simple") and count it, under its design too."""
    if design == "simple":
        lib, entry = _lib(), f"repro_{name}"
    elif name == "stencil_sum_blocks":
        lib, entry = _lib_blocks_sm90(), "repro_stencil_sum_blocks_sm90"
    elif design == "sm90_group":
        lib, entry = _lib_sm90(), f"repro_{name}_group_sm90_f32"
    else:
        lib, entry = _lib_sm90(), f"repro_{name}_sm90_f32"
    _build.launch(lib, name, getattr(lib, entry), device, *args)
    counts = (_build.BLOCKS_DESIGN_LAUNCHES if name == "stencil_sum_blocks"
              else _build.STENCIL_DESIGN_LAUNCHES)
    counts[design] += 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data is not 16-byte aligned (the
    Hopper design moves 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stencil_step_fused(store: torch.Tensor, weights: torch.Tensor,
                       nbr: torch.Tensor, bnd: torch.Tensor | None = None,
                       *, g: int, S: int = 1, rule: str = "gol",
                       bc: BoundarySpec | MixedBoundary | str = PERIODIC,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """S fused timesteps over the resident store, one device-memory
    round trip.

    store:   (nb_src, T, T, T) in a dtype of :data:`DTYPES`, or the stacked
             (C, nb_src, T, T, T) store when the rule declares C > 1
             (DESIGN.md §9)
    weights: (2g+1, 2g+1, 2g+1) f32 tap weights
    nbr:     (nb, 27) int32 neighbour table (core.neighbors), nb ≤ nb_src
    bnd:     (nb, 6) int32 clamped-face flags; required when ``bc`` is
             clamped, ignored for periodic
    g, S:    stencil radius and substeps per launch; S·g must divide T
    rule:    "gol" | "jacobi" | "identity" | "wave" (kernels/rules.py)
    bc:      boundary contract (core.boundary), uniform or mixed
    out:     optional (C,) nb, T, T, T output in the store's dtype, not
             sharing memory with ``store``: contiguous, or for a stacked
             store the core ``ext[:, :nb]`` of a larger contiguous store
    returns: the store's computed core after S timesteps, in the store's
             dtype (every substep runs in f32; the result rounds once, as
             kernels/ref.round_to does)
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
    out, out_nb = _core_output(out, out_shape, store)
    if dev.type == "cpu":
        return _emit(ref.stencil_fused_ref(store, weights, nbr, S=S, rule=r,
                                           bc=bc, bnd=bnd), out)
    if RULES.get(r.name) is not r:
        raise ValueError(f"rule {r.name!r} has no CUDA kernel; known: "
                         f"{sorted(_RULE_IDS)}")
    if out is None:
        out = torch.empty(out_shape, dtype=store.dtype, device=dev)
    # a whole periodic cube whose table groups (its group table is built at
    # the table's first launch, then looked up) may take the group design
    groups = group_table_device(nbr) if not bc.clamped and nb == nb_src else None
    _fused_on_card(fused_design(T, g, S, C, store.dtype, cube=groups is not None),
                   store, weights, nbr, bnd if bc.clamped else None, out, out_nb,
                   g=g, S=S, rule=r.name, bc=bc, groups=groups)
    return out


def _fused_on_card(design: str, store, weights, nbr, bnd, out, out_nb: int, *,
                   g: int, S: int, rule: str, bc,
                   overlap: bool | None = None,
                   groups: torch.Tensor | None = None) -> None:
    """Launch ``design``'s fused kernel on checked CUDA tensors (its own
    limits are checked again in C, which returns an error that raises).
    The Hopper block design runs with its overlap (persistent thread blocks
    that prefetch the next window) where that costs no thread block per SM;
    ``overlap=True`` or ``False`` forces either way, for timing. The group
    design steps the groups of ``groups``, the periodic cube's group table
    of ``nbr`` (core.neighbors.group_table_device), and prefetches the next
    group's window beside the substeps where a third window fits
    (``overlap=False`` streams it in while the result is written instead,
    for timing; ``True`` raises where it does not fit)."""
    nb, nb_src, T = nbr.shape[0], store.shape[-4], store.shape[-1]
    dest, dest_nb = out, out_nb
    if design != "simple":
        store = _aligned(store)
        if out.data_ptr() % 16:
            dest = torch.empty(out.shape, dtype=out.dtype, device=out.device)
            dest_nb = nb
    if design == "sm90_group":
        args = (groups.data_ptr(), groups.shape[0], nb_src, dest_nb, T, g, S,
                _RULE_IDS[rule], -1 if overlap is None else int(overlap))
    else:
        axes = bc.axes
        args = (nbr.data_ptr(), None if bnd is None else bnd.data_ptr(),
                nb, nb_src, dest_nb, T, g, S, _RULE_IDS[rule],
                *(_BC_IDS[a.kind] for a in axes), *(float(a.value) for a in axes),
                DTYPES[store.dtype] if design == "simple"
                else -1 if overlap is None else int(overlap))
    _launch("stencil_step_fused", design, store.device, store.data_ptr(),
            dest.data_ptr(), weights.data_ptr(), *args)
    if dest is not out:
        out.copy_(dest)


def stencil_sum_resident(store: torch.Tensor, weights: torch.Tensor,
                         nbr: torch.Tensor, *, g: int,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """In-kernel halo streaming over the persistent block store.

    store:   (nb, T, T, T) in a dtype of :data:`DTYPES` — SFC-ordered, no halo
             duplication
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
    out = _output(out, (nb, T, T, T), torch.float32, store, "store")
    if dev.type == "cpu":
        return _emit(ref.stencil_sum_resident_ref(store, weights, nbr), out)
    if out is None:
        out = torch.empty((nb, T, T, T), dtype=torch.float32, device=dev)
    _resident_on_card(fused_design(T, g, 1, 1, store.dtype), store, weights,
                      nbr, out, g=g)
    return out


def _resident_on_card(design: str, store, weights, nbr, out, *, g: int,
                      overlap: bool | None = None) -> None:
    """Launch ``design``'s resident tap sum on checked CUDA tensors
    (``overlap`` as in :func:`_fused_on_card`)."""
    nb, T = store.shape[0], store.shape[1]
    dest, extra = out, (DTYPES[store.dtype],)
    if design == "sm90":
        store = _aligned(store)
        if out.data_ptr() % 16:
            dest = torch.empty_like(out)
        extra = (-1 if overlap is None else int(overlap),)
    _launch("stencil_sum_resident", design, store.device, store.data_ptr(),
            dest.data_ptr(), weights.data_ptr(), nbr.data_ptr(), nb, T, g,
            *extra)
    if dest is not out:
        out.copy_(dest)


def stencil_sum_blocks(blocks: torch.Tensor, weights: torch.Tensor, *,
                       g: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """acc[b] = sum_d w[d] * blocks[b, z+d] for every block b.

    blocks:  (nb, T+2g, T+2g, T+2g) in a dtype of :data:`DTYPES` — SFC-ordered,
             halo-extended
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
    out = _output(out, (nb, T, T, T), torch.float32, blocks, "blocks")
    if dev.type == "cpu":
        return _emit(ref.stencil_sum_ref(blocks, weights), out)
    if out is None:
        out = torch.empty((nb, T, T, T), dtype=torch.float32, device=dev)
    _blocks_on_card(blocks_design(T, g, blocks.dtype), blocks, weights, out, g=g)
    return out


def _blocks_on_card(design: str, blocks, weights, out, *, g: int) -> None:
    """Launch ``design``'s repack tap sum on checked CUDA tensors (its own
    limits are checked again in C, which returns an error that raises).
    The Hopper design's bulk copies and 16-byte stores need 16-byte aligned
    blocks and out: a misaligned one goes through an aligned copy."""
    nb, W = blocks.shape[0], blocks.shape[1]
    dest = out
    if design == "sm90":
        blocks = _aligned(blocks)
        if out.data_ptr() % 16:
            dest = torch.empty_like(out)
    _launch("stencil_sum_blocks", design, blocks.device, blocks.data_ptr(),
            dest.data_ptr(), weights.data_ptr(), nb, W - 2 * g, g,
            DTYPES[blocks.dtype])
    if dest is not out:
        out.copy_(dest)
