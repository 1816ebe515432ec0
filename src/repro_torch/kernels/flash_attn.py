"""Flash attention with a space-filling-curve block schedule: the wrapper
of the CUDA kernel.

The torch counterpart of ``repro.kernels.flash_attn``: ``build_schedule``
(numpy, array-equal to the JAX package's) and ``flash_attention_fwd``,
with the same signature minus ``interpret``. Two hand-written CUDA
designs compute it, and :func:`flash_design` (a pure function of dtype, D
and the block sizes) picks one: ``csrc/flash_attn_sm90.cu`` (wgmma on the
tensor cores, TMA-fed K/V ring, warp specialisation) for bf16 with D and
both blocks in {64, 128}, the simple design ``csrc/flash_attn.cuh`` (one
thread per q row, D/128 above a head dim of 128, f32 on the CUDA cores;
above 1024 one thread per (q row, key) and the accumulator in an f32
workspace; one library per element type, ``csrc/flash_attn_<type>.cu``)
for every other case: f32, f16 and fp8 q, k, v and every head dim among
them. Either takes any number of folded heads.

The (q-block × kv-block) score grid is a 2D index space (DESIGN.md §5);
on the TPU one sequential grid walks its cells in curve order. On the GPU
the thread blocks run in parallel, one per (head, q block): the curve
orders the q blocks (the order in which the thread blocks are handed out)
and, within one, its kv blocks. The plan that says so is built once per
grid shape and kept on the device.

The device decides the path: a CUDA tensor launches the kernel or raises,
a CPU tensor runs the plain version (kernels/ref.flash_attention_ref).
Each launch adds one to ``LAUNCHES["flash_attention_fwd"]`` and one to its
design's count in ``FLASH_DESIGN_LAUNCHES`` (kernels/_build.py), and is
charged to an open ``roofline.op_cost.count`` (its q, k, v and output in
bytes, 0 flops): the launch itself goes past the dispatcher.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core.layout import device_constant
from repro_torch.core.orderings import path_index_2d
from repro_torch.roofline import op_cost

from . import _build, ref

__all__ = ["SCHEDULES", "build_schedule", "flash_attention_fwd", "flash_design",
           "pad_head_dim", "schedule_plan"]

# The dtypes the kernels take, by the simple design's library of each
# (csrc/flash_attn_<type>.cu).
_DTYPES = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16",
           torch.float16: "flash_attn_f16",
           torch.float8_e4m3fn: "flash_attn_e4m3",
           torch.float8_e5m2: "flash_attn_e5m2"}
_MAX_BLOCK = 128
_MAX_REG_HEAD_DIM = 1024  # wider head dims take the simple design's wide instance
_SM90_SIZES = (64, 128)  # D, block_q and block_k of the sm90 design
SCHEDULES = ("row_major", "morton", "hilbert")


def build_schedule(nq: int, nk: int, *, causal: bool, block_q: int,
                   block_k: int, kind: str = "morton",
                   offs: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Cell visit order over the (nq × nk) block grid.

    Returns (iq_of_t, ik_of_t) int32 arrays of equal length = #visited
    cells. Causal filtering keeps cells whose block intersects
    ``col <= row + offs`` (offs = Sk - Sq aligns the diagonal at the end).
    """
    if kind == "row_major":
        cells = [(iq, ik) for iq in range(nq) for ik in range(nk)]
    else:
        n = 1 << max(0, (max(nq, nk) - 1)).bit_length()
        n = max(n, 2)
        seq = path_index_2d(kind, n)
        cells = [divmod(int(t), n) for t in seq]
        cells = [(iq, ik) for iq, ik in cells if iq < nq and ik < nk]
    if causal:
        cells = [(iq, ik) for iq, ik in cells
                 if ik * block_k <= (iq + 1) * block_q - 1 + offs]
    iq = np.array([c[0] for c in cells], dtype=np.int32)
    ik = np.array([c[1] for c in cells], dtype=np.int32)
    return iq, ik


def schedule_plan(nq: int, nk: int, *, causal: bool, block_q: int,
                  block_k: int, kind: str, offs: int) -> np.ndarray:
    """The kernel's plan, int32 ``[q_order (nq) | row_ptr (nq+1) | cols]``:
    the q blocks in the order the schedule first visits them (then those
    it never visits, whose rows see no key), and for each q block its kv
    blocks in the order the schedule visits them (CSR by q block)."""
    iq, ik = build_schedule(nq, nk, causal=causal, block_q=block_q,
                            block_k=block_k, kind=kind, offs=offs)
    seen, first = np.unique(iq, return_index=True)
    order = np.concatenate([seen[np.argsort(first)],
                            np.setdiff1d(np.arange(nq), seen)])
    cols = ik[np.argsort(iq, kind="stable")]
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(iq, minlength=nq))])
    return np.concatenate([order, row_ptr, cols]).astype(np.int32)


def flash_design(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> str:
    """The CUDA design ``flash_attention_fwd`` launches for these
    arguments: ``"sm90"`` (``csrc/flash_attn_sm90.cu``) for bf16 with D,
    block_q and block_k each 64 or 128; ``"simple"``
    (``csrc/flash_attn.cuh``) for every other case, any head dim among
    them. Nothing else, and never a failure, decides it."""
    if dtype == torch.bfloat16 and d in _SM90_SIZES and block_q in _SM90_SIZES \
            and block_k in _SM90_SIZES:
        return "sm90"
    return "simple"


@functools.cache
def _lib(design: str, dtype: torch.dtype) -> tuple[ctypes.CDLL, object]:
    """The library of ``design`` for ``dtype`` and its C entry point."""
    if design == "sm90":
        lib = _build.library("flash_attn_sm90")
        fn = lib.repro_flash_attention_fwd_sm90
    else:
        lib = _build.library(_DTYPES[dtype])
        fn = lib.repro_flash_attention_fwd
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the simple design's entry also takes the wide instance's workspace
    fn.argtypes = [p] * (5 if design == "sm90" else 6) + [i] * 7 + [f, p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(q, k, v, block_q: int, block_k: int, schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; use one of {SCHEDULES}")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"q must be (BH, Sq, D) and k, v (BH, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, D = q.shape
    if k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in "
                         "BH or D")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32, bfloat16, float16, "
                        f"float8_e4m3fn or float8_e5m2, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.device.type not in ("cpu", "cuda") or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"q, k and v must lie on one cuda or cpu device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if D < 1:
        raise ValueError(f"head dim {D} is not at least 1")
    for name, b, s in (("block_q", block_q, Sq), ("block_k", block_k, k.shape[1])):
        if not 1 <= b <= _MAX_BLOCK or s % b:
            raise ValueError(f"{name}={b} must lie in [1, {_MAX_BLOCK}] and "
                             f"divide the sequence ({s})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, block_q: int = 64,
                        block_k: int = 64, schedule: str = "morton") -> torch.Tensor:
    """Flash attention forward. q: (BH, Sq, D); k, v: (BH, Sk, D).

    Heads are pre-folded into the batch axis (ops.py handles GQA). f32,
    bf16, f16, float8_e4m3fn or float8_e5m2, arithmetic in f32, output in
    q's dtype (rounded once, as kernels/ref.round_to rounds); the causal
    diagonal is aligned to the end and a row with no key gives 0. Any D
    and any BH; block_q and block_k are at most 128 and divide Sq and Sk
    (ops.py picks them, as the JAX package does). Anything else raises. The
    output does not depend on ``schedule`` beyond f32 rounding. On the
    card :func:`flash_design` picks the kernel; a failed build or launch
    raises.
    """
    _check(q, k, v, block_q, block_k, schedule)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _fwd_on_card(flash_design(q.dtype, q.shape[2], block_q, block_k),
                        q, k, v, causal, block_q, block_k, schedule)


def _fwd_on_card(design: str, q, k, v, causal, block_q: int, block_k: int,
                 schedule: str) -> torch.Tensor:
    """Launch ``design``'s kernel on checked CUDA tensors (its own limits
    are checked again in C, which returns an error that raises). A head
    dim that is not a multiple of 8 is zero-padded for the kernel's
    16-byte loads (:func:`pad_head_dim`); the scale stays 1/sqrt(D) of
    the true D and the padded columns are sliced off the output. Above a
    padded head dim of 1024 the simple design keeps its f32 accumulator in
    a workspace of one float per output element."""
    D = q.shape[2]
    q, k, v = pad_head_dim(q, k, v)
    BH, Sq, Dp = q.shape
    Sk = k.shape[1]
    nq, nk, offs = Sq // block_q, Sk // block_k, Sk - Sq
    plan = device_constant(
        ("flashplan", nq, nk, bool(causal), block_q, block_k, schedule, offs),
        lambda: schedule_plan(nq, nk, causal=bool(causal), block_q=block_q,
                              block_k=block_k, kind=schedule, offs=offs),
        q.device)
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)
    lib, fn = _lib(design, q.dtype)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if design == "simple":
        ws = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
            if Dp > _MAX_REG_HEAD_DIM else None
        ptrs.append(None if ws is None else ws.data_ptr())
    _build.launch(lib, "flash_attention_fwd", fn, q.device, *ptrs,
                  plan.data_ptr(), BH, Sq, Sk, Dp, block_q, block_k,
                  int(bool(causal)), 1.0 / math.sqrt(D))
    _build.FLASH_DESIGN_LAUNCHES[design] += 1
    op_cost.charge_kernel("flash_attention_fwd", (q, k, v), out)
    return out if Dp == D else out[..., :D].contiguous()


def pad_head_dim(q, k, v):
    """q, k and v with the head dim zero-padded to a multiple of 8 (the
    unchanged tensors when it is one). Zero columns add nothing to the
    scores q·k, and the output's padded columns are zero."""
    D = q.shape[-1]
    pad = -D % 8
    if not pad:
        return q, k, v
    padded = []
    for t in (q, k, v):  # zeros, then a copy: F.pad has no fp8 kernels
        z = t.new_zeros(t.shape[:-1] + (D + pad,))
        z[..., :D] = t
        padded.append(z)
    return tuple(padded)
