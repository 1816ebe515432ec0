"""Per-device cost of eager PyTorch code, counted op by op as it runs.

The torch counterpart of ``repro.roofline.hlo_cost``: flops, HBM bytes
and collective bytes (by kind) of a step, and its peak memory, from the
aten ops the step dispatches (a ``TorchDispatchMode``), with the JAX
package's op cost model:

- a matmul-family op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``:
  what ``@``, ``linear`` and ``einsum`` reach): 2 · |out| · K flops;
- an elementwise op |out| flops, a reduction |operand| flops; copies,
  casts, concatenations and fills 0 flops;
- a view (``view``, ``select``, ``slice``, ``expand``, ``permute``,
  ``t``, ``_unsafe_view``, ``detach``, ...) 0 flops and 0 bytes, so a
  layer's slice of a stacked (L, ...) weight is charged where a product
  reads the slice; an allocation (``empty``) moves nothing either;
- a gather or index op 2 · |out| bytes, a scatter or ``index_put`` 2 ·
  |update| bytes (the buffer it writes into is aliased, not rewritten),
  ``copy_`` its source plus its destination;
- every other op its operands plus its result;
- a collective (``_c10d_functional``, ``_dtensor.shard_dim_alltoall``)
  its result bytes under the JAX package's kind (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), besides its HBM bytes.

This module is much smaller than ``hlo_cost.py`` because eager PyTorch
has nothing to recover: a Python loop runs unrolled, so there are no
loop trip counts to read, and every op reads its operands from HBM and
writes its result there, so the bytes at op boundaries are exactly the
eager traffic (there are no fusions to open).

Per device: on DTensor arguments the mode steps aside
(``NotImplemented``), so the ops it counts are DTensor's local ones, on
this rank's shards, and the collectives DTensor issues. DTensor's own
bookkeeping is host work, not the step's. Most of it runs only the first
time DTensor meets an op and its shardings, and is cached after: its
sharding propagation (on ``FakeTensor``\\ s, which the count skips, or on
meta tensors and a throwaway ``DeviceMesh`` where it decomposes an op),
its planning of a redistribute and a mesh's construction. So count a
step in steady state, after one run of it (``launch.dryrun.run_cell``
counts its second step). One piece runs in every step:
``_StridedShard.local_shard_size_and_offset`` (the placement DTensor
gives a dim after a view that merges or splits a sharded dim) works out
the local indices with index tensors on the host; the count skips the ops
run from that function's frame. A host-to-device copy is counted as any
copy: a steady-state step makes none (its device constants are cached
by the first run). A
CUDA kernel launched outside the dispatcher (``kernels/_build.launch``)
is charged by its wrapper through :func:`charge_kernel`: its operands
plus its result in bytes and 0 flops, as ``hlo_cost.py`` charges a
custom call, and listed under ``kernels`` so that a reader sees what the
count does not open.

Peak memory: each storage a counted op creates is tracked once, from its
creation until its last reference goes; ``memory`` holds the arguments'
bytes, the outputs', the peak of the step's own live bytes and the
temporaries (the peak less what is still alive at the end), the
counterpart of XLA's ``memory_analysis``. ``torch_raw`` keeps the global
count of ``torch.utils.flop_counter.FlopCounterMode`` (matmuls at the
DTensor level, global shapes), as the JAX record keeps XLA's loop-blind
count as ``xla_raw``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCost", "COLLECTIVES", "count", "charge_kernel", "tree_bytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten

# matmul family: the index of the operand whose last dim is K
_MATMUL = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
           _aten.dot.default: 0, _aten.addmm.default: 1,
           _aten.baddbmm.default: 1, _aten.addbmm.default: 1,
           _aten.addmv.default: 1}

# 0 flops and 0 bytes besides views: aliases, wrappers and allocations
_FREE = {_aten._unsafe_view.default, _aten.detach.default,
         _aten.lift_fresh.default, _aten._local_scalar_dense.default,
         _aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten.sym_size.int,
         _aten.sym_stride.int, _aten.sym_numel.default,
         _aten.is_same_size.default}

# data movement: 0 flops (pointwise-tagged copies included)
_MOVES = {_aten.clone.default, _aten._to_copy.default, _aten.copy_.default,
          _aten.copy.default, _aten.cat.default, _aten.stack.default,
          _aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default,
          _aten.repeat.default, _aten.constant_pad_nd.default,
          _aten.slice_backward.default, _aten.select_backward.default,
          _aten.embedding_dense_backward.default, _aten.tril.default,
          _aten.triu.default}

# gathers: 2 · |out| bytes, 0 flops
_GATHERS = {_aten.index.Tensor, _aten._unsafe_index.Tensor,
            _aten.gather.default, _aten.index_select.default,
            _aten.embedding.default, _aten.take.default}

# scatters: 2 · |update| bytes, 0 flops; the index of the update operand
_SCATTERS = {_aten.index_put.default: 2, _aten.index_put_.default: 2,
             _aten._index_put_impl_.default: 2, _aten.scatter.src: 3,
             _aten.scatter_.src: 3, _aten.scatter.value: 2,
             _aten.scatter_.value: 2, _aten.scatter_add.default: 3,
             _aten.scatter_add_.default: 3, _aten.scatter_reduce.two: 3,
             _aten.index_add.default: 3, _aten.index_add_.default: 3,
             _aten.index_copy.default: 3, _aten.index_copy_.default: 3,
             _aten.slice_scatter.default: 1, _aten.select_scatter.default: 1,
             _aten.diagonal_scatter.default: 1,
             _aten.as_strided_scatter.default: 1}

# reductions the op tags do not mark: |operand| flops
_REDUCTIONS = {_aten._softmax.default, _aten._log_softmax.default,
               _aten._softmax_backward_data.default,
               _aten._log_softmax_backward_data.default,
               _aten.cumsum.default, _aten.topk.default, _aten.sort.default,
               _aten.sort.stable, _aten.argsort.default, _aten.argsort.stable,
               _aten.searchsorted.Tensor}

# collective name fragments -> the JAX package's kinds
_COLL_KIND = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
              ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
              ("alltoall", "all-to-all"), ("permute", "collective-permute"))
_COLL_FREE = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def tree_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on this device (a DTensor's local
    shard), each tensor once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(_local(t))
    return total


@dataclass
class OpCost:
    """What one counted region cost this device. Integers throughout:
    flops, HBM bytes, collective result bytes by kind, flops by kind
    (``matmul``, ``elementwise``, ``reduction``), the matmul flops by
    operand dtype (what runs on the tensor cores), bytes by aten op,
    the kernels charged by their wrappers, the memory record and the
    global ``FlopCounterMode`` count."""
    flops: int = 0
    bytes: int = 0
    coll_bytes: dict = field(default_factory=lambda: {k: 0 for k in COLLECTIVES})
    flops_by_kind: dict = field(default_factory=lambda: {
        "matmul": 0, "elementwise": 0, "reduction": 0})
    matmul_flops_by_dtype: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)
    torch_raw: dict = field(default_factory=dict)

    def add_bytes(self, op: str, n: int) -> None:
        self.bytes += n
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + n

    def add_flops(self, kind: str, n: int) -> None:
        self.flops += n
        self.flops_by_kind[kind] += n

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": dict(self.coll_bytes),
                "flops_by_kind": dict(self.flops_by_kind),
                "matmul_flops_by_dtype": dict(self.matmul_flops_by_dtype),
                "bytes_by_op": dict(self.bytes_by_op),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "memory": dict(self.memory), "torch_raw": dict(self.torch_raw)}


_ACTIVE: list["_CostMode"] = []
_LOCK = threading.RLock()  # storage finalizers may run while it is held


def charge_kernel(name: str, operands, results) -> None:
    """Charge a kernel launched outside the dispatcher to every open count:
    its operands plus its results in bytes, 0 flops, one launch under
    ``kernels[name]``."""
    if not _ACTIVE:
        return
    n = sum(_nbytes(t) for t in _tensors(operands) + _tensors(results))
    with _LOCK:
        for mode in _ACTIVE:
            k = mode.cost.kernels.setdefault(name, {"launches": 0, "bytes": 0})
            k["launches"] += 1
            k["bytes"] += n
            mode.cost.add_bytes(name, n)


# DTensor's bookkeeping that runs in every step (the module docstring):
# a strided shard's host-side index arithmetic
_BOOKKEEPING_FILE = os.path.join("distributed", "tensor", "placement_types.py")
_BOOKKEEPING_FUNC = "local_shard_size_and_offset"


def _bookkeeping() -> bool:
    """Whether the op being dispatched runs from DTensor's
    ``local_shard_size_and_offset`` (a frame of it is on the stack)."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if code.co_name == _BOOKKEEPING_FUNC \
                and code.co_filename.endswith(_BOOKKEEPING_FILE):
            return True
        f = f.f_back
    return False


def _coll_kind(func) -> str | None:
    """The JAX package's kind of a collective op, "" for a collective's
    free wrapper, None for any other op."""
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns == "_dtensor" and "alltoall" in name:
        return "all-to-all"
    if ns not in ("_c10d_functional", "c10d_functional", "c10d"):
        return None
    if any(f in name for f in _COLL_FREE):
        return ""
    for frag, kind in _COLL_KIND:
        if frag in name:
            return kind
    return name


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.live = 0
        self.peak = 0
        self._tracked: set[int] = set()

    # -- memory
    def _free(self, key: int, n: int) -> None:
        with _LOCK:
            if key in self._tracked:
                self._tracked.discard(key)
                self.live -= n

    def _track(self, outs, operands) -> None:
        mine = {id(t.untyped_storage()) for t in operands
                if t.layout == torch.strided}
        for t in outs:
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in mine or key in self._tracked:
                continue
            n = st.nbytes()
            with _LOCK:
                self._tracked.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    # -- cost
    def _charge(self, func, args, operands, outs) -> None:
        c = self.cost
        op = str(func.overloadpacket)
        kind = _coll_kind(func)
        if kind == "":
            return
        if kind is not None:
            ob = sum(_nbytes(t) for t in outs)
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) + ob
            c.add_bytes(op, sum(_nbytes(t) for t in operands) + ob)
            return
        if func.is_view or func in _FREE:
            return
        if func in _MATMUL:
            a = args[_MATMUL[func]]
            n = 2 * sum(t.numel() for t in outs) * a.shape[-1]
            c.add_flops("matmul", n)
            dt = str(a.dtype).replace("torch.", "")
            c.matmul_flops_by_dtype[dt] = c.matmul_flops_by_dtype.get(dt, 0) + n
            c.add_bytes(op, sum(_nbytes(t) for t in operands + outs))
            return
        if func in _GATHERS:
            c.add_bytes(op, 2 * sum(_nbytes(t) for t in outs))
            return
        if func in _SCATTERS:
            i = _SCATTERS[func]
            upd = args[i] if len(args) > i else None
            if isinstance(upd, torch.Tensor):
                n = _nbytes(upd)
            else:  # a scalar value: one element of the target per index
                n = args[2].numel() * args[0].element_size()
            c.add_bytes(op, 2 * n)
            return
        if func is _aten.copy_.default:
            c.add_bytes(op, _nbytes(args[0]) + _nbytes(args[1]))
            return
        c.add_bytes(op, sum(_nbytes(t) for t in operands + outs))
        if func in _MOVES:
            return
        tags = func.tags
        if torch.Tag.reduction in tags or func in _REDUCTIONS:
            c.add_flops("reduction", operands[0].numel() if operands else 0)
        elif torch.Tag.pointwise in tags:
            c.add_flops("elementwise", sum(t.numel() for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(x, DTensor) for x in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        operands = [x for x in flat if isinstance(x, torch.Tensor)]
        outs = _tensors(out)
        if any(isinstance(x, FakeTensor) for x in operands + outs) \
                or _bookkeeping():
            return out
        self._charge(func, args, operands, outs)
        self._track(outs, operands)
        return out


@contextlib.contextmanager
def count(args=None):
    """Count what runs inside the ``with`` block on this device; yields
    the :class:`OpCost`, complete when the block ends. ``args`` (a tree of
    tensors) are the step's arguments: their bytes on this device are
    ``memory["argument_bytes"]``. Set ``memory["output_bytes"]`` yourself
    (:func:`tree_bytes` of the step's result) where it matters. The block
    also runs under ``FlopCounterMode`` for ``torch_raw``."""
    from torch.utils.flop_counter import FlopCounterMode

    cost = OpCost()
    mode = _CostMode(cost)
    raw_mode = FlopCounterMode(display=False)
    with _LOCK:
        _ACTIVE.append(mode)
    try:
        with mode, raw_mode:
            yield cost
    finally:
        with _LOCK:
            _ACTIVE.remove(mode)
        cost.memory = {"argument_bytes": tree_bytes(args) if args is not None else 0,
                       "output_bytes": cost.memory.get("output_bytes", 0),
                       "peak_bytes": mode.peak,
                       "temp_bytes": mode.peak - mode.live,
                       "live_at_end_bytes": mode.live}
        cost.torch_raw = {"flops": int(raw_mode.get_total_flops())}
