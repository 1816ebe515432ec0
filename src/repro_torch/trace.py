"""Program spans: ``torch.profiler`` ranges at the port's layer boundaries.

A span is a ``record_function`` range. The profiler keeps it in memory on
the clock of its device events, and on the device's timeline it becomes
an annotation spanning the kernels launched inside it, which is how a
trace attributes device time to the program's layers. With the profiler
off, :func:`span` and :func:`sublayer` return one shared no-op after a
flag check, and nothing else runs.

A sublayer span (:func:`sublayer`) also covers its backward. The range is
held open on the thread that runs the code, and on CUDA autograd runs the
backward on a thread of its own, whose kernels a range held open around
``torch.autograd.grad`` does not claim. So, where grad is enabled, the
span hooks its edges in the autograd graph and inserts no node: a hook
on its output's node opens a range of the same name in the backward, a
hook on its grad-carrying input's gradient closes it, and both run on the
backward's thread. Where one sublayer's output is the next one's input,
autograd runs the tensor's hook (closing the later sublayer's range)
before its node's (opening the earlier one's), so the ranges never
overlap. Inside a backward (remat's recompute of a layer's forward) a
sublayer span does not open; :func:`recompute` opens ``model.recompute``
there instead.

The spans and what they cover:

- ``model.attention``: the attention sublayer (its norm, projections,
  RoPE, attention, output projection and residual add);
- ``kernels.flash_attention``: the flash wrapper, forward and backward,
  inside ``model.attention``;
- ``model.mlp``: the FFN sublayer (its norm, FFN and residual add);
- ``model.head``: the final norm, the logits and the loss;
- ``model.recompute``: a layer's forward rerun by remat in the backward;
- ``adamw_update``: the optimizer (``train/train_step.py``);
- ``stencil.blockize``, ``stencil.unblockize``: a resident pipeline's
  curve layout into blocks and back (``stencil/pipeline.ResidentPipeline.run``).
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "sublayer", "recompute", "in_backward"]

# ``_profiler._is_profiler_enabled`` is the flag the spans check: the
# profiler sets it on entry and clears it on exit, for every thread (the
# backward's too), where ``torch._C._autograd._profiler_enabled()`` reads
# the calling thread's state.


def in_backward() -> bool:
    """Whether the caller runs inside autograd's backward."""
    return torch._C._current_graph_task_id() != -1


class _Off:
    """The span with the profiler off: enters, leaves and marks nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def input(self, t):
        return t

    def output(self, t):
        return t


_OFF = _Off()


def span(name: str):
    """A ``record_function(name)`` range around the code of a ``with``
    block while the profiler records, else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


class _Sublayer(_profiler.record_function):
    """A range around a sublayer's forward whose :meth:`input` and
    :meth:`output` hook the edges of its backward's range."""

    def __init__(self, name: str):
        super().__init__(name)
        self.marked = False
        self.back = None

    def input(self, t):
        """``t`` (the sublayer's grad-carrying input: an activation, or the
        weight of a gather), hooked where it carries a gradient."""
        if torch.is_grad_enabled() and t.requires_grad:
            self.marked = True
            t.register_hook(self._close)
        return t

    def output(self, t):
        """``t`` (the sublayer's output), hooked where its input was."""
        if self.marked and t.grad_fn is not None:
            t.grad_fn.register_prehook(self._open)
        return t

    def _open(self, grads):
        self.back = _profiler.record_function(self.name)
        self.back.__enter__()

    def _close(self, grad):
        if self.back is not None:
            self.back.__exit__(None, None, None)
            self.back = None


def sublayer(name: str):
    """A span of a sublayer, forward and backward: a ``with`` block whose
    target marks the input with ``.input(x)`` and the output with
    ``.output(y)``. The shared no-op with the profiler off, or inside a
    backward."""
    if not _profiler._is_profiler_enabled or in_backward():
        return _OFF
    return _Sublayer(name)


def recompute():
    """The span ``model.recompute`` where the caller runs inside a backward
    while the profiler records (remat rerunning a layer's forward), else
    the shared no-op."""
    if not _profiler._is_profiler_enabled or not in_backward():
        return _OFF
    return _profiler.record_function("model.recompute")
