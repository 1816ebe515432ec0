"""Device time inside the program's spans, read from a traced window.

The program (``repro_torch.trace``) runs its layers in
``record_function`` ranges, forward and backward. On the device's
timeline each time a span ran is an annotation range (``Trace.ranges``)
from the first to the last device event launched inside it. A span's
self time is the device's busy time within its ranges, less the part
inside the ranges of the child spans listed. A span the program does not
have (an older program, a path that skips it) reads None.
"""

from __future__ import annotations

from bench.devtrace import _union


def _minus(keep: list[tuple[int, int]], cut: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The parts of the merged intervals ``keep`` outside the merged
    intervals ``cut``."""
    out, j = [], 0
    for s, e in keep:
        while j < len(cut) and cut[j][1] <= s:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < e:
            if cut[k][0] > s:
                out.append((s, cut[k][0]))
            s = max(s, cut[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def _overlap(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """ns that the merged intervals ``a`` and ``b`` share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_s(trace, names, minus=()) -> float | None:
    """Device seconds busy inside the ranges of the span ``names`` (a
    name, or several, taken together), less the part inside the ranges of
    the spans ``minus``; None where no span of ``names`` ran."""
    names = (names,) if isinstance(names, str) else names
    ranges = [r for n in names for r in trace.ranges.get(n, [])]
    if not ranges:
        return None
    cut = _union([r for n in minus for r in trace.ranges.get(n, [])])
    return _overlap(trace.busy(), _minus(_union(ranges), cut)) / 1e9


def ms_per_unit(run, names, minus=()) -> float | None:
    """:func:`self_s` in ms per unit of the traced window (a job, a step,
    a request); None without a trace, a unit or the span."""
    if run.trace is None or not run.units:
        return None
    s = self_s(run.trace, names, minus)
    return None if s is None else 1e3 * s / len(run.units)
