"""Reading a ``torch.profiler`` trace of the measured window.

The raw events of the finished trace (``kineto_results.events()``) are
read directly, as ``chip_smoke.device_ms_by_name`` sums them: building
the profiler's event tree (``key_averages``) takes seconds per hundred
thousand events. Times are the profiler's own clock, nanoseconds since
the epoch, the clock of ``time.time_ns()``.

Device events are kernels, copies and sets. A ``record_function`` range
also appears on the device's timeline as an annotation spanning the
kernels launched inside it: those are kept apart, by name, as ranges.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag())


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _covered(merged: list[tuple[int, int]], lo: int, hi: int) -> int:
    """ns of [lo, hi) that the merged intervals cover."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


@dataclass
class Trace:
    """What a traced window holds: device events (name, start, end),
    device-side annotation ranges by name, host events (name, start,
    end, is an annotation), and the window [t0, t1) in ns."""
    t0: int
    t1: int
    device: list[tuple[str, int, int]] = field(default_factory=list)
    ranges: dict[str, list[tuple[int, int]]] = field(default_factory=dict)
    host: list[tuple[str, int, int, bool]] = field(default_factory=list)

    @classmethod
    def of(cls, prof, t0_ns: int, t1_ns: int) -> "Trace":
        from torch.autograd import DeviceType

        tr = cls(t0_ns, t1_ns)
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if _is_annotation(e):
                    tr.ranges.setdefault(e.name(), []).append((s, end))
                elif end > s:
                    tr.device.append((e.name(), s, end))
            else:
                tr.host.append((e.name(), s, end, _is_annotation(e)))
        return tr

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        return _union([(s, e) for _, s, e in self.device])

    def busy_s(self) -> float:
        return _covered(self.busy(), self.t0, self.t1) / 1e9

    def kernel_s(self, match) -> tuple[float, int]:
        """(device seconds, events) of the device events whose name
        ``match(name)`` accepts."""
        hits = [e - s for name, s, e in self.device if match(name)]
        return sum(hits) / 1e9, len(hits)

    def range_busy_s(self, name: str) -> tuple[float, int]:
        """(device seconds busy inside the annotation ranges ``name``,
        number of ranges)."""
        spans = self.ranges.get(name, [])
        merged = self.busy()
        return sum(_covered(merged, s, e) for s, e in spans) / 1e9, len(spans)

    def top_ops(self, n: int = 10) -> list[list]:
        by = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest stretches of the window with no device event, each
        named by what the host was doing at its middle: the outermost
        annotation there and the innermost host operation."""
        edges = [self.t0] + [x for se in self.busy() for x in se] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for s, e in gaps:
            mid = (s + e) // 2
            over = [h for h in host if h[1] <= mid < h[2]]
            outer = [h for h in over if h[3]]
            inner = [h for h in over if not h[3]]
            what = []
            if outer:
                what.append(min(outer, key=lambda h: h[1])[0])
            if inner:
                what.append(max(inner, key=lambda h: h[1])[0])
            out.append([" > ".join(what) or "python (no host op)", (e - s) / 1e9])
        return out
