"""The self time of the program's spans (``bench/spans.py``) and the seven
readers of it, on synthetic traces with nested ranges: a span's device
busy time less the part inside its listed children, per unit of the
window, and None where the program has no such span (an older program)."""

import pytest

from bench import harness, spans
from bench.devtrace import Trace

MS = 1_000_000  # ns


def _trace(ranges: dict, busy: list[tuple[int, int]]) -> Trace:
    return Trace(0, 1000 * MS, device=[("k", s * MS, e * MS) for s, e in busy],
                 ranges={n: [(s * MS, e * MS) for s, e in rs] for n, rs in ranges.items()})


def _run(cell: str, trace, units: int = 2) -> harness.Run:
    return harness.Run(harness.resolve(cell), [harness.Unit(0, 1)] * units, 1.0, 0.0,
                       trace)


# one training step: the forward, then the backward's ranges in reverse
# order, remat's recompute inside the last layer's mlp backward and
# flash's ranges inside attention and the recompute; the device idle in
# [140, 145)
STEP = {"model.embed": [(0, 10), (190, 200)],
        "model.attention": [(10, 40), (150, 190)],
        "kernels.flash_attention": [(20, 30), (110, 120), (160, 175)],
        "model.mlp": [(40, 60), (100, 150)],
        "model.head": [(60, 80), (80, 100)],
        "model.recompute": [(100, 130)],
        "adamw_update": [(200, 230)]}
STEP_BUSY = [(0, 5), (5, 140), (145, 230)]


def test_minus_and_overlap_of_merged_intervals():
    assert spans._minus([(0, 100)], [(20, 50)]) == [(0, 20), (50, 100)]
    assert spans._minus([(0, 10), (20, 30)], [(5, 25)]) == [(0, 5), (25, 30)]
    assert spans._minus([(0, 10)], [(-5, 0), (10, 15)]) == [(0, 10)]
    assert spans._minus([(0, 10)], [(0, 10)]) == []
    assert spans._minus([(0, 10), (12, 14)], []) == [(0, 10), (12, 14)]
    assert spans._overlap([(0, 10), (15, 30)], [(5, 20), (25, 40)]) == 5 + 5 + 5
    assert spans._overlap([], [(0, 10)]) == 0


def test_self_time_is_busy_time_less_the_children():
    tr = _trace({"p": [(0, 100)], "c": [(20, 50)]}, [(0, 10), (15, 30), (40, 60), (90, 120)])
    assert spans.self_s(tr, "p") == pytest.approx(55e-3)
    assert spans.self_s(tr, "p", ("c",)) == pytest.approx(35e-3)
    assert spans.self_s(tr, "c") == pytest.approx(20e-3)
    # a child the program does not have takes nothing off
    assert spans.self_s(tr, "p", ("absent",)) == pytest.approx(55e-3)
    # ranges of one span that overlap count once
    tr.ranges["p"].append((5 * MS, 25 * MS))
    assert spans.self_s(tr, "p") == pytest.approx(55e-3)


def test_a_span_the_program_lacks_reads_none():
    tr = _trace({"adamw_update": [(0, 10)]}, [(0, 10)])
    assert spans.self_s(tr, "model.mlp") is None
    assert spans.self_s(tr, ("stencil.blockize", "stencil.unblockize")) is None
    assert spans.ms_per_unit(_run("smollm-360m.train-4k", None), "model.mlp") is None
    assert spans.ms_per_unit(_run("smollm-360m.train-4k", tr, units=0), "adamw_update") is None


@pytest.mark.parametrize("name, want", [
    ("attention_ms.train", (20 + 25) / 2),   # less flash; the recompute lies elsewhere
    ("mlp_ms.train", (20 + 20 - 5) / 2),     # less the recompute, idle [140, 145)
    ("head_ms.train", (20 + 20) / 2),
    ("recompute_ms.train", 30 / 2),          # flash's recomputed forward included
])
def test_the_training_readers(name, want):
    run = _run("smollm-360m.train-4k", _trace(STEP, STEP_BUSY))
    assert harness.metric_reader(name).read(run) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("attention_ms.prefill", 3 * (30 - 10) / 3),
    ("mlp_ms.prefill", 3 * 15 / 3),
])
def test_the_prefill_readers(name, want):
    ranges = {"model.embed": [], "model.attention": [], "kernels.flash_attention": [],
              "model.mlp": [], "model.head": []}
    for r in range(3):  # three requests of one layer each
        at = 100 * r
        ranges["model.embed"].append((at, at + 5))
        ranges["model.attention"].append((at + 5, at + 35))
        ranges["kernels.flash_attention"].append((at + 10, at + 20))
        ranges["model.mlp"].append((at + 35, at + 50))
        ranges["model.head"].append((at + 50, at + 60))
    run = _run("smollm-360m.prefill-long", _trace(ranges, [(0, 300)]), units=3)
    assert harness.metric_reader(name).read(run) == pytest.approx(want)


@pytest.mark.parametrize("cell", ["wave-m256.hilbert", "wave-m256.row-major"])
def test_the_layout_reader_takes_both_layout_spans(cell):
    ranges = {"stencil.blockize": [(0, 2), (10, 12)],
              "stencil.steps": [(2, 9), (12, 19)],
              "stencil.unblockize": [(9, 10), (19, 20)]}
    busy = [(0, 1.5), (2, 9), (9, 10), (10, 12), (12, 19), (19.5, 20)]
    run = _run(cell, _trace(ranges, busy))
    assert harness.metric_reader("layout_ms.stencil").read(run) == pytest.approx(
        (1.5 + 1 + 2 + 0.5) / 2)


NEW = ["layout_ms.stencil", "attention_ms.prefill", "mlp_ms.prefill",
       "attention_ms.train", "mlp_ms.train", "head_ms.train", "recompute_ms.train"]


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_none_from_a_program_without_spans(name):
    cell = next(m for m in harness.load_spec()["per_layer"] if m["name"] == name)
    tr = _trace({"adamw_update": [(0, 10)], "bench.step": [(0, 20)]}, [(0, 20)])
    for w in cell["workloads"]:
        assert harness.metric_reader(name).read(_run(w, tr)) is None
        assert harness.metric_reader(name).read(_run(w, None)) is None


def test_the_new_metrics_are_program_spans_of_their_cells():
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for name in NEW:
        m = spec[name]
        assert (m["source"], m["unit"], m["better"]) == ("program_span", "ms", "lower")
        for w in m["workloads"]:
            assert name in {x["name"] for x in harness.resolve(w).per_layer}
