"""What a run's windows hand the metrics and the comparison.

A traced run serves one window without the profiler, which the
per-layer metrics of the host's clock read, then one under it; the
prefill comparison holds the first request of every length served; the
training comparison holds the window's last step. On the CPU at a
test's size."""

import random
import time

import pytest
import torch

from bench import harness
from bench.loops import prefill_requests
from bench.tests._cells import tiny_cell


def _run(cell, trace=False, seed=2 ** 31 + 23, seconds=0.2):
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


def test_a_traced_run_reads_the_host_clock_from_its_untraced_window():
    cell = tiny_cell("wave-m256.hilbert")
    out = _run(cell, trace=True)
    plain, run = out["plain"], out["run"]
    assert plain is not run and plain.units and run.units
    assert plain.trace is None and run.trace is not None
    assert harness.is_correct(out), out["checks"]
    metrics = harness.read_metrics(out, True)
    want = harness.metric_reader("step_mfu").read(plain)
    assert metrics["step_mfu.stencil"]["value"] == pytest.approx(want)
    assert want != pytest.approx(harness.metric_reader("step_mfu").read(run), rel=1e-12)


def test_an_untraced_run_serves_one_window():
    out = _run(tiny_cell("wave-m256.hilbert"))
    assert out["plain"] is out["run"]
    assert set(harness.read_metrics(out, False)) == {"stencil_glups", "setup_s"}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 12345])
def test_the_prefill_sample_holds_the_first_request_of_every_length(seed):
    cell = tiny_cell("smollm-360m.prefill-long")
    cell.traffic.update(lengths={"128": 5, "256": 3, "512": 1}, check_requests=5)
    loop = prefill_requests.Loop(cell, seed, torch.device("cpu"), lambda: None)
    rng = random.Random(seed)
    lengths = [rng.choice([128, 128, 128, 256, 256, 512]) for _ in range(60)]
    loop.units = [harness.Unit(i, i + 1, {"tokens": L}) for i, L in enumerate(lengths)]
    picked = loop.sample()
    assert len(picked) == 5 and len({id(u) for u in picked}) == 5
    for L in set(lengths):
        first = next(u for u in loop.units if u.work["tokens"] == L)
        assert any(u is first for u in picked), L


def test_the_training_comparison_holds_the_windows_last_step():
    cell = tiny_cell("smollm-360m.train-4k")
    out = _run(cell, seconds=0.5)
    loop = out["loop"]
    assert harness.is_correct(out), out["checks"]
    assert "window_change_gap" in {c.name for c in out["checks"]}
    assert loop.snap["step"] == loop.next_step - 1 >= cell.traffic["compared_steps"]
    assert loop.snap["loss"] == loop.window_step["loss"]
