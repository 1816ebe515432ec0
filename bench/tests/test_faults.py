"""A run with the timed path broken underneath comes out not correct.

Each cell's run is driven as ``bench/run.py`` drives it (set-up, window,
release, the comparison with the reference), on the CPU at a test's size
and with the committed limits, once sound and once with each fault of
``bench/faults.py`` that the cell can have planted in the program."""

import time

import pytest
import torch

from bench import faults, harness
from bench.tests._cells import tiny_cell

CASES = [(name, fault) for name in ("wave-m256.hilbert", "smollm-360m.train-4k",
                                    "smollm-360m.prefill-long")
         for fault in (None, *faults.FAULTS[harness.resolve(name).loop])]


def _run(cell, seed=2 ** 31 + 11):
    return harness.run_cell(cell, seed, 0.2, False, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("name, fault", CASES)
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    cell = tiny_cell(name)
    if fault is None:
        out = _run(cell)
        assert harness.is_correct(out), out["checks"]
        return
    with getattr(faults, fault)():
        out = _run(cell)
    assert out["run"].units
    assert not harness.is_correct(out), out["checks"]
