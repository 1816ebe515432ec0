"""Each cell's control, at a size a test run holds, fails the committed
limits: the program's own bfloat16 store for the float32 stencil, and
the reference in fp8 products in the program's place for the bf16 model.
On the card ``bench/controls.py --mode control`` reads the same at the
cells' own sizes."""

import time

import pytest
import torch

from bench import harness
from bench.tests._cells import tiny_cell


@pytest.mark.parametrize("name", ["wave-m256.hilbert", "wave-m256.row-major",
                                  "smollm-360m.train-4k", "smollm-360m.prefill-long"])
def test_the_control_fails_a_limit(name):
    cell = tiny_cell(name)
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.2, False, torch.device("cpu"),
                           time.perf_counter())
    assert harness.is_correct(out), out["checks"]
    control = out["loop"].control()
    assert not all(c.ok for c in control), control
