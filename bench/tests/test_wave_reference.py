"""The plain wave reference against the port's CPU path at M=16: bit for
bit, since both take the taps in dk, di, dj order with no fused
multiply-add, under every block order the cells use."""

import pytest
import torch

from bench.reference.wave import wave_run


def _fields(seed=0, M=16):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, M, M, M), generator=g) - 0.5


@pytest.mark.parametrize("kind", ["hilbert", "row_major", "morton"])
def test_reference_equals_the_port_bit_for_bit(kind):
    from repro_torch.stencil.pipeline import ResidentPipeline

    x = _fields()
    port = ResidentPipeline(M=16, T=8, g=1, kind=kind, S=4, rule="wave",
                            device="cpu").run(x, 12)
    assert torch.equal(port, wave_run(x, 12))


def test_reference_leaves_its_input_and_moves_the_state():
    x = _fields(1)
    before = x.clone()
    out = wave_run(x, 3)
    assert torch.equal(x, before)
    assert (out - x).abs().max() > 0


def test_a_bfloat16_store_rounds_away_from_float32():
    x = _fields(2)
    assert (wave_run(x, 4, store_dtype=torch.bfloat16) - wave_run(x, 4)).abs().max() > 0
