"""The benchmark's frozen arithmetic gives the bounds the kernel table of
PERF.md was measured against."""

import json
from pathlib import Path

import pytest

from bench import work

ROOT = Path(__file__).resolve().parents[2]


def _ms(x):
    return round(1e3 * x, 4)


def test_gol_fused_bound_at_the_main_path():
    # PERF.md's kernel table, row 1: M=256, T=8, S=4, g=1, gol, f32
    flops, nbytes = work.fused_launch(256, 8, 1, 4, "gol", 1)
    assert _ms(work.bound_s(flops, nbytes, "float32")) == 0.0541
    assert flops / work.PEAK_FLOP_PER_S["float32"] > nbytes / work.HBM_BYTES_PER_S


def test_wave_fused_bound_is_bytes():
    flops, nbytes = work.fused_launch(256, 8, 1, 4, "wave", 2)
    assert flops == 4 * 256 ** 3 * (54 + 9)
    assert _ms(work.fused_launch_bound_s(256, 8, 1, 4, "wave", 2)) == 0.0812
    assert nbytes / work.HBM_BYTES_PER_S > flops / work.PEAK_FLOP_PER_S["float32"]


@pytest.mark.parametrize("fn, want", [(work.flash_fwd, 0.1303), (work.flash_bwd, 0.3258)])
def test_flash_bounds_at_the_training_shape(fn, want):
    # PERF.md's kernel table, rows 5: BH=60, S=4096, D=64, bf16, causal
    flops, nbytes = fn(60, 4096, 64)
    assert _ms(work.bound_s(flops, nbytes, "bfloat16")) == want


def test_smollm_model_flops():
    cfg = json.loads((ROOT / "bench/configs/smollm-360m.json").read_text())
    assert work.lm_weight_params(cfg) == 32 * 9_830_400 + 960 * 49152
    train = work.lm_train_flops(cfg, 8, 4096)
    assert 95.8e12 < train < 96.0e12
    # prefill: the trunk at every position, the head once
    S = 4096
    assert work.lm_prefill_flops(cfg, S) == pytest.approx(
        2 * 32 * 9_830_400 * S + 2 * 960 * 49152 + work.lm_attention_fwd_flops(cfg, S))
