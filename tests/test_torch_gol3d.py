"""The slice end to end: the torch package's gol3d (resident fused path and
repack path) and wave pipeline against the JAX package's, on the same
numpy inputs and seeds; the byte and item models as integers; plan().

The JAX side runs in a subprocess (tests/_torch_oracle.py): its Gol3d and
ResidentPipeline reach ``device_constant``.
"""

import numpy as np
import pytest
import torch

import repro.stencil.pipeline as jpipe
from _torch_oracle import (GOL_K, GOL_M, GOL_S, GOL_SEED, GOL_T, KINDS,
                           reference_arrays, wave_fields)
from repro_torch import interop
from repro_torch.core.boundary import NEUMANN0
from repro_torch.core.orderings import ordering_from_name
from repro_torch.kernels.stencil3d import SMEM_LIMIT_BYTES, fused_smem_bytes
from repro_torch.stencil import pipeline as tpipe
from repro_torch.stencil.gol3d import Gol3d, Gol3dConfig
from repro_torch.stencil.pipeline import ResidentPipeline


@pytest.fixture(scope="module")
def ref_gol3d(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "gol3d")


def _cfg(kind, **kw):
    return Gol3dConfig(M=GOL_M, g=1, ordering=ordering_from_name(kind),
                       block_T=GOL_T, substeps=GOL_S, seed=GOL_SEED,
                       device="cpu", **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_gol3d_matches_jax_package(kind, ref_gol3d):
    """run_resident(5) with S=2 (two fused launches + one remainder) is
    bit-equal to the JAX Gol3d.run_resident, to the JAX reference_run, and
    to the port's repack path run(5)."""
    app = Gol3d(_cfg(kind))
    assert torch.equal(app.state_path, torch.from_numpy(ref_gol3d[f"state0/{kind}"]))
    reference = app.reference_run(GOL_K)
    assert torch.equal(reference, torch.from_numpy(ref_gol3d[f"reference/{kind}"]))
    resident = app.run_resident(GOL_K)
    assert torch.equal(resident, torch.from_numpy(ref_gol3d[f"resident/{kind}"]))
    assert torch.equal(app.cube, reference)
    repack = Gol3d(_cfg(kind))
    repack.run(GOL_K)
    assert torch.equal(repack.state_path, resident)


@pytest.mark.parametrize("kind", KINDS)
def test_wave_pipeline_matches_jax_package(kind, ref_gol3d):
    pipe = ResidentPipeline(M=GOL_M, T=GOL_T, g=1, kind=kind, S=GOL_S,
                            rule="wave", bc=NEUMANN0, device="cpu")
    fields = torch.from_numpy(wave_fields())
    out = pipe.run(fields, GOL_K)
    assert torch.equal(out, torch.from_numpy(ref_gol3d[f"wave/{kind}"]))
    assert torch.equal(fields, torch.from_numpy(wave_fields()))  # input untouched


def test_from_reference_state_round_trips(ref_gol3d):
    state = ref_gol3d["state0/hilbert"]
    app = interop.from_reference_state(state, _cfg("hilbert"), device="cpu")
    np.testing.assert_array_equal(app.state_path.numpy(), state)
    app.run_resident(GOL_K)
    np.testing.assert_array_equal(app.state_path.numpy(),
                                  ref_gol3d["resident/hilbert"])
    with pytest.raises(ValueError):
        interop.from_reference_state(state[:-1], _cfg("hilbert"), device="cpu")


def test_store_and_weights_interop():
    rng = np.random.default_rng(0)
    for shape in ((8, 4, 4, 4), (2, 8, 4, 4, 4)):
        arr = rng.normal(size=shape).astype(np.float32)
        t = interop.store_from_numpy(arr, device="cpu")
        assert t.shape == shape and t.is_contiguous()
        np.testing.assert_array_equal(interop.store_to_numpy(t), arr)
    w = interop.weights_from_numpy(np.ones((3, 3, 3), np.float32), device="cpu")
    assert w.shape == (3, 3, 3)
    with pytest.raises(ValueError):
        interop.store_from_numpy(np.zeros((8, 4, 4), np.float32), device="cpu")
    with pytest.raises(ValueError):
        interop.weights_from_numpy(np.ones((2, 2, 2), np.float32), device="cpu")


_GRID = [(M, T, g) for M in (8, 16, 32) for T in (2, 4, 8) for g in (1, 2)
         if T <= M and T % g == 0]


@pytest.mark.parametrize("name", [
    "repack_items_per_step", "repack_bytes_per_step",
    "resident_unfused_items_per_step", "resident_unfused_bytes_per_step",
    "fused_items_per_launch", "resident_bytes_per_step", "_boundary_items"])
def test_byte_models_equal_reference(name):
    mine, theirs = getattr(tpipe, name), getattr(jpipe, name)
    for M, T, g in _GRID:
        if name == "_boundary_items":
            cases = [((M,), {})]
        elif name == "fused_items_per_launch":
            cases = [((M, T, g, S), {"fields": C}) for S in (1, 2, 4)
                     for C in (1, 2) if S * g <= T and T % (S * g) == 0]
        elif name == "resident_bytes_per_step":
            cases = [((M, T, g, K), {"S": S, "fields": C}) for K in (1, 5, 16)
                     for S in (1, 2) for C in (1, 2) if T % (S * g) == 0]
        elif name == "resident_unfused_bytes_per_step":
            cases = [((M, T, g, K), {}) for K in (1, 7)]
        else:
            cases = [((M, T, g), {})]
        for args, kw in cases:
            a, b = mine(*args, **kw), theirs(*args, **kw)
            assert a == b and type(a) is type(b), (name, args, kw, a, b)


@pytest.mark.parametrize("rule", ["gol", "wave"])
def test_plan_fits_shared_memory(rule):
    for M in (16, 64, 256):
        for g in (1, 2):
            p = ResidentPipeline.plan(M, g=g, kind="hilbert", rule=rule,
                                      device="cpu")
            assert p.smem_bytes() == fused_smem_bytes(p.T, g, p.S,
                                                      fields=p.channels)
            assert p.smem_bytes() <= SMEM_LIMIT_BYTES
            assert M % p.T == 0 and p.T % (p.S * g) == 0
    with pytest.raises(ValueError, match="smem_limit"):
        ResidentPipeline.plan(64, rule=rule, smem_limit=100, device="cpu")


def test_runner_launch_count_and_remainder(monkeypatch):
    """ceil(K/S) fused launches; a remainder that S·g-divisibility allows
    runs as one smaller launch, else step by step."""
    calls = []
    real = tpipe.stencil_step_fused

    def counting(store, *a, S, **kw):
        calls.append(S)
        return real(store, *a, S=S, **kw)

    monkeypatch.setattr(tpipe, "stencil_step_fused", counting)
    cube = torch.from_numpy((np.random.default_rng(1).random((8, 8, 8)) < 0.3)
                            .astype(np.float32))
    for S, K, want in ((2, 5, [2, 2, 1]), (4, 4, [4]), (4, 6, [4, 2]),
                       (4, 7, [4, 1, 1, 1])):
        calls.clear()
        pipe = ResidentPipeline(M=8, T=4, S=S, kind="morton", device="cpu")
        out = pipe.run(cube, K)
        assert calls == want, (S, K)
        seq = ResidentPipeline(M=8, T=4, S=1, kind="morton", device="cpu").run(cube, K)
        assert torch.equal(out, seq)


def test_substeps_zero_delegates_to_plan():
    app = Gol3d(Gol3dConfig(M=16, substeps=0,
                            ordering=ordering_from_name("morton"), device="cpu"))
    pipe = app.resident_pipeline()
    assert pipe == ResidentPipeline.plan(16, g=1, kind="morton", device="cpu")
    assert torch.equal(app.run_resident(3), app.state_path)


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE", "CHIP_MAIN", "CHIP_REPACK"])
def test_configs_fit_the_kernels(name):
    """Every named config runs on the fused kernel as given: S·g | T | M
    and the window fits in shared memory."""
    from repro_torch.configs import gol3d as grid

    cfg = getattr(grid, name)
    assert cfg.M % cfg.block_T == 0 and cfg.block_T % (cfg.substeps * cfg.g) == 0
    assert fused_smem_bytes(cfg.block_T, cfg.g, cfg.substeps) <= SMEM_LIMIT_BYTES


def test_configs_match_jax_package():
    """The paper grid is the JAX package's; the chip grid adds column-major."""
    import repro.configs.gol3d as jgrid
    from repro_torch.configs import gol3d as grid

    assert [o.name for o in grid.ORDERINGS] == [o.name for o in jgrid.ORDERINGS]
    for key in ("PROBLEM_SIZES", "STENCILS", "HALO_WIDTHS"):
        assert getattr(grid, key) == getattr(jgrid, key)
    for key in ("CONFIG", "SMOKE"):
        mine, theirs = getattr(grid, key), getattr(jgrid, key)
        for f in ("M", "g", "block_T", "substeps", "density", "seed"):
            assert getattr(mine, f) == getattr(theirs, f), (key, f)
        assert mine.ordering.name == theirs.ordering.name
    assert [o.name for o in grid.CHIP_ORDERINGS] == [
        "row_major", "column_major", "morton", "hilbert"]
    assert grid.CHIP_MAIN.M == max(grid.PROBLEM_SIZES)
