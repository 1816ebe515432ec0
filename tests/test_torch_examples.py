"""The examples' torch twins (``examples/*_torch.py``) on the CPU, held
against the JAX package on the same seeds.

The twins are scripts, not a package: each is loaded by path. The JAX
side of gol3d, the wave store and the serve demo runs in the ``examples``
recipe of tests/_torch_oracle.py (its Gol3d and ResidentPipeline reach
``device_constant``), with the plain versions (``use_kernel=False``),
which the JAX package's own tests hold bit-equal to its kernels; its host
and byte models are numpy and plain Python and run here.
"""

import math

import numpy as np
import pytest
import torch

import repro.core.cache_model as jcache
import repro.core.surfaces as jsurf
import repro.stencil as jstencil
from _torch_oracle import (EX_SERVE_BATCH, EX_SERVE_NEW, EX_SERVE_PROMPT,
                           EX_STEPS, reference_arrays, serve_example_config,
                           tree_of)
from _torch_oracle import load_example as load
from repro.core.boundary import NEUMANN0 as JNEUMANN0
from repro.core.orderings import ordering_from_name as jordering
from repro.core.orderings import rmo_to_path as jrmo_to_path
from repro_torch import interop

TWINS = ("quickstart_torch", "stencil_halo_demo_torch", "serve_lm_torch",
         "train_lm_torch")
CPU = torch.device("cpu")
DIST_STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The twins' CPU runs are many small ops: one intra-op thread runs
    them faster than several, and does not crowd the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_examples(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "examples")


@pytest.fixture(scope="module")
def quickstart():
    return load("quickstart_torch").main(["--device", "cpu"])


@pytest.fixture(scope="module")
def demo():
    return load("stencil_halo_demo_torch")


@pytest.fixture(scope="module")
def resident(demo):
    """The stencil demo's part 1 at EX_STEPS steps (its own: 10)."""
    return demo.resident_demo(CPU, steps=EX_STEPS)


@pytest.fixture(scope="module")
def wave(demo):
    """Part 3 at EX_STEPS steps (its own: 8)."""
    return demo.wave_demo(CPU, steps=EX_STEPS)


@pytest.fixture(scope="module")
def dist(demo):
    """Part 2 at DIST_STEPS steps (its own: 10): one S=2 round and one
    S=4 round (its S=2 remainder) besides the per-step form."""
    return demo.distributed_demo(CPU, steps=DIST_STEPS)


@pytest.mark.parametrize("name", ["row_major", "morton", "hilbert"])
def test_quickstart_host_models_equal_reference(name, quickstart):
    spec, M, g = jordering(name), 32, 1
    s = jcache.offset_summary(spec, M, g)
    assert quickstart["offsets"][name] == (s.n_distinct, s.frac_within_line)
    assert quickstart["cache"][name] == (
        jcache.cache_misses(spec, M, g, b=8, c=64),
        jcache.surface_cache_misses(spec, M, g, 8, 64, "j0"))
    rs = jsurf.run_stats(spec, M, g, "j0")
    assert quickstart["pack"][name] == (len(jsurf.surface_path_indices(
        spec, M, g, "j0")), rs.n_runs, rs.mean_run)
    assert all(type(v) is int for v in quickstart["cache"][name])


@pytest.mark.parametrize("name", ["row_major", "morton", "hilbert"])
def test_quickstart_packed_face_equals_reference(name, quickstart):
    """Part 4's packed j0 face: the curve-ordered cube's items at the JAX
    package's surface path indices, in that order."""
    spec, M, g = jordering(name), 32, 1
    cube = np.random.default_rng(0).random((M, M, M)).astype(np.float32)
    path = np.empty(M ** 3, np.float32)
    path[jrmo_to_path(spec, M)] = cube.reshape(-1)
    want = path[jsurf.surface_path_indices(spec, M, g, "j0")]
    np.testing.assert_array_equal(quickstart["packed"][name].numpy(), want)


@pytest.mark.parametrize("name", ["row_major", "morton", "hilbert"])
def test_quickstart_gol3d_equals_jax_package(name, quickstart, ref_examples):
    got = quickstart["finals"][name]
    assert got.device.type == "cpu"
    assert torch.equal(got, torch.from_numpy(ref_examples[f"quickstart/{name}"]))


def test_stencil_demo_byte_models_equal_reference(resident, wave, dist):
    """Every modelled byte count the demo prints, as integers."""
    M, T, g, K = 32, 8, 1, EX_STEPS
    assert resident["bytes"] == {
        "repack": jstencil.repack_bytes_per_step(M, T, g),
        "unfused": jstencil.resident_unfused_bytes_per_step(M, T, g, K),
        "fused": jstencil.resident_bytes_per_step(M, T, g, K, S=4)}
    for S, row in wave["table"].items():
        assert row == (jstencil.resident_bytes_per_step(M, T, g, K, S=S),
                       jstencil.resident_bytes_per_step(M, T, g, K, S=S, fields=2),
                       jstencil.exchange_bytes_per_step(M, g, S),
                       jstencil.exchange_bytes_per_step(M, g, S, fields=2),
                       jstencil.distributed_bytes_per_step(M, T, g, K, S=S,
                                                           fields=2))
    procs, n, K = (2, 2, 2), JNEUMANN0, DIST_STEPS
    for S, row in dist["ici"].items():
        assert row == (jstencil.exchange_bytes_per_step(16, g, S),
                       jstencil.exchange_bytes_per_step(16, g, S, bc=n, procs=procs),
                       jstencil.exchange_bytes_per_step(16, g, S, bc=n, procs=procs,
                                                        coords=(0, 0, 0)))
    assert dist["dist"] == (
        jstencil.distributed_bytes_per_step(16, 8, g, K, S=1),
        jstencil.distributed_bytes_per_step(16, 8, g, K, S=4),
        jstencil.distributed_bytes_per_step(16, 8, g, K, S=4, bc=n, procs=procs))
    T_p, S_p, smem, _ = resident["plan"]
    assert 32 % T_p == 0 and T_p % S_p == 0 and smem > 0


@pytest.mark.parametrize("name", ["morton", "hilbert"])
def test_stencil_demo_resident_equals_jax_package(name, resident, ref_examples):
    """Part 1: the repack steps (``Gol3d.step_fn``) and the fused run
    agree (the demo's own check), and equal the JAX package's repack
    steps bit for bit."""
    want = torch.from_numpy(ref_examples[f"resident/{name}"])
    assert torch.equal(resident["finals"][name], want)


@pytest.mark.parametrize("S", [2, 4])
def test_stencil_demo_wave_equals_jax_package(S, wave, ref_examples):
    assert torch.equal(wave["finals"][S],
                       torch.from_numpy(ref_examples[f"wave/{S}"]))


def test_stencil_demo_distributed_on_a_local_mesh(dist):
    """Part 2 on the CPU's local 2×2×2 mesh: its checks (the per-step
    form against the global oracle, S=2 and 4 against the per-step form)
    raise on a mismatch."""
    assert set(dist["ms"]) == {(bc, o) for bc in ("periodic", "neumann0")
                               for o in ("row_major", "morton", "hilbert")}
    assert all(set(t) == {1, 2, 4} for t in dist["ms"].values())


def test_serve_tokens_equal_jax_greedy_decode(ref_examples):
    """The serve twin on the JAX weights (carried across by
    ``interop.lm_params_from_numpy``) decodes the JAX tokens, in f32."""
    serve = load("serve_lm_torch")
    cfg = serve.reduced_config()
    assert cfg == serve_example_config("repro_torch")
    prompts = serve.prompts_for(cfg.vocab, EX_SERVE_BATCH, EX_SERVE_PROMPT)
    np.testing.assert_array_equal(prompts, ref_examples["serve/prompts"])
    model = interop.lm_params_from_numpy(tree_of(ref_examples, "serve/params"),
                                         cfg, device="cpu")
    out, _ = serve.serve(model, prompts, EX_SERVE_NEW)
    assert out.shape == (EX_SERVE_BATCH, EX_SERVE_NEW)
    np.testing.assert_array_equal(out.numpy(), ref_examples["serve/tokens"])


def test_train_runs_and_resumes(tmp_path):
    train = load("train_lm_torch")
    common = ["--device", "cpu", "--batch", "2", "--seq", "32",
              "--ckpt-dir", str(tmp_path / "ck")]
    first = train.main(["--steps", "3"] + common)
    assert first["steps"] == [0, 1, 2]
    assert all(math.isfinite(x) for x in first["losses"])
    again = train.main(["--steps", "4", "--resume"] + common)
    assert again["steps"] == [3]
    assert all(math.isfinite(x) for x in again["losses"])


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card(name, monkeypatch, tmp_path):
    """Without a card the default ``--device cuda`` raises: no twin
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load(name).main(["--ckpt-dir", str(tmp_path)]
                        if name == "train_lm_torch" else [])
