"""The torch package stands alone: it imports neither JAX, nor the JAX
package, nor ml_dtypes (which comes with JAX, and the card's machine
lacks), asks for CUDA explicitly and never falls back to the CPU, and its
kernel builder imports on machines without a CUDA compiler."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = ("import repro_torch, repro_torch.stencil.gol3d, "
            "repro_torch.kernels.stencil3d, repro_torch.interop, "
            "repro_torch.configs.gol3d, repro_torch.core.cache_model, "
            "repro_torch.core.surfaces, repro_torch.kernels.sfc_gather, "
            "repro_torch.kernels.ops, repro_torch.stencil.domain, "
            "repro_torch.stencil.halo, repro_torch.stencil.pipeline, "
            "repro_torch.kernels.flash_attn, repro_torch.models, "
            "repro_torch.models.attention, repro_torch.models.transformer, "
            "repro_torch.configs.registry, repro_torch.configs.smollm_360m, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.checkpoint, repro_torch.checkpoint.ckpt, "
            "repro_torch.stencil.runner, repro_torch.launch.faults, "
            "repro_torch.launch.elastic, repro_torch.serve.roi, "
            "repro_torch.serve.service, repro_torch.train, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.train.trainer, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.launch.train, "
            "repro_torch.models.moe, repro_torch.configs.gemma3_1b, "
            "repro_torch.configs.deepseek_coder_33b, "
            "repro_torch.configs.phi4_mini_3p8b, "
            "repro_torch.configs.deepseek_v2_lite_16b, "
            "repro_torch.configs.deepseek_moe_16b, repro_torch.models.mamba2, "
            "repro_torch.configs.mamba2_2p7b, repro_torch.configs.zamba2_1p2b, "
            "repro_torch.configs.whisper_small, "
            "repro_torch.configs.internvl2_76b, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.models.params, sys; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro', 'ml_dtypes', "
            "'benchmarks') or m.startswith(('jax.', 'repro.', 'ml_dtypes.', "
            "'benchmarks.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr


def test_sharded_paths_pull_in_no_jax(tmp_path):
    """A train step and a decode step over a one-rank gloo mesh, with
    the flash path, MoE dispatch and a sharded checkpoint: no JAX, JAX
    package, ml_dtypes or benchmarks module comes in."""
    code = f"""
import dataclasses, sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint import ckpt
from repro_torch.configs import deepseek_moe_16b, smollm_360m
from repro_torch.launch.dryrun import sanitize_specs
from repro_torch.launch.mesh import batch_axes, hilbert_device_permutation
from repro_torch.models import Model
from repro_torch.train import TrainConfig, init_opt_state, make_train_step
dist.init_process_group("gloo", init_method="file://{tmp_path / 'rdv'}",
                        world_size=1, rank=0)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
for base in (smollm_360m.SMOKE, deepseek_moe_16b.SMOKE):
    cfg = dataclasses.replace(base, use_flash_kernel=True, ep_axis="model",
                              act_spec=(batch_axes(mesh), "model", None))
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    m.requires_grad_().shard(mesh, sanitize_specs(mesh, m.specs(), m.defs()))
    p = m.params()
    toks = torch.randint(0, cfg.vocab, (2, 9))
    p, s, out = make_train_step(m, TrainConfig())(
        p, init_opt_state(p), {{"tokens": toks[:, :-1], "labels": toks[:, 1:]}})
    assert torch.isfinite(out["loss"])
ckpt.save("{tmp_path / 'ck'}", 1, {{"params": p}})
hilbert_device_permutation(list(range(8)))
dist.destroy_process_group()
bad = [m for m in sys.modules if m in ('jax', 'repro', 'ml_dtypes', 'benchmarks')
       or m.startswith(('jax.', 'repro.', 'ml_dtypes.', 'benchmarks.'))]
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_dry_run_pulls_in_no_jax():
    """The roofline package and the dry run, one mini cell on meta under a
    fake process group: no JAX, JAX package, ml_dtypes or benchmarks
    module comes in; the entry points still default to the card."""
    code = """
import inspect, sys, torch, torch.distributed as dist
import repro_torch.roofline, repro_torch.roofline.op_cost
from repro_torch.launch import dryrun
from repro_torch.configs.registry import ShapeSpec, concrete_batch, get_smoke
from repro_torch.models import Model
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(get_smoke("deepseek-moe-16b"), ShapeSpec("t", 32, 8, "train"),
                      mesh, "mini", dryrun.DEFAULT_OPTS)
assert rec["flops_per_dev"] > 0 and rec["device"] == "meta"
dist.destroy_process_group()
assert inspect.signature(Model).parameters["device"].default == "cuda"
assert inspect.signature(concrete_batch).parameters["device"].default == "cuda"
bad = [m for m in sys.modules if m in ('jax', 'repro', 'ml_dtypes', 'benchmarks')
       or m.startswith(('jax.', 'repro.', 'ml_dtypes.', 'benchmarks.'))]
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]


# each example twin with small arguments on the CPU (train: into the
# test's tmp dir, appended below); the stencil demo, which has no size
# options, runs its three parts at one step each
TWIN_ARGS = {"quickstart_torch": [], "stencil_halo_demo_torch": [],
             "serve_lm_torch": ["--new-tokens", "2"],
             "train_lm_torch": ["--steps", "1", "--batch", "2", "--seq", "16"]}
STENCIL_PARTS = """
cpu = __import__("torch").device("cpu")
for part in ("resident_demo", "wave_demo", "distributed_demo"):
    mod[part](cpu, steps=1)
"""


@pytest.mark.parametrize("name", sorted(TWIN_ARGS))
def test_example_twins_pull_in_no_jax(name, tmp_path):
    """``examples/<name>.py --device cpu`` runs as a script and loads no
    JAX, JAX package, ml_dtypes or benchmarks module."""
    args = ["--device", "cpu"] + TWIN_ARGS[name]
    if name == "train_lm_torch":
        args += ["--ckpt-dir", str(tmp_path / "ck")]
    path = str(REPO / "examples" / (name + ".py"))
    run = (f"mod = runpy.run_path({path!r})" + STENCIL_PARTS
           if name == "stencil_halo_demo_torch"
           else f"runpy.run_path({path!r}, run_name='__main__')")
    code = f"""
import runpy, sys
sys.argv = {[name + ".py"] + args!r}
{run}
bad = [m for m in sys.modules if m in ('jax', 'repro', 'ml_dtypes', 'benchmarks')
       or m.startswith(('jax.', 'repro.', 'ml_dtypes.', 'benchmarks.'))]
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src"),
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+repro(\s|\.|$)"
                     r"|from\s+repro(\s|\.)|import\s+ml_dtypes|from\s+ml_dtypes"
                     r"|import\s+benchmarks|from\s+benchmarks)",
                     re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {f.name for f in files}
    assert {"cache_model.py", "surfaces.py", "sfc_gather.py", "domain.py",
            "halo.py", "flash_attn.py", "attention.py", "transformer.py",
            "zoo.py", "params.py", "layers.py", "registry.py",
            "smollm_360m.py", "serve_step.py", "serve.py", "ckpt.py",
            "runner.py", "faults.py", "elastic.py", "roi.py",
            "service.py", "optimizer.py", "train_step.py", "trainer.py",
            "pipeline.py", "train.py", "moe.py", "gemma3_1b.py",
            "deepseek_coder_33b.py", "phi4_mini_3p8b.py",
            "deepseek_v2_lite_16b.py", "deepseek_moe_16b.py", "mamba2.py",
            "mamba2_2p7b.py", "zamba2_1p2b.py", "whisper_small.py",
            "internvl2_76b.py", "mesh.py", "dryrun.py", "op_cost.py",
            "analysis.py"} <= names
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cuda_default_raises_without_a_card(monkeypatch):
    import types

    from repro_torch.configs.smollm_360m import SMOKE
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import Model
    from repro_torch.serve import greedy_decode
    from repro_torch.stencil.domain import make_stencil_mesh
    from repro_torch.stencil.gol3d import Gol3d, Gol3dConfig
    from repro_torch.stencil.pipeline import ResidentPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Gol3d(Gol3dConfig(M=8, block_T=4))
    with pytest.raises(RuntimeError, match="cuda"):
        ResidentPipeline(M=8, T=4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_stencil_mesh((2, 2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        Model(SMOKE)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_launcher.stencil_main(serve_launcher.build_parser().parse_args(
            ["--stencil", "--M", "8", "--T", "4"]))
    with pytest.raises(RuntimeError, match="cuda"):
        Model(SMOKE, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        greedy_decode(types.SimpleNamespace(device=torch.device("cuda")),
                      torch.zeros((1, 2), dtype=torch.int32), 1, 4)
    assert Model(SMOKE, device="cpu").embed.device.type == "cpu"
    cpu = Gol3dConfig(M=8, block_T=4, device="cpu")
    assert Gol3d(cpu).state_path.device.type == "cpu"


def test_build_imports_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "-fmad=false" in _build.NVCC_FLAGS


def test_group_mesh_needs_a_group_of_its_size(tmp_path):
    """A process-group mesh raises without an initialised group, or with
    one whose world size is not the mesh's shard count; it never runs the
    shards locally instead."""
    import torch.distributed as dist

    from repro_torch.core.orderings import MORTON
    from repro_torch.stencil.domain import make_stencil_mesh
    from repro_torch.stencil.pipeline import DistributedPipeline

    with pytest.raises(RuntimeError, match="initialised"):
        make_stencil_mesh((2, 1, 1), device="cpu", group=object())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="1 ranks"):
            make_stencil_mesh((2, 1, 1), device="cpu", group=dist.group.WORLD)
        with pytest.raises(ValueError, match="1 ranks"):
            make_stencil_mesh((2, 2, 2), device="cpu", group=dist.group.WORLD)
        mesh = make_stencil_mesh((1, 1, 1), device="cpu", group=dist.group.WORLD)
        assert mesh.shards == ((0, 0, 0),)
        pipe = DistributedPipeline(mesh=mesh, spec=MORTON, M=8, T=4, S=2)
        cube = (torch.arange(512) % 3 == 0).float().reshape(8, 8, 8)
        local = DistributedPipeline(mesh=make_stencil_mesh((1, 1, 1), device="cpu"),
                                    spec=MORTON, M=8, T=4, S=2)
        assert torch.equal(pipe.run_cube(cube, 3), local.run_cube(cube, 3))
    finally:
        dist.destroy_process_group()
    assert make_stencil_mesh((2, 1, 1), device="cpu").shards == \
        ((0, 0, 0), (1, 0, 0))
