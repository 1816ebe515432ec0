"""The torch package stands alone: it imports neither JAX nor the JAX
package, asks for CUDA explicitly and never falls back to the CPU, and
its kernel builder imports on machines without a CUDA compiler."""

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
            "repro_torch.stencil.halo, repro_torch.stencil.pipeline, sys; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+repro(\s|\.|$)"
                     r"|from\s+repro(\s|\.))", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {f.name for f in files}
    assert {"cache_model.py", "surfaces.py", "sfc_gather.py", "domain.py",
            "halo.py"} <= names
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cuda_default_raises_without_a_card(monkeypatch):
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
