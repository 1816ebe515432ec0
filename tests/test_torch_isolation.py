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
            "repro_torch.configs.gol3d, sys; "
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
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cuda_default_raises_without_a_card(monkeypatch):
    from repro_torch.stencil.gol3d import Gol3d, Gol3dConfig
    from repro_torch.stencil.pipeline import ResidentPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Gol3d(Gol3dConfig(M=8, block_T=4))
    with pytest.raises(RuntimeError, match="cuda"):
        ResidentPipeline(M=8, T=4)
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
