"""Fault-tolerant stencil runs in the torch package (DESIGN.md §10): the
runner matrix of tests/test_resilience.py on the CPU, and runs that cross
packages.

- CheckpointedRun on one device: chunked == unchunked for gol, jacobi and
  wave; kill at steps 1, 5 and 8, then resume with another ordering, T
  or S, bit-identical to the uninterrupted run for every rule; physics
  validated on resume; the NaN and per-rule guards; newest-valid fallback
  past a corrupt checkpoint;
- the subprocess CLI (``python -m repro_torch.launch.faults --device
  cpu``): a real ``os._exit`` death (exit 17), resumed by a second
  process, crc-equal to an uninterrupted third;
- the elastic reshard matrix on local CPU meshes: 2×2×2 → 1×1×1, the
  non-cubic 4×2×1 jacobi box, distributed → resident; and the elastic
  CLI;
- across packages: a JAX CheckpointedRun killed in the reference child
  (tests/_torch_oracle.py, recipe ``xrun``) resumes here, and one killed
  here resumes there; gol and wave bit-equal to the JAX package's
  uninterrupted run, jacobi within 1e-6 (``assert_matches``: XLA may
  contract the JAX side's arithmetic).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_oracle import (XRUN_CASES, XRUN_M, XRUN_SEED, assert_matches,
                           recipe_arrays)
from repro.launch import faults as jfaults
from repro.stencil.runner import boundary_to_json as jax_boundary_to_json
from repro_torch.checkpoint import ckpt
from repro_torch.core.boundary import as_boundary, dirichlet, mixed
from repro_torch.core.orderings import HILBERT, MORTON
from repro_torch.launch.faults import (KILL_EXIT, FaultPlan, SimulatedCrash,
                                       initial_state, state_crc, truncate_chunk)
from repro_torch.stencil import (CheckpointedRun, DistributedPipeline,
                                 ResidentPipeline, RunHealthError, health_check,
                                 make_stencil_mesh)
from repro_torch.stencil.runner import RULE_GUARDS, boundary_to_json

REPO = Path(__file__).resolve().parent.parent
M = 8


@pytest.fixture()
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


def _resident(rule="gol", **kw):
    d = dict(M=M, T=4, S=1, rule=rule, kind="morton", device="cpu")
    d.update(kw)
    return ResidentPipeline(**d)


def _ref(pipe, state0, n):
    return pipe.run(torch.from_numpy(state0), n).numpy()


def _killed(pipe, d, state0, n, kill_at, interval=4):
    with pytest.raises(SimulatedCrash):
        CheckpointedRun(pipe, d, interval=interval,
                        hooks=FaultPlan(kill_at_step=kill_at,
                                        kill_mode="raise").hooks()
                        ).run(state0, n)


# ------------------------------------------------- checkpointed run (1 device)
@pytest.mark.parametrize("rule,interval", [("gol", 3), ("jacobi", 4),
                                           ("wave", 5)])
def test_checkpointed_run_equals_plain(tmp_ckpt, rule, interval):
    """Chunked run == one-shot pipeline run, bit-identical, including
    intervals that do not divide n_steps and multi-field (C=2) state; the
    canonical state is a C-contiguous f32 host array."""
    pipe = _resident(rule)
    state0 = initial_state(rule, M, seed=1)
    ref = _ref(pipe, state0, 10)
    out = CheckpointedRun(pipe, tmp_ckpt, interval=interval).run(state0, 10)
    assert isinstance(out, np.ndarray) and out.flags.c_contiguous
    np.testing.assert_array_equal(out, ref)
    assert ckpt.latest_step(tmp_ckpt) == 10  # the final step checkpoints
    _, meta = ckpt.restore(tmp_ckpt)
    assert meta["state_crc32"] == state_crc(out)


@pytest.mark.parametrize("kill_at", [1, 5, 8])
@pytest.mark.parametrize("rule,resume_kw", [
    ("gol", dict(T=8, S=2, kind="hilbert")),
    ("jacobi", dict(T=8, S=2, kind="hilbert")),
    ("wave", dict(T=4, S=2, kind="row_major")),
], ids=["gol", "jacobi", "wave"])
def test_resume_bit_identity_after_kill(tmp_ckpt, rule, resume_kw, kill_at):
    """Kill at any step (boundary or not); resume with another ordering,
    block edge and fused depth; the final state bit-identical to the
    uninterrupted run, for every rule (the plain versions fix the
    substep arithmetic whatever the launch structure)."""
    state0 = initial_state(rule, M, seed=2)
    ref = _ref(_resident(rule), state0, 10)
    _killed(_resident(rule), tmp_ckpt, state0, 10, kill_at)
    assert ckpt.latest_step(tmp_ckpt) <= kill_at  # kill precedes its ckpt
    resumed = CheckpointedRun(_resident(rule, **resume_kw),
                              tmp_ckpt, interval=4).run(state0, 10)
    np.testing.assert_array_equal(resumed, ref)


def test_resume_bit_identity_clamped(tmp_ckpt):
    """A clamped contract (mixed, and dirichlet for wave) survives
    kill/resume with a changed ordering and S."""
    for rule, bc in [("gol", "neumann0"), ("jacobi", mixed(k="neumann0")),
                     ("wave", dirichlet(0.5))]:
        d = os.path.join(tmp_ckpt, rule)
        state0 = initial_state(rule, M, seed=3)
        ref = _ref(_resident(rule, bc=bc), state0, 9)
        _killed(_resident(rule, bc=bc), d, state0, 9, 6)
        resumed = CheckpointedRun(_resident(rule, kind="hilbert", S=2, bc=bc),
                                  d, interval=4).run(state0, 9)
        np.testing.assert_array_equal(resumed, ref)


def test_resume_validates_physics(tmp_ckpt):
    """Layout may change on resume; physics may not — rule, boundary
    contract and shape mismatches are refused with a clear error."""
    state0 = initial_state("gol", M, seed=4)
    CheckpointedRun(_resident("gol"), tmp_ckpt, interval=4).run(state0, 4)
    with pytest.raises(ValueError, match="rule"):
        CheckpointedRun(_resident("jacobi"), tmp_ckpt).run(
            initial_state("jacobi", M), 8)
    with pytest.raises(ValueError, match="bc"):
        CheckpointedRun(_resident("gol", bc="dirichlet"), tmp_ckpt).run(
            state0, 8)
    with pytest.raises(ValueError, match="shape"):
        CheckpointedRun(ResidentPipeline(M=16, T=4, rule="gol", device="cpu"),
                        tmp_ckpt).run(initial_state("gol", 16), 8)
    with pytest.raises(ValueError, match="beyond"):
        CheckpointedRun(_resident("gol"), tmp_ckpt).run(state0, 2)
    with pytest.raises(ValueError, match="does not match"):
        CheckpointedRun(_resident("gol"), tmp_ckpt).run(state0[:4], 8)
    with pytest.raises(ValueError, match="interval"):
        CheckpointedRun(_resident("gol"), tmp_ckpt, interval=0)


@pytest.mark.parametrize("name", ["periodic", "neumann0", "dirichlet", "mixed"])
def test_boundary_contract_to_json_equals_jax(name):
    """The manifest's bc entry is the JAX package's, so that a resume in
    either package validates the other's checkpoint."""
    from repro.core import boundary as jbnd
    from repro_torch.core import boundary as tbnd

    def contract(pkg):
        return {"periodic": lambda: "periodic", "neumann0": lambda: pkg.NEUMANN0,
                "dirichlet": lambda: pkg.dirichlet(0.5),
                "mixed": lambda: pkg.mixed(k="dirichlet", i="periodic",
                                           j="neumann0")}[name]()

    j = boundary_to_json(contract(tbnd))
    assert j == jax_boundary_to_json(contract(jbnd))
    assert boundary_to_json(as_boundary(contract(tbnd))) == j
    if name == "mixed":
        assert len(j["axes"]) == 3 and j["axes"][0]["kind"] == "dirichlet"


# ------------------------------------------------------------ runtime guards
def test_guard_nan_at_boundary(tmp_ckpt):
    """NaN injected at a checkpoint boundary trips the guard *at* that
    boundary — the poison is never checkpointed."""
    state0 = initial_state("gol", M, seed=5)
    with pytest.raises(RunHealthError) as ei:
        CheckpointedRun(_resident("gol"), tmp_ckpt, interval=4,
                        hooks=FaultPlan(poison_at_step=8).hooks()
                        ).run(state0, 10)
    assert ei.value.step == 8 and ei.value.last_good_step == 4
    assert "NaN" in ei.value.reason
    assert ckpt.latest_step(tmp_ckpt) == 4  # poisoned state not persisted


def test_guard_nan_propagates_to_next_boundary(tmp_ckpt):
    """jacobi propagates NaN; poison mid-interval is caught at the next
    checkpoint boundary with the previous interval still good."""
    state0 = initial_state("jacobi", M, seed=5)
    with pytest.raises(RunHealthError) as ei:
        CheckpointedRun(_resident("jacobi"), tmp_ckpt, interval=4,
                        hooks=FaultPlan(poison_at_step=5).hooks()
                        ).run(state0, 10)
    assert ei.value.step == 8 and ei.value.last_good_step == 4


def test_guard_rule_invariants(tmp_ckpt):
    """Finite-but-wrong states trip the per-rule invariants: gol must be
    exactly {0,1}, jacobi must respect its initial range (max principle)."""
    assert sorted(RULE_GUARDS) == ["gol", "jacobi"]
    with pytest.raises(RunHealthError, match="0, 1"):
        CheckpointedRun(_resident("gol"), os.path.join(tmp_ckpt, "g"),
                        interval=4,
                        hooks=FaultPlan(poison_at_step=4,
                                        poison_value=0.5).hooks()
                        ).run(initial_state("gol", M, seed=6), 8)
    with pytest.raises(RunHealthError, match="maximum-principle"):
        CheckpointedRun(_resident("jacobi"), os.path.join(tmp_ckpt, "j"),
                        interval=4,
                        hooks=FaultPlan(poison_at_step=4,
                                        poison_value=1e6).hooks()
                        ).run(initial_state("jacobi", M, seed=6), 8)


def test_health_check_function():
    ok = np.zeros((4, 4, 4), np.float32)
    assert health_check("gol", ok) is None
    assert health_check("jacobi", ok, bounds=[-1.0, 1.0]) is None
    assert "NaN" in health_check("wave", np.full((2, 4), np.nan))
    assert "0, 1" in health_check("gol", ok + 0.25)
    assert "range" in health_check("jacobi", ok + 5.0, bounds=[-1.0, 1.0])
    assert health_check("jacobi", ok + 5.0, bounds=None) is None


def test_resume_falls_back_past_corrupt_checkpoint(tmp_ckpt):
    """Corrupting the newest checkpoint after a completed run: resume
    quarantines it, restores the previous valid step, re-runs the lost
    interval, and still reproduces the uninterrupted result bit-exactly."""
    pipe = _resident("jacobi")
    state0 = initial_state("jacobi", M, seed=7)
    ref = _ref(pipe, state0, 8)
    out = CheckpointedRun(pipe, tmp_ckpt, interval=2).run(state0, 8)
    np.testing.assert_array_equal(out, ref)
    truncate_chunk(tmp_ckpt, 8)
    resumed = CheckpointedRun(pipe, tmp_ckpt, interval=2).run(state0, 8)
    np.testing.assert_array_equal(resumed, ref)
    assert os.path.isdir(os.path.join(tmp_ckpt, ".corrupt_step_00000008"))
    assert ckpt.latest_step(tmp_ckpt) == 8  # re-written after the re-run


@pytest.mark.parametrize("rule,shape", [("gol", 8), ("jacobi", (8, 4, 2)),
                                        ("wave", 4)])
def test_initial_state_and_crc_equal_jax(rule, shape):
    """The CLI's initial states are the JAX package's numbers, and their
    crc is the same: FAULTS_DONE lines compare across packages."""
    got, want = initial_state(rule, shape, seed=3), jfaults.initial_state(rule, shape, seed=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert state_crc(got) == jfaults.state_crc(want)
    assert KILL_EXIT == jfaults.KILL_EXIT == 17


# ------------------------------------------------------- subprocess kill CLI
def _cli(*args, ckpt_dir):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.faults",
                           "--device", "cpu", "--rule", "gol", "--steps", "12",
                           "--interval", "4", "--ckpt-dir", ckpt_dir, *args],
                          capture_output=True, text=True, env=env, timeout=300)


def test_subprocess_kill_and_resume(tmp_path):
    """A real process death (os._exit mid-run): exit code 17, no
    checkpoint at/after the kill step; a second process resumes with a
    different ordering/T/S and matches an uninterrupted run's crc."""
    d_kill, d_ref = str(tmp_path / "kill"), str(tmp_path / "ref")
    r = _cli("--M", "8", "--T", "4", "--kill-at", "6", ckpt_dir=d_kill)
    assert r.returncode == KILL_EXIT, r.stdout + r.stderr
    assert ckpt.latest_step(d_kill) == 4
    r2 = _cli("--M", "8", "--T", "8", "--S", "2", "--ordering", "morton",
              ckpt_dir=d_kill)
    r3 = _cli("--M", "8", "--T", "4", ckpt_dir=d_ref)
    crc = [ln.split("crc=")[1] for ln in (r2.stdout + r3.stdout).splitlines()
           if ln.startswith("FAULTS_DONE step=12")]
    assert len(crc) == 2 and crc[0] == crc[1], (r2.stdout, r2.stderr, r3.stdout)
    assert "FAULTS_LAUNCHES" in r2.stdout


def test_subprocess_kill_on_a_mesh(tmp_path):
    """The CLI's --mesh: killed on a 2×2×2 local mesh, resumed by a
    resident process (--M is the local edge, so 16 over 2³ shards of 8)."""
    d = str(tmp_path / "mesh")
    r = _cli("--mesh", "2,2,2", "--M", "8", "--T", "4", "--S", "2",
             "--kill-at", "5", ckpt_dir=d)
    assert r.returncode == KILL_EXIT, r.stdout + r.stderr
    r2 = _cli("--M", "16", "--T", "8", ckpt_dir=d)
    r3 = _cli("--M", "16", "--T", "4", ckpt_dir=str(tmp_path / "ref"))
    crc = [ln.split("crc=")[1] for ln in (r2.stdout + r3.stdout).splitlines()
           if ln.startswith("FAULTS_DONE")]
    assert len(crc) == 2 and crc[0] == crc[1], (r2.stdout, r2.stderr, r3.stdout)


# ------------------------------------------- elastic reshard matrix (CPU)
@pytest.mark.parametrize("case", ["cubic", "noncubic", "takeover"])
def test_elastic_reshard_matrix(tmp_path, case):
    """Kill on mesh A, resume on mesh B — different mesh shape, ordering,
    T and S — bit-identical to the uninterrupted run: 2×2×2 → 1×1×1, a
    non-cubic 4×2×1 jacobi box (32, 16, 8), and distributed → resident."""
    steps, interval, d = 12, 4, str(tmp_path / case)
    mesh = lambda shape: make_stencil_mesh(shape, device="cpu")  # noqa: E731
    if case == "cubic":
        state0 = initial_state("gol", 16, seed=0)
        first = DistributedPipeline(mesh=mesh((2, 2, 2)), spec=HILBERT, M=8,
                                    T=8, S=2)
        then = DistributedPipeline(mesh=mesh((1, 1, 1)), spec=MORTON, M=16,
                                   T=4, S=1)
    elif case == "noncubic":
        state0 = initial_state("jacobi", (32, 16, 8), seed=1)
        first = DistributedPipeline(mesh=mesh((4, 2, 1)), spec=MORTON, M=8,
                                    T=8, S=1, rule="jacobi")
        then = DistributedPipeline(mesh=mesh((4, 2, 1)), spec=HILBERT, M=8,
                                   T=4, S=2, rule="jacobi")
    else:
        state0 = initial_state("gol", 16, seed=2)
        first = DistributedPipeline(mesh=mesh((2, 2, 2)), spec=HILBERT, M=8,
                                    T=8, S=2)
        then = ResidentPipeline(M=16, T=8, S=1, kind="hilbert", device="cpu")
    ref = first.run_cube(torch.from_numpy(state0), steps).numpy()
    _killed(first, d, state0, steps, 6, interval)
    out = CheckpointedRun(then, d, interval=interval).run(state0, steps)
    np.testing.assert_array_equal(out, ref)


def test_clis_default_to_the_card(tmp_path, monkeypatch):
    """Without --device both CLIs ask for CUDA, and raise where there is
    none; nothing falls back to the CPU."""
    from repro_torch.launch import elastic, faults

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((faults, ["--ckpt-dir", str(tmp_path / "f")]),
                      (elastic, ["--stencil", "--ckpt-dir", str(tmp_path / "e")])):
        args = mod.build_parser().parse_args(argv)
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            (elastic.stencil_main if mod is elastic else faults.main)(args)


def test_elastic_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.elastic", "--device", "cpu"]
    r = subprocess.run(cmd + ["--stencil", "--ckpt-dir", str(tmp_path / "el")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "bit-exact vs uninterrupted run" in r.stdout \
        and "[elastic] OK" in r.stdout, r.stdout + r.stderr
    r = subprocess.run(cmd + ["--devices", "8", "--from-shape", "4,2",
                              "--to-shape", "2,2"],
                       capture_output=True, text=True, env=env, timeout=400)
    assert r.returncode == 0 and "params bit-exact" in r.stdout \
        and "[elastic] OK" in r.stdout, r.stdout + r.stderr[-4000:]


# ------------------------------------------------ runs that cross packages
@pytest.fixture(scope="module")
def xrun(tmp_path_factory):
    """This package kills its runs in ``port_kill/<rule>``; the reference
    child resumes them there and kills its own in ``jax_kill/<rule>``."""
    work = tmp_path_factory.mktemp("xrun")
    for rule, interval, steps, kill, *_ in XRUN_CASES:
        state0 = initial_state(rule, XRUN_M, seed=XRUN_SEED)
        pipe = ResidentPipeline(M=XRUN_M, T=4, S=1, rule=rule, kind="morton",
                                device="cpu")
        _killed(pipe, str(work / "port_kill" / rule), state0, steps, kill,
                interval)
    return work, recipe_arrays(work, "xrun")


@pytest.mark.parametrize("case", XRUN_CASES, ids=[c[0] for c in XRUN_CASES])
def test_jax_killed_run_resumes_in_port(xrun, case):
    work, ref = xrun
    rule, interval, steps, kill, kind, T, S = case
    assert ckpt.latest_step(str(work / "jax_kill" / rule)) < kill
    state0 = initial_state(rule, XRUN_M, seed=XRUN_SEED)
    pipe = ResidentPipeline(M=XRUN_M, T=T, S=S, rule=rule, kind=kind, device="cpu")
    out = CheckpointedRun(pipe, str(work / "jax_kill" / rule),
                          interval=interval).run(state0, steps)
    assert_matches(torch.from_numpy(out), ref[f"plain/{rule}"], rule, rule)


@pytest.mark.parametrize("case", XRUN_CASES, ids=[c[0] for c in XRUN_CASES])
def test_port_killed_run_resumes_in_jax(xrun, case):
    work, ref = xrun
    rule, interval, steps, *_ = case
    assert ckpt.latest_step(str(work / "port_kill" / rule)) == steps
    assert_matches(torch.from_numpy(ref[f"resumed/{rule}"]), ref[f"plain/{rule}"],
                   rule, rule)
    state0 = initial_state(rule, XRUN_M, seed=XRUN_SEED)
    mine = _ref(ResidentPipeline(M=XRUN_M, T=4, S=1, rule=rule, kind="morton",
                                 device="cpu"), state0, steps)
    assert_matches(torch.from_numpy(mine), ref[f"plain/{rule}"], rule, rule)
