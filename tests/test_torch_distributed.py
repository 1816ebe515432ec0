"""The slice end to end against the JAX package: the torch package's
communication-avoiding distributed pipeline on the same numpy inputs, and
its gol3d entry point against the resident path and the oracle.

``DistributedPipeline.run_cube`` on a local 2×2×2 mesh (global 16³,
local M=8, T=4, K=5) runs against the JAX package's on 8 host devices
(the reference subprocess, tests/_torch_oracle.py): 4 orderings × gol
periodic × S ∈ {1, 2}; {gol, jacobi, wave} × {dirichlet(0.5), neumann0,
mixed(k=neumann0)} on Hilbert; one 4×2×1 box. gol and wave are
bit-equal; jacobi is held within rtol=atol=1e-6, because XLA may contract
or reorder the JAX side's division and sums (DESIGN.md §4).
tests/test_torch_mesh.py holds the port's own matrix and its transports.
"""

import pytest
import torch

from _torch_oracle import (DIST_K, DIST_M, DIST_T, KINDS, boundary, dist_cases,
                           dist_cube, reference_arrays)
from repro_torch.core import boundary as tbnd
from repro_torch.core.orderings import ordering_from_name
from repro_torch.stencil import (DistributedPipeline, Gol3d, Gol3dConfig,
                                 make_stencil_mesh)
from repro_torch.stencil import halo

CASES = dist_cases()


@pytest.fixture(scope="module")
def ref_dist(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "distributed")


def _pipe(shape, kind, rule, bc, S, M=DIST_M, T=DIST_T):
    return DistributedPipeline(mesh=make_stencil_mesh(shape, device="cpu"),
                               spec=ordering_from_name(kind), M=M, T=T, g=1,
                               S=S, rule=rule, bc=boundary(tbnd, bc))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_run_cube_matches_jax_package(case, ref_dist):
    name, kind, rule, bc, S, shape = case
    cube = torch.from_numpy(dist_cube(rule, shape))
    got = _pipe(shape, kind, rule, bc, S).run_cube(cube, DIST_K)
    want = torch.from_numpy(ref_dist[name])
    assert got.shape == want.shape
    if rule == "jacobi":
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-6), name
    else:
        assert torch.equal(got, want), name
    assert torch.equal(cube, torch.from_numpy(dist_cube(rule, shape)))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (4, 2, 1)])
def test_global_M_as_the_jax_package(shape):
    """``global_M`` is the cube edge on a cubic mesh and refuses a
    non-cubic one, as the JAX package's does (its mesh stands in by its
    axis sizes alone)."""
    import types

    from repro.core.orderings import MORTON as JMORTON
    from repro.stencil.pipeline import DistributedPipeline as JPipeline

    mine = _pipe(shape, "morton", "gol", "periodic", 1)
    theirs = JPipeline(mesh=types.SimpleNamespace(shape=dict(zip(
        ("dx", "dy", "dz"), shape))), spec=JMORTON, M=DIST_M, T=DIST_T)
    assert mine.global_shape == theirs.global_shape
    if len(set(shape)) == 1:
        assert mine.global_M == theirs.global_M == shape[0] * DIST_M
    else:
        with pytest.raises(ValueError, match="cubic"):
            mine.global_M
        with pytest.raises(AssertionError):
            theirs.global_M


@pytest.mark.parametrize("kind", KINDS)
def test_gol3d_run_distributed_equals_resident_and_reference(kind):
    cfg = Gol3dConfig(M=16, g=1, ordering=ordering_from_name(kind), block_T=4,
                      substeps=2, seed=9, device="cpu")
    ref = Gol3d(cfg).reference_run(5)
    res = Gol3d(cfg)
    res.run_resident(5)
    for shape in ((1, 1, 1), (2, 2, 2)):
        app = Gol3d(cfg)
        out = app.run_distributed(make_stencil_mesh(shape, device="cpu"), 5)
        assert out is app.state_path
        assert torch.equal(app.state_path, res.state_path), shape
        assert torch.equal(app.cube, ref), shape
    assert Gol3d(cfg).distributed_pipeline(
        make_stencil_mesh((2, 2, 2), device="cpu")).M == 8


def test_substeps_zero_delegates_to_distributed_plan():
    cfg = Gol3dConfig(M=32, substeps=0, ordering=ordering_from_name("morton"),
                      device="cpu")
    mesh = make_stencil_mesh((2, 2, 2), device="cpu")
    assert Gol3d(cfg).distributed_pipeline(mesh) == DistributedPipeline.plan(
        mesh, cfg.ordering, 16, g=1)


@pytest.mark.parametrize("bc", ["periodic", "mixed"])
@pytest.mark.parametrize("rule", ["gol", "wave"])
def test_packs_and_fused_steps_per_round(monkeypatch, bc, rule):
    """Each round packs six faces per shard (every channel in one pack),
    whatever the boundary, and runs one fused step per shard: the counts
    chip_smoke.py asserts for the gather_rows and fused kernels."""
    packs, fused = [], []
    real_pack, real_fused = halo.pack_surface, halo.stencil_step_fused

    def count_pack(data, *a, **kw):
        packs.append(tuple(data.shape))
        return real_pack(data, *a, **kw)

    def count_fused(*a, **kw):
        fused.append(kw["S"])
        return real_fused(*a, **kw)

    monkeypatch.setattr(halo, "pack_surface", count_pack)
    monkeypatch.setattr(halo, "stencil_step_fused", count_fused)
    pipe = _pipe((2, 2, 2), "morton", rule, bc, 2)
    pipe.run_cube(torch.from_numpy(dist_cube(rule)), 5)  # rounds: S=2, 2, 1
    assert len(packs) == 3 * 8 * 6
    assert set(packs) == {(2 if rule == "wave" else 1, DIST_M ** 3)}
    assert fused == [2] * 8 + [2] * 8 + [1] * 8
