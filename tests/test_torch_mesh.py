"""The port's own checks of the distributed slice on the CPU: the full
matrix against its ordering-independent oracle, S-deep rounds against
per-step rounds, the local mesh's shift, and the process-group transport.

- 4 orderings × {gol, jacobi, wave} × 4 boundaries × S ∈ {1, 2, 4} on a
  local 2×2×2 mesh (global 16³) against ``fields_step_ref`` on the global
  cube, bit for bit (jacobi too: both sides divide and add in the same
  order).
- Process groups: gloo ranks spawned from a child process
  (tests/_torch_oracle.py ``ranks``; file rendezvous under the test's
  tmp_path, a 60 s group timeout, one thread per rank, a time limit on
  the whole spawn), one shard each, bit-equal to the local mesh.
"""

import numpy as np
import pytest
import torch

from _torch_oracle import (DIST_K, DIST_M, DIST_T, KINDS, RANK_CASES, RANK_KIND,
                           RANK_S, RULES, boundary, dist_cube, rank_arrays)
from repro_torch.core import boundary as tbnd
from repro_torch.core.orderings import ordering_from_name
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import uniform_weights
from repro_torch.stencil import (DistributedPipeline, make_distributed_step,
                                 make_stencil_mesh)
from repro_torch.stencil.halo import shard_state

BCS = ("periodic", "dirichlet", "neumann0", "mixed")


def _pipe(shape, kind, rule, bc, S):
    return DistributedPipeline(mesh=make_stencil_mesh(shape, device="cpu"),
                               spec=ordering_from_name(kind), M=DIST_M,
                               T=DIST_T, g=1, S=S, rule=rule,
                               bc=boundary(tbnd, bc))


def _oracle(cube, rule, bc, K):
    want = cube
    for _ in range(K):
        want = tref.fields_step_ref(want, uniform_weights(1, "cpu"), 1,
                                    rule=rule, bc=boundary(tbnd, bc))
    return want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rule", ["gol", "jacobi", "wave"])
def test_matrix_matches_own_oracle(kind, rule):
    """K = S + 1 steps: one S-deep round and a remainder round (two S=1
    rounds at S=1), every boundary, on a 2×2×2 mesh."""
    seed = 3 * KINDS.index(kind) + RULES.index(rule)
    cube = torch.from_numpy(dist_cube(rule, seed=seed))
    for bc in BCS:
        for S in (1, 2, 4):
            got = _pipe((2, 2, 2), kind, rule, bc, S).run_cube(cube, S + 1)
            assert torch.equal(got, _oracle(cube, rule, bc, S + 1)), (bc, S)


@pytest.mark.parametrize("rule", ["gol", "jacobi", "wave"])
@pytest.mark.parametrize("S", [2, 4])
def test_deep_round_equals_sequential_steps(rule, S):
    """One S-deep exchange round == S per-step rounds
    (make_distributed_step), bit for bit, under a mixed contract."""
    pipe = _pipe((2, 2, 2), "hilbert", rule, "mixed", S)
    shards = list(shard_state(torch.from_numpy(dist_cube(rule)), pipe.spec,
                              pipe.procs).flatten(0, 2))
    got = pipe.run(shards, S)
    step = make_distributed_step(pipe.mesh, pipe.spec, DIST_M, 1, T=DIST_T,
                                 rule=rule, bc=pipe.bc)
    want = shards
    for _ in range(S):
        want = step(want)
    assert len(got) == 8
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mesh_shift_semantics():
    """Local mesh: ppermute semantics on a 3-ring, open and periodic, with
    zeros where no pair sends; a 1-ring is a self-copy."""
    from repro_torch.core.neighbors import ring_perms

    mesh = make_stencil_mesh((3, 1, 2), device="cpu")
    assert mesh.shards[:3] == ((0, 0, 0), (0, 0, 1), (1, 0, 0))
    bufs = [torch.full((2,), float(mesh.rank_of(co))) for co in mesh.shards]
    fwd, bwd = ring_perms(3, periodic=True)
    got = mesh.shift(bufs, 0, fwd)
    for co, t in zip(mesh.shards, got):
        src = ((co[0] - 1) % 3, co[1], co[2])
        assert t[0].item() == mesh.rank_of(src)
    fwd, _ = ring_perms(3, periodic=False)
    got = mesh.shift(bufs, 0, fwd)
    for co, t in zip(mesh.shards, got):
        want = 0.0 if co[0] == 0 else float(mesh.rank_of((co[0] - 1, 0, co[2])))
        assert t[0].item() == want
    fwd, _ = ring_perms(1, periodic=True)
    assert mesh.shift(bufs, 1, fwd)[4] is bufs[4]
    assert all(t.abs().sum() == 0 for t in mesh.shift(bufs, 1, []))


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 1, 1)],
                         ids=["2x2x2-8ranks", "2x1x1-2ranks"])
def test_process_group_runs_equal_local_mesh(shape, tmp_path):
    """Gloo ranks, one shard each (the 2×1×1 mesh is the periodic 2-ring
    whose forward and backward messages go to one peer): every rank's
    cube equals the local-mesh run bit for bit."""
    got = rank_arrays(tmp_path, shape)
    n = int(np.prod(shape))
    for rule, bc in RANK_CASES:
        want = _pipe(shape, RANK_KIND, rule, bc, RANK_S).run_cube(
            torch.from_numpy(dist_cube(rule, shape)), DIST_K)
        for r in range(n):
            np.testing.assert_array_equal(got[f"{rule}/{bc}/rank{r}"],
                                          want.numpy(), err_msg=f"{rule} {bc} {r}")
