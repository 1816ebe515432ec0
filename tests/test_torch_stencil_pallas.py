"""The stencil kernels' wrappers on CPU tensors against the Pallas kernels
in interpret mode, and the identities the CUDA kernels are held to on the
card: resident sum == repack sum, and one S-deep launch == S sequential
launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import (BCS, KINDS, RULES, assert_matches, boundary,
                           port_fused, random_store, tables, to_torch)
from repro.core import boundary as jbnd
from repro.core.layout import blockize_with_halo as jax_blockize_with_halo
from repro.kernels import stencil3d as jk
from repro.kernels.ops import _build_uniform_weights
from repro_torch.core import neighbors as tnbr
from repro_torch.core.layout import blockize, blockize_with_halo
from repro_torch.kernels import stencil3d as tk
from repro_torch.kernels.ops import uniform_weights

M, T = 16, 4


@pytest.mark.parametrize("kind,bc,S,rule", [
    ("hilbert", "periodic", 2, "gol"),
    ("morton", "neumann0", 2, "wave"),
    ("row_major", "dirichlet", 1, "jacobi"),
    ("column_major", "mixed", 4, "gol"),
])
def test_fused_matches_pallas_kernel(kind, bc, S, rule):
    nt = M // T
    store = random_store(rule, nt ** 3, T, seed=S)
    (nbr, bnd), _ = tables(kind, nt, bc)
    want = jk.stencil_step_fused(jnp.asarray(store),
                                 jnp.asarray(_build_uniform_weights(1)),
                                 jnp.asarray(nbr), jnp.asarray(bnd), g=1, S=S,
                                 rule=rule, bc=boundary(jbnd, bc), interpret=True)
    got = port_fused(store, kind, nt, bc, S, rule)
    assert_matches(got, np.asarray(want), rule, (kind, bc, S, rule))


def test_resident_and_blocks_match_pallas_kernels():
    x = np.random.default_rng(4).normal(size=(8, 8, 8)).astype(np.float32)
    w = _build_uniform_weights(1)
    store = blockize(to_torch(x), 4, "morton")
    nbr = tnbr.neighbor_table("morton", 2)
    got = tk.stencil_sum_resident(store, to_torch(w), to_torch(nbr), g=1)
    want = jk.stencil_sum_resident(jnp.asarray(store.numpy()), jnp.asarray(w),
                                   jnp.asarray(nbr), g=1, interpret=True)
    assert torch.equal(got, to_torch(want))
    halo = jax_blockize_with_halo(jnp.asarray(x), 4, 1, "morton")
    assert torch.equal(blockize_with_halo(to_torch(x), 4, 1, "morton"),
                       to_torch(halo))
    want_b = jk.stencil_sum_blocks(halo, jnp.asarray(w), g=1, interpret=True)
    got_b = tk.stencil_sum_blocks(to_torch(halo), to_torch(w), g=1)
    assert torch.equal(got_b, to_torch(want_b))


@pytest.mark.parametrize("kind", KINDS)
def test_resident_sum_equals_repack_sum(kind):
    x = to_torch(np.random.default_rng(5).normal(size=(16, 16, 16)).astype(np.float32))
    for T_, g in ((4, 1), (8, 2), (4, 4)):
        w = uniform_weights(g, "cpu")
        nbr = tnbr.neighbor_table_device(kind, 16 // T_, device="cpu")
        res = tk.stencil_sum_resident(blockize(x, T_, kind), w, nbr, g=g)
        rep = tk.stencil_sum_blocks(blockize_with_halo(x, T_, g, kind), w, g=g)
        assert torch.equal(res, rep), (T_, g)


@pytest.mark.parametrize("rule", RULES)
def test_fused_equals_sequential_steps(rule):
    """One S-deep launch == S launches of S=1, bit for bit."""
    nt = M // T
    for bc in BCS:
        store = random_store(rule, nt ** 3, T, seed=11)
        for S in (2, 4):
            fused = port_fused(store, "hilbert", nt, bc, S, rule)
            seq = store
            for _ in range(S):
                seq = port_fused(seq, "hilbert", nt, bc, 1, rule).numpy()
            assert torch.equal(fused, to_torch(seq)), (bc, S)
