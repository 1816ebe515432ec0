"""The stencil kernels' wrappers on CPU tensors (their plain versions)
against the JAX package's oracle, on the same numpy inputs.

gol and wave are exact in f32 by construction (DESIGN.md §4, §9), so they
must be bit-equal. jacobi is compared at rtol=atol=1e-6: XLA may contract
or rewrite the JAX side's arithmetic (FMA contraction, division by a
constant), which moves the last ulp. The CUDA kernels are held against the
same plain versions on the card by chip_smoke.py; the Pallas kernels
themselves are in tests/test_torch_stencil_pallas.py.
"""

import pytest
import torch

from _torch_oracle import (BCS, KINDS, RULES, assert_matches, jax_fused,
                           port_fused, random_store)
from repro_torch.core import neighbors as tnbr
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil3d as tk
from repro_torch.kernels.ops import uniform_weights

M, T = 16, 4


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_matches_jax_oracle(kind, bc):
    """4 orderings × 4 boundaries here, × S ∈ {1, 2, 4} × {gol, jacobi,
    wave} inside (S=4 needs T=4, g=1)."""
    nt = M // T
    for rule in RULES:
        seed = 100 * KINDS.index(kind) + 10 * BCS.index(bc) + RULES.index(rule)
        store = random_store(rule, nt ** 3, T, seed)
        for S in (1, 2, 4):
            got = port_fused(store, kind, nt, bc, S, rule)
            assert_matches(got, jax_fused(store, kind, nt, bc, S, rule),
                           rule, (kind, bc, rule, S))


def test_fused_writes_into_out():
    nt = M // T
    store = torch.from_numpy(random_store("gol", nt ** 3, T, seed=2))
    w = uniform_weights(1, "cpu")
    nbr = tnbr.neighbor_table_device("morton", nt, device="cpu")
    out = torch.full_like(store, -1.0)
    got = tk.stencil_step_fused(store, w, nbr, g=1, S=2, out=out)
    assert got is out
    assert torch.equal(out, tref.stencil_fused_ref(store, w, nbr, S=2))


def _refused_call(case):
    nt = M // T
    w = uniform_weights(1, "cpu")
    store = torch.from_numpy(random_store("gol", nt ** 3, T, seed=3))
    nbr = tnbr.neighbor_table_device("morton", nt, device="cpu")
    if case == "dtype":
        return lambda: tk.stencil_step_fused(store.double(), w, nbr, g=1)
    if case == "S*g":
        return lambda: tk.stencil_step_fused(store, w, nbr, g=1, S=3)
    if case == "alias":
        return lambda: tk.stencil_step_fused(store, w, nbr, g=1, out=store)
    if case == "smem":  # T=32, S=8: two (32+16)³ f32 windows > 227 KB
        big = torch.zeros((1, 32, 32, 32))
        one = tnbr.neighbor_table_device("morton", 1, device="cpu")
        return lambda: tk.stencil_step_fused(big, w, one, g=1, S=8)
    if case == "bnd":
        return lambda: tk.stencil_step_fused(store, w, nbr, g=1, bc="neumann0")
    if case == "blocks_dtype":
        half = torch.zeros((1, 6, 6, 6), dtype=torch.float16)
        return lambda: tk.stencil_sum_blocks(half, w, g=1)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dtype", "S*g", "alias", "smem", "bnd",
                                  "blocks_dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        _refused_call(case)()


def test_smem_model_matches_the_kernel_layout():
    """Two C·(T+2Sg)³ f32 windows plus 33 int32 table entries."""
    assert tk.fused_smem_bytes(8, 1, 4) == 2 * 16 ** 3 * 4 + 132
    assert tk.fused_smem_bytes(16, 1, 4, fields=2) == 221_184 + 132
    assert tk.fused_smem_bytes(16, 1, 4, fields=2) <= tk.SMEM_LIMIT_BYTES
    assert tk.halo_smem_bytes(8, 1) == 10 ** 3 * 4
