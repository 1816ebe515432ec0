"""The single-block case (M = T) of the fused stencil on CPU tensors
against the JAX package's oracle: every neighbour of the one block is the
block itself. A file of its own because each new window shape costs the
JAX side seconds of eager compiles.
"""

import pytest

from _torch_oracle import RULES, assert_matches, jax_fused, port_fused, random_store


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_single_block_case_matches_jax_oracle(S):
    """M = T: every neighbour of the one block is the block itself
    (T=4; S=8 needs T=8 and runs gol under periodic only, because each
    new window shape costs the JAX side seconds of eager compiles)."""
    for rule in RULES if S < 8 else ("gol",):
        store = random_store(rule, 1, max(4, S), seed=S)
        for bc in ("periodic", "neumann0") if S < 8 else ("periodic",):
            got = port_fused(store, "hilbert", 1, bc, S, rule)
            assert_matches(got, jax_fused(store, "hilbert", 1, bc, S, rule),
                           rule, (rule, bc))
