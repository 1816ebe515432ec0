"""The fused step and the resident tap sum on bf16, f16 and fp8 stores:
the wrappers (their plain versions, on CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its oracle, the dtypes of
what they return and take as ``out``, and the design each dtype is sent
to on the card (``fused_design``).

Every substep runs in f32 after an exact widening and the result rounds
once to the store's dtype (the fused step) or stays f32 (the tap sum), in
both packages; with the neighbour-count weights every product is exact,
so gol and wave are bit-equal, as they are in f32. An fp8 result rounds
as XLA converts (``ref.round_to``): float8_e4m3fn gives NaN above 464 in
magnitude where ``Tensor.to`` saturates at 448, so the fp8 stores hold
values in [440, 500] and NaN, and every fp8 comparison is of bits (NaN
where the JAX package gives NaN: ``same_bits``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import (FP8, bits, boundary, fp8_pair, fp8_values,
                           random_store, same_bits, tables, to_torch)
from repro.core import boundary as jbnd
from repro.kernels import ref as jref
from repro.kernels import stencil3d as jk
from repro.kernels.ops import _build_uniform_weights
from repro_torch.core import boundary as tbnd
from repro_torch.core import neighbors as tnbr
from repro_torch.core.layout import blockize
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil3d as tk
from repro_torch.kernels.ops import uniform_weights

M, T = 16, 4
NT = M // T
HALF = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
        "float16": (jnp.float16, torch.float16)}


def _stores(rule, dtype, seed):
    """The same half-precision store in both packages."""
    x = random_store(rule, NT ** 3, T, seed)
    jdt, tdt = HALF[dtype]
    js, ts = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(np.asarray(js.astype(jnp.float32)), ts.float().numpy())
    return js, ts


def _port(ts, bc, S, rule):
    _, (nbr, bnd) = tables("hilbert", NT, bc)
    return tk.stencil_step_fused(ts, uniform_weights(1, "cpu"), to_torch(nbr),
                                 to_torch(bnd), g=1, S=S, rule=rule,
                                 bc=boundary(tbnd, bc))


def _as_torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("rule,bc", [("gol", "periodic"), ("wave", "neumann0")])
def test_bf16_fused_matches_pallas_kernel(rule, bc, S):
    js, ts = _stores(rule, "bfloat16", seed=20 + S)
    (nbr, bnd), _ = tables("hilbert", NT, bc)
    want = jk.stencil_step_fused(js, jnp.asarray(_build_uniform_weights(1)),
                                 jnp.asarray(nbr), jnp.asarray(bnd), g=1, S=S,
                                 rule=rule, bc=boundary(jbnd, bc), interpret=True)
    got = _port(ts, bc, S, rule)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == ts.shape
    assert torch.equal(got.float(), _as_torch(want))


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("bc", ["periodic", "dirichlet", "mixed"])
@pytest.mark.parametrize("rule", ["gol", "wave"])
def test_half_fused_matches_jax_oracle(rule, bc, dtype):
    """S ∈ {1, 2} against the JAX package's jnp oracle, which widens the
    window to f32 and rounds the result to the store's dtype."""
    js, ts = _stores(rule, dtype, seed=30 + len(bc))
    (nbr, bnd), _ = tables("hilbert", NT, bc)
    for S in (1, 2):
        want = jref.stencil_fused_ref(js, jnp.asarray(_build_uniform_weights(1)),
                                      jnp.asarray(nbr), S=S, rule=rule,
                                      bc=boundary(jbnd, bc), bnd=jnp.asarray(bnd))
        got = _port(ts, bc, S, rule)
        assert got.dtype == ts.dtype
        assert torch.equal(got.float(), _as_torch(want)), (rule, bc, dtype, S)


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_resident_matches_pallas_kernel(dtype):
    """The resident tap sum of a bf16 or f16 store is f32, bit-equal to the
    JAX package's kernel."""
    x = np.random.default_rng(6).normal(size=(M, M, M)).astype(np.float32)
    jdt, tdt = HALF[dtype]
    store = blockize(torch.from_numpy(x).to(tdt), T, "morton")
    nbr = tnbr.neighbor_table("morton", NT)
    w = _build_uniform_weights(1)
    js = jnp.asarray(store.float().numpy()).astype(jdt)
    want = jk.stencil_sum_resident(js, jnp.asarray(w), jnp.asarray(nbr), g=1,
                                   interpret=True)
    got = tk.stencil_sum_resident(store, to_torch(w), to_torch(nbr), g=1)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert torch.equal(got, to_torch(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_fused_is_the_f32_run_rounded_once(dtype):
    """A half-precision store runs every substep in f32: an S-deep launch
    equals the same launch on the widened store, rounded once at the end
    (not S launches of S=1, which would round after each step)."""
    x = random_store("jacobi", NT ** 3, T, seed=8)
    ts = torch.from_numpy(x).to(dtype)
    w = torch.from_numpy(np.random.default_rng(9).normal(size=(3, 3, 3)).astype(np.float32))
    nbr = tnbr.neighbor_table_device("hilbert", NT, device="cpu")
    for S in (2, 4):
        got = tk.stencil_step_fused(ts, w, nbr, g=1, S=S, rule="jacobi")
        wide = tk.stencil_step_fused(ts.float(), w, nbr, g=1, S=S, rule="jacobi")
        assert torch.equal(got, wide.to(dtype))


def test_outputs_take_the_dtype_of_the_result():
    """``out`` of the fused step is in the store's dtype; that of the
    resident sum is f32. Anything else raises."""
    ts = torch.from_numpy(random_store("gol", NT ** 3, T, seed=4)).to(torch.bfloat16)
    w = uniform_weights(1, "cpu")
    nbr = tnbr.neighbor_table_device("morton", NT, device="cpu")
    out = torch.zeros_like(ts)
    assert tk.stencil_step_fused(ts, w, nbr, g=1, S=2, out=out) is out
    assert torch.equal(out, tref.stencil_fused_ref(ts, w, nbr, S=2))
    with pytest.raises(TypeError, match="bfloat16"):
        tk.stencil_step_fused(ts, w, nbr, g=1, out=torch.zeros(ts.shape))
    acc = torch.zeros(ts.shape)
    assert tk.stencil_sum_resident(ts, w, nbr, g=1, out=acc) is acc
    with pytest.raises(TypeError, match="float32"):
        tk.stencil_sum_resident(ts, w, nbr, g=1, out=torch.zeros_like(ts))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32,
                                   torch.float8_e4m3fnuz])
def test_stores_of_other_dtypes_raise(dtype):
    ts = torch.zeros((NT ** 3, T, T, T)).to(dtype)
    w = uniform_weights(1, "cpu")
    nbr = tnbr.neighbor_table_device("morton", NT, device="cpu")
    for call in (lambda: tk.stencil_step_fused(ts, w, nbr, g=1),
                 lambda: tk.stencil_sum_resident(ts, w, nbr, g=1)):
        with pytest.raises(TypeError, match="float32, bfloat16, float16, "
                                            "float8_e4m3fn or float8_e5m2"):
            call()


def test_fused_design_sends_half_stores_to_the_first_design():
    """``fused_design(T, g, S, C, dtype)`` over its whole domain: the Hopper
    design exactly where it has an f32 instance, the first design for
    every bf16, f16 and fp8 store; the dtype defaults to f32."""
    n_sm90 = 0
    for T_ in range(1, 33):
        for g in range(1, 5):
            for S in range(1, 17):
                for C in (1, 2, 3):
                    f32 = tk.fused_design(T_, g, S, C)
                    assert f32 == tk.fused_design(T_, g, S, C, torch.float32)
                    n_sm90 += f32 == "sm90"
                    for dtype in (torch.bfloat16, torch.float16,
                                  torch.float8_e4m3fn, torch.float8_e5m2):
                        assert tk.fused_design(T_, g, S, C, dtype) == "simple"
    assert n_sm90 == 20


# ------------------------------------------------------- fp8 stores (F2)

def _fp8_stores(rule, dtype, seed):
    """The same fp8 store in both packages, converted once by XLA, and the
    port's own conversion of the same f32 values checked bit-equal to it."""
    base = random_store(rule, NT ** 3, T, seed)
    x = fp8_values(base.shape, seed + 1, base=base)
    js, ts = fp8_pair(x, dtype)
    assert same_bits(tref.round_to(torch.from_numpy(x), ts.dtype), js)
    return js, ts


@pytest.mark.parametrize("dtype", FP8 + ("float16",))
def test_round_to_is_xla_conversion(dtype):
    """``ref.round_to`` gives XLA's bits on a million random f32 bit
    patterns (every NaN payload, inf, subnormal and overflow among them)
    and on the edges of e4m3fn (448, 464) and e5m2 (57344, 61440): all of
    them in e4m3fn (NaN's sign too) and f16, NaN where XLA gives NaN in
    e5m2."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2 ** 32, size=1_000_000, dtype=np.uint64) \
        .astype(np.uint32).view(np.float32)
    edges = np.array([448, 463.99, 464, 464.01, 480, 57344, 61439, 61440,
                      np.inf, np.nan, 0.0, 2.0 ** -10, 2.0 ** -17],
                     dtype=np.float32)
    x = np.concatenate([x, edges, -edges])
    want = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = tref.round_to(torch.from_numpy(x), getattr(torch, dtype))
    assert same_bits(got, want)
    if dtype != "float8_e5m2":
        assert (bits(got) == bits(want)).all()
    if dtype == "float8_e4m3fn":  # where Tensor.to saturates instead
        big = torch.from_numpy(np.array([464.01, -1000.0, np.inf], np.float32))
        assert torch.isnan(tref.round_to(big, torch.float8_e4m3fn).float()).all()
        assert (big.to(torch.float8_e4m3fn).float().abs() == 448).all()


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
@pytest.mark.parametrize("rule", ["gol", "jacobi", "wave"])
@pytest.mark.parametrize("dtype", FP8)
def test_fp8_fused_matches_pallas_kernel(dtype, rule, bc):
    """S=1 on fp8 stores holding 440–500 and NaN: bit-equal to the JAX
    package's kernel, which writes in the store's fp8 dtype."""
    js, ts = _fp8_stores(rule, dtype, seed=40 + len(rule) + len(bc))
    (nbr, bnd), _ = tables("hilbert", NT, bc)
    want = jk.stencil_step_fused(js, jnp.asarray(_build_uniform_weights(1)),
                                 jnp.asarray(nbr), jnp.asarray(bnd), g=1, S=1,
                                 rule=rule, bc=boundary(jbnd, bc), interpret=True)
    got = _port(ts, bc, 1, rule)
    assert got.dtype == ts.dtype and str(want.dtype) == dtype
    assert same_bits(got, want)


@pytest.mark.parametrize("bc", ["neumann0", "mixed"])
@pytest.mark.parametrize("rule", ["gol", "jacobi", "wave"])
@pytest.mark.parametrize("dtype", FP8)
def test_fp8_fused_matches_jax_oracle(dtype, rule, bc):
    """S ∈ {1, 2} against the JAX package's jnp oracle under the clamped
    contracts the kernel test above leaves out: bit-equal, NaN where XLA
    gives NaN (e4m3fn above 464)."""
    js, ts = _fp8_stores(rule, dtype, seed=50 + len(rule) + len(bc))
    (nbr, bnd), _ = tables("hilbert", NT, bc)
    for S in (1, 2):
        want = jref.stencil_fused_ref(js, jnp.asarray(_build_uniform_weights(1)),
                                      jnp.asarray(nbr), S=S, rule=rule,
                                      bc=boundary(jbnd, bc), bnd=jnp.asarray(bnd))
        got = _port(ts, bc, S, rule)
        assert same_bits(got, want), (rule, bc, dtype, S)


@pytest.mark.parametrize("dtype", FP8)
def test_fp8_resident_matches_pallas_kernel(dtype):
    """The resident tap sum of an fp8 store is f32, bit-equal to the JAX
    package's kernel (NaN where a tap reads NaN)."""
    x = fp8_values((M, M, M), seed=11)
    js, ts = fp8_pair(x, dtype)
    store = blockize(ts.float(), T, "morton")
    store = tref.round_to(store, ts.dtype)
    nbr = tnbr.neighbor_table("morton", NT)
    w = _build_uniform_weights(1)
    jstore, _ = fp8_pair(store.float().numpy(), dtype)
    want = jk.stencil_sum_resident(jstore, jnp.asarray(w), jnp.asarray(nbr),
                                   g=1, interpret=True)
    got = tk.stencil_sum_resident(store, to_torch(w), to_torch(nbr), g=1)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert torch.isnan(got).any()
    assert same_bits(got, want)


@pytest.mark.parametrize("dtype", FP8)
def test_fp8_fused_is_the_f32_run_rounded_once(dtype):
    """An fp8 store runs every substep in f32 and rounds once, with XLA's
    rounding: an S-deep launch equals the launch on the widened store,
    rounded by ``round_to``; the identity rule's sums of 26 values of up
    to 448 overflow e4m3fn to NaN (never to 448) and stay finite in e5m2."""
    tdt = getattr(torch, dtype)
    x = random_store("jacobi", NT ** 3, T, seed=8) * 100
    ts = tref.round_to(torch.from_numpy(x), tdt)
    w = torch.from_numpy(np.random.default_rng(9).normal(size=(3, 3, 3)).astype(np.float32))
    nbr = tnbr.neighbor_table_device("hilbert", NT, device="cpu")
    for S in (2, 4):
        got = tk.stencil_step_fused(ts, w, nbr, g=1, S=S, rule="jacobi")
        wide = tk.stencil_step_fused(ts.float(), w, nbr, g=1, S=S, rule="jacobi")
        assert same_bits(got, tref.round_to(wide, tdt))
    big = tref.round_to(torch.full((NT ** 3, T, T, T), 448.0), tdt)
    ones = uniform_weights(1, "cpu")
    out = tk.stencil_step_fused(big, ones, nbr, g=1, rule="identity").float()
    if dtype == "float8_e4m3fn":
        assert torch.isnan(out).all()
    else:
        assert torch.equal(out, torch.full_like(out, 26 * 448.0).to(tdt).float())
