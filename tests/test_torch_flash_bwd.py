"""Flash attention's backward: the plain versions of the backward kernels
(``ref.flash_attention_bwd_ref``) and of the forward's log-sum-exp
(``ref.flash_attention_lse_ref``), the ``flash_attention_bwd`` wrapper and
``ops.flash_attention``'s gradients on the CPU, against ``jax.vjp`` of the
JAX package's ``ops.flash_attention`` on the same numpy inputs.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``flash_bwd``): its Pallas forward in interpret mode, its backward
``_fa_bwd`` (the vjp of the dense oracle). That backward gives NaN wherever
a row with no key reaches (causal, Sq > Sk) and the port gives 0 there:
such cases are compared on the rows that have a key, against the JAX vjp
of those rows alone, and the port's zeros are asserted.
"""

import math

import numpy as np
import pytest
import torch

from _torch_oracle import FLASH_BWD_CASES, flash_bwd_inputs, reference_arrays
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attn import flash_attention_bwd, flash_attention_fwd

# f32 on both sides, the same gradient summed in other orders (the port from
# the saved output and log-sum-exp, the JAX package through the dense
# oracle's vjp), gradients of order 1: the training slice's 1e-5
F32_TOL = 1e-5
# bf16: both sides compute in f32 from the same bf16 inputs and round each
# gradient once, but the JAX vjp rounds its kv gradients before the GQA sum
# and the port's Δ reads the bf16 output: a relative L2 error of a few 1e-3
# (each side's own from the f32 gradient), held within one bf16 unit, 2^-7
BF16_REL_L2 = 2.0 ** -7
# the new backward against the old recompute path (autograd of the dense
# oracle) on CPU tensors in f32, as a share of the gradient's largest
# element: the port's Δ = rowsum(dO∘O) and the oracle's Σ P·dP are equal
# sums of terms of order sqrt(D) taken in other orders, so a gradient near
# 0 (a row with one key) sits a few 1e-7 of the terms' size from it
# (up to 5.8e-7 of the largest element in these cases)
RECOMPUTE_TOL = 1e-6


@pytest.fixture(scope="module")
def ref_bwd(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "flash_bwd")


def _inputs(case, requires_grad=True):
    dtype = getattr(torch, case[-1])
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in flash_bwd_inputs(case))
    if requires_grad:
        q, k, v = (t.requires_grad_() for t in (q, k, v))
    return q, k, v, g


def _close(got: torch.Tensor, want: np.ndarray, dtype, what):
    got = got.detach().float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL, err_msg=what)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL_L2, (what, rel)


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_attention_grads_match_jax(ref_bwd, case):
    """ops.flash_attention's gradients (the plain backward on the CPU, no
    launch) against jax.vjp of the JAX package's flash_attention."""
    B, hkv, rep, sq, sk, D, causal, _ = case
    q, k, v, g = _inputs(case)
    before = dict(_build.LAUNCHES)
    tops.flash_attention(q, k, v, causal, "morton", 16, 16).backward(g)
    assert _build.LAUNCHES == before
    grads = dict(zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad)))
    for name, got in grads.items():
        assert got.dtype == q.dtype and bool(torch.isfinite(got.float()).all()), name
    if not (causal and sq > sk):
        for name, got in grads.items():
            _close(got, ref_bwd[f"{case}/{name}"], q.dtype, name)
        return
    # rows 0 .. sq - sk - 1 see no key: the port's dq is 0 there, the JAX
    # vjp's dv is NaN throughout (the empty rows' NaN probabilities reach
    # every key); everything else is held against the vjp of the keyed rows
    empty = sq - sk
    assert not bool(grads["dq"][:, :, :empty].any())
    assert np.isnan(ref_bwd[f"{case}/dv"]).all()
    _close(grads["dq"][:, :, empty:], ref_bwd[f"{case}/keyed/dq"], q.dtype, "dq")
    _close(grads["dk"], ref_bwd[f"{case}/keyed/dk"], q.dtype, "dk")
    _close(grads["dv"], ref_bwd[f"{case}/keyed/dv"], q.dtype, "dv")
    # the full vjp agrees wherever it is a number
    for name, got in grads.items():
        want = ref_bwd[f"{case}/{name}"]
        fin = torch.from_numpy(np.isfinite(want))
        if fin.any():
            _close(got[fin], want[fin.numpy()], q.dtype, name)


@pytest.mark.parametrize("case", [c for c in FLASH_BWD_CASES if c[-1] == "float32"],
                         ids=str)
def test_plain_backward_is_the_jax_vjp_of_the_folded_heads(ref_bwd, case):
    """ref.flash_attention_bwd_ref on the GQA-folded tensors, each kv
    head's gradient summed over its group, is the JAX package's gradient
    (on the rows that have a key)."""
    B, hkv, rep, sq, sk, D, causal, _ = case
    q, k, v, g = _inputs(case, requires_grad=False)
    qf, kf, vf = tops._fold_gqa(q, k, v)
    o = ref.flash_attention_ref(qf, kf, vf, causal)
    lse = ref.flash_attention_lse_ref(qf, kf, causal)
    dq, dk, dv = ref.flash_attention_bwd_ref(qf, kf, vf, o, lse, g.reshape(qf.shape),
                                             causal)
    dq = dq.reshape(q.shape)
    dk, dv = (t.reshape(B, hkv, rep, sk, D).sum(2) for t in (dk, dv))
    keyed = "/keyed" if causal and sq > sk else ""
    _close(dq[:, :, sq - sk:] if keyed else dq, ref_bwd[f"{case}{keyed}/dq"],
           torch.float32, "dq")
    _close(dk, ref_bwd[f"{case}{keyed}/dk"], torch.float32, "dk")
    _close(dv, ref_bwd[f"{case}{keyed}/dv"], torch.float32, "dv")


@pytest.mark.parametrize("sq,sk,causal", [(32, 32, True), (48, 32, True), (16, 40, True),
                                          (24, 40, False)])
def test_lse_ref_is_the_logsumexp_in_f64(sq, sk, causal):
    """The plain log-sum-exp against torch.logsumexp of the scaled scores
    in f64, within 1e-5 (f32); +inf on the rows with no key."""
    rng = np.random.default_rng(sq + sk)
    q, k = (torch.from_numpy(rng.normal(size=(3, s, 40)).astype(np.float32))
            for s in (sq, sk))
    got = ref.flash_attention_lse_ref(q, k, causal)
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) / math.sqrt(40)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    want = torch.logsumexp(s, dim=-1)
    keyed = torch.isfinite(want)
    assert got.dtype == torch.float32 and got.shape == (3, sq)
    assert bool((got[~keyed] == float("inf")).all())
    assert int(keyed.sum()) == 3 * min(sq, sq if not causal else sk)
    torch.testing.assert_close(got[keyed].double(), want[keyed], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [(2, 1, 3, 32, 32, 64, True), (1, 2, 1, 24, 40, 40, True),
                                  (1, 1, 2, 32, 48, 16, False), (1, 2, 2, 100, 100, 64, True)],
                         ids=str)
def test_backward_equals_the_old_recompute_path(case):
    """On CPU tensors in f32 the backward (from the saved output and
    log-sum-exp) is the vector-Jacobian product of the dense oracle on the
    folded tensors, which it replaces, within 1e-6 of each gradient's
    largest element."""
    B, hkv, rep, sq, sk, D, causal = case
    q, k, v, g = _inputs(case + ("float32",))
    tops.flash_attention(q, k, v, causal, "hilbert", 128, 128).backward(g)
    want = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref.attention_ref(*tops._fold_gqa(*want), causal=causal).reshape(g.shape).backward(g)
    for got, w in zip((q, k, v), want):
        assert bool(torch.isfinite(got.grad).all())
        assert (got.grad - w.grad).abs().max() <= RECOMPUTE_TOL * w.grad.abs().max()


def test_forward_returns_the_lse_and_the_wrapper_checks():
    """flash_attention_fwd(return_lse=True) gives the plain log-sum-exp
    beside the output; flash_attention_bwd runs the plain backward on the
    CPU with no launch, and refuses what the kernels do not take."""
    q, k, v, g = (t[0] for t in _inputs((1, 2, 1, 32, 48, 40, True, "float32"),
                                        requires_grad=False))
    o, lse = flash_attention_fwd(q, k, v, block_q=16, block_k=16, return_lse=True)
    assert torch.equal(o, flash_attention_fwd(q, k, v, block_q=16, block_k=16))
    assert torch.equal(lse, ref.flash_attention_lse_ref(q, k))
    before = dict(_build.LAUNCHES), dict(_build.FLASH_BWD_DESIGN_LAUNCHES)
    got = flash_attention_bwd(q, k, v, o, lse, g, block_q=16, block_k=16)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (dict(_build.LAUNCHES), dict(_build.FLASH_BWD_DESIGN_LAUNCHES)) == before
    blocks = dict(block_q=16, block_k=16)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse.double(), g, **blocks)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse[:, :-1], g, **blocks)
    with pytest.raises(ValueError, match="o and do"):
        flash_attention_bwd(q, k, v, o[:, :-1], lse, g, **blocks)
    with pytest.raises(ValueError, match="o and do"):
        flash_attention_bwd(q, k, v, o, lse, g.bfloat16(), **blocks)
    with pytest.raises(ValueError, match="block"):
        flash_attention_bwd(q, k, v, o, lse, g, block_q=48, block_k=16)
    with pytest.raises(TypeError, match="float32"):
        flash_attention_bwd(q.double(), k, v, o, lse, g, **blocks)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float8_e4m3fn])
def test_plain_backward_keeps_the_dtype(dtype):
    """f16 and fp8 gradients: the f32 gradient rounded once, as the simple
    design's kernels round it (fp8 as XLA rounds, ``ref.round_to``)."""
    q, k, v, g = (t[0].to(dtype) for t in _inputs((1, 2, 1, 32, 32, 64, True, "float32"),
                                                 requires_grad=False))
    o, lse = flash_attention_fwd(q, k, v, block_q=16, block_k=16, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, g, block_q=16, block_k=16)
    want = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse,
                                       g.float())
    bits = lambda t: t.view(torch.uint8) if t.element_size() == 1 else t
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert torch.equal(bits(a), bits(ref.round_to(b, dtype)))
