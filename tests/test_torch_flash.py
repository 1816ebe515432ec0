"""Flash attention: the torch package's build_schedule, the kernel's plan,
flash_attention_fwd (its plain version on the CPU) and ops.flash_attention
against the JAX package's, on the same numpy inputs; the wrapper's checks,
its choice between the two CUDA designs, and a plain emulation of the
Hopper design's arithmetic against the plain version.

The JAX kernel runs as its own tests run it on the CPU, in interpret mode,
in the reference subprocess (tests/_torch_oracle.py, recipe ``flash``).
"""

import numpy as np
import pytest
import torch

from _torch_oracle import (BLOCK_CASES, FLASH_BF16_BLOCK, FLASH_BF16_SHAPE,
                           FLASH_MANY_HEADS, FLASH_NARROW_DTYPES, FLASH_SCHEDULES,
                           FLASH_SHAPES, FLASH_WIDE_SHAPES, FLASH_XWIDE_SHAPES,
                           SCHEDULE_GRIDS, any_block_inputs,
                           flash_inputs, gqa_inputs, reference_arrays)
from repro.kernels import ops as jops
from repro_torch.configs import smollm_360m
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attn import (build_schedule, flash_attention_fwd,
                                            flash_design, pad_head_dim,
                                            schedule_plan)

# The plain version against the Pallas kernel in f32: both are f32
# softmax attention, summed in another order (dense against online, in
# 16-blocks): the JAX package's own tolerance (tests/test_kernels.py).
F32_TOL = 2e-4
# ops.flash_attention at blocks that are not multiples of 16: the plain
# version against the Pallas kernel, one or two blocks per head at S <= 100
ANY_BLOCK_TOL = 1e-5
# bf16: both compute in f32 from the same bf16 inputs and round the output
# once, so they differ by at most one bf16 unit in the last place
# (2^-7 of the value) where the f32 results straddle a rounding boundary.
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# head dims above 256 in f32: the plain version against the Pallas kernel,
# one or two 16-blocks per head of 32 keys
WIDE_F32_TOL = 1e-5


def one_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    """|got - want| within one unit in the last place of their dtype at
    ``want``, plus BF16_ATOL: both are computed in f32 and rounded once, so
    the f32 results straddle at most one rounding boundary, and where the
    output is small beside the terms of its sum (|o| ~ 1e-4 from values of
    order 1) their f32 difference, about 1e-7, can exceed a unit of f16."""
    fi = torch.finfo(want.dtype)
    w = want.double()
    unit = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(fi.tiny)))) * fi.eps
    return got.dtype == want.dtype and bool(
        ((got.double() - w).abs() <= BF16_ATOL + unit).all())


@pytest.fixture(scope="module")
def ref_flash(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "flash")


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", FLASH_SCHEDULES)
@pytest.mark.parametrize("grid", SCHEDULE_GRIDS,
                         ids=["x".join(map(str, g)) for g in SCHEDULE_GRIDS])
def test_build_schedule_equals_jax(ref_flash, grid, kind, causal):
    nq, nk, bq, bk, offs = grid
    tag = f"{kind}/{int(causal)}/{nq}x{nk}/{bq}x{bk}/{offs}"
    iq, ik = build_schedule(nq, nk, causal=causal, block_q=bq, block_k=bk,
                            kind=kind, offs=offs)
    assert iq.dtype == ik.dtype == np.int32
    np.testing.assert_array_equal(iq, ref_flash[f"sched_iq/{tag}"])
    np.testing.assert_array_equal(ik, ref_flash[f"sched_ik/{tag}"])


@pytest.mark.parametrize("kind", FLASH_SCHEDULES)
@pytest.mark.parametrize("grid", SCHEDULE_GRIDS + ((4, 2, 16, 16, -32),),
                         ids=["x".join(map(str, g)) for g in SCHEDULE_GRIDS]
                         + ["4x2x16x16x-32"])
def test_schedule_plan_is_the_schedule_by_row(grid, kind):
    """The kernel's plan holds every cell once, each q block's kv blocks
    in the schedule's visit order, and every q block (those the schedule
    never visits last) in first-visit order."""
    nq, nk, bq, bk, offs = grid
    iq, ik = build_schedule(nq, nk, causal=True, block_q=bq, block_k=bk,
                            kind=kind, offs=offs)
    plan = schedule_plan(nq, nk, causal=True, block_q=bq, block_k=bk,
                         kind=kind, offs=offs)
    assert plan.dtype == np.int32 and plan.size == 2 * nq + 1 + iq.size
    order, row_ptr, cols = plan[:nq], plan[nq:2 * nq + 1], plan[2 * nq + 1:]
    assert sorted(order) == list(range(nq))
    seen = list(dict.fromkeys(iq.tolist()))
    assert order[:len(seen)].tolist() == seen
    for r in range(nq):
        np.testing.assert_array_equal(cols[row_ptr[r]:row_ptr[r + 1]], ik[iq == r])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", FLASH_SCHEDULES)
@pytest.mark.parametrize("n", range(len(FLASH_SHAPES)))
def test_plain_flash_matches_pallas_kernel(ref_flash, n, kind, causal):
    q, k, v = _t(*flash_inputs(FLASH_SHAPES[n], n))
    got = flash_attention_fwd(q, k, v, causal=causal, block_q=16, block_k=16,
                              schedule=kind)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref_flash[f"fwd/{kind}/{int(causal)}/{n}"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_flash_bf16_matches_pallas_kernel(ref_flash):
    BH, S, D = FLASH_BF16_SHAPE
    q, k, v = (t.to(torch.bfloat16) for t in _t(*flash_inputs((BH, S, S, D), 99)))
    got = flash_attention_fwd(q, k, v, causal=True, block_q=FLASH_BF16_BLOCK,
                              block_k=FLASH_BF16_BLOCK)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref_flash["fwd_bf16"],
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_gqa_flash_attention_matches_jax(ref_flash):
    q, k, v = _t(*gqa_inputs())
    got = tops.flash_attention(q, k, v, True, "hilbert", 64, 64)
    np.testing.assert_allclose(got.numpy(), ref_flash["gqa"], rtol=F32_TOL,
                               atol=F32_TOL)
    # query head h reads kv head h // rep (repeat_interleave, not tile)
    np.testing.assert_array_equal(tops._fold_gqa(q, k, v)[1].numpy(),
                                  ref_flash["gqa_fold_k"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", BLOCK_CASES,
                         ids=[f"S{c[0]}-D{c[3]}" for c in BLOCK_CASES])
def test_flash_attention_takes_every_block_the_reference_takes(ref_flash, case,
                                                               causal):
    """Blocks halved from 128 until they divide S (8, 12, 24 and 100),
    and D ∈ {12, 160, 256}: the JAX package runs them, and so does the
    port."""
    q, k, v = _t(*any_block_inputs(case))
    got = tops.flash_attention(q, k, v, causal, "morton", 128, 128)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref_flash[f"any_block/{case}/{int(causal)}"],
                               rtol=ANY_BLOCK_TOL, atol=ANY_BLOCK_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", FLASH_NARROW_DTYPES)
def test_narrow_dtypes_within_one_unit_of_pallas_kernel(ref_flash, dtype, causal):
    """F3: f16, float8_e4m3fn and float8_e5m2 q, k, v (the same bits in
    both packages), widened to f32 and the output rounded once to their
    dtype: within one unit in the last place of the JAX package's."""
    from _torch_oracle import narrow_flash_inputs

    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a.view(np.uint16 if dtype == "float16" else np.uint8)
                                .copy()).view(tdt)
               for a in narrow_flash_inputs(dtype, 60 + FLASH_NARROW_DTYPES.index(dtype)))
    got = flash_attention_fwd(q, k, v, causal=causal, block_q=16, block_k=16,
                              schedule="hilbert")
    want = torch.from_numpy(ref_flash[f"narrow/{dtype}/{int(causal)}"]).view(tdt)
    assert got.dtype == tdt and got.shape == q.shape
    assert one_ulp(got, want)
    assert flash_design(tdt, q.shape[2], 16, 16) == "simple"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_WIDE_SHAPES, ids=[f"D{s[2]}" for s in FLASH_WIDE_SHAPES])
def test_head_dims_up_to_1024_match_pallas_kernel(ref_flash, shape, dtype):
    """F1 above 256: D ∈ {320, 512, 1024} (320 padded to the DP=512
    build), f32 within 1e-5 and bf16 within one unit in the last place of
    the JAX package's kernel."""
    BH, S, D = shape
    tdt = getattr(torch, dtype)
    q, k, v = (t.to(tdt) for t in _t(*flash_inputs((BH, S, S, D), D)))
    got = flash_attention_fwd(q, k, v, causal=True, block_q=16, block_k=16)
    want = torch.from_numpy(ref_flash[f"wide/{D}/{dtype}"])
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=WIDE_F32_TOL, atol=WIDE_F32_TOL)
    else:
        assert one_ulp(got, want.to(tdt))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_XWIDE_SHAPES, ids=[f"D{s[2]}" for s in FLASH_XWIDE_SHAPES])
def test_head_dims_above_1024_match_pallas_kernel(ref_flash, shape, dtype, causal):
    """F1 above 1024: D ∈ {1152, 2048} (the simple design's wide instance
    on the card), f32 within 1e-5 and bf16 within one unit in the last
    place of the JAX package's kernel; the design is the simple one."""
    BH, S, D = shape
    tdt = getattr(torch, dtype)
    q, k, v = (t.to(tdt) for t in _t(*flash_inputs((BH, S, S, D), D)))
    got = flash_attention_fwd(q, k, v, causal=causal, block_q=16, block_k=16,
                              schedule="hilbert")
    want = torch.from_numpy(ref_flash[f"xwide/{D}/{dtype}/{int(causal)}"])
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=WIDE_F32_TOL, atol=WIDE_F32_TOL)
    else:
        assert one_ulp(got, want.to(tdt))
    assert flash_design(tdt, D, 16, 16) == "simple"


def test_more_heads_than_a_grid_has_rows_match_jax(ref_flash):
    """F4: BH = 65,536 folded heads (a CUDA grid has 65,535 rows; both
    designs launch the heads in chunks) against the JAX package's
    attention_ref, within 1e-5."""
    BH, S, D = FLASH_MANY_HEADS
    q, k, v = _t(*flash_inputs((BH, S, S, D), 65))
    got = flash_attention_fwd(q, k, v, causal=True, block_q=8, block_k=8)
    assert got.shape == (BH, S, D)
    torch.testing.assert_close(got, torch.from_numpy(ref_flash["many_heads"]),
                               rtol=WIDE_F32_TOL, atol=WIDE_F32_TOL)


def test_padded_head_dim_leaves_the_attention_unchanged():
    """The card's route for a head dim that is not a multiple of 8: zero
    columns padded to the next multiple, scores scaled by the true D, the
    padded output columns zero and sliced off."""
    q, k, v = _t(*flash_inputs((2, 24, 24, 12), 7))
    qp, kp, vp = pad_head_dim(q, k, v)
    assert qp.shape == (2, 24, 16) and kp.shape == vp.shape == (2, 24, 16)
    assert all(torch.equal(a[..., :12], b) and not a[..., 12:].any()
               for a, b in ((qp, q), (kp, k), (vp, v)))
    p = torch.softmax(qp @ kp.transpose(1, 2) / np.sqrt(12), dim=-1)
    out = p @ vp
    assert not out[..., 12:].any()
    torch.testing.assert_close(out[..., :12], ref.flash_attention_ref(q, k, v, False),
                               rtol=1e-6, atol=1e-6)
    q8 = q[..., :8]
    assert all(a is b for a, b in zip(pad_head_dim(q8, q8, q8), (q8,) * 3))


@pytest.mark.parametrize("s,pref", [(2048, 128), (16, 128), (96, 64), (48, 128),
                                    (7, 64), (1, 64), (32768, 128)])
def test_pick_block_equals_jax(s, pref):
    assert tops._pick_block(s, pref) == jops._pick_block(s, pref)


def test_rows_with_no_key_give_zero():
    """Sq > Sk, causal: the first Sq - Sk rows see no key and give 0 (the
    JAX oracle gives NaN there); the others equal attention_ref."""
    q, k, v = _t(*flash_inputs((2, 64, 32, 16), 5))
    got = flash_attention_fwd(q, k, v, causal=True, block_q=16, block_k=16)
    assert torch.all(got[:, :32] == 0)
    want = ref.attention_ref(q, k, v, causal=True)
    assert torch.isnan(want[:, :32]).all()
    torch.testing.assert_close(got[:, 32:], want[:, 32:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_equals_attention_ref(causal):
    q, k, v = _t(*flash_inputs((3, 32, 64, 8), 11))
    torch.testing.assert_close(ref.flash_attention_ref(q, k, v, causal),
                               ref.attention_ref(q, k, v, causal),
                               rtol=1e-6, atol=1e-6)


def test_wrapper_checks_and_counts_no_launch_on_cpu():
    q, k, v = _t(*flash_inputs((2, 64, 64, 16), 1))
    before = _build.LAUNCHES["flash_attention_fwd"]
    flash_attention_fwd(q, k, v, block_q=32, block_k=64)
    assert _build.LAUNCHES["flash_attention_fwd"] == before
    for kw in ({"block_q": 48}, {"block_k": 24}, {"block_q": 256},
               {"block_k": 128}, {"block_q": 0}):
        with pytest.raises(ValueError, match="block"):
            flash_attention_fwd(q, k, v, **{"block_q": 16, "block_k": 16, **kw})
    with pytest.raises(ValueError, match="schedule"):
        flash_attention_fwd(q, k, v, schedule="peano")
    with pytest.raises(TypeError, match="float32, bfloat16, float16, "
                                        "float8_e4m3fn or float8_e5m2"):
        flash_attention_fwd(q, k.double(), v)
    with pytest.raises(ValueError, match="head dim"):
        empty = torch.zeros(2, 64, 0)  # no head dim: the reference's scale is 1/0
        flash_attention_fwd(empty, empty, empty)
    with pytest.raises(ValueError, match="BH or D"):
        flash_attention_fwd(q, k[:1], v[:1])
    # a tensor that needs a gradient takes one: the backward's plain
    # version on the CPU, which launches nothing either, within 1e-6 of the
    # vector-Jacobian product of the oracle
    bwd_before = _build.LAUNCHES["flash_attention_bwd"]
    qg = q[None].clone().requires_grad_()
    tops.flash_attention(qg, k[None], v[None], True, "morton", 32, 64).sum().backward()
    o = ref.flash_attention_ref(q, k, v, causal=True)
    dq, _, _ = ref.flash_attention_bwd_ref(q, k, v, o, ref.flash_attention_lse_ref(q, k),
                                           torch.ones_like(q))
    assert torch.equal(qg.grad[0], dq)
    want = q[None].clone().requires_grad_()
    ref.attention_ref(want[0], k, v, causal=True).sum().backward()
    torch.testing.assert_close(qg.grad, want.grad, rtol=1e-6, atol=1e-6)
    assert _build.LAUNCHES["flash_attention_fwd"] == before
    assert _build.LAUNCHES["flash_attention_bwd"] == bwd_before


@pytest.mark.parametrize("dtype,d,block_q,block_k,want", [
    (torch.bfloat16, 64, 128, 128, "sm90"),   # the smollm-360m prefill
    (torch.bfloat16, 128, 128, 128, "sm90"),
    (torch.bfloat16, 64, 128, 64, "sm90"),
    (torch.bfloat16, 128, 64, 128, "sm90"),
    (torch.bfloat16, 64, 64, 64, "sm90"),
    (torch.float32, 64, 128, 128, "simple"),
    (torch.bfloat16, 40, 64, 64, "simple"),
    (torch.bfloat16, 96, 128, 128, "simple"),
    (torch.bfloat16, 64, 16, 128, "simple"),
    (torch.bfloat16, 64, 128, 32, "simple"),
    (torch.bfloat16, 256, 128, 128, "simple"),  # gemma3-1b's head dim
    (torch.bfloat16, 160, 64, 64, "simple"),
    (torch.float32, 256, 64, 64, "simple"),
    (torch.float16, 64, 128, 128, "simple"),    # F3: f16 and fp8
    (torch.float8_e4m3fn, 64, 128, 128, "simple"),
    (torch.float8_e5m2, 128, 64, 64, "simple"),
    (torch.bfloat16, 512, 128, 128, "simple"),  # F1 up to D = 1024
    (torch.float32, 1024, 64, 64, "simple"),
    (torch.bfloat16, 2048, 64, 64, "simple"),   # F1 above 1024: the wide instance
    (torch.float8_e5m2, 4096, 128, 128, "simple"),
])
def test_flash_design_is_a_function_of_dtype_d_and_blocks(dtype, d, block_q,
                                                          block_k, want):
    assert flash_design(dtype, d, block_q, block_k) == want


def test_smollm_prefill_takes_the_hopper_design_and_cpu_runs_none():
    """gqa_attention calls the kernel with 128 x 128 blocks on the bf16
    activations of smollm-360m; on the CPU neither design is launched."""
    cfg = smollm_360m.CONFIG
    assert cfg.activation_dtype == "bfloat16"
    assert flash_design(torch.bfloat16, cfg.hd, 128, 128) == "sm90"
    q, k, v = (t.to(torch.bfloat16) for t in _t(*flash_inputs((2, 128, 128, 64), 3)))
    before = dict(_build.FLASH_DESIGN_LAUNCHES)
    flash_attention_fwd(q, k, v, block_q=128, block_k=128)
    assert _build.FLASH_DESIGN_LAUNCHES == before


def _hopper_emulation(q, k, v, *, causal, block_q, block_k, schedule,
                      split=True):
    """The Hopper design's arithmetic in plain PyTorch (bf16 q, k, v):
    f32 scores from the exact bf16 products, each q block's kv tiles in
    the schedule's order, the running max kept scaled by log2(e)/sqrt(D),
    p = exp2(s·c - m) with one rounding, P split into bf16(P) + bf16(P -
    bf16(P)) (or, with ``split=False``, a single bf16(P)) multiplied by V
    into an f32 accumulator, the output rounded once to bf16."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    nq, nk, offs = Sq // block_q, Sk // block_k, Sk - Sq
    c = torch.tensor((1.0 / np.sqrt(D)) * np.float32(1.4426950408889634),
                     dtype=torch.float32)
    plan = schedule_plan(nq, nk, causal=causal, block_q=block_q,
                         block_k=block_k, kind=schedule, offs=offs)
    row_ptr, cols = plan[nq:2 * nq + 1], plan[2 * nq + 1:]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(BH, Sq, D)
    for iq in range(nq):
        rows = torch.arange(iq * block_q, (iq + 1) * block_q)
        acc = torch.zeros(BH, block_q, D)
        m = torch.full((BH, block_q, 1), -torch.inf)
        l = torch.zeros(BH, block_q, 1)
        for ik in cols[row_ptr[iq]:row_ptr[iq + 1]]:
            keys = torch.arange(ik * block_k, (ik + 1) * block_k)
            s = (qf[:, rows].double() @ kf[:, keys].double().transpose(1, 2)).float()
            if causal:
                s = s.masked_fill(keys[None, None, :] > rows[None, :, None] + offs,
                                  -torch.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2((s.double() * c.double() - m_use.double()).float())
            hi = p.to(torch.bfloat16)
            pv = hi.float() @ vf[:, keys]
            if split:
                pv = pv + (p - hi.float()).to(torch.bfloat16).float() @ vf[:, keys]
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv
            m = m_new
        out[:, rows] = acc * torch.where(l > 0, 1.0 / l, 0.0)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("case", [
    ((2, 256, 256, 64), True, 64, 64, "hilbert"),
    ((2, 256, 256, 64), True, 128, 64, "morton"),
    ((2, 256, 256, 128), True, 64, 128, "row_major"),
    ((2, 256, 128, 64), True, 64, 64, "hilbert"),     # Sq > Sk
    ((2, 128, 256, 64), False, 64, 64, "morton"),
], ids=["hilbert", "morton-128x64", "d128-row_major", "sq>sk", "full"])
def test_hopper_arithmetic_within_one_bf16_unit_of_plain(case):
    """The split P keeps the f32 result within about 2^-16 of sum |p v|
    of the plain version's, so the two bf16 outputs differ by at most one
    unit in the last place (the bf16 tolerance the card's check holds the
    kernel to). A single bf16(P) errs by up to 2^-8 per probability: with
    flat softmax rows and values of both signs the outputs are small, and
    that error exceeds the tolerance — the reason for the split."""
    (BH, Sq, Sk, D), causal, bq, bk, sched = case
    q, k, v = (t.to(torch.bfloat16) for t in _t(*flash_inputs((BH, Sq, Sk, D), 23)))
    want = ref.flash_attention_ref(q, k, v, causal=causal).float()
    tol = BF16_ATOL + BF16_RTOL * want.abs()
    got = _hopper_emulation(q, k, v, causal=causal, block_q=bq, block_k=bk,
                            schedule=sched).float()
    assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max()
    one = _hopper_emulation(q, k, v, causal=causal, block_q=bq, block_k=bk,
                            schedule=sched, split=False).float()
    assert not bool(((one - want).abs() <= tol).all())
