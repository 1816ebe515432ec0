"""The ssm and hybrid families — mamba2-2.7b (Mamba2/SSD) and zamba2-1.2b
(Mamba2 + one weight-shared attention block) — against the JAX package at
SMOKE sizes (f32 activations, the flash kernel's path on), the JAX weights
carried across by ``interop.lm_params_from_numpy``; and the SSD scan, its
decode step, one Mamba2 layer and the custom inits alone.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``lm_ssm``); the torch side on the CPU.
"""

import numpy as np
import pytest
import torch

from _torch_oracle import (GREEDY_NEW, GREEDY_P, INIT_DRAWS, LM_B, LM_S,
                           LM_SEED, SSD_CASES, SSD_GRAD_CHUNK, SSM_ARCHS,
                           arch_configs, lm_tokens, loss_batch,
                           mamba_layer_inputs, reference_arrays, ssd_cotangent,
                           ssd_inputs, tree_of)
from repro_torch.configs.registry import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import Model
from repro_torch.models import mamba2 as tm
from repro_torch.models import transformer as tfm
from repro_torch.models.params import _custom_fill, count_params, leaf_paths
from repro_torch.serve import greedy_decode

CFGS = arch_configs("repro_torch", SSM_ARCHS)
# f32 activations: the same arithmetic in both packages summed in other
# orders: logits, losses and the scan's values of scale 1 agree to 1e-5;
# gradients, summed over more terms, to a relative L2 error of 1e-4 per leaf
F32_TOL = 1e-5
GRAD_REL_L2 = 1e-4
SSD_NAMES = ("x", "dt", "A", "Bm", "Cm")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "lm_ssm")


@pytest.fixture(scope="module")
def models(ref):
    return {a: lm_params_from_numpy(tree_of(ref, f"params/{a}"), cfg, device="cpu")
            for a, cfg in CFGS.items()}


def _tokens(cfg):
    return torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, LM_S), LM_SEED))


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_param_tree_matches_jax(ref, models, arch):
    m = models[arch]
    got = {k: p.detach().numpy() for k, p in m.named_parameters()}
    want = {".".join(path): a for path, a in leaf_paths(tree_of(ref, f"params/{arch}"))}
    assert got.keys() == want.keys()
    assert {"layers.a_log", "layers.dt_bias", "layers.conv_w"} <= got.keys()
    assert ("shared_block.wq" in got) == (CFGS[arch].family == "hybrid")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_counts_of_full_width_equal_jax(ref, arch):
    """Counted from the defs: the full-width model is never allocated."""
    assert count_params(tfm.model_defs(get_config(arch))) == int(ref[f"n_params/{arch}"])


def test_hybrid_applies_the_shared_block_after_full_segments():
    """zamba2: the shared block after every full segment of ``period``
    layers, not after a short last one — 6 at full width (38 layers,
    period 6), 2 at SMOKE (5 layers, period 2) — and one cache slot each."""
    arch = "zamba2-1.2b"
    for cfg, want in ((get_config(arch), 6), (CFGS[arch], 2)):
        assert tfm._n_shared_apps(cfg) == want
        assert tfm.cache_defs(cfg, 1, 4)["shared"]["k"].shape[0] == want
    segs = tfm._mamba_segments(get_config(arch))
    assert [s[:2] for s in segs][-2:] == [(30, 36), (36, 38)]
    assert [s[2] for s in segs] == [True] * 6 + [False]
    assert tfm._mamba_segments(get_config("mamba2-2.7b")) == [(0, 64, False)]


def test_hybrid_application_counts_equal_jax(ref):
    arch = "zamba2-1.2b"
    assert [tfm._n_shared_apps(get_config(arch)),
            tfm._n_shared_apps(CFGS[arch])] == ref[f"n_apps/{arch}"].tolist()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_forward_and_prefill_match_jax(ref, models, arch):
    toks = _tokens(CFGS[arch])
    logits, aux = models[arch].forward({"tokens": toks})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref[f"forward/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)
    got = models[arch].prefill({"tokens": toks})
    np.testing.assert_allclose(got.numpy(), ref[f"prefill/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_steps_match_jax_and_forward(ref, models, arch):
    """Decode through the conv and SSM states (and the hybrid's shared
    k/v), written in place into the stacked cache, against the JAX decode
    and the chunked forward."""
    m = models[arch]
    toks = _tokens(CFGS[arch])
    cache = m.init_cache(LM_B, LM_S, torch.float32)
    assert set(cache) == ({"layers", "shared"} if CFGS[arch].family == "hybrid"
                          else {"layers"})
    assert set(cache["layers"]) == {"conv", "ssm"}
    full, _ = m.forward({"tokens": toks})
    for t in range(LM_S):
        lg, cache = m.decode(cache, {"tokens": toks[:, t:t + 1], "cur": t})
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[f"decode/{arch}"][t],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")
    assert all(bool(leaf.abs().sum() > 0) for _, leaf in leaf_paths(cache))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_greedy_decode_tokens_equal_jax(ref, models, arch):
    cfg = CFGS[arch]
    prompts = torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 1))
    out = greedy_decode(models[arch], prompts, GREEDY_NEW, GREEDY_P + GREEDY_NEW + 1)
    np.testing.assert_array_equal(out.numpy(), ref[f"greedy/{arch}"])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_and_grads_match_jax(ref, arch):
    cfg = CFGS[arch]
    model = lm_params_from_numpy(tree_of(ref, f"params/{arch}"), cfg,
                                 device="cpu").requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in loss_batch(cfg.vocab, 32, False).items()}
    loss, (ce, _) = model.loss(batch, remat=True)
    np.testing.assert_allclose(ce.item(), ref[f"loss/{arch}/ce"], rtol=F32_TOL,
                               atol=F32_TOL)
    paths, leaves = zip(*leaf_paths(model.params()))
    want = dict(leaf_paths(tree_of(ref, f"grads/{arch}")))
    assert set(paths) == set(want)
    for path, g in zip(paths, torch.autograd.grad(loss, leaves)):
        assert _rel_l2(g.numpy(), want[path]) <= GRAD_REL_L2, "/".join(path)


@pytest.mark.parametrize("T,chunk", SSD_CASES)
def test_ssd_chunked_matches_jax_and_the_recurrence(ref, T, chunk):
    """The chunked scan against the JAX package's (chunk 256 included:
    ``exp`` overflows above the diagonal there, and the selection keeps
    it finite) and against the recurrence, token by token, through
    ``ssd_decode_step``."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in ssd_inputs(T))
    y = tm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    want = ref[f"ssd/{T}/{chunk}"]
    assert bool(torch.isfinite(y).all())
    scale = np.abs(want).max()
    assert np.abs(y.numpy() - want).max() <= F32_TOL * scale
    h = torch.zeros((1, 4, 8, 16))
    steps = []
    for t in range(T):
        yt, h = tm.ssd_decode_step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        steps.append(yt)
    assert (torch.stack(steps, 1) - y).abs().max().item() <= F32_TOL * scale


@pytest.mark.parametrize("T,chunk", SSD_CASES)
def test_ssd_gradients_finite_at_the_production_chunk(ref, T, chunk):
    """The port's gradient of sum(y·g) at each chunk against the JAX
    package's at SSD_GRAD_CHUNK (the scan's value does not depend on the
    chunk). At chunk 256 the JAX package's own gradient is non-finite in
    dt and A (its mask selects after the ``exp``: 0·inf in the backward),
    a condition on the reference side; the port's is finite."""
    inputs = [torch.from_numpy(a).requires_grad_() for a in ssd_inputs(T)]
    g = torch.from_numpy(ssd_cotangent(T))
    grads = torch.autograd.grad((tm.ssd_chunked(*inputs, chunk) * g).sum(), inputs)
    for name, gr in zip(SSD_NAMES, grads):
        assert bool(torch.isfinite(gr).all()), name
        want = ref[f"ssd_grad/{T}/{SSD_GRAD_CHUNK}/{name}"]
        assert _rel_l2(gr.numpy(), want) <= GRAD_REL_L2, name
    jax_finite = {n: bool(np.isfinite(ref[f"ssd_grad/{T}/{chunk}/{n}"]).all())
                  for n in SSD_NAMES}
    assert jax_finite == {n: chunk < 256 or n not in ("dt", "A") for n in SSD_NAMES}


def test_ssd_chunk_must_divide_the_sequence():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in ssd_inputs(32))
    with pytest.raises(ValueError, match="32 is not a multiple of the SSD chunk 12"):
        tm.ssd_chunked(x, dt, A, Bm, Cm, 12)


@pytest.mark.parametrize("T,chunk", SSD_CASES)
def test_ssd_decode_step_matches_jax(ref, T, chunk):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in ssd_inputs(T))
    h = torch.from_numpy(np.random.default_rng(T).normal(size=(1, 4, 8, 16))
                         .astype(np.float32))
    y, h_new = tm.ssd_decode_step(h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    np.testing.assert_allclose(y.numpy(), ref[f"ssd_step/{T}/y"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(h_new.numpy(), ref[f"ssd_step/{T}/h"], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba2_block_and_decode_step_match_jax(ref, models, arch):
    """One Mamba2 layer (the first), its block over a sequence and one
    decode step from a random cache, which it only reads."""
    cfg = CFGS[arch]
    p0 = {k: v[0] for k, v in models[arch].params()["layers"].items()}
    x, x1, cache = mamba_layer_inputs(cfg)
    cache = {k: torch.from_numpy(v) for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        y = tm.mamba2_block(p0, torch.from_numpy(x), cfg)
        out, new = tm.mamba2_decode(p0, torch.from_numpy(x1), cache, cfg)
    np.testing.assert_allclose(y.numpy(), ref[f"block/{arch}"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(out.numpy(), ref[f"block_decode/{arch}/out"],
                               rtol=F32_TOL, atol=F32_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(new[k].numpy(), ref[f"block_decode/{arch}/cache/{k}"],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)
        assert torch.equal(cache[k], before[k])


@pytest.mark.parametrize("name,lo,hi", [("a_log", 1.0, 16.0),
                                        ("dt_bias", 1e-3, 1e-1)])
def test_custom_inits_range_and_distribution(ref, name, lo, hi):
    """a_log = log U[1, 16]; dt_bias = softplus⁻¹(dt), dt log-uniform in
    [1e-3, 1e-1]: the drawn A or dt lies in its range, and the port's
    draws (a ``torch.Generator``) and the JAX package's agree in
    distribution: every decile of log A or log dt within 2% of the
    range's log width."""
    t = torch.empty(INIT_DRAWS)
    _custom_fill(t, name, torch.Generator().manual_seed(LM_SEED))

    def drawn(a):
        a = torch.as_tensor(a, dtype=torch.float64)
        return (a.exp() if name == "a_log" else torch.nn.functional.softplus(a)).log()

    got, want = drawn(t), drawn(ref[f"init/{name}"])
    width = np.log(hi) - np.log(lo)
    assert got.min() >= np.log(lo) - 1e-5 and got.max() <= np.log(hi) + 1e-5
    q = torch.linspace(0.1, 0.9, 9, dtype=torch.float64)
    assert (got.quantile(q) - want.quantile(q)).abs().max() <= 0.02 * width
    with pytest.raises(ValueError, match="b_log"):
        _custom_fill(t, "b_log", torch.Generator())


def test_model_init_draws_the_custom_inits():
    """Model.init draws a_log and dt_bias by their custom inits (d_skip
    ones, conv_b and the norms zeros), from the generator alone."""
    cfg = CFGS["mamba2-2.7b"]
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1)).params()
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1)).params()
    lay = a["layers"]
    A = lay["a_log"].exp()
    assert bool(((A >= 1) & (A <= 16)).all())
    dt = torch.nn.functional.softplus(lay["dt_bias"])
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 1e-1 * (1 + 1e-5))).all())
    assert bool((lay["d_skip"] == 1).all()) and not lay["conv_b"].any()
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(leaf_paths(a), leaf_paths(b)))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_equals_forward_where_the_scan_matters(models, arch):
    """At SMOKE's init the conv's small weights leave the SSD's share of
    a layer's output near f32 rounding, so decode and forward agree bit
    for bit; with the conv's weights scaled up the scan carries the
    output (changing A moves the logits), and decode through the states
    still equals the chunked forward."""
    cfg = CFGS[arch]
    m = Model(cfg, device="cpu")
    with torch.no_grad():
        for (name, p), (_, q) in zip(m.named_parameters(), models[arch].named_parameters()):
            p.copy_(q * 50 if name == "layers.conv_w" else q)
    toks = _tokens(cfg)
    full, _ = m.forward({"tokens": toks})
    with torch.no_grad():
        m.layers.a_log.add_(1.0)
    moved = (m.forward({"tokens": toks})[0] - full).abs().max().item()
    with torch.no_grad():
        m.layers.a_log.sub_(1.0)
    assert moved > 1e-3
    cache = m.init_cache(LM_B, LM_S, torch.float32)
    for t in range(LM_S):
        lg, cache = m.decode(cache, {"tokens": toks[:, t:t + 1], "cur": t})
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")
