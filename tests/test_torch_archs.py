"""The dense archs beside smollm-360m — gemma3-1b (sliding window,
local:global layers, two RoPE bases), deepseek-coder-33b and
phi4-mini-3.8b — and temperature sampling: the torch package against the
JAX package at SMOKE sizes (f32 activations, the flash kernel's path on),
the JAX weights carried across by ``interop.lm_params_from_numpy``.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``lm_archs``), its flash attention as the Pallas kernel in
interpret mode; the torch side on the CPU, where the flash wrapper runs
its plain version. Sampled tokens are held equal by carrying the Gumbel
noise that ``jax.random.categorical`` draws from each step's key across
as numpy, in the batch's ``"gumbel"`` tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_oracle import (DENSE_ARCHS, GREEDY_NEW, GREEDY_P, LM_B, LM_S,
                           LM_SEED, SAMPLE_TEMPS, STEP_OPT, STEP_PIPE,
                           arch_configs, lm_tokens, reference_arrays, tree_of)
from repro_torch.configs.registry import get_config
from repro_torch.data import TokenPipeline
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models.zoo import active_params
from repro_torch.models import transformer as tfm
from repro_torch.models.params import count_params, leaf_paths
from repro_torch.serve import greedy_decode, make_serve_step
from repro_torch.train import (OptConfig, TrainConfig, init_opt_state,
                               make_train_step)

CFGS = arch_configs("repro_torch", DENSE_ARCHS)
# f32 activations: the same arithmetic in both packages, summed in other
# orders (XLA's CPU dots against torch's; dense softmax against the Pallas
# kernel's online softmax): logits of scale 1 agree to 1e-5, a train
# step's parameters to 1e-4 relative (as tests/test_torch_train.py)
F32_TOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# AdamW's eps is 1e-8: a gradient of 100·eps or more is well-conditioned
COND_GRAD = 1e-6
# decode against forward, as tests/test_models.py holds the JAX package
DECODE_VS_FORWARD_TOL = 2e-2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "lm_archs")


@pytest.fixture(scope="module")
def models(ref):
    return {a: lm_params_from_numpy(tree_of(ref, f"params/{a}"), cfg, device="cpu")
            for a, cfg in CFGS.items()}


def _tokens(cfg):
    return torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, LM_S), LM_SEED))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_tree_matches_jax(ref, models, arch):
    m = models[arch]
    got = {k: p.detach().numpy() for k, p in m.named_parameters()}
    want = {".".join(path): a for path, a in leaf_paths(tree_of(ref, f"params/{arch}"))}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert m.n_params() == sum(v.size for v in want.values())


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_n_params_of_full_width_equals_jax(ref, models, arch):
    """Counted from the defs (the full-width model is never allocated); a
    dense model's active count is all of it."""
    n = count_params(tfm.model_defs(get_config(arch)))
    assert n == int(ref[f"n_params/{arch}"])
    assert active_params(get_config(arch)) == n
    assert models[arch].n_active_params() == models[arch].n_params()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_jax(ref, models, arch):
    logits, aux = models[arch].forward({"tokens": _tokens(CFGS[arch])})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref[f"forward/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_matches_jax(ref, models, arch):
    got = models[arch].prefill({"tokens": _tokens(CFGS[arch])})
    assert got.shape == (LM_B, CFGS[arch].vocab)
    np.testing.assert_allclose(got.numpy(), ref[f"prefill/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_steps_match_jax_and_forward(ref, models, arch):
    m = models[arch]
    toks = _tokens(CFGS[arch])
    cache = m.init_cache(LM_B, LM_S, torch.float32)
    full, _ = m.forward({"tokens": toks})
    for t in range(LM_S):
        lg, cache = m.decode(cache, {"tokens": toks[:, t:t + 1], "cur": t})
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[f"decode/{arch}"][t],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")
        err = (lg[:, 0] - full[:, t]).abs().max().item()
        assert err < DECODE_VS_FORWARD_TOL, (t, err)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_greedy_decode_tokens_equal_jax(ref, models, arch):
    cfg = CFGS[arch]
    prompts = torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 1))
    out = greedy_decode(models[arch], prompts, GREEDY_NEW, GREEDY_P + GREEDY_NEW + 1)
    assert out.dtype == torch.int32 and out.shape == (LM_B, GREEDY_NEW)
    np.testing.assert_array_equal(out.numpy(), ref[f"greedy/{arch}"])


def test_gemma3_window_and_global_base_are_what_jax_runs(ref, models):
    """SMOKE's window (8) is shorter than the sequence (16) and every second
    layer is global with its own RoPE base: dropping either moves the
    logits far from the JAX package's, so the forward test above holds
    both (the window's mask and the per-layer base)."""
    arch = "gemma3-1b"
    cfg, m = CFGS[arch], models[arch]
    assert cfg.sliding_window < LM_S
    assert [cfg.layer_is_global(i) for i in range(cfg.n_layers)] == [False, True] * 2
    for other in (dataclasses.replace(cfg, sliding_window=None),
                  dataclasses.replace(cfg, global_rope_theta=cfg.rope_theta)):
        logits, _ = tfm.forward(m.params(), {"tokens": _tokens(cfg)}, other)
        assert np.abs(logits.numpy() - ref[f"forward/{arch}"]).max() > 1e-3


def _sampled(model, prompts, step):
    """A decode of GREEDY_NEW tokens after teacher-forced prompts, each
    step's token from ``step(cache, batch, t)``."""
    cache = model.init_cache(LM_B, GREEDY_P + GREEDY_NEW, torch.float32)
    tok, out = prompts[:, :1], []
    for t in range(GREEDY_P + GREEDY_NEW - 1):
        nxt, cache = step(cache, {"tokens": tok, "cur": t}, t)
        tok = prompts[:, t + 1:t + 2] if t + 1 < GREEDY_P else nxt[:, None]
        out.append(nxt)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("temp", SAMPLE_TEMPS)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_sampled_tokens_equal_jax_given_its_noise(ref, models, arch, temp):
    """make_serve_step(sample=True) fed the Gumbel noise that
    jax.random.categorical drew from each step's key gives the JAX step's
    tokens (prompt steps included: those tokens are sampled too)."""
    cfg = CFGS[arch]
    prompts = torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 2))
    noise = torch.from_numpy(ref[f"sample/{arch}/{temp}/gumbel"])
    serve = make_serve_step(models[arch], sample=True, temperature=temp)
    got = _sampled(models[arch], prompts,
                   lambda c, b, t: serve(c, {**b, "gumbel": noise[t]}))
    want = ref[f"sample/{arch}/{temp}/tokens"]
    np.testing.assert_array_equal(got.numpy(), want)
    # the same noise at another temperature picks other tokens somewhere
    other = make_serve_step(models[arch], sample=True, temperature=temp * 4)
    moved = _sampled(models[arch], prompts,
                     lambda c, b, t: other(c, {**b, "gumbel": noise[t]}))
    assert not np.array_equal(moved.numpy(), want)


def test_sampling_from_a_generator_is_seeded(models):
    m = models["phi4-mini-3.8b"]
    prompts = torch.from_numpy(lm_tokens(CFGS["phi4-mini-3.8b"].vocab,
                                         (LM_B, GREEDY_P), LM_SEED + 2))

    def run(seed):
        serve = make_serve_step(m, sample=True, temperature=1.0,
                                generator=torch.Generator().manual_seed(seed))
        return _sampled(m, prompts, lambda c, b, t: serve(c, b))

    a = run(3)
    assert a.dtype == torch.int32 and torch.equal(a, run(3))
    assert not torch.equal(a, run(4))
    with pytest.raises(ValueError, match="generator"):
        make_serve_step(m, sample=True)(m.init_cache(LM_B, 2, torch.float32),
                                        {"tokens": prompts[:, :1], "cur": 0})
    with pytest.raises(ValueError, match="temperature"):
        make_serve_step(m, sample=True, temperature=0.0)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_train_step_matches_jax(ref, arch):
    """One make_train_step step from the JAX weights, as
    tests/test_torch_train.py holds smollm-360m's: the loss and gradient
    norm, and the new parameters. AdamW's first step moves a parameter by
    lr·g/(|g| + eps): where |g| is near eps = 1e-8, an f32 rounding of
    1e-10 in g moves it by a few percent of lr, so the parameters are held
    at the step's tolerance where |g| >= COND_GRAD (the update then within
    1% of ±lr) or g = 0 (weight decay alone), and within lr of JAX's
    elsewhere."""
    cfg = CFGS[arch]
    opt = OptConfig(**STEP_OPT)
    model = lm_params_from_numpy(tree_of(ref, f"params/{arch}"), cfg,
                                 device="cpu").requires_grad_()
    params = model.params()
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(vocab=cfg.vocab, **STEP_PIPE).batch_at(0).items()}
    paths, leaves = zip(*leaf_paths(params))
    grads = dict(zip(paths, torch.autograd.grad(model.loss(batch)[0], leaves)))
    step = make_train_step(model, TrainConfig(opt=opt))
    params, _, metrics = step(params, init_opt_state(params), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), ref[f"train/{arch}/{k}"],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    want = dict(leaf_paths(tree_of(ref, f"train/{arch}/params")))
    got = dict(leaf_paths(params))
    assert got.keys() == want.keys()
    n_ill = 0
    for k in want:
        g, w = got[k].detach().numpy(), want[k]
        a = np.abs(grads[k].numpy())
        ok = (a >= COND_GRAD) | (a == 0)
        n_ill += int((~ok).sum())
        np.testing.assert_allclose(g[ok], w[ok], rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg="/".join(k))
        assert np.abs(g[~ok] - w[~ok]).max(initial=0.0) <= opt.lr, "/".join(k)
    # the elements held only within lr are a small share (0.2% at most)
    assert n_ill < 1e-2 * sum(w.size for w in want.values())
