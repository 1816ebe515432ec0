"""The LM serving slice: the torch package's smollm-360m path (registry,
parameter tree, forward, prefill with the flash kernel's path on,
decode_step and greedy_decode) against the JAX package's, with the JAX
weights carried across by ``interop.lm_params_from_numpy``.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``lm``), its flash attention as the Pallas kernel in interpret
mode; the torch side on the CPU, where the flash wrapper runs its plain
version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from _torch_oracle import (GREEDY_NEW, GREEDY_P, LM_B, LM_S, LM_S_ODD,
                           LM_SEED, lm_configs, lm_tokens, reference_arrays)
from repro_torch.configs.registry import (ARCHS, PORTED, SHAPES, ShapeSpec,
                                          concrete_batch, get_config, get_smoke)
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import _build
from repro_torch.launch import serve as tserve
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.params import count_params
from repro_torch.serve import greedy_decode, make_serve_step

CFGS = lm_configs("repro_torch")
F32_NAMES = [n for n, c in CFGS.items() if c.activation_dtype == "float32"]
# f32 activations: the same arithmetic in both packages, summed in other
# orders (XLA's CPU dots against torch's; dense softmax against the
# Pallas kernel's online softmax): logits of scale 1 agree to 1e-5.
F32_TOL = 1e-5
# bf16 activations: each matmul output and the attention output are
# rounded to bf16 (2^-8 relative) at places where XLA and torch may round
# differently; over 4 layers the logits (scale 0.6) agree to 1e-2.
BF16_TOL = 1e-2
# decode against forward, as tests/test_models.py holds the JAX package
DECODE_VS_FORWARD_TOL = 2e-2


@pytest.fixture(scope="module")
def ref_lm(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "lm")


def _tree(ref, name):
    tree: dict = {}
    pre = f"params/{name}/"
    for key, arr in ref.items():
        if key.startswith(pre):
            *head, leaf = key[len(pre):].split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return tree


@pytest.fixture(scope="module")
def models(ref_lm):
    return {name: lm_params_from_numpy(_tree(ref_lm, name), cfg, device="cpu")
            for name, cfg in CFGS.items()}


def _tokens(cfg):
    return torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, LM_S), LM_SEED))


def _tol(name):
    return F32_TOL if CFGS[name].activation_dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("name", list(CFGS))
def test_param_tree_matches_jax(ref_lm, models, name):
    m = models[name]
    got = {k: p.detach().numpy() for k, p in m.named_parameters()}
    want = {k[len(f"params/{name}/"):].replace("/", "."): v
            for k, v in ref_lm.items() if k.startswith(f"params/{name}/")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert m.n_params() == sum(v.size for v in want.values())


def test_n_params_of_full_width_equals_jax(ref_lm):
    defs = tfm.model_defs(get_config("smollm-360m"))
    assert count_params(defs) == int(ref_lm["n_params/smollm-360m"])
    assert count_params(defs) == 409_007_040


@pytest.mark.parametrize("name", list(CFGS))
def test_forward_matches_jax(ref_lm, models, name):
    m = models[name]
    logits, aux = m.forward({"tokens": _tokens(CFGS[name])})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref_lm[f"forward/{name}"],
                               rtol=_tol(name), atol=_tol(name))


@pytest.mark.parametrize("name", list(CFGS))
def test_forward_plain_sdpa_matches_jax(ref_lm, models, name):
    """The same weights with the flash path off (masked_sdpa)."""
    cfg = dataclasses.replace(CFGS[name], use_flash_kernel=False)
    logits, _ = tfm.forward(models[name].params(), {"tokens": _tokens(cfg)}, cfg)
    np.testing.assert_allclose(logits.numpy(), ref_lm[f"forward_sdpa/{name}"],
                               rtol=_tol(name), atol=_tol(name))


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_matches_jax(ref_lm, models, name):
    got = models[name].prefill({"tokens": _tokens(CFGS[name])})
    assert got.shape == (LM_B, CFGS[name].vocab)
    np.testing.assert_allclose(got.numpy(), ref_lm[f"prefill/{name}"],
                               rtol=_tol(name), atol=_tol(name))


def test_prefill_at_a_block_of_12_matches_jax(ref_lm, models):
    """SMOKE with the flash kernel's path on, at S=12: the block halved
    from 128 until it divides S is 12, which the JAX package runs."""
    toks = torch.from_numpy(lm_tokens(CFGS["smoke"].vocab, (LM_B, LM_S_ODD),
                                      LM_SEED))
    got = models["smoke"].prefill({"tokens": toks})
    np.testing.assert_allclose(got.numpy(), ref_lm[f"prefill_s{LM_S_ODD}/smoke"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name", F32_NAMES)
def test_decode_steps_match_jax_and_forward(ref_lm, models, name):
    m = models[name]
    toks = _tokens(CFGS[name])
    cache = m.init_cache(LM_B, LM_S, torch.float32)
    full, _ = m.forward({"tokens": toks})
    for t in range(LM_S):
        lg, cache = m.decode(cache, {"tokens": toks[:, t:t + 1], "cur": t})
        assert lg.shape == (LM_B, 1, CFGS[name].vocab)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref_lm[f"decode/{name}"][t],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")
        err = (lg[:, 0] - full[:, t]).abs().max().item()
        assert err < DECODE_VS_FORWARD_TOL, (t, err)


@pytest.mark.parametrize("name", F32_NAMES)
def test_greedy_decode_tokens_equal_jax(ref_lm, models, name):
    cfg = CFGS[name]
    prompts = torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 1))
    out = greedy_decode(models[name], prompts, GREEDY_NEW,
                        GREEDY_P + GREEDY_NEW + 1)
    assert out.dtype == torch.int32 and out.shape == (LM_B, GREEDY_NEW)
    np.testing.assert_array_equal(out.numpy(), ref_lm[f"greedy/{name}"])


def test_bf16_decode_keeps_the_activation_dtype(models):
    """bf16 activations with the f32 cache that greedy_decode allocates:
    the step runs (the JAX package's decode scan refuses it) and its
    logits agree with the forward's within the decode tolerance."""
    m = models["tiny_bf16"]
    toks = _tokens(CFGS["tiny_bf16"])
    full, _ = m.forward({"tokens": toks})
    cache = m.init_cache(LM_B, LM_S, torch.float32)
    step = make_serve_step(m)
    for t in range(LM_S):
        lg, cache = m.decode(cache, {"tokens": toks[:, t:t + 1], "cur": t})
        assert (lg[:, 0] - full[:, t]).abs().max().item() < DECODE_VS_FORWARD_TOL
    nxt, _ = step(cache, {"tokens": toks[:, :1], "cur": 0})
    assert nxt.dtype == torch.int32 and nxt.shape == (LM_B,)


def test_flash_path_is_taken_only_when_asked(models, monkeypatch):
    """Prefill with use_flash_kernel reaches flash_attention_fwd once per
    layer; with the flag off, never."""
    from repro_torch.kernels import flash_attn

    calls = []
    real = flash_attn.flash_attention_fwd
    monkeypatch.setattr("repro_torch.kernels.ops.flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = CFGS["smoke"]
    m = models["smoke"]
    before = _build.LAUNCHES["flash_attention_fwd"]
    m.prefill({"tokens": _tokens(cfg)})
    assert len(calls) == cfg.n_layers
    tfm.prefill(m.params(), {"tokens": _tokens(cfg)},
                dataclasses.replace(cfg, use_flash_kernel=False))
    assert len(calls) == cfg.n_layers
    # CPU tensors run the plain version: no kernel launch is counted
    assert _build.LAUNCHES["flash_attention_fwd"] == before


@pytest.mark.parametrize("sname", ["prefill", "decode"])
def test_concrete_batch_equals_jax(ref_lm, sname):
    shape = ShapeSpec("t", LM_S, LM_B, "prefill") if sname == "prefill" \
        else SHAPES["decode_32k"]
    got = concrete_batch(CFGS["smoke"], shape, batch_override=3, seed=LM_SEED,
                         device="cpu")
    keys = sorted(k[len(f"batch/{sname}/"):] for k in ref_lm
                  if k.startswith(f"batch/{sname}/"))
    assert sorted(got) == keys
    for k in keys:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), ref_lm[f"batch/{sname}/{k}"])


def test_registry_names_what_is_not_ported():
    """Every arch of the JAX package is ported: its CONFIG and SMOKE equal
    the JAX package's field by field (sub-configs included). An unknown
    arch raises KeyError, an unknown family ValueError (as there)."""
    assert set(PORTED) == set(ARCHS) == set(jreg.ARCHS)
    for arch in ARCHS:
        for got, want in ((get_config(arch), jreg.get_config(arch)),
                          (get_smoke(arch), jreg.get_smoke(arch))):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
    with pytest.raises(KeyError):
        get_config("gpt-2")
    odd = dataclasses.replace(get_smoke("smollm-360m"), family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        Model(odd, device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        tfm.cache_defs(odd, 1, 4)


def test_params_from_numpy_checks_the_tree(ref_lm):
    cfg = CFGS["tiny"]
    tree = _tree(ref_lm, "tiny")
    bad = {**tree, "layers": {**tree["layers"], "wq": tree["layers"]["wq"][:, :, :8]}}
    with pytest.raises(ValueError, match="layers/wq"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    bad = {**tree, "layers": {**tree["layers"], "wq": tree["layers"]["wq"].astype(np.float64)}}
    with pytest.raises(ValueError, match="float32"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy({**tree, "extra": np.zeros(3, np.float32)}, cfg,
                             device="cpu")


def test_model_init_is_seeded():
    cfg = get_smoke("smollm-360m")
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (ka, pa), (kb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert ka == kb and torch.equal(pa, pb)
    assert torch.all(a.layers.norm1 == 0) and a.layers.wq.std() > 0.01
    assert not any(p.requires_grad for p in a.parameters())


def test_serve_launcher_on_cpu(capsys, monkeypatch):
    args = tserve.build_parser().parse_args(
        ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--batch", "2",
         "--new-tokens", "3"])
    out = tserve.lm_main(args)
    assert out.shape == (2, 3) and out.dtype == torch.int32
    assert "smollm-360m-smoke on cpu: 6 tokens" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["serve", "--stencil", "--device", "cpu",
                                     "--M", "16", "--T", "4", "--queries", "3",
                                     "--deadline-ms", "60000"])
    tserve.main()
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == "SERVE_DONE" and out[-1].startswith("SERVE_LAUNCHES ")
    assert sum("exact=True" in ln for ln in out) == 3



def test_layers_match_jax():
    """rmsnorm, both RoPE forms, swiglu and the masks against the JAX
    package's on the same numpy inputs (f32: rounding only)."""
    import jax.numpy as jnp

    from repro.models import attention as jattn
    from repro.models import layers as jl
    from repro_torch.models import attention as tattn
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    pairs = [
        (tl.rmsnorm(tx, torch.from_numpy(w)), jl.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        (tl.apply_rope(tx, tpos, 1e4), jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        (tattn.rope_with_freqs(tx, tpos, torch.from_numpy(tl.rope_freqs(16, 1e6))),
         jattn.rope_with_freqs(jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(jl.rope_freqs(16, 1e6)))),
    ]
    mlp = {k: rng.normal(size=s).astype(np.float32) * 0.1
           for k, s in (("gate", (16, 24)), ("up", (16, 24)), ("down", (24, 16)))}
    pairs.append((tl.swiglu({k: torch.from_numpy(v) for k, v in mlp.items()}, tx),
                  jl.swiglu({k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(x))))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    kpos = np.arange(12, dtype=np.int32)
    for window in (None, 4):
        np.testing.assert_array_equal(
            tl.causal_window_mask(tpos + 4, torch.from_numpy(kpos), window).numpy(),
            np.asarray(jl.causal_window_mask(jnp.asarray(pos + 4), jnp.asarray(kpos), window)))
    np.testing.assert_array_equal(tl.rope_freqs(64, 1e4), jl.rope_freqs(64, 1e4))
