"""The encdec and vlm families — whisper-small (a bidirectional encoder
over stubbed frames, a causal decoder with cross-attention) and
internvl2-76b (stubbed ViT patches through a projector, prepended to a
GQA LM) — against the JAX package at SMOKE sizes (f32 activations, the
flash kernel's path on), the JAX weights carried across by
``interop.lm_params_from_numpy``; the registry's frames and patches; and
the trainer's extra batch.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``lm_encdec``); the torch side on the CPU. The JAX package fills no
cross cache: the decode steps here (both sides) fill it from
``_enc_kv_all`` of the batch's frames, and greedy decode runs on the zero
cache, as the JAX package's ``greedy_decode`` does.
"""

import numpy as np
import pytest
import torch

from _torch_oracle import (ENCDEC_ARCHS, FRONTEND_BATCH, GREEDY_NEW, GREEDY_P,
                           LM_B, LM_S, LM_SEED, LOSS_B, arch_configs,
                           frontend_inputs, lm_tokens, loss_batch,
                           reference_arrays, tree_of)
from repro_torch.configs.registry import ShapeSpec, concrete_batch, get_config
from repro_torch.data import TokenPipeline
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.params import count_params, leaf_paths
from repro_torch.serve import greedy_decode
from repro_torch.train import OptConfig, TrainConfig, Trainer, TrainerConfig

CFGS = arch_configs("repro_torch", ENCDEC_ARCHS)
# f32 activations: the same arithmetic in both packages summed in other
# orders: logits and losses of scale 1 agree to 1e-5; gradients, summed
# over more terms, to a relative L2 error of 1e-4 per leaf
F32_TOL = 1e-5
GRAD_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "lm_encdec")


@pytest.fixture(scope="module")
def models(ref):
    return {a: lm_params_from_numpy(tree_of(ref, f"params/{a}"), cfg, device="cpu")
            for a, cfg in CFGS.items()}


def _batch(cfg, B=LM_B):
    toks = torch.from_numpy(lm_tokens(cfg.vocab, (B, LM_S), LM_SEED))
    return {"tokens": toks, **{k: torch.from_numpy(a)
                               for k, a in frontend_inputs(cfg, B).items()}}


def _filled_cache(model, batch):
    """A decode cache of LM_S positions whose cross K/V (encdec) come from
    the encoder's output on the batch's frames."""
    cache = model.init_cache(LM_B, LM_S, torch.float32)
    if model.cfg.family == "encdec":
        p = model.params()
        with torch.no_grad():
            k, v = tfm._enc_kv_all(p, tfm._encode(p, batch["frames"], model.cfg, False),
                                   model.cfg)
        cache["cross"]["k"].copy_(k)
        cache["cross"]["v"].copy_(v)
    return cache


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_param_tree_matches_jax(ref, models, arch):
    m = models[arch]
    got = {k: p.detach().numpy() for k, p in m.named_parameters()}
    want = {".".join(path): a for path, a in leaf_paths(tree_of(ref, f"params/{arch}"))}
    assert got.keys() == want.keys()
    own = ({"layers.cross.wq", "layers.norm_x", "enc_layers.wq", "enc_final_norm"}
           if CFGS[arch].family == "encdec" else {"projector.w1", "projector.norm"})
    assert own <= got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_counts_of_full_width_equal_jax(ref, arch):
    """Counted from the defs: the full-width model is never allocated."""
    assert count_params(tfm.model_defs(get_config(arch))) == int(ref[f"n_params/{arch}"])


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_forward_and_prefill_match_jax(ref, models, arch):
    """The vlm's logits cover [patches; text]; its prefill is the last
    text position's."""
    cfg = CFGS[arch]
    logits, aux = models[arch].forward(_batch(cfg))
    extra = cfg.vlm.n_patches if cfg.family == "vlm" else 0
    assert logits.shape == (LM_B, extra + LM_S, cfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref[f"forward/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)
    got = models[arch].prefill(_batch(cfg))
    np.testing.assert_allclose(got.numpy(), ref[f"prefill/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_cross_kv_match_jax(ref, models):
    arch = "whisper-small"
    cache = _filled_cache(models[arch], _batch(CFGS[arch]))
    np.testing.assert_allclose(cache["cross"]["k"].numpy(), ref[f"cross/{arch}/k"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_decode_steps_match_jax(ref, models, arch):
    """Decode against the JAX decode; whisper's (cross cache filled from
    the encoder) also against its forward. The vlm decodes text tokens
    only, so its decode is not its forward (which prepends the patches)."""
    m = models[arch]
    batch = _batch(CFGS[arch])
    cache = _filled_cache(m, batch)
    full, _ = m.forward(batch)
    toks = batch["tokens"]
    for t in range(LM_S):
        lg, cache = m.decode(cache, {"tokens": toks[:, t:t + 1], "cur": t})
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[f"decode/{arch}"][t],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")
        if CFGS[arch].family == "encdec":
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_greedy_decode_tokens_equal_jax(ref, models, arch):
    cfg = CFGS[arch]
    prompts = torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 1))
    out = greedy_decode(models[arch], prompts, GREEDY_NEW, GREEDY_P + GREEDY_NEW + 1)
    np.testing.assert_array_equal(out.numpy(), ref[f"greedy/{arch}"])


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_loss_and_grads_match_jax(ref, arch):
    """loss_fn with frames or patches (the vlm's scores its text only)."""
    cfg = CFGS[arch]
    model = lm_params_from_numpy(tree_of(ref, f"params/{arch}"), cfg,
                                 device="cpu").requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in
             {**loss_batch(cfg.vocab, 32, False), **frontend_inputs(cfg, LOSS_B)}.items()}
    loss, (ce, _) = model.loss(batch, remat=True)
    np.testing.assert_allclose(ce.item(), ref[f"loss/{arch}/ce"], rtol=F32_TOL,
                               atol=F32_TOL)
    paths, leaves = zip(*leaf_paths(model.params()))
    want = dict(leaf_paths(tree_of(ref, f"grads/{arch}")))
    assert set(paths) == set(want)
    for path, g in zip(paths, torch.autograd.grad(loss, leaves)):
        w = want[path]
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_REL_L2, ("/".join(path), err)


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_concrete_batch_equals_jax(ref, arch):
    """Frames (whisper) and patches and text tokens (the vlm: S − n_patches
    of them) drawn as the JAX package draws them, key by key."""
    S, B, seed = FRONTEND_BATCH
    cfg = CFGS[arch]
    got = concrete_batch(cfg, ShapeSpec("t", S, B, "prefill"), seed=seed, device="cpu")
    pre = f"batch/{arch}/"
    keys = [k[len(pre):] for k in ref if k.startswith(pre)]
    assert sorted(got) == sorted(keys)
    assert list(got)[:2] == ["tokens", "labels"]
    extra = "frames" if cfg.family == "encdec" else "patches"
    assert got[extra].dtype == torch.float32 and got["tokens"].dtype == torch.int32
    text = S - cfg.vlm.n_patches if cfg.family == "vlm" else S
    assert tuple(got["tokens"].shape) == (B, text)
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), ref[pre + k])


def test_encoder_and_cross_attention_run_no_flash(models, monkeypatch):
    """Only the decoder's causal self-attention reaches the flash wrapper:
    the bidirectional encoder and the cross-attention run plain softmax
    attention."""
    arch = "whisper-small"
    cfg = CFGS[arch]
    calls = []
    real = tattn.flash_attention

    def counting(q, *a, **k):
        calls.append(tuple(q.shape))
        return real(q, *a, **k)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    models[arch].prefill(_batch(cfg))
    assert len(calls) == cfg.n_layers
    assert all(s[2] == LM_S for s in calls)


def test_trainer_merges_the_extra_batch(tmp_path):
    """One CPU step of a whisper SMOKE Trainer with its frames in
    ``extra_batch``: the step's loss is ``loss_fn`` of the initial weights
    (the trainer's seed) on the pipeline's batch and those frames."""
    cfg = CFGS["whisper-small"]
    pipe = TokenPipeline(vocab=cfg.vocab, batch=2, seq=16, seed=0)
    frames = frontend_inputs(cfg, 2)["frames"]
    tr = Trainer(Model(cfg, device="cpu"), pipe, TrainerConfig(
        total_steps=1, ckpt_every=100, ckpt_dir=str(tmp_path), log_every=100,
        train=TrainConfig(opt=OptConfig(warmup_steps=1, total_steps=1))),
        extra_batch={"frames": frames})
    _, _, log = tr.run(resume=False)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    with torch.no_grad():
        want, _ = model.loss({**batch, "frames": torch.from_numpy(frames)})
        without, _ = model.loss({**batch, "frames": torch.zeros(frames.shape)})
    assert log[0]["loss"] == pytest.approx(want.item(), rel=1e-6)
    assert abs(want.item() - without.item()) > 1e-4
