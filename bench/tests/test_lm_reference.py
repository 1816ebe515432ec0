"""The plain SmolLM reference against the port's CPU path at the SMOKE
size in float32: logits, the prefill's last logits, the loss and every
gradient, and one AdamW step, within float32 rounding."""

import dataclasses

import pytest
import torch

from bench.loops import _lm
from bench.reference.lm import Ref, adamw_step

OPT = {"lr": 3e-4, "warmup_steps": 100, "total_steps": 10000, "min_lr_frac": 0.1,
       "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}


def _cfg(tie):
    from repro_torch.configs.smollm_360m import SMOKE

    cfg = dataclasses.asdict(dataclasses.replace(SMOKE, use_flash_kernel=True,
                                                 tie_embeddings=tie))
    cfg["initializer_range"] = 0.02
    return cfg


def _batch(cfg, B=2, S=64, seed=3):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(cfg["vocab"], (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1].to(torch.int32), "labels": toks[:, 1:].to(torch.int32)}


def _close(a, b, rtol=2e-5):
    scale = b.abs().max().clamp(min=1e-12)
    return float((a - b).abs().max() / scale) <= rtol


@pytest.mark.parametrize("tie", [False, True])
def test_logits_and_prefill(tie):
    cfg = _cfg(tie)
    w = _lm.make_weights(cfg, 5, "cpu")
    model = _lm.load_model(cfg, w, "cpu")
    batch = _batch(cfg)
    ref = Ref(cfg, w)
    logits, _ = model.forward(batch)
    for b in range(2):
        want = ref.mm(ref.hidden(batch["tokens"][b]), ref.head())
        assert _close(logits[b], want)
    last = model.prefill({"tokens": batch["tokens"][:1]})[0]
    assert _close(last, ref.last_logits(batch["tokens"][0]))


@pytest.mark.parametrize("tie", [False, True])
def test_loss_gradients_and_an_adamw_step(tie):
    from repro_torch.models.params import leaf_paths, tree_like
    from repro_torch.train import OptConfig, init_opt_state
    from repro_torch.train.optimizer import adamw_update

    cfg = _cfg(tie)
    w = _lm.make_weights(cfg, 6, "cpu")
    model = _lm.load_model(cfg, w, "cpu").requires_grad_()
    batch = _batch(cfg, seed=4)
    params = model.params()
    paths = [".".join(p) for p, _ in leaf_paths(params)]
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, [x for _, x in leaf_paths(params)])
    ref_w = {n: t.clone() for n, t in w.items()}
    ref_loss, ref_grads = Ref(cfg, ref_w).loss_and_grads(batch["tokens"], batch["labels"])
    assert abs(loss.item() - ref_loss) <= 2e-6 * abs(ref_loss)
    for n, g in zip(paths, grads):
        assert _close(g, ref_grads[n], rtol=1e-4), n
    adamw_update(params, tree_like(params, list(grads)), init_opt_state(params),
                 OptConfig(**OPT))
    adamw_step(ref_w, {n: g for n, g in zip(paths, grads)}, {}, 0, OPT)
    # the f32 weights after the step, within a few units in their last place
    for n, p in zip(paths, [x for _, x in leaf_paths(params)]):
        assert _close(p.detach(), ref_w[n], rtol=1e-6), n
        assert (p.detach() - w[n]).abs().max() > 0, n
