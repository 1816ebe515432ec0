"""The training slice: the torch package's trainable flash attention, loss,
AdamW, train step, token pipeline, Trainer and CLI against the JAX
package's, on the CPU with f32 activations.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``train``): ``jax.vjp`` of ``ops.flash_attention`` (the Pallas
kernel in interpret mode, the backward through ``attention_ref``),
``jax.value_and_grad`` of ``Model.loss``, ``adamw_update``,
``make_train_step``, ``TokenPipeline`` and its ``Trainer`` writing and
resuming checkpoints in the test's directory. Weights cross as numpy
(``interop.lm_params_from_numpy``, ``opt_state_from_numpy``); the two
packages never share a random stream.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils.checkpoint as tcp

from _torch_oracle import (ADAMW_CASES, ADAMW_OPT, FLASH_GRAD_CASES,
                           LOSS_CASES, PIPE_CASES, PIPE_SHAPE, STEP_OPT,
                           STEP_PIPE, TRAIN_STEPS, TRAINER_CFG, TRAINER_KILL,
                           TRAINER_OPT, TRAINER_PIPE, TRAINER_STEPS,
                           adamw_inputs, flash_grad_inputs, lm_configs,
                           loss_batch, recipe_arrays)
from repro_torch.checkpoint import ckpt
from repro_torch.data import TokenPipeline, cube_loader
from repro_torch.interop import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import leaf_paths, tree_like
from repro_torch.train import (OptConfig, TrainConfig, Trainer, TrainerConfig,
                               adamw_update, init_opt_state, make_eval_step,
                               make_train_step)
from repro_torch.train.optimizer import global_norm, lr_at

REPO = Path(__file__).resolve().parent.parent
CFGS = lm_configs("repro_torch")
# f32 on both sides, summed in other orders (XLA's CPU dots against
# torch's; the Pallas kernel's online softmax against the dense oracle in
# the forward): outputs, losses and a step's parameters of scale 1 agree to
# 1e-5; gradients, summed over more terms, to 1e-4 relative
F32_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# one AdamW update on the same f32 inputs: the same operations, one
# rounding apart at most (XLA may contract a multiply-add)
ADAMW_RTOL, ADAMW_ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def ref_train(tmp_path_factory):
    """The torch package's Trainer killed at TRAINER_KILL in
    ``port_kill`` first; then the reference child, which resumes it."""
    work = tmp_path_factory.mktemp("train")
    _trainer(TRAINER_KILL, work / "port_kill").run(resume=False)
    return work, recipe_arrays(work, "train")


def _tree(ref, prefix):
    tree: dict = {}
    pre = prefix + "/"
    for key, arr in ref.items():
        if key.startswith(pre):
            *head, leaf = key[len(pre):].split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return tree


def _model(ref, name):
    m = lm_params_from_numpy(_tree(ref, f"params/{name}"), CFGS[name], device="cpu")
    return m.requires_grad_()


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _named(tree):
    """(path, leaf) of a tree of nested dicts, paths joined by "/"."""
    return [("/".join(path), leaf) for path, leaf in leaf_paths(tree)]


def _loss_and_grads(model, batch, remat):
    loss, (ce, aux) = model.loss(batch, remat=remat)
    names, leaves = zip(*_named(model.params()))
    return loss, ce, aux, dict(zip(names, torch.autograd.grad(loss, leaves)))


def _trainer(steps, where, cfg=None, **kw):
    model = Model(cfg or ModelConfig(**TRAINER_CFG), device="cpu")
    return Trainer(model, TokenPipeline(**TRAINER_PIPE), TrainerConfig(
        total_steps=steps, ckpt_every=TRAINER_KILL, ckpt_dir=str(where),
        log_every=100, train=TrainConfig(opt=OptConfig(**TRAINER_OPT)), **kw))


def _assert_tree_close(got: dict, want: dict, rtol, atol, what):
    got, want = dict(_named(got)), dict(_named(want))
    assert got.keys() == want.keys(), what
    for k in want:
        g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("case", FLASH_GRAD_CASES, ids=str)
def test_flash_attention_grads_match_jax(ref_train, case):
    _, ref_ = ref_train
    q, k, v, g = (torch.from_numpy(a) for a in flash_grad_inputs(case))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = _build.LAUNCHES["flash_attention_fwd"]
    o = tops.flash_attention(q, k, v, case[2], "morton", 128, 128)
    o.backward(g)
    assert _build.LAUNCHES["flash_attention_fwd"] == before  # CPU: plain version
    for name, got in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   ref_[f"flash/{case}/{name}"],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def test_flash_attention_backward_is_the_oracles():
    """The backward is the plain version of the backward kernels
    (``ref.flash_attention_bwd_ref``) on the GQA-folded tensors, from the
    forward's output and log-sum-exp, each kv head's gradient summed over
    its group, whatever forward ran; it is the vector-Jacobian product of
    the dense oracle within 1e-6 in f32, and bf16 and f16 tensors keep
    their dtype through it."""
    q, k, v, g = (torch.from_numpy(a) for a in flash_grad_inputs((32, 2, True)))
    B, Hq, S, D = q.shape
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        ins = [t.to(dtype).detach().requires_grad_() for t in (q, k, v)]
        tops.flash_attention(*ins, True, "hilbert", 16, 16).backward(g.to(dtype))
        qf, kf, vf = tops._fold_gqa(*(t.detach() for t in ins))
        dq, dk, dv = ref.flash_attention_bwd_ref(
            qf, kf, vf, ref.flash_attention_ref(qf, kf, vf), ref.flash_attention_lse_ref(qf, kf),
            g.to(dtype).reshape(qf.shape))
        rep = Hq // k.shape[1]
        for got, w in zip(ins, (dq.reshape(q.shape),
                                dk.reshape(B, -1, rep, S, D).sum(2),
                                dv.reshape(B, -1, rep, S, D).sum(2))):
            assert got.grad.dtype == dtype
            assert torch.equal(got.grad, w), dtype
        want = [t.detach().requires_grad_() for t in ins]
        ref.attention_ref(*tops._fold_gqa(*want), causal=True).reshape(
            B, Hq, S, D).backward(g.to(dtype))
        # f32: the same gradient summed in another order. bf16 and f16: the
        # oracle rounds its kv gradients before the group sum and the kernel's
        # Δ reads the rounded output, so the two differ by a relative L2
        # error (2.8e-3 and 3.1e-4 here) of the order of each one's own from
        # the f32 gradient; held within one unit of the dtype, 2^-7 and 2^-10
        for got, w in zip(ins, want):
            if dtype == torch.float32:
                torch.testing.assert_close(got.grad, w.grad, rtol=1e-6, atol=1e-6)
            else:
                rel = (got.grad.float() - w.grad.float()).norm() / w.grad.float().norm()
                assert rel <= torch.finfo(dtype).eps, (dtype, rel)


# ------------------------------------------------------------ the loss
@pytest.mark.parametrize("case", LOSS_CASES, ids=str)
def test_loss_fn_and_grads_match_jax(ref_train, case):
    _, ref_ = ref_train
    name, S, masked = case
    model = _model(ref_, name)
    loss, ce, aux, grads = _loss_and_grads(
        model, _t(loss_batch(CFGS[name].vocab, S, masked)), remat=True)
    assert loss.dtype == torch.float32 and float(aux) == 0.0 and torch.equal(loss, ce)
    np.testing.assert_allclose(loss.item(), ref_[f"loss/{case}/loss"],
                               rtol=F32_TOL, atol=F32_TOL)
    want = _tree(ref_, f"loss/{case}/grads")
    _assert_tree_close({k: g for k, g in grads.items()},
                       dict(_named(want)), GRAD_RTOL, GRAD_ATOL, str(case))


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("S", [1024, 32])
def test_remat_modes_give_equal_losses_and_grads(ref_train, remat, S):
    """Recomputing a layer in the backward repeats the same CPU arithmetic:
    losses and gradients equal bit for bit with remat off."""
    _, ref_ = ref_train
    model = _model(ref_, "smoke")
    batch = _t(loss_batch(CFGS["smoke"].vocab, S, True))
    want = _loss_and_grads(model, batch, remat=False)
    got = _loss_and_grads(model, batch, remat=remat)
    assert torch.equal(got[0], want[0])
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        assert torch.equal(got[3][k], want[3][k]), k


def test_remat_dots_saves_the_weight_gemms(ref_train, monkeypatch):
    """"dots" keeps exactly the weight products' outputs, as the JAX
    package's dots_with_no_batch_dims_saveable; without selective
    checkpointing in torch it raises rather than becoming True."""
    _, ref_ = ref_train
    model = _model(ref_, "smoke")
    seen = []
    real = tfm._dots_policy
    monkeypatch.setattr(tfm, "_dots_policy",
                        lambda ctx, op, *a, **kw: seen.append(op) or real(ctx, op, *a, **kw))
    model.loss(_t(loss_batch(CFGS["smoke"].vocab, 32, False)), remat="dots")[0].backward()
    saved = {op for op in seen if real(None, op) == tcp.CheckpointPolicy.MUST_SAVE}
    assert saved == {torch.ops.aten.mm.default}
    assert torch.ops.aten.bmm.default in seen  # the attention's products: recomputed
    with pytest.raises(ValueError, match="remat"):
        model.loss(_t(loss_batch(CFGS["smoke"].vocab, 32, False)), remat="all")
    monkeypatch.delattr(tcp, "create_selective_checkpoint_contexts")
    with pytest.raises(NotImplementedError, match="dots"):
        model.loss(_t(loss_batch(CFGS["smoke"].vocab, 32, False)), remat="dots")


def test_chunked_ce_equals_full_logits(ref_train):
    """At S=1024 the loss sums 512-position chunks; the full logits'
    softmax_cross_entropy gives the same mean."""
    _, ref_ = ref_train
    model = _model(ref_, "tiny")
    cfg = CFGS["tiny"]
    batch = _t(loss_batch(cfg.vocab, 1024, True))
    with torch.no_grad():
        hidden, _ = tfm.forward_hidden(model.params(), batch, cfg)
        w = tfm._unembed_w(model.params(), cfg)
        chunked = tfm._chunked_ce(hidden, w, batch["labels"], batch["loss_mask"], cfg)
        full = tfm._chunked_ce(hidden, w, batch["labels"], batch["loss_mask"], cfg,
                               chunk=1000)
        logits, _ = tfm.forward(model.params(), batch, cfg)
    from repro_torch.models.layers import softmax_cross_entropy
    assert torch.equal(full, softmax_cross_entropy(logits, batch["labels"],
                                                   batch["loss_mask"]))
    np.testing.assert_allclose(chunked.item(), full.item(), rtol=1e-6)


def test_eval_step_and_model_counts(ref_train):
    _, ref_ = ref_train
    model = _model(ref_, "tiny")
    batch = _t(loss_batch(CFGS["tiny"].vocab, 32, True))
    out = make_eval_step(model)(model.params(), batch)
    assert not out["loss"].requires_grad
    assert torch.equal(out["loss"], model.loss(batch, remat=False)[0].detach())
    assert model.n_active_params() == model.n_params() == sum(
        p.numel() for p in model.parameters())


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("case", ADAMW_CASES, ids=str)
def test_adamw_update_matches_jax(ref_train, case):
    _, ref_ = ref_train
    params, grads, state = adamw_inputs(case)
    tp = tree_like(params, [torch.from_numpy(a.copy()) for _, a in _named(params)])
    tg = tree_like(grads, [torch.from_numpy(a) for _, a in _named(grads)])
    ts = {"m": tree_like(state["m"], [torch.from_numpy(a.copy()) for _, a in _named(state["m"])]),
          "v": tree_like(state["v"], [torch.from_numpy(a.copy()) for _, a in _named(state["v"])]),
          "step": torch.tensor(case[0], dtype=torch.int32)}
    p2, s2, om = adamw_update(tp, tg, ts, OptConfig(**ADAMW_OPT))
    assert p2 is tp and s2 is ts and s2["step"].dtype == torch.int32
    assert int(s2["step"]) == case[0] + 1 == int(ref_[f"adamw/{case}/state/step"])
    _assert_tree_close(p2, dict(_named(_tree(ref_, f"adamw/{case}/params"))),
                       ADAMW_RTOL, ADAMW_ATOL, "params")
    for name in ("m", "v"):
        _assert_tree_close(s2[name], dict(_named(_tree(ref_, f"adamw/{case}/state/{name}"))),
                           ADAMW_RTOL, ADAMW_ATOL, name)
    for name in ("lr", "grad_norm"):
        assert om[name].dtype == torch.float32
        np.testing.assert_allclose(om[name].item(), ref_[f"adamw/{case}/{name}"],
                                   rtol=1e-6, err_msg=name)


def test_schedule_and_norm_are_f32():
    cfg = OptConfig(lr=1e-3, warmup_steps=4, total_steps=20, min_lr_frac=0.1)
    lrs = [lr_at(torch.tensor(s, dtype=torch.int32), cfg) for s in range(24)]
    assert all(x.dtype == torch.float32 for x in lrs)
    assert float(lrs[0]) == pytest.approx(2.5e-4) and float(lrs[3]) == pytest.approx(1e-3)
    assert float(lrs[23]) == pytest.approx(1e-4)
    g = {"a": torch.ones(3), "b": {"c": 2 * torch.ones(2, 2)}}
    assert float(global_norm(g)) == pytest.approx(np.sqrt(3 + 16))
    state = init_opt_state(g)
    assert state["step"].dtype == torch.int32 and state["m"]["b"]["c"].dtype == torch.float32


# ------------------------------------------------------------ train step
def test_three_train_steps_match_jax(ref_train):
    _, ref_ = ref_train
    model = _model(ref_, "tiny")
    params = model.params()
    opt = init_opt_state(params)
    step = make_train_step(model, TrainConfig(opt=OptConfig(**STEP_OPT)))
    pipe = TokenPipeline(vocab=CFGS["tiny"].vocab, **STEP_PIPE)
    for i in range(TRAIN_STEPS):
        params, opt, metrics = step(params, opt, _t(pipe.batch_at(i)))
        np.testing.assert_allclose(metrics["loss"].item(), ref_[f"steps/{i}/loss"],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {i}")
        _assert_tree_close(params, dict(_named(_tree(ref_, f"steps/{i}/params"))),
                           GRAD_RTOL, GRAD_ATOL, f"params after step {i}")
    assert params["layers"]["wq"] is model.layers.wq  # written in place


def _tiny2():
    return ModelConfig(name="tiny-dense", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                       activation_dtype="float32")


@pytest.mark.parametrize("micro", [2, 4])
def test_microbatch_equals_full_batch_grads(micro):
    """Grad accumulation is loss-equivalent to the unsplit batch (the JAX
    package's test_microbatch_equals_full_batch_grads)."""
    batch = _t(TokenPipeline(vocab=64, batch=8, seq=16, seed=2).batch_at(0))
    outs = []
    for n in (1, micro):
        model = Model(_tiny2(), device="cpu").init(torch.Generator().manual_seed(0))
        params = model.requires_grad_().params()
        step = make_train_step(model, TrainConfig(
            opt=OptConfig(warmup_steps=1, total_steps=10), microbatches=n))
        p2, _, metrics = step(params, init_opt_state(params), batch)
        outs.append((float(metrics["loss"]), p2))
    assert abs(outs[1][0] - outs[0][0]) < 1e-4
    _assert_tree_close(outs[1][1], {k: v.detach().numpy() for k, v in _named(outs[0][1])},
                       2e-4, 2e-5, f"microbatches={micro}")


def test_loss_decreases_on_tiny_model():
    model = Model(_tiny2(), device="cpu").init(torch.Generator().manual_seed(0))
    params = model.requires_grad_().params()
    opt = init_opt_state(params)
    step = make_train_step(model, TrainConfig(
        opt=OptConfig(lr=1e-3, warmup_steps=5, total_steps=60)))
    pipe = TokenPipeline(vocab=64, batch=8, seq=32, seed=1)
    losses = []
    for i in range(60):
        params, opt, metrics = step(params, opt, _t(pipe.batch_at(i)))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("case", PIPE_CASES, ids=str)
def test_token_pipeline_equals_jax(ref_train, case):
    _, ref_ = ref_train
    seed, step = case
    got = TokenPipeline(seed=seed, **PIPE_SHAPE).batch_at(step)
    assert sorted(got) == ["labels", "tokens"]
    for k, a in got.items():
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, ref_[f"pipe/{seed}/{step}/{k}"])


def test_cube_loader_follows_the_ordering():
    from repro_torch.core.orderings import HILBERT, ROW_MAJOR, path_to_rmo

    rmo = cube_loader(8, 0.3, seed=4)
    hil = cube_loader(8, 0.3, seed=4, spec=HILBERT)
    assert rmo.shape == (512,) and rmo.dtype == np.float32
    np.testing.assert_array_equal(hil, rmo[path_to_rmo(HILBERT, 8)])
    np.testing.assert_array_equal(rmo, cube_loader(8, 0.3, seed=4, spec=ROW_MAJOR))


# ------------------------------------------------------------ checkpoints
def test_trainer_restart_bit_exact(tmp_path):
    """Killed after TRAINER_KILL steps and resumed: the final parameters
    equal the unbroken run's bit for bit (the CPU's arithmetic repeats)."""
    p_full, _, log_full = _trainer(TRAINER_STEPS, tmp_path / "full").run(resume=False)
    _trainer(TRAINER_KILL, tmp_path / "ck").run(resume=False)
    assert ckpt.latest_step(str(tmp_path / "ck")) == TRAINER_KILL
    resumed = _trainer(TRAINER_STEPS, tmp_path / "ck")
    p_res, opt, log_res = resumed.run(resume=True)
    assert [m["step"] for m in log_res] == list(range(TRAINER_KILL, TRAINER_STEPS))
    assert [m["loss"] for m in log_res] == [m["loss"] for m in log_full[TRAINER_KILL:]]
    for (ka, a), (kb, b) in zip(_named(p_full), _named(p_res)):
        assert ka == kb and torch.equal(a, b), ka
    assert int(opt["step"]) == TRAINER_STEPS
    tree, meta = ckpt.restore(str(tmp_path / "ck"))
    assert meta == {"step": TRAINER_STEPS, "data_cursor": TRAINER_STEPS}
    assert tree["opt_state"]["step"].dtype == np.int32 and tree["opt_state"]["step"].shape == ()


def test_jax_checkpoint_resumes_in_port(ref_train):
    """The JAX Trainer's checkpoint at step TRAINER_KILL, resumed here to
    TRAINER_STEPS, agrees with the JAX package's unbroken run."""
    work, ref_ = ref_train
    p_res, _, _ = _trainer(TRAINER_STEPS, work / "jax_kill").run(resume=True)
    _assert_tree_close(p_res, dict(_named(_tree(ref_, "trainer/jax_full"))),
                       GRAD_RTOL, GRAD_ATOL, "port resume of the JAX checkpoint")


def test_port_checkpoint_resumes_in_jax(ref_train, tmp_path):
    """The reverse: this package's checkpoint at TRAINER_KILL (written by the
    fixture), resumed by the JAX Trainer, agrees with this package's
    unbroken run from the same seeded weights."""
    _, ref_ = ref_train
    p_full, _, _ = _trainer(TRAINER_STEPS, tmp_path / "full").run(resume=False)
    _assert_tree_close(_tree(ref_, "trainer/port_resumed"),
                       {k: v.detach().numpy() for k, v in _named(p_full)},
                       GRAD_RTOL, GRAD_ATOL, "JAX resume of the port checkpoint")


def test_opt_state_from_numpy_checks_the_tree(ref_train):
    _, ref_ = ref_train
    cfg = CFGS["tiny"]
    params = _tree(ref_, "params/tiny")
    zeros = {k: {kk: np.zeros_like(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else np.zeros_like(v) for k, v in params.items()}
    good = {"m": zeros, "v": zeros, "step": np.asarray(4, np.int32)}
    st = opt_state_from_numpy(good, cfg, device="cpu")
    assert int(st["step"]) == 4 and st["m"]["layers"]["wq"].shape == params["layers"]["wq"].shape
    with pytest.raises(ValueError, match="step"):
        opt_state_from_numpy({**good, "step": np.asarray(4, np.int64)}, cfg, device="cpu")
    with pytest.raises(ValueError, match="'m', 'v', 'step'"):
        opt_state_from_numpy({"m": zeros, "v": zeros}, cfg, device="cpu")
    bad = {**zeros, "embed": zeros["embed"].astype(np.float64)}
    with pytest.raises(ValueError, match="embed"):
        opt_state_from_numpy({**good, "v": bad}, cfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        opt_state_from_numpy({**good, "m": {k: v for k, v in zeros.items()
                                            if k != "final_norm"}}, cfg, device="cpu")


# ------------------------------------------------------------------ CLI
def test_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smollm-360m", "--smoke", "--steps", "3", "--batch", "2", "--seq",
           "32", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "[trainer] step 0 loss" in r.stdout, r.stdout + r.stderr
    assert ckpt.latest_step(str(tmp_path / "ck")) == 3
    r = subprocess.run(cmd[:4] + ["whisper-small", "--smoke", "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and "family-specific" in r.stderr


def test_train_cli_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tlaunch.build_parser().parse_args(
        ["--arch", "smollm-360m", "--smoke", "--ckpt-dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(args)
    encdec = dataclasses.replace(CFGS["tiny"], family="encdec")
    monkeypatch.setattr("repro_torch.configs.registry.get_smoke", lambda arch: encdec)
    with pytest.raises(SystemExit, match="family-specific"):
        tlaunch.main(args)
