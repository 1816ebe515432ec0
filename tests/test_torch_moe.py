"""The moe family — deepseek-v2-lite-16b (MLA + MoE) and deepseek-moe-16b
(GQA + MoE), each with its first layer dense — against the JAX package at
SMOKE sizes (f32 activations, the flash kernel's path on), the JAX
weights carried across by ``interop.lm_params_from_numpy``.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``lm_moe``); the torch side on the CPU. SMOKE's capacity factor
(4.0) leaves every expert room for every assignment; one MoE layer is
also held at MOE_DROP_CF, where assignments are dropped.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_oracle import (GREEDY_NEW, GREEDY_P, LM_B, LM_S, LM_SEED,
                           MOE_ARCHS, MOE_DROP_CF, arch_configs, lm_tokens,
                           loss_batch, moe_input, reference_arrays, tree_of)
from repro_torch.configs.registry import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models.zoo import active_params
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.models.params import count_params, leaf_paths
from repro_torch.serve import greedy_decode

CFGS = arch_configs("repro_torch", MOE_ARCHS)
# f32 activations: the same arithmetic in both packages summed in other
# orders: logits and losses of scale 1 agree to 1e-5; gradients, summed
# over more terms, to a relative L2 error of 1e-4 per leaf
F32_TOL = 1e-5
GRAD_REL_L2 = 1e-4
# decode against forward, as tests/test_models.py holds the JAX package
DECODE_VS_FORWARD_TOL = 2e-2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "lm_moe")


@pytest.fixture(scope="module")
def models(ref):
    return {a: lm_params_from_numpy(tree_of(ref, f"params/{a}"), cfg, device="cpu")
            for a, cfg in CFGS.items()}


def _tokens(cfg):
    return torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, LM_S), LM_SEED))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_tree_matches_jax(ref, models, arch):
    m = models[arch]
    got = {k: p.detach().numpy() for k, p in m.named_parameters()}
    want = {".".join(path): a for path, a in leaf_paths(tree_of(ref, f"params/{arch}"))}
    assert got.keys() == want.keys()
    assert {"dense_layers.gate", "layers.moe.w1", "layers.moe.router"} <= got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert m.n_params() == sum(v.size for v in want.values())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_counts_of_full_width_equal_jax(ref, models, arch):
    """count_params and the MoE-discounted active count at full width (from
    the defs: the full-width model is never allocated), and the model's own
    count at SMOKE size."""
    cfg = get_config(arch)
    assert count_params(tfm.model_defs(cfg)) == int(ref[f"n_params/{arch}"])
    assert active_params(cfg) == int(ref[f"n_active/{arch}"])
    assert active_params(cfg) < count_params(tfm.model_defs(cfg))
    m = models[arch]
    assert m.n_active_params() == active_params(CFGS[arch]) < m.n_params()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_jax(ref, models, arch):
    logits, aux = models[arch].forward({"tokens": _tokens(CFGS[arch])})
    assert logits.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(logits.numpy(), ref[f"forward/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux.item(), ref[f"forward_aux/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_matches_jax(ref, models, arch):
    got = models[arch].prefill({"tokens": _tokens(CFGS[arch])})
    assert got.shape == (LM_B, CFGS[arch].vocab)
    np.testing.assert_allclose(got.numpy(), ref[f"prefill/{arch}"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_steps_match_jax_and_forward(ref, models, arch):
    """Decode through the cache (MLA's compressed c_kv and k_rope, or GQA's
    k and v, in both stacks) against the JAX decode and the forward: a
    decode step's MoE layer has C=1 per row and K distinct experts, so it
    never drops, nor does SMOKE's forward."""
    m = models[arch]
    toks = _tokens(CFGS[arch])
    cache = m.init_cache(LM_B, LM_S, torch.float32)
    assert set(cache) == {"dense_layers", "layers"}
    assert set(cache["layers"]) == ({"c_kv", "k_rope"} if CFGS[arch].mla
                                    else {"k", "v"})
    full, _ = m.forward({"tokens": toks})
    for t in range(LM_S):
        lg, cache = m.decode(cache, {"tokens": toks[:, t:t + 1], "cur": t})
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[f"decode/{arch}"][t],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"step {t}")
        err = (lg[:, 0] - full[:, t]).abs().max().item()
        assert err < DECODE_VS_FORWARD_TOL, (t, err)
    assert all(bool(leaf[:, :, LM_S - 1].abs().sum() > 0)
               for _, leaf in leaf_paths(cache))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_decode_tokens_equal_jax(ref, models, arch):
    cfg = CFGS[arch]
    prompts = torch.from_numpy(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 1))
    out = greedy_decode(models[arch], prompts, GREEDY_NEW, GREEDY_P + GREEDY_NEW + 1)
    np.testing.assert_array_equal(out.numpy(), ref[f"greedy/{arch}"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_jax(ref, arch):
    cfg = CFGS[arch]
    model = lm_params_from_numpy(tree_of(ref, f"params/{arch}"), cfg,
                                 device="cpu").requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in loss_batch(cfg.vocab, 32, False).items()}
    loss, (ce, aux) = model.loss(batch, remat=True)
    np.testing.assert_allclose(ce.item(), ref[f"loss/{arch}/ce"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(aux.item(), ref[f"loss/{arch}/aux"], rtol=F32_TOL,
                               atol=F32_TOL)
    assert torch.equal(loss, ce + aux)
    paths, leaves = zip(*leaf_paths(model.params()))
    want = dict(leaf_paths(tree_of(ref, f"grads/{arch}")))
    assert set(paths) == set(want)
    for path, g in zip(paths, torch.autograd.grad(loss, leaves)):
        w = want[path]
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_REL_L2, ("/".join(path), err)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_drops_as_jax(ref, models, arch):
    """One MoE layer at capacity factor MOE_DROP_CF: the same assignments
    dropped (the stable sort keeps each expert's earliest tokens), the
    same output and aux loss."""
    cfg = dataclasses.replace(CFGS[arch], moe=dataclasses.replace(
        CFGS[arch].moe, capacity_factor=MOE_DROP_CF))
    p0 = {k: v[0] for k, v in models[arch].params()["layers"]["moe"].items()}
    x = torch.from_numpy(moe_input(cfg))
    C = tmoe.capacity(LM_S, cfg)
    assert C == int(ref[f"moe_drop/{arch}/C"])
    _, _, ids = tmoe.route(p0, x, cfg)
    _, _, keep = tmoe.dispatch_slots(ids, cfg.moe.n_routed, C)
    dropped = int((~keep).sum())
    assert dropped == int(ref[f"moe_drop/{arch}/dropped"]) > 0
    with torch.no_grad():
        out, aux = tmoe.moe_ffn(p0, x, cfg)
    np.testing.assert_allclose(out.numpy(), ref[f"moe_drop/{arch}/out"],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux.item(), ref[f"moe_drop/{arch}/aux"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("C", [1, 2, 5])
def test_dispatch_slots_equal_a_loop(C):
    """dispatch_slots against a plain loop over each row's assignments in
    token-major order: an assignment takes its expert's next place until
    C are taken."""
    rng = np.random.default_rng(C)
    E, K = 6, 3
    ids = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(9)])
                    for _ in range(2)])
    slot_e, slot_c, keep = tmoe.dispatch_slots(torch.from_numpy(ids), E, C)
    for b in range(2):
        taken = [0] * E
        for a, e in enumerate(ids[b].reshape(-1)):
            ok = taken[e] < C
            assert bool(keep[b, a]) == ok
            assert (int(slot_e[b, a]), int(slot_c[b, a])) == ((e, taken[e]) if ok else (E, 0))
            taken[e] += ok


def test_mla_query_chunks_equal_one_block(monkeypatch, models):
    """MLA's q-chunk branch (queries in chunks above the threshold) against
    the single block, on the same projections; the threshold is lowered so
    that SMOKE's 16 queries go in 4 chunks of 4."""
    arch = "deepseek-v2-lite-16b"
    cfg = CFGS[arch]
    p = {k: v[0] for k, v in models[arch].params()["layers"].items() if k != "moe"}
    x = torch.from_numpy(moe_input(cfg))
    pos = torch.arange(LM_S)
    parts = tattn._mla_parts(p, x, cfg)
    one = tattn._mla_attend(p, *parts, pos, pos, cfg)
    monkeypatch.setattr(tattn, "_CHUNK_THRESHOLD", 8)
    chunked = tattn._mla_attend(p, *parts, pos, pos, cfg, q_chunk=4)
    assert chunked.shape == one.shape == (LM_B, LM_S, cfg.n_heads * cfg.mla.v_dim)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_params_from_numpy_checks_the_moe_tree(ref):
    arch = "deepseek-v2-lite-16b"
    cfg = CFGS[arch]
    tree = tree_of(ref, f"params/{arch}")
    moe = tree["layers"]["moe"]
    bad = {**tree, "layers": {**tree["layers"], "moe": {**moe, "w1": moe["w1"][:, :4]}}}
    with pytest.raises(ValueError, match="layers/moe/w1"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    bad = {**tree, "dense_layers": {k: v for k, v in tree["dense_layers"].items()
                                    if k != "w_uk"}}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(bad, cfg, device="cpu")
