"""The torch package's mesh cases, one function a case, run on every gloo
rank by ``tests/_torch_oracle.py`` (``shard_arrays``): ``step`` and
``hints`` on a (2, 2) ("data", "model") mesh of 4 ranks, ``elastic`` on
8. Each takes (rank, inputs, work directory) and returns the arrays the
rank saves; a sharded tensor's whole value is gathered on every rank (a
collective), and the unsharded runs beside it are the port's own."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint import ckpt
from repro_torch.configs import deepseek_moe_16b, deepseek_v2_lite_16b, smollm_360m
from repro_torch.data import TokenPipeline
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import sanitize_specs
from repro_torch.launch.elastic import (ELASTIC_OPT, ELASTIC_PIPE,
                                       elastic_config, reshard_run)
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import Model
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import (leaf_paths, leaves, on_mesh, placements,
                                       unflatten)
from repro_torch.train import OptConfig, TrainConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state

MESH = (2, 2)
STEPS = 3
DECODE_B, DECODE_LEN, DECODE_STEPS = 2, 16, 6
DECODE_RULES = {"batch": None, "seq": "model", "kv_heads": None, "heads": None}
MOE_B, MOE_S = 4, 32
GQA_B, GQA_S = 4, 32


def mesh():
    return init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def tree_of(inputs: dict, prefix: str) -> dict:
    pre = prefix + "/"
    return unflatten({tuple(k[len(pre):].split("/")): v
                      for k, v in inputs.items() if k.startswith(pre)})


def put(res: dict, prefix: str, tree) -> None:
    for path, t in leaf_paths(tree):
        res[prefix + "/" + "/".join(path)] = whole(t).detach().numpy()


def sharded(model: Model, m, **rules) -> Model:
    """``model`` placed on mesh ``m`` by its sanitised specs."""
    return model.shard(m, sanitize_specs(m, model.specs(**rules), model.defs()))


def _batches(cfg):
    pipe = TokenPipeline(vocab=cfg.vocab, **ELASTIC_PIPE)
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
            for i in range(STEPS)]


def _steps(model, batches, microbatches=1):
    params = model.params()
    opt = init_opt_state(params)
    step = make_train_step(model, TrainConfig(opt=OptConfig(**ELASTIC_OPT),
                                              microbatches=microbatches))
    out = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return params, opt, out


def step(rank: int, inputs: dict, work) -> dict:
    """Three train steps of the elastic configuration from the JAX
    package's initial weights, sharded over (2, 2) with the residual split
    (``act_spec``) and unsharded; one sharded step with microbatches=2."""
    m = mesh()
    cfg = elastic_config()
    init = tree_of(inputs, "init")
    batches = _batches(cfg)
    res = {}
    scfg = dataclasses.replace(cfg, act_spec=(batch_axes(m), "model", None))
    model = sharded(lm_params_from_numpy(init, scfg, device="cpu").requires_grad_(), m)
    params, opt, out = _steps(model, batches)
    res["mesh/metrics"] = np.asarray(out)
    put(res, "mesh/final", params)
    res["mesh/m_is_dtensor"] = np.bool_(all(isinstance(x, DTensor)
                                            for x in leaves(opt["m"])))
    res["mesh/m_placements_match"] = np.bool_(all(
        x.placements == p.placements for x, p in zip(leaves(opt["m"]), leaves(params))))
    # the sharded tree written in the background, restored onto the mesh
    # by a callable (path, value) -> (mesh, placements)
    where = {"/".join(path): (m, x.placements) for path, x in leaf_paths(params)}
    ckpt.save_async(str(work / "ckpt"), STEPS, {"params": params})
    ckpt.wait()
    back, _ = ckpt.restore(str(work / "ckpt"),
                           shardings=lambda path, v: where[path[len("params/"):]])
    res["mesh/restored_bit_equal"] = np.bool_(all(
        isinstance(b, DTensor) and b.placements == a.placements
        and torch.equal(a.to_local(), b.to_local())
        for a, b in zip(leaves(params), leaves(back["params"]))))
    micro = sharded(lm_params_from_numpy(init, scfg, device="cpu").requires_grad_(), m)
    res["micro/metrics"] = np.asarray(_steps(micro, batches[:1], microbatches=2)[2])
    plain = lm_params_from_numpy(init, cfg, device="cpu").requires_grad_()
    params, _, out = _steps(plain, batches)
    res["plain/metrics"] = np.asarray(out)
    put(res, "plain/final", params)
    return res


def _counting_dispatch(counts: list):
    real = moe_mod.dispatch_slots

    def counted(ids, E, C):
        slot_e, slot_c, keep = real(ids, E, C)
        counts.append(int((~keep).sum()))
        return slot_e, slot_c, keep
    return counted


def hints(rank: int, inputs: dict, work) -> dict:
    """The sharding hints on (2, 2): deepseek-moe-16b SMOKE (capacity
    factor 1, so assignments drop) with ``ep_axis`` and ``act_spec``,
    prefill logits and dropped assignments; smollm SMOKE decode with
    ``score_spec`` over a sequence-split cache; a GQA model whose q heads
    split over "model" while its one kv head does not, loss and
    gradients through the flash path."""
    m = mesh()
    res = {"model_coord": np.asarray(m.get_coordinate()[1])}
    # one dim split over two mesh dims, pod-major as JAX splits it
    pods = init_device_mesh("cpu", MESH, mesh_dim_names=("pod", "data"))
    rows = distribute_tensor(torch.arange(8.0), pods,
                             placements((("pod", "data"),), pods))
    res["pod_major/rows"] = rows.to_local().numpy()
    res["pod_major/coord"] = np.asarray(pods.get_coordinate())
    gen = lambda s: torch.Generator().manual_seed(s)
    # MoE prefill and its drops
    cfg = dataclasses.replace(deepseek_moe_16b.SMOKE, moe=dataclasses.replace(
        deepseek_moe_16b.SMOKE.moe, capacity_factor=1.0))
    tokens = torch.randint(0, cfg.vocab, (MOE_B, MOE_S), generator=gen(2))
    for name, c in (("plain", cfg), ("mesh", dataclasses.replace(
            cfg, act_spec=(batch_axes(m), "model", None), ep_axis="model"))):
        model = Model(c, device="cpu").init(gen(0))
        batch = {"tokens": tokens}
        if name == "mesh":
            sharded(model, m)
            batch = {"tokens": distribute_tensor(tokens, m, placements(("data",), m))}
        counts: list = []
        real = moe_mod.dispatch_slots
        moe_mod.dispatch_slots = _counting_dispatch(counts)
        try:
            res[f"moe/{name}/logits"] = whole(model.prefill(batch)).numpy()
        finally:
            moe_mod.dispatch_slots = real
        res[f"moe/{name}/drops"] = np.asarray(counts)
    # decode with score_spec over a sequence-split cache
    cfg = dataclasses.replace(smollm_360m.SMOKE, use_flash_kernel=True)
    tokens = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_STEPS), generator=gen(1))
    for name, c in (("plain", cfg), ("mesh", dataclasses.replace(
            cfg, score_spec=(None, None, None, "model")))):
        model = Model(c, device="cpu").init(gen(0))
        cache = model.init_cache(DECODE_B, DECODE_LEN, torch.float32)
        if name == "mesh":
            sharded(model, m)
            specs = dict(leaf_paths(sanitize_specs(
                m, model.cache_specs(DECODE_B, DECODE_LEN, extra_rules=DECODE_RULES),
                cache)))
            cache = unflatten({p: distribute_tensor(t, m, placements(specs[p], m))
                               for p, t in leaf_paths(cache)})
            res["decode/cache_seq_split"] = np.bool_(
                cache["layers"]["k"].placements[1].is_shard(2))
        logits = []
        for cur in range(DECODE_STEPS):
            lg, cache = model.decode(cache, {"tokens": tokens[:, cur:cur + 1],
                                             "cur": cur})
            logits.append(whole(lg).numpy())
        res[f"decode/{name}/logits"] = np.stack(logits)
    # q heads split, the kv head replicated: the flash path on the mesh
    cfg = dataclasses.replace(elastic_config(), n_kv_heads=1, use_flash_kernel=True)
    tokens = torch.randint(0, cfg.vocab, (GQA_B, GQA_S + 1), generator=gen(3))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    calls = []
    real_flash = ops._flash_on_mesh

    def flash_seen(q, k, v, *a):
        calls.append((tuple(q.placements), tuple(k.placements)))
        return real_flash(q, k, v, *a)

    for name, c in (("plain", cfg), ("mesh", dataclasses.replace(
            cfg, act_spec=(batch_axes(m), "model", None)))):
        model = Model(c, device="cpu").init(gen(4)).requires_grad_()
        b = batch
        if name == "mesh":
            sharded(model, m)
            b = {k: distribute_tensor(t, m, placements(("data",), m))
                 for k, t in batch.items()}
        ops._flash_on_mesh = flash_seen
        try:
            loss, _ = model.loss(b)
            names, ps = zip(*leaf_paths(model.params()))
            with on_mesh(model.params()):
                grads = torch.autograd.grad(loss, ps)
        finally:
            ops._flash_on_mesh = real_flash
        res[f"gqa/{name}/loss"] = whole(loss).detach().numpy()
        for path, g in zip(names, grads):
            res[f"gqa/{name}/grads/" + "/".join(path)] = whole(g).numpy()
    res["gqa/flash_on_mesh_calls"] = np.asarray(len(calls))
    res["gqa/q_heads_split_kv_whole"] = np.bool_(bool(calls) and all(
        q[1].is_shard(1) and k[1].is_replicate() for q, k in calls))
    _heads_cases(res, m, gen)
    return res


def _heads_cases(res: dict, m, gen) -> None:
    """Attention without the flash kernel on the mesh, each rank on its own
    heads: 4 q heads over "model" with their 2 kv heads split too ("kv2"),
    with their one kv head taken whole ("kv1"), and MLA's 4 heads
    (deepseek-v2-lite SMOKE, "mla"); loss and gradients beside the
    unsharded model's, and the placements of each attention's output."""
    base = elastic_config()
    mla = dataclasses.replace(deepseek_v2_lite_16b.SMOKE,
                              activation_dtype="float32")
    real = ops.on_heads
    for case, cfg in (("kv2", base), ("kv1", dataclasses.replace(base, n_kv_heads=1)),
                      ("mla", mla)):
        tokens = torch.randint(0, cfg.vocab, (GQA_B, GQA_S + 1), generator=gen(5))
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        outs = []

        def seen(*a, **kw):
            o = real(*a, **kw)
            outs.append(tuple(o.placements))
            return o

        for name in ("plain", "mesh"):
            model = Model(cfg, device="cpu").init(gen(6)).requires_grad_()
            b = batch
            if name == "mesh":
                sharded(model, m)
                b = {k: distribute_tensor(t, m, placements(("data",), m))
                     for k, t in batch.items()}
            attn_mod.on_heads = seen
            try:
                loss, _ = model.loss(b)
                names, ps = zip(*leaf_paths(model.params()))
                with on_mesh(model.params()):
                    grads = torch.autograd.grad(loss, ps)
            finally:
                attn_mod.on_heads = real
            res[f"heads/{case}/{name}/loss"] = whole(loss).detach().numpy()
            for path, g in zip(names, grads):
                res[f"heads/{case}/{name}/grads/" + "/".join(path)] = whole(g).numpy()
        res[f"heads/{case}/calls"] = np.asarray(len(outs))
        res[f"heads/{case}/heads_split"] = np.bool_(bool(outs) and all(
            o[0].is_shard(0) and o[1].is_shard(2) for o in outs))


def elastic(rank: int, inputs: dict, work) -> dict:
    """The elastic training run through the port's functions
    (``launch.elastic.reshard_run``) from the JAX package's initial
    weights: 3 steps on a (4, 2) mesh of the 8 ranks, a checkpoint in
    ``work``, a restore onto (2, 2), 3 more steps."""
    model = lm_params_from_numpy(tree_of(inputs, "init"), elastic_config(),
                                 device="cpu").requires_grad_()
    out = reshard_run(model, [4, 2], [2, 2], str(work / "ckpt"),
                      log=lambda m: None)
    res = {"losses": np.asarray(out["losses"])}
    if out["bit_exact"] is not None:
        res["bit_exact"] = np.bool_(out["bit_exact"])
    return res
