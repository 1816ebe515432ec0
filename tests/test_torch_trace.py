"""The port's spans (``repro_torch.trace``) on the CPU: a tiny LM's train
step and prefill, a resident pipeline's job at M=32, and the MoE, MLA and
one-rank mesh (DTensor) steps at the SMOKE sizes.

With the profiler off a span is the shared no-op. The spans insert no
node into the autograd graph, on or off, and the loss and gradients are
bit-equal to a run under the profiler. Under ``torch.profiler`` the
host's events hold the spans, the backward's sublayer ranges in reverse
layer order, ``model.recompute`` with remat only and no sublayer span
inside it, and every aten op that does work inside one of the spans but
for the token embedding's and the curve steps' own.
"""

import dataclasses
from collections import Counter

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import deepseek_moe_16b, deepseek_v2_lite_16b, smollm_360m
from repro_torch.launch.dryrun import sanitize_specs
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import leaves as tree_leaves, on_mesh
from repro_torch.stencil.pipeline import ResidentPipeline
from repro_torch.train import TrainConfig, init_opt_state, make_train_step
from repro_torch.train.train_step import shard_batch

CFG = ModelConfig(name="tiny-trace", family="dense", n_layers=3, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                  activation_dtype="bfloat16", use_flash_kernel=True)
SPANS = {"model.attention", "kernels.flash_attention", "model.mlp", "model.head",
         "model.recompute", "adamw_update", "stencil.blockize", "stencil.unblockize"}
# top-level aten ops that do no work (aliases)
NO_WORK = {"aten::detach", "aten::view", "aten::alias", "aten::empty",
           "aten::empty_like", "aten::reshape", "aten::t", "aten::transpose",
           "aten::select", "aten::slice", "aten::unbind", "aten::as_strided"}
# the work a forward does outside the layers' spans: the token embedding
# (the tokens' cast, the lookup and the rows' cast), the positions, and the
# aux loss's start and its sum over the layers (0-d adds)
EMBEDDING = Counter({"aten::to": 2, "aten::embedding": 1, "aten::arange (0-d)": 1,
                     "aten::zeros (0-d)": 1, "aten::add (0-d)": CFG.n_layers})
# and a backward's: its seed, a one-element fill that
# ``torch.autograd.grad`` makes on the caller's thread, and the embedding's
# gradient (the rows' cast and the lookup's)
EMBEDDING_BACKWARD = Counter({"aten::ones_like (0-d)": 1, "aten::to": 1,
                              "aten::embedding_backward": 1})


def _model(seed=0):
    torch.manual_seed(seed)
    return Model(CFG, device="cpu").requires_grad_()


def _batch(B=2, S=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(CFG.vocab, (B, S), generator=g),
            "labels": torch.randint(CFG.vocab, (B, S), generator=g)}


def _loss_and_grads(model, batch, remat):
    params = model.params()
    loss, _ = tfm.loss_fn(params, batch, CFG, remat)
    return loss, torch.autograd.grad(loss, tree_leaves(params))


def _nodes(t) -> Counter:
    """Every node of the autograd graph behind ``t``, by name."""
    seen, todo, names = set(), [t.grad_fn], Counter()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names[fn.name()] += 1
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _profiled(fn):
    fn()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    return out, prof.profiler.function_events


def _spans(events):
    return sorted((e for e in events if e.name in SPANS), key=lambda e: e.time_range.start)


def _within(e, s) -> bool:
    return (e is not s and e.thread == s.thread and s.time_range.start <= e.time_range.start
            and e.time_range.end <= s.time_range.end)


def _overlapping(spans):
    """The pairs of spans of one thread that overlap without nesting."""
    return [(a.name, b.name) for i, a in enumerate(spans) for b in spans[i + 1:]
            if a.thread == b.thread and b.time_range.start < a.time_range.end
            and not _within(b, a)]


def _outermost(spans):
    return [s.name for s in spans if not any(_within(s, o) for o in spans)]


def _outside(events) -> Counter:
    """The top-level aten ops that do work and lie inside no span, by name,
    " (0-d)" added to an op on 0-d tensors alone."""
    spans = _spans(events)
    return Counter(e.name + (" (0-d)" if all(sh == [] for sh in e.input_shapes) else "")
                   for e in events if e.name.startswith("aten::") and e.name not in NO_WORK
                   and not (e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"))
                   and not any(_within(e, s) for s in spans))


def _step(remat):
    model = _model()
    params = model.params()
    state = init_opt_state(params)
    step = make_train_step(model, TrainConfig(remat=remat))
    batch = _batch()
    return lambda: step(params, state, batch)


def test_a_span_is_the_shared_no_op_with_the_profiler_off():
    for make in (trace.span, trace.sublayer):
        s = make("model.mlp")
        assert s is trace._OFF
        x = torch.ones(3, requires_grad=True)
        with s as got:
            assert got.input(x) is x and got.output(x) is x
    assert trace.recompute() is trace._OFF


def _hooks(monkeypatch) -> Counter:
    """Counts of the sublayer spans' backward hooks as they run."""
    ran = Counter()
    for name in ("_open", "_close"):
        real = getattr(trace._Sublayer, name)

        def hook(self, g, real=real, name=name):
            ran[name] += 1
            return real(self, g)

        monkeypatch.setattr(trace._Sublayer, name, hook)
    return ran


@pytest.mark.parametrize("remat", [True, False, "dots"])
def test_no_edge_without_the_profiler_and_the_same_numbers_under_it(remat, monkeypatch):
    ran = _hooks(monkeypatch)
    model, batch = _model(), _batch()
    loss, grads = _loss_and_grads(model, batch, remat)
    off = _nodes(loss)
    assert not ran
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on, grads_on = _loss_and_grads(model, batch, remat)
        on = _nodes(loss_on)
    # under the profiler the graph is the same, node for node, and the
    # backward ran one opening and one closing hook for each sublayer
    # span (the head and each layer's attention and mlp)
    assert on == off
    assert ran == dict.fromkeys(("_open", "_close"), 1 + 2 * CFG.n_layers)
    assert torch.equal(loss, loss_on)
    for g, g_on in zip(grads, grads_on):
        assert torch.equal(g, g_on)


@pytest.mark.parametrize("remat", [True, False])
def test_the_train_step_runs_in_the_spans_forward_and_backward(remat):
    _, events = _profiled(_step(remat))
    spans = _spans(events)
    layer = ["model.attention", "model.mlp"]
    want = (layer * CFG.n_layers + ["model.head"]
            + ["model.head"] + layer[::-1] * CFG.n_layers + ["adamw_update"])
    assert _outermost(spans) == want
    # a sublayer's backward range closes before the previous one opens
    assert not _overlapping(spans)
    # the backward's ranges hold the backward's work
    backward = [s for s in spans if s.name.startswith("model.")][1 + 2 * CFG.n_layers:]
    for s in backward:
        if not s.name == "model.recompute":
            assert any("evaluate_function" in e.name and _within(e, s) for e in events), s.name
    flash = [s for s in spans if s.name == "kernels.flash_attention"]
    attention = [s for s in spans if s.name == "model.attention"]
    recompute = [s for s in spans if s.name == "model.recompute"]
    # flash's forward, its backward, and with remat its recomputed forward
    assert len(flash) == (3 if remat else 2) * CFG.n_layers
    for f in flash:
        assert any(_within(f, a) for a in attention + recompute)
    assert len(recompute) == (CFG.n_layers if remat else 0)
    for r in recompute:
        assert not any(_within(s, r) for s in spans
                       if s.name in ("model.attention", "model.mlp", "model.head"))
        # inside the backward of the layer's mlp, whose output's gradient asks for it
        assert any(_within(r, m) for m in spans if m.name == "model.mlp")


@pytest.mark.parametrize("remat", [True, False])
def test_every_op_of_a_train_step_lies_inside_a_span(remat):
    _, events = _profiled(_step(remat))
    assert _outside(events) == EMBEDDING + EMBEDDING_BACKWARD


def test_every_op_of_a_prefill_lies_inside_a_span():
    model = Model(CFG, device="cpu")
    tokens = {"tokens": _batch(B=1, S=64)["tokens"]}
    _, events = _profiled(lambda: model.prefill(tokens))
    spans = _spans(events)
    layer = ["model.attention", "model.mlp"]
    assert _outermost(spans) == layer * CFG.n_layers + ["model.head"]
    assert sum(s.name == "kernels.flash_attention" for s in spans) == CFG.n_layers
    assert _outside(events) == EMBEDDING


def test_every_op_of_a_pipeline_job_lies_inside_a_span():
    pipe = ResidentPipeline(M=32, T=8, g=1, kind="hilbert", S=4, rule="wave",
                            device="cpu")
    x = torch.rand((2, 32, 32, 32), generator=torch.Generator().manual_seed(3))
    out, events = _profiled(lambda: pipe.run(x, 8))
    assert _outermost(_spans(events)) == ["stencil.blockize", "stencil.unblockize"]
    # outside the two layout spans: the curve-ordered steps, op for op
    stores = [pipe.to_blocks(x) for _ in range(2)]
    _, steps = _profiled(lambda: pipe.run_fn(8)(stores.pop()))
    assert _outside(events) == _outside(steps)
    assert torch.equal(out, pipe.run(x, 8))


# the dense and MoE families over a one-rank (1, 1) gloo mesh, whose
# parameters, activations and flash calls are DTensors, and the MoE family
# (GQA and MLA attention) on plain tensors
STEPS = {"dense-mesh": (smollm_360m.SMOKE, True), "moe-mesh": (deepseek_moe_16b.SMOKE, True),
         "moe": (deepseek_moe_16b.SMOKE, False), "mla-moe": (deepseek_v2_lite_16b.SMOKE, False)}


@pytest.mark.parametrize("case", list(STEPS))
def test_a_profiled_step_gives_the_numbers_of_a_plain_one(case, tmp_path):
    base, sharded = STEPS[case]
    cfg = dataclasses.replace(base, use_flash_kernel=True)
    if sharded:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                                world_size=1, rank=0)
    try:
        if sharded:
            mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
            cfg = dataclasses.replace(cfg, ep_axis="model",
                                      act_spec=(batch_axes(mesh), "model", None))
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        model.requires_grad_()
        if sharded:
            model.shard(mesh, sanitize_specs(mesh, model.specs(), model.defs()))
        toks = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if sharded:
            batch = shard_batch(batch, mesh)
        params = model.params()

        def loss_and_grads():
            with on_mesh(params):
                loss, _ = tfm.loss_fn(params, batch, cfg, True)
                grads = torch.autograd.grad(loss, tree_leaves(params))
            # the whole tensors, before the group goes
            return [t.full_tensor() if isinstance(t, DTensor) else t for t in (loss, *grads)]

        off = loss_and_grads()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = loss_and_grads()
        names = Counter(e.name for e in prof.profiler.function_events if e.name in SPANS)
    finally:
        if sharded:
            dist.destroy_process_group()
    # each layer's sublayers forward and backward, the recompute, the head
    assert names["model.attention"] == names["model.mlp"] == 2 * cfg.n_layers
    assert names["model.recompute"] == cfg.n_layers and names["model.head"] == 2
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))
