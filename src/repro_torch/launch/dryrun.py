"""Multi-pod dry run: count every (arch × shape × mesh) cell's real step.

The torch counterpart of ``repro.launch.dryrun``. For each cell this
builds the real step (the train step for ``train_4k``, the prefill for
``prefill_32k``, the serve step for the decode shapes) with the
production shardings, runs it once on the meta device (shapes and dtypes,
nothing allocated) under torch's fake process group, counts one device's
flops, HBM bytes, collective bytes and peak memory op by op
(``roofline.op_cost``), and writes the roofline terms to
``experiments/dryrun_torch/<arch>_<shape>_<mesh>.json``. It runs on a
machine without a card, as the JAX package's runs on host devices; the
same ``run_cell`` on ``device="cuda"`` counts the step on the card.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --all --mesh single --opt act_seq_shard=0

``sanitize_specs`` and ``_batch_specs`` are the sharding helpers the
trainer shares. ``mesh`` is a ``DeviceMesh`` with named dims (the helpers
read only its ``mesh_dim_names`` and ``shape``, as the JAX package reads
only ``mesh.shape``). The model, trainer and serving modules are imported
inside ``run_cell``: the trainer imports this module.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.models.params import Spec, leaf_paths, unflatten

__all__ = ["sanitize_specs", "DEFAULT_OPTS", "run_cell", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# The production meshes' device type: meta tensors need no card, and a
# "cuda" mesh's sharding propagation needs a torch built with CUDA. On a
# "cpu" mesh DTensor moves a shard from one dim to another (Shard(i) ->
# Shard(j) on one mesh dim) by gloo's all-gather and a chunk, where on a
# card it takes one all-to-all: such moves count as all-gathers here.
MESH_DEVICE_TYPE = "cpu"


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def sanitize_specs(mesh, specs, abstracts):
    """Drop the sharding of any dim the mesh axis does not divide (vocab
    51865 over 16 ways, 5 kv heads over 16): the JAX package's baseline
    replicates such dims rather than pad them, and so does the port,
    although DTensor would take uneven shards. ``abstracts`` is a matching
    tree of anything with a ``shape`` (tensors, ParamDefs)."""
    shapes = {path: tuple(a.shape) for path, a in leaf_paths(abstracts)}

    def fix(spec, shape):
        parts = list(spec) + [None] * (len(shape) - len(spec))
        return Spec(*(axis if dim % _axis_size(mesh, axis) == 0 else None
                      for dim, axis in zip(shape, parts)))

    return unflatten({path: fix(spec, shapes[path])
                      for path, spec in leaf_paths(specs)})


def _batch_specs(specs_tree, baxes):
    """``Spec(baxes, None, ...)`` for every array input (anything with a
    ``shape``); scalars replicated."""
    def one(a):
        nd = len(a.shape)
        return Spec() if nd == 0 else Spec(baxes, *([None] * (nd - 1)))
    return unflatten({path: one(a) for path, a in leaf_paths(specs_tree)})


# the options ``run_cell`` and ``main`` read; the JAX package's ``donate``
# and ``window_cache`` are not among them (an eager step writes in place,
# and no step here reads a window cache), and ``--opt`` refuses them
DEFAULT_OPTS = {
    "act_seq_shard": 1,     # Megatron-SP residual sharding for train/prefill
    "remat": "1",   # "1" | "0" | "dots"
    "microbatches": 1,
    "score_shard": 1,       # decode: pin scores to the cache's seq sharding
    "flash": 0,             # the flash_attention_fwd kernel (CUDA only)
    "device_order": "hilbert",
}


def _place(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` placed by its spec
    in ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.params import placements

    spec_of = dict(leaf_paths(specs))
    return unflatten({path: distribute_tensor(t, mesh, placements(spec_of[path], mesh))
                      for path, t in leaf_paths(tree)})


def _inputs(cfg, shape, dev) -> dict:
    """A cell's inputs on ``dev``: meta tensors (``input_specs``) on meta,
    else ``concrete_batch``'s seeded values."""
    from repro_torch.configs.registry import concrete_batch, input_specs

    if dev.type == "meta":
        return input_specs(cfg, shape)
    return concrete_batch(cfg, shape, device=dev)


def _measure(run, dev) -> dict:
    """The step once more, outside the count: its ms (host clock around a
    synchronised run) and the most bytes the card's allocator held above
    what it held before."""
    import torch

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    return {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
            "device": torch.cuda.get_device_name(dev)}


def run_cell(arch, shape, mesh, mesh_name: str, opts: dict, *,
             device="meta", measure: bool = False) -> dict:
    """Count one cell's step on one device of ``mesh`` and return its
    roofline record (``RooflineCell.to_dict`` plus the counts).

    ``arch`` is a name in ``ARCHS`` or a ``ModelConfig``; ``shape`` a name
    in ``SHAPES`` or a ``ShapeSpec`` (how tests and ``chip_smoke.py`` pass
    cut shapes). On ``device="meta"`` nothing is allocated and ``mesh`` is
    a mesh of the fake process group; on ``"cpu"`` or ``"cuda"`` the
    weights are drawn from a seeded generator and the step really runs.
    The step runs once before the counted one, which is in steady state
    (device constants copied, DTensor's plans made); the decode step
    writes its token at the cache's last position (its cost does not
    depend on where). With ``measure`` on the card, the step runs once
    more outside the count (``measured``: ms and peak bytes).
    ``opts["flash"]`` runs the flash kernel, which exists on the card only:
    on meta it raises."""
    import torch

    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.roofline import analyze, op_cost

    from .mesh import batch_axes

    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = arch if isinstance(arch, str) else cfg.name
    dev = resolve_device(device)
    baxes = batch_axes(mesh)
    n_dev = mesh.size()

    if shape.mode in ("train", "prefill") and opts["act_seq_shard"]:
        cfg = dataclasses.replace(cfg, act_spec=(baxes, "model", None))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, ep_axis="model")
    if opts["flash"]:
        if dev.type == "meta":
            raise ValueError(
                "opts['flash']=1 runs the flash_attention_fwd CUDA kernel, "
                "which has no meta form: count it with device='cuda', or "
                "run the dry run with flash=0")
        cfg = dataclasses.replace(cfg, use_flash_kernel=True)

    def build(cfg, dtype):
        """The model in ``dtype`` weights, placed on the mesh by its
        sanitised specs."""
        m = Model(dataclasses.replace(cfg, param_dtype=str(dtype).split(".")[-1]),
                  device=dev)
        if dev.type != "meta":
            m.init(torch.Generator(device=dev).manual_seed(0))
        return m, sanitize_specs(mesh, m.specs(), m.abstract(dtype))

    t0 = time.time()
    if shape.mode == "train":
        from repro_torch.train import TrainConfig, init_opt_state, make_train_step

        model, pspecs = build(cfg, torch.float32)
        model.requires_grad_().shard(mesh, pspecs)
        params = model.params()
        opt = init_opt_state(params)
        batch = _inputs(cfg, shape, dev)
        batch = _place(batch, _batch_specs(batch, baxes), mesh)
        rm = opts["remat"]
        rm = {"1": True, "0": False, 1: True, 0: False}.get(rm, rm)
        step = make_train_step(model, TrainConfig(
            microbatches=opts["microbatches"], remat=rm))
        args = (params, opt, batch)

        def run():
            return step(params, opt, batch)

        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * model.n_active_params() * tokens
    elif shape.mode == "prefill":
        model, pspecs = build(cfg, torch.bfloat16)
        model.shard(mesh, pspecs)
        batch = _inputs(cfg, shape, dev)
        batch = _place(batch, _batch_specs(batch, baxes), mesh)
        args = (model.params(), batch)

        def run():
            return model.prefill(batch)

        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * model.n_active_params() * tokens
    else:  # decode
        from repro_torch.configs.registry import input_specs
        from repro_torch.serve import make_serve_step

        B, S = shape.global_batch, shape.seq_len
        b_rule = baxes if B >= 8 else None
        # sequence-parallel decode cache: KV-head counts (1..8) don't
        # divide the 16-way TP axis, the 2^k sequence always does; B=1
        # (long_500k) additionally spreads seq over the batch axes.
        seq_rule = ("data", "model") if B == 1 else "model"
        if opts["score_shard"]:
            cfg = dataclasses.replace(
                cfg, score_spec=(b_rule, None, None, seq_rule))
        model, pspecs = build(cfg, torch.bfloat16)
        model.shard(mesh, pspecs)
        cache_specs = model.cache_specs(
            B, S, extra_rules={"batch": b_rule, "seq": seq_rule,
                               "kv_heads": None, "heads": None})
        cache_specs = sanitize_specs(mesh, cache_specs,
                                     model.abstract_cache(B, S, torch.bfloat16))
        cache = _place(model.init_cache(B, S, torch.bfloat16), cache_specs, mesh)
        tokens = {"tokens": _inputs(cfg, shape, dev)["tokens"]}
        tokens = _place(tokens, _batch_specs(tokens, b_rule), mesh)["tokens"]
        # the step's arguments; the position is an int32 scalar of 4 bytes
        # where the step reads it (an SSM's decode reads none, and XLA
        # drops the JAX package's unused argument)
        pos = {} if cfg.family == "ssm" else {"cur": input_specs(cfg, shape)["cur"]}
        args = (model.params(), cache, {"tokens": tokens, **pos})
        step = make_serve_step(model)

        def run():
            return step(cache, {"tokens": tokens, "cur": S - 1})

        model_flops = 2.0 * model.n_active_params() * B
    # a step in steady state: the first one also copies device constants
    # and lets DTensor plan its redistributes, once
    run()
    t_build = time.time() - t0
    t0 = time.time()
    with op_cost.count(args) as cost:
        out = run()
    cost.memory["output_bytes"] = op_cost.tree_bytes(out)
    t_count = time.time() - t0
    del out

    cell = analyze(arch, shape.name, mesh_name, n_dev, cost, model_flops)
    rec = cell.to_dict()
    rec.update(t_build_s=t_build, t_count_s=t_count, opts=dict(opts),
               n_params=model.n_params(), n_active=model.n_active_params(),
               device=dev.type, cost=cost.to_dict())
    if measure and dev.type == "cuda":
        rec["measured"] = _measure(run, dev)
    print(f"  memory: {cost.memory}")
    print(f"  cost: flops={cost.flops:.3e} bytes={cost.bytes:.3e} "
          f"collective={sum(cost.coll_bytes.values()):.3e} "
          f"(FlopCounterMode, global: {cost.torch_raw.get('flops', 0):.3e})")
    print(f"  roofline: compute {cell.t_compute*1e3:.2f} ms | memory "
          f"{cell.t_memory*1e3:.2f} ms | collective "
          f"{cell.t_collective*1e3:.2f} ms ({cell.collective_link}) -> "
          f"{cell.bottleneck}-bound, useful-flops {cell.useful_flops_frac:.2f}, "
          f"MFU-bound {cell.mfu_bound:.2%}")
    return rec


def _fake_group(n: int):
    """Torch's fake process group of ``n`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", action="append", default=[],
                    help="key=val overrides, e.g. --opt act_seq_shard=0")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs.registry import cells, shape_skip_reason

    from .mesh import make_production_mesh

    opts = dict(DEFAULT_OPTS)
    for kv in args.opt:
        k, v = kv.split("=", 1)
        if k not in DEFAULT_OPTS:
            ap.error(f"--opt {k}: not an option of the dry run "
                     f"({', '.join(DEFAULT_OPTS)})")
        opts[k] = type(DEFAULT_OPTS[k])(v)

    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        reason = shape_skip_reason(args.arch, args.shape)
        if reason:
            print(f"SKIP {args.arch} × {args.shape}: {reason}")
            return
        todo = [(args.arch, args.shape)]

    _fake_group(512 if args.mesh in ("multi", "both") else 256)
    failures = []
    try:
        meshes = []
        for name, multi, want in (("single_pod_16x16", False, ("single", "both")),
                                  ("multi_pod_2x16x16", True, ("multi", "both"))):
            if args.mesh in want:
                meshes.append((name, make_production_mesh(
                    multi_pod=multi, device_order=opts["device_order"],
                    device_type=MESH_DEVICE_TYPE)))
        os.makedirs(args.out, exist_ok=True)
        for mesh_name, mesh in meshes:
            for arch, shape_name in todo:
                key = f"{arch}_{shape_name}_{mesh_name}{args.tag}"
                print(f"[dryrun] {key}", flush=True)
                try:
                    rec = run_cell(arch, shape_name, mesh, mesh_name, opts)
                    with open(os.path.join(args.out, key + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:  # noqa: BLE001 — report-and-continue runner
                    traceback.print_exc()
                    failures.append((key, repr(e)))
    finally:
        dist.destroy_process_group()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for k, e in failures:
            print("  ", k, e)
        raise SystemExit(1)
    print(f"[dryrun] all {len(todo) * len(meshes)} cells counted OK")


if __name__ == "__main__":
    main()
