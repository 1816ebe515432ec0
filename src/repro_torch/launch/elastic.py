"""Elastic re-scaling: restore a checkpoint onto a different mesh, on the
card unless ``--device cpu``.

The torch counterpart of ``repro.launch.elastic``. The training mode::

    python -m repro_torch.launch.elastic --devices 8 --from-shape 4,2 \
        --to-shape 2,2

starts ``--devices`` ranks of one process group (file rendezvous in a
temporary directory, each rank killed if the command outlasts
``RANK_TIMEOUT_S``), trains a reduced smollm-360m (2 layers, d_model 128, 4/2
heads) for 3 steps with its parameters and AdamW state sharded over
mesh A (``--from-shape``, ("data", "model")), checkpoints the sharded
tree, restores it onto mesh B (``--to-shape``: fewer "data" ways, a lost
slice, on the first ranks), asserts the parameters bit-exact across the
reshard and trains 3 more steps with finite losses. It ends with
``[elastic] OK`` and an ``[elastic] losses`` line (the six losses, as
JSON). ``--device cpu`` runs gloo ranks; on ``cuda`` rank r takes card
r, with nccl, and the command needs a card for every rank: nccl refuses
two ranks on one card, and gloo's DTensor collectives on CUDA tensors of
ranks sharing a card crash (an H100 with torch 2.11), so more ranks than
cards exit non-zero at once, naming the counts.

The ``--stencil`` mode kills a checkpointed stencil run on mesh A and
resumes it on mesh B with another ordering, T and S (DESIGN.md §10)::

    python -m repro_torch.launch.elastic --stencil --from-mesh 2,2,2 \
        --to-mesh 1,1,1 --local-M 128

Both of its meshes are local (every shard held by this process on one
device): the run on mesh A (Hilbert, T=8, S=2) dies at ``--kill-at``
before that step's checkpoint, the run on mesh B (Morton, T=4, S=1)
resumes from the newest checkpoint, and its final state must equal, bit
for bit, an uninterrupted resident run over the same global box. It ends
with ``[elastic] OK`` and a ``[elastic] launches`` line (the kernel
launches of the whole command, as JSON). Its checkpoints go to
``--ckpt-dir``, which is emptied first.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the training mode's process group")
    ap.add_argument("--from-shape", default="4,2")
    ap.add_argument("--to-shape", default="2,2")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stencil", action="store_true",
                    help="elastic-reshard a checkpointed stencil run instead "
                         "of the training loop")
    ap.add_argument("--from-mesh", default="2,2,2")
    ap.add_argument("--to-mesh", default="1,1,1")
    ap.add_argument("--local-M", type=int, default=8,
                    help="per-shard cube edge on the FROM mesh")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--interval", type=int, default=4)
    ap.add_argument("--kill-at", type=int, default=6)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints (emptied first); default: the stencil "
                         "mode's /tmp/repro_elastic_stencil, a temporary "
                         "directory for the training mode")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    return ap


ELASTIC_CFG = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   head_dim=32, d_ff=256, vocab=512, activation_dtype="float32")
ELASTIC_PIPE = dict(batch=8, seq=32)
ELASTIC_OPT = dict(warmup_steps=2, total_steps=10)
ELASTIC_STEPS = 3
RANK_TIMEOUT_S = 600


def elastic_config():
    """The reference's reduced smollm-360m (f32 activations)."""
    import dataclasses

    from repro_torch.configs import smollm_360m

    return dataclasses.replace(smollm_360m.CONFIG, **ELASTIC_CFG)


def mesh_of(shape, device_type: str):
    """A ("data", "model") ``DeviceMesh`` over the first prod(shape) ranks
    of the default group (every rank of the group calls this)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=("data", "model"))


def param_specs(mesh, model) -> dict:
    """``model.specs()`` sanitised for ``mesh``."""
    from repro_torch.launch.dryrun import sanitize_specs

    return sanitize_specs(mesh, model.specs(), model.defs())


def shardings(mesh, model) -> dict:
    """Each parameter's (mesh, placements) (the reference's
    ``_shardings``)."""
    from repro_torch.models.params import placements, tree_map

    return tree_map(lambda s: (mesh, placements(s, mesh)), param_specs(mesh, model))


def reshard_run(model, from_shape, to_shape, ckpt_dir: str, log=print) -> dict:
    """The training mode on this rank: 3 steps of ``model`` (its full
    initial weights, the same on every rank) sharded over mesh A, a
    checkpoint of the sharded tree, a restore onto mesh B, 3 more steps.
    Returns ``{"losses": [...], "bit_exact": bool}`` on the ranks of mesh
    B (the first rank logs); the other ranks return after the checkpoint
    with ``losses`` of mesh A only."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.data import TokenPipeline
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state

    cfg, dev = model.cfg, model.device
    pipe = TokenPipeline(vocab=cfg.vocab, **ELASTIC_PIPE)
    step = make_train_step(model, TrainConfig(opt=OptConfig(**ELASTIC_OPT)))

    def batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(i).items()}

    # --- phase 1: train on mesh A, checkpoint the sharded tree
    mesh_a = mesh_of(from_shape, dev.type)
    first = not any(mesh_a.get_coordinate())
    model.shard(mesh_a, param_specs(mesh_a, model))
    params = model.params()
    opt = init_opt_state(params)
    losses = []
    for i in range(ELASTIC_STEPS):
        params, opt, m = step(params, opt, batch(i))
        losses.append(float(m["loss"]))
        if first:
            log(f"[elastic] mesh {list(from_shape)} step {i} loss {losses[-1]:.4f}")
    ckpt.save(ckpt_dir, ELASTIC_STEPS, {"params": params, "opt_state": opt},
              meta={"step": ELASTIC_STEPS})
    before = [p.full_tensor() for p in leaves(params)]

    # --- phase 2: restore onto mesh B (a lost slice), continue
    mesh_b = mesh_of(to_shape, dev.type)
    if mesh_b.get_coordinate() is None:
        return {"losses": losses, "bit_exact": None}
    sh_b = shardings(mesh_b, model)
    tree, meta = ckpt.restore(ckpt_dir, device=dev, shardings={
        "params": sh_b, "opt_state": {"m": sh_b, "v": sh_b}})
    params_b = tree_map(lambda t: t.requires_grad_(), tree["params"])
    opt_b = tree["opt_state"]
    exact = all(torch.equal(a, b.full_tensor())
                for a, b in zip(before, leaves(params_b)))
    if not exact:
        raise SystemExit(f"[elastic] reshard {list(from_shape)} -> "
                         f"{list(to_shape)}: params differ")
    first = not any(mesh_b.get_coordinate())
    if first:
        log(f"[elastic] reshard {list(from_shape)} -> {list(to_shape)}: "
            f"params bit-exact")
    for i in range(meta["step"], meta["step"] + ELASTIC_STEPS):
        params_b, opt_b, m = step(params_b, opt_b, batch(i))
        losses.append(float(m["loss"]))
        if first:
            log(f"[elastic] mesh {list(to_shape)} step {i} loss {losses[-1]:.4f}")
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"[elastic] step {i}: loss {losses[-1]}")
    return {"losses": losses, "bit_exact": exact}


def _rank_device(a, rank: int):
    """(device, backend) of ``rank``: gloo on the CPU; nccl on card
    ``rank``, which must exist (one card a rank)."""
    import torch

    from repro_torch.core.device import resolve_device

    dev = resolve_device(a.device)
    if dev.type == "cpu":
        return dev, "gloo"
    n_cards = torch.cuda.device_count()
    if a.devices > n_cards:
        raise SystemExit(
            f"[elastic] --devices {a.devices} on cuda needs {a.devices} cards, "
            f"{n_cards} found: nccl refuses two ranks on one card and gloo's "
            f"DTensor collectives crash on CUDA tensors of ranks sharing one; "
            f"use --device cpu or a machine with {a.devices} cards")
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    return dev, "nccl"


def rank_main(a) -> None:
    """One rank of the training mode."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.models import Model

    dev, backend = _rank_device(a, a.rank)
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{a.init_file}",
                            world_size=a.devices, rank=a.rank,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        from_shape, to_shape = _shapes(a)
        model = Model(elastic_config(), device=dev).init(
            torch.Generator(device=dev).manual_seed(0)).requires_grad_()
        _build.reset_launches()
        out = reshard_run(model, from_shape, to_shape, a.ckpt_dir,
                          log=lambda m: print(m, flush=True))
        dist.barrier()
        if a.rank == 0:
            print(f"[elastic] losses {json.dumps(out['losses'])}")
            print(f"[elastic] backend {backend}, {a.devices} ranks on {dev.type}")
            print("[elastic] OK")
            print(f"[elastic] launches {json.dumps(_build.LAUNCHES)}", flush=True)
    finally:
        dist.destroy_process_group()


def _shapes(a) -> tuple[list, list]:
    """(--from-shape, --to-shape) as lists; mesh A must cover the
    ``--devices`` ranks and mesh B fit in them."""
    from_shape = [int(x) for x in a.from_shape.split(",")]
    to_shape = [int(x) for x in a.to_shape.split(",")]
    if math.prod(from_shape) != a.devices or math.prod(to_shape) > a.devices:
        raise SystemExit(f"--from-shape {a.from_shape} must cover the "
                         f"{a.devices} ranks and --to-shape {a.to_shape} "
                         f"fit in them")
    return from_shape, to_shape


def main(a) -> None:
    """The training mode: start ``--devices`` ranks of this module, wait
    for them (killing any left after ``RANK_TIMEOUT_S``), fail if any
    failed."""
    _shapes(a)
    _rank_device(a, 0)
    work = tempfile.mkdtemp(prefix="repro_elastic_")
    ckpt_dir = a.ckpt_dir or os.path.join(work, "ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    init_file = os.path.join(work, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "repro_torch.launch.elastic",
            "--devices", str(a.devices), "--from-shape", a.from_shape,
            "--to-shape", a.to_shape, "--device", a.device,
            "--ckpt-dir", ckpt_dir, "--init-file", init_file]
    procs = [subprocess.Popen(argv + ["--rank", str(r)], env=env)
             for r in range(a.devices)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    if any(c != 0 for c in codes):
        raise SystemExit(f"[elastic] ranks exited {codes}")


def stencil_main(a) -> None:
    """Kill a checkpointed run on mesh A, resume it on mesh B with another
    ordering/T/S, and assert the final state is bit-identical to an
    uninterrupted resident run."""
    import numpy as np
    import torch

    from repro_torch.core.device import resolve_device
    from repro_torch.core.orderings import HILBERT, MORTON
    from repro_torch.kernels import _build
    from repro_torch.launch.faults import (FaultPlan, SimulatedCrash,
                                           initial_state)
    from repro_torch.stencil import (CheckpointedRun, DistributedPipeline,
                                     ResidentPipeline, make_stencil_mesh)

    dev = resolve_device(a.device)
    a.ckpt_dir = a.ckpt_dir or "/tmp/repro_elastic_stencil"
    shutil.rmtree(a.ckpt_dir, ignore_errors=True)
    procs_a = tuple(int(x) for x in a.from_mesh.split(","))
    procs_b = tuple(int(x) for x in a.to_mesh.split(","))
    gshape = tuple(p * a.local_M for p in procs_a)
    locals_b = {g // p for g, p in zip(gshape, procs_b)}
    if len(locals_b) != 1:
        raise SystemExit(f"to-mesh {procs_b} gives non-cubic locals over "
                         f"global {gshape}")
    local_b = locals_b.pop()
    state0 = initial_state("gol", gshape, seed=0)
    _build.reset_launches()

    # --- phase 1: run on mesh A, die at --kill-at (before its checkpoint)
    pipe_a = DistributedPipeline(mesh=make_stencil_mesh(procs_a, device=dev),
                                 spec=HILBERT, M=a.local_M, T=8, S=2)
    run_a = CheckpointedRun(pipe_a, a.ckpt_dir, interval=a.interval,
                            hooks=FaultPlan(kill_at_step=a.kill_at,
                                            kill_mode="raise").hooks())
    try:
        run_a.run(state0, a.steps)
        raise SystemExit("injected kill did not fire")
    except SimulatedCrash:
        print(f"[elastic] mesh {procs_a} killed at step {a.kill_at}")

    # --- phase 2: resume on mesh B (lost slice), new ordering/T/S
    pipe_b = DistributedPipeline(mesh=make_stencil_mesh(procs_b, device=dev),
                                 spec=MORTON, M=local_b, T=4, S=1)
    out = CheckpointedRun(pipe_b, a.ckpt_dir,
                          interval=a.interval).run(state0, a.steps)
    print(f"[elastic] resumed on mesh {procs_b} to step {a.steps}")

    # --- reference: uninterrupted resident run over the same global box
    if len(set(gshape)) == 1:
        ref_pipe = ResidentPipeline(M=gshape[0], T=8, S=1, kind="hilbert",
                                    device=dev)
        ref = ref_pipe.run(torch.from_numpy(state0).to(dev), a.steps)
        np.testing.assert_array_equal(out, ref.cpu().numpy())
        print(f"[elastic] reshard {procs_a} -> {procs_b}: "
              f"state bit-exact vs uninterrupted run")
    print("[elastic] OK")
    print(f"[elastic] launches {json.dumps(_build.LAUNCHES)}", flush=True)


if __name__ == "__main__":
    args = build_parser().parse_args()
    if args.stencil:
        stencil_main(args)
    elif args.rank is not None:
        rank_main(args)
    else:
        main(args)
