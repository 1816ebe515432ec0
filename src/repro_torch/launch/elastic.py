"""Elastic re-scaling of a checkpointed stencil run: kill it on mesh A,
resume it on mesh B with another ordering, T and S (DESIGN.md §10), on
the card unless ``--device cpu``::

    python -m repro_torch.launch.elastic --stencil --from-mesh 2,2,2 \\
        --to-mesh 1,1,1 --local-M 128

The torch counterpart of ``repro.launch.elastic``'s ``--stencil`` mode.
Both meshes are local (every shard held by this process on one device):
the run on mesh A (Hilbert, T=8, S=2) dies at ``--kill-at`` before that
step's checkpoint, the run on mesh B (Morton, T=4, S=1) resumes from the
newest checkpoint, and its final state must equal, bit for bit, an
uninterrupted resident run over the same global box. It ends with
``[elastic] OK`` and a ``[elastic] launches`` line (the kernel launches
of the whole command, as JSON). Checkpoints go to ``--ckpt-dir``, which
is emptied first. The training mode of the reference (reshard a
language model's parameters) is not ported and raises.
"""

from __future__ import annotations

import argparse
import json
import shutil


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stencil", action="store_true",
                    help="elastic-reshard a checkpointed stencil run (the "
                         "training mode is not ported: without --stencil "
                         "this raises)")
    ap.add_argument("--from-mesh", default="2,2,2")
    ap.add_argument("--to-mesh", default="1,1,1")
    ap.add_argument("--local-M", type=int, default=8,
                    help="per-shard cube edge on the FROM mesh")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--interval", type=int, default=4)
    ap.add_argument("--kill-at", type=int, default=6)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_elastic_stencil")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    return ap


def main(a) -> None:
    """Training-mode elastic reshard: not ported (ROADMAP.md queue 1,
    item 12.10: it reshards over a device mesh with partition specs)."""
    raise SystemExit("repro_torch.launch.elastic: the training mode "
                     "(resharding a language model's parameters over a "
                     "device mesh) is not ported yet (ROADMAP.md queue 1, "
                     "item 12.10); run --stencil")


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
    else:
        main(args)
