"""Distributed gol3d on the torch port: 2×2×2 mesh, SFC halo packing, ring shifts.

The twin of ``examples/stencil_halo_demo.py`` on ``repro_torch``, on the
card unless ``--device cpu``.

Part 1: the resident-block pipeline — blockize once, run K steps
entirely in curve order with in-kernel halo streaming and S-deep
temporal blocking (stencil/pipeline.py; S substeps per device-memory
round-trip, DESIGN.md §4), verify bit-identity against the per-step
repack pipeline (``Gol3d.step_fn``), and print the modelled per-substep
bytes of repack / unfused / fused forms plus the (T, S) the plan()
autotuner picks under the fused kernel's shared memory.

Part 2: a local 2×2×2 mesh (all eight shards in this process, on one
device: ``make_stencil_mesh((2, 2, 2), device=...)``), a 32³ cube
decomposed onto it, 10 steps under each ordering two ways: the per-step
exchange (make_distributed_step) verified against the single-device
oracle, and the communication-avoiding DistributedPipeline (one deep
S·g exchange per S fused substeps, DESIGN.md §7) verified bit-identical
to the per-step form. The same matrix repeats under clamped neumann0
boundaries (DESIGN.md §8), and the modelled exchange savings table
prints for both boundary contracts.

Part 3: the multi-field store (DESIGN.md §9) — the C=2 FDTD-style wave
rule rides the same fused resident pipeline at S ∈ {2, 4}, bit-identical
to its sequential global oracle (kernels/ref.fields_step_ref), and the
×C bytes-model table prints.

On the card the fused steps launch ``stencil_step_fused``, the repack
steps ``stencil_sum_blocks`` and the exchange packs ``gather_rows``.

Run: PYTHONPATH=src python examples/stencil_halo_demo_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (HILBERT, MORTON, NEUMANN0, PERIODIC, ROW_MAJOR,
                              apply_ordering)
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ops import uniform_weights
from repro_torch.stencil import (DistributedPipeline, Gol3d, Gol3dConfig,
                                 ResidentPipeline, distributed_bytes_per_step,
                                 exchange_bytes_per_step, make_distributed_step,
                                 make_stencil_mesh, repack_bytes_per_step,
                                 resident_bytes_per_step,
                                 resident_unfused_bytes_per_step, shard_state,
                                 unshard_state)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resident_demo(dev, M=32, g=1, T=8, steps=10, S=4) -> dict:
    """Part 1. Returns the modelled bytes, the plan, and per ordering the
    ms/step of both forms and the final path-ordered state."""
    print(f"[stencil_halo_demo] resident pipeline, M={M} g={g} T={T} "
          f"K={steps} steps, temporal blocking S={S}")
    rep_b = repack_bytes_per_step(M, T, g)
    unf_b = resident_unfused_bytes_per_step(M, T, g, steps)
    fus_b = resident_bytes_per_step(M, T, g, steps, S=S)
    print(f"  modelled HBM bytes/substep: repack={rep_b / 1e6:.2f} MB  "
          f"resident(unfused)={unf_b / 1e6:.2f} MB  "
          f"fused S={S}={fus_b / 1e6:.2f} MB  "
          f"(x{rep_b / fus_b:.2f} vs repack, x{unf_b / fus_b:.2f} vs unfused)")
    auto = ResidentPipeline.plan(M, g=g, device=dev)
    print(f"  plan(M={M}, g={g}) -> T={auto.T} S={auto.S} "
          f"(smem {auto.smem_bytes() / 1024:.0f} KiB, "
          f"{auto.bytes_per_step(steps) / 1e6:.2f} MB/substep)")
    res = {"bytes": {"repack": rep_b, "unfused": unf_b, "fused": fus_b},
           "plan": (auto.T, auto.S, auto.smem_bytes(), auto.bytes_per_step(steps)),
           "ms": {}, "finals": {}}
    for spec in (MORTON, HILBERT):
        app = Gol3d(Gol3dConfig(M=M, g=g, ordering=spec, block_T=T,
                                substeps=S, device=str(dev)))
        # repack: one warm-up step, then K steps
        step = app.step_fn()
        step(app.state_path)
        _sync(dev)
        t0 = time.perf_counter()
        sa = app.state_path
        for _ in range(steps):
            sa = step(sa)
        _sync(dev)
        t_rep = time.perf_counter() - t0
        # fused resident: ceil(K/S) launches over the persistent store
        pipe = app.resident_pipeline()
        run = pipe.run_fn(steps)
        run(pipe.to_blocks(app.cube))
        _sync(dev)
        t0 = time.perf_counter()
        out = run(pipe.to_blocks(app.cube))
        _sync(dev)
        t_res = time.perf_counter() - t0
        sb = apply_ordering(pipe.to_cube(out), spec)
        ok = torch.equal(sa, sb)
        print(f"  {spec.name:10s} repack {t_rep * 1e3 / steps:6.1f} ms/step  "
              f"fused S={pipe.S} {t_res * 1e3 / steps:6.1f} ms/step  "
              f"bit-identical: {ok}")
        if not ok:
            raise RuntimeError(f"{spec.name}: fused resident run differs from "
                               "the repack steps")
        res["ms"][spec.name] = (t_rep * 1e3 / steps, t_res * 1e3 / steps)
        res["finals"][spec.name] = sb
    print("resident pipeline OK")
    return res


def wave_demo(dev, M=32, g=1, T=8, steps=8) -> dict:
    """Part 3: the C=2 wave workload on the multi-field block store.
    Returns ms/step and the final fields per S, and the ×C byte table."""
    C = 2
    print(f"[stencil_halo_demo] multi-field wave (C={C}), M={M} g={g} T={T} "
          f"K={steps} steps")
    rng = np.random.default_rng(0)
    fields = torch.from_numpy(rng.normal(size=(C, M, M, M)).astype(np.float32)).to(dev)
    w = uniform_weights(g, dev)
    want = fields
    for _ in range(steps):
        want = kref.fields_step_ref(want, w, g, rule="wave")
    res = {"ms": {}, "finals": {}, "table": {}}
    for S in (2, 4):
        pipe = ResidentPipeline(M=M, T=T, g=g, kind="hilbert", S=S,
                                rule="wave", device=dev)
        run = pipe.run_fn(steps)
        run(pipe.to_blocks(fields))  # warm
        store = pipe.to_blocks(fields)
        _sync(dev)
        t0 = time.perf_counter()
        out = run(store)
        _sync(dev)
        dt = time.perf_counter() - t0
        got = pipe.to_cube(out)
        ok = torch.equal(got, want)
        print(f"  wave fused S={S}: {dt * 1e3 / steps:6.1f} ms/step  "
              f"bit-identical to sequential oracle: {ok}")
        if not ok:
            raise RuntimeError(f"wave S={S} differs from fields_step_ref")
        res["ms"][S] = dt * 1e3 / steps
        res["finals"][S] = got
    # the xC bytes model next to the single-field numbers
    print(f"  modelled bytes/substep (M={M}, T={T}, g={g}): "
          "single-field vs C=2")
    print("    S   HBM C=1     HBM C=2     ICI C=1     ICI C=2    ratio")
    for S in (1, 2, 4):
        h1 = resident_bytes_per_step(M, T, g, steps, S=S)
        h2 = resident_bytes_per_step(M, T, g, steps, S=S, fields=C)
        i1 = exchange_bytes_per_step(M, g, S)
        i2 = exchange_bytes_per_step(M, g, S, fields=C)
        d2 = distributed_bytes_per_step(M, T, g, steps, S=S, fields=C)
        res["table"][S] = (h1, h2, i1, i2, d2)
        print(f"    {S}  {h1 / 1e6:7.2f} MB {h2 / 1e6:8.2f} MB "
              f"{i1 / 1e3:8.1f} KB {i2 / 1e3:8.1f} KB   x{h2 / h1:.2f} "
              f"(dist C=2 {d2 / 1e6:.2f} MB)")
    print("multi-field wave OK")
    return res


def distributed_demo(dev, steps=10) -> dict:
    """Part 2, on a local 2×2×2 mesh: every shard in this process on
    ``dev``. Returns ms/step per boundary and ordering, and the modelled
    exchange tables."""
    procs = (2, 2, 2)
    mesh = make_stencil_mesh(procs, device=dev)
    local_M, g, GM = 16, 1, 32
    rng = np.random.default_rng(0)
    gcube = torch.from_numpy(
        (rng.random((GM, GM, GM)) < 0.35).astype(np.float32)).to(dev)
    res = {"ms": {}, "ici": {}}
    for bc in (PERIODIC, NEUMANN0):
        print(f"  --- boundaries: {bc.kind} ---")
        want = gcube
        for _ in range(steps):
            want = kref.gol3d_step_ref(want, g, bc=bc)
        for spec in (ROW_MAJOR, MORTON, HILBERT):
            full = shard_state(gcube, spec, procs)
            st = [full[co] for co in mesh.shards]
            # per-step reference: one exchange per step (S=1)
            step = make_distributed_step(mesh, spec, local_M, g, bc=bc)
            step(st)  # warm
            _sync(dev)
            t0 = time.perf_counter()
            gs = st
            for _ in range(steps):
                gs = step(gs)
            _sync(dev)
            dt_seq = (time.perf_counter() - t0) / steps
            got = unshard_state(torch.stack(gs).view(procs + (-1,)), spec, GM)
            ok = torch.equal(got, want)
            line = f"  {spec.name:10s} per-step {dt_seq*1e3:6.1f} ms/step (oracle: {ok})"
            if not ok:
                raise RuntimeError(f"{bc.kind} {spec.name}: per-step exchange "
                                   "differs from the global oracle")
            times = {1: dt_seq * 1e3}
            # communication-avoiding pipeline: one deep exchange per S substeps
            for S in (2, 4):
                pipe = DistributedPipeline(mesh=mesh, spec=spec, M=local_M, T=8,
                                           g=g, S=S, bc=bc)
                run = pipe.run_fn(steps)
                run(st)  # warm
                _sync(dev)
                t0 = time.perf_counter()
                out = run(st)
                _sync(dev)
                dt = (time.perf_counter() - t0) / steps
                okS = all(torch.equal(a, b) for a, b in zip(out, gs))
                line += f"  S={S} {dt*1e3:6.1f} ms/step (bit-identical: {okS})"
                if not okS:
                    raise RuntimeError(f"{bc.kind} {spec.name}: S={S} pipeline "
                                       "differs from the per-step form")
                times[S] = dt * 1e3
            res["ms"][(bc.kind, spec.name)] = times
            print(line)

    # modelled exchange bytes per mesh shard: deep exchange (S) x boundary
    # contract. Periodic torus shards send both faces on every axis;
    # clamped mesh-edge shards skip the wrap links (DESIGN.md §8) - on a
    # 2x2x2 mesh every shard is a corner, so the clamped column is exactly
    # half the torus volume.
    print(f"  modelled ICI bytes/step/shard (local M={local_M}, g={g}):")
    print("    S   periodic   clamped(mean)   edge-shard   clamped/periodic")
    for S in (1, 2, 4):
        per = exchange_bytes_per_step(local_M, g, S)
        mean = exchange_bytes_per_step(local_M, g, S, bc=NEUMANN0, procs=procs)
        edge = exchange_bytes_per_step(local_M, g, S, bc=NEUMANN0, procs=procs,
                                       coords=(0, 0, 0))
        res["ici"][S] = (per, mean, edge)
        print(f"    {S}   {per/1e3:7.1f} KB {mean/1e3:10.1f} KB "
              f"{edge/1e3:9.1f} KB   x{mean/per:.2f}")
    b1 = distributed_bytes_per_step(local_M, 8, g, steps, S=1)
    b4 = distributed_bytes_per_step(local_M, 8, g, steps, S=4)
    b4c = distributed_bytes_per_step(local_M, 8, g, steps, S=4, bc=NEUMANN0,
                                     procs=procs)
    res["dist"] = (b1, b4, b4c)
    print(f"  modelled bytes/step/shard (HBM+ICI): S=1 {b1/1e3:.0f} KB -> "
          f"S=4 {b4/1e3:.0f} KB (x{b1/b4:.2f}); clamped S=4 {b4c/1e3:.0f} KB")
    print("distributed gol3d OK (periodic + clamped)")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = {"resident": resident_demo(dev), "wave": wave_demo(dev)}
    print(f"[stencil_halo_demo] local 2x2x2 mesh, eight shards on {dev}...")
    res["distributed"] = distributed_demo(dev)
    return res


if __name__ == "__main__":
    main()
