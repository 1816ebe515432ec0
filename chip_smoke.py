#!/usr/bin/env python3
"""Drive the torch port on one CUDA card and check it against its plain
versions.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``:

1. set-up: TF32 off, the card's name and power limit, the kernels built
   from ``src/repro_torch/kernels/csrc`` with nvcc (build seconds and the
   compiler's register/spill report);
2. every kernel against its plain PyTorch version on the card, at M=64:
   4 orderings × S ∈ {1, 2, 4} × {gol, jacobi, wave} × {periodic,
   dirichlet, neumann0, mixed}, plus g=2 with T=8, S=2, and the resident
   and repack tap sums against each other and their plain versions —
   every comparison bit-exact (tolerance 0);
3. the main paths at full size (``repro_torch.configs.gol3d.CHIP_*``),
   each with the launch counts set to 0 just before and read just after:
   ``Gol3d.run_resident(16)`` at M=256, T=8, S=4 for the four orderings
   (must equal ``reference_run(16)``; 4 fused launches each); the wave
   pipeline at M=256, S=2, neumann0 (8 steps of ``fields_step_ref``); the
   repack path ``Gol3d.run(2)`` at M=128; the resident tap sum
   ``stencil_sum_resident`` on the M=256 store;
4. timings with CUDA events (median of repeats after a warm-up): each
   kernel at its main-path shape beside its plain version, a single
   PyTorch call that computes the same function where there is one
   (conv3d, TF32 off; a yardstick the port never calls) and the least
   time the card could take for the function's own work (bytes over
   3.35 TB/s or f32 operations over 67 TFLOP/s, whichever is larger; the
   halo sites the fused design recomputes are reported apart, as a model
   of the design's work); ms/timestep of the main path per ordering and
   per block curve.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then not 0 and no result line is printed. Without CUDA, or without the
repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/csrc/stencil3d.cu"
REPLACES = {"stencil_step_fused": "src/repro/kernels/stencil3d.py:296",
            "stencil_sum_resident": "src/repro/kernels/stencil3d.py:212",
            "stencil_sum_blocks": "src/repro/kernels/stencil3d.py:114"}
BCS = ("periodic", "dirichlet", "neumann0", "mixed")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.gol3d import (CHIP_MAIN, CHIP_MAIN_STEPS,
                                           CHIP_ORDERINGS, CHIP_REPACK,
                                           CHIP_REPACK_STEPS)
    from repro_torch.core import (blockize, blockize_fields, blockize_with_halo,
                                  boundary_face_table_device, dirichlet, mixed,
                                  neighbor_table_device, axes_periodic)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import stencil3d as K
    from repro_torch.kernels.ops import uniform_weights
    from repro_torch.stencil.gol3d import Gol3d
    from repro_torch.stencil.pipeline import (ResidentPipeline,
                                              fused_items_per_launch,
                                              resident_bytes_per_step)

    KINDS = tuple(spec.name for spec in CHIP_ORDERINGS)
    M_MAIN, T_MAIN, G_MAIN = CHIP_MAIN.M, CHIP_MAIN.block_T, CHIP_MAIN.g
    S_MAIN, K_MAIN = CHIP_MAIN.substeps, CHIP_MAIN_STEPS
    TAPS = (2 * G_MAIN + 1) ** 3
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    rng = np.random.default_rng(0)

    def bc_of(name):
        return {"periodic": "periodic", "dirichlet": dirichlet(0.5),
                "neumann0": "neumann0", "mixed": mixed(k="neumann0")}[name]

    def cube_for(rule, M, C=1):
        if rule == "gol":
            a = (rng.random((C, M, M, M)) < 0.3).astype(np.float32)
        else:
            a = rng.normal(size=(C, M, M, M)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def cuda_ms(fn, reps=5, inner=10):
        """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls."""
        fn()
        sync()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                fn()
            e1.record()
            sync()
            times.append(e0.elapsed_time(e1) / inner)
        return statistics.median(times)

    def bound(nbytes, flops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")

    # ---------------------------------------------------------------- set-up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(_build.SOURCES)}; flags {' '.join(_build.NVCC_FLAGS)})")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    # ------------------------------------------- kernels vs plain, on the card
    t0 = time.perf_counter()
    M, n_cmp = 64, 0
    cases = [(k, S, r, b, 8, 1) for k in KINDS for S in (1, 2, 4)
             for r in ("gol", "jacobi", "wave") for b in BCS]
    cases += [("hilbert", 2, r, b, 8, 2) for r in ("gol", "jacobi", "wave")
              for b in BCS]
    for kind, S, rule, bcn, T, g in cases:
        C = 2 if rule == "wave" else 1
        cube = cube_for(rule, M, C)
        store = blockize_fields(cube, T, kind) if C == 2 else blockize(cube[0], T, kind)
        bc = bc_of(bcn)
        nbr = neighbor_table_device(kind, M // T, periodic=axes_periodic(bc), device=dev)
        bnd = boundary_face_table_device(kind, M // T, dev)
        w = uniform_weights(g, dev)
        got = K.stencil_step_fused(store, w, nbr, bnd, g=g, S=S, rule=rule, bc=bc)
        want = ref.stencil_fused_ref(store, w, nbr, S=S, rule=rule, bc=bc, bnd=bnd)
        check(torch.equal(got, want),
              f"fused {kind} S={S} {rule} {bcn} T={T} g={g}: max |d| "
              f"{(got - want).abs().max().item()}")
        n_cmp += 1
    for kind in KINDS:
        for T, g in ((8, 1), (8, 2), (4, 1), (16, 4)):
            cube = cube_for("jacobi", M)[0]
            w = uniform_weights(g, dev)
            store = blockize(cube, T, kind)
            nbr = neighbor_table_device(kind, M // T, device=dev)
            res = K.stencil_sum_resident(store, w, nbr, g=g)
            halo = blockize_with_halo(cube, T, g, kind)
            rep = K.stencil_sum_blocks(halo, w, g=g)
            check(torch.equal(res, rep), f"resident != blocks {kind} T={T} g={g}")
            check(torch.equal(res, ref.stencil_sum_resident_ref(store, w, nbr)),
                  f"resident != plain {kind} T={T} g={g}")
            check(torch.equal(rep, ref.stencil_sum_ref(halo, w)),
                  f"blocks != plain {kind} T={T} g={g}")
            n_cmp += 3
    sync()
    log(f"kernels vs plain at M={M}: {n_cmp} comparisons bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")

    # ----------------------------------------- main paths, launches counted
    main_launches = {name: 0 for name in K.LAUNCHES}

    def counted(fn):
        K.reset_launches()
        out = fn()
        sync()
        counts = dict(K.LAUNCHES)
        for name, n in counts.items():
            main_launches[name] += n
        return out, counts

    t0 = time.perf_counter()
    apps = {}
    for spec in CHIP_ORDERINGS:
        kind = spec.name
        app = Gol3d(dataclasses.replace(CHIP_MAIN, ordering=spec))
        want = app.reference_run(K_MAIN)
        _, counts = counted(lambda: app.run_resident(K_MAIN))
        got = app.cube
        check(counts["stencil_step_fused"] == -(-K_MAIN // S_MAIN),
              f"{kind}: {counts} fused launches for K={K_MAIN}, S={S_MAIN}")
        check(got.shape == (M_MAIN,) * 3 and bool(torch.isfinite(got).all()),
              f"{kind}: result not finite or misshapen")
        check(torch.equal(got, want), f"{kind}: run_resident != reference_run")
        apps[kind] = app
        log(f"main gol3d {kind}: M={M_MAIN} T={T_MAIN} S={S_MAIN} K={K_MAIN} "
            f"launches {counts['stencil_step_fused']}, equal to reference_run, "
            f"live cells {int(got.sum().item())}")

    fields = torch.from_numpy(
        np.random.default_rng(2).normal(size=(2,) + (M_MAIN,) * 3)
        .astype(np.float32)).to(dev)
    wave = ResidentPipeline(M=M_MAIN, T=T_MAIN, g=G_MAIN, kind="hilbert", S=2,
                            rule="wave", bc="neumann0", device=dev)
    got, counts = counted(lambda: wave.run(fields, 8))
    want = fields
    for _ in range(8):
        want = ref.fields_step_ref(want, uniform_weights(G_MAIN, dev), G_MAIN,
                                   rule="wave", bc="neumann0")
    check(counts["stencil_step_fused"] == 4, f"wave launches {counts}")
    check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
          "wave pipeline != 8 steps of fields_step_ref")
    log(f"main wave: M={M_MAIN} C=2 S=2 neumann0 K=8 launches "
        f"{counts['stencil_step_fused']}, equal to fields_step_ref")

    rep_app = Gol3d(CHIP_REPACK)
    want = rep_app.reference_run(CHIP_REPACK_STEPS)
    _, counts = counted(lambda: rep_app.run(CHIP_REPACK_STEPS))
    check(counts["stencil_sum_blocks"] == CHIP_REPACK_STEPS,
          f"repack launches {counts}")
    check(torch.equal(rep_app.cube, want), "repack run != reference_run")
    log(f"main repack: M={CHIP_REPACK.M} {rep_app.block_kind} "
        f"K={CHIP_REPACK_STEPS} launches {counts['stencil_sum_blocks']}, "
        f"equal to reference_run")

    cube = apps["hilbert"].cube.contiguous()
    w1 = uniform_weights(G_MAIN, dev)
    store = blockize(cube, T_MAIN, "hilbert")
    nbr_h = neighbor_table_device("hilbert", M_MAIN // T_MAIN, device=dev)
    acc, counts = counted(lambda: K.stencil_sum_resident(store, w1, nbr_h,
                                                         g=G_MAIN))
    check(counts["stencil_sum_resident"] == 1, f"resident launches {counts}")
    check(torch.equal(acc, ref.stencil_sum_resident_ref(store, w1, nbr_h)),
          "resident sum != plain at M=256")
    halo_main = blockize_with_halo(cube, T_MAIN, G_MAIN, "hilbert")
    check(torch.equal(acc, K.stencil_sum_blocks(halo_main, w1, g=G_MAIN)),
          "resident sum != repack sum at M=256")
    sync()
    for name, n in main_launches.items():
        check(n > 0, f"{name} was not launched on its main path")
    log(f"main paths: launches {main_launches} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---------------------------------------------------------------- timings
    t0 = time.perf_counter()
    kernels = []
    nb = (M_MAIN // T_MAIN) ** 3
    T3 = T_MAIN ** 3

    # stencil_step_fused at the main path's shape: gol, hilbert store
    out = torch.empty_like(store)
    fused = lambda: K.stencil_step_fused(store, w1, nbr_h, g=G_MAIN, S=S_MAIN,
                                         out=out)
    plain = lambda: ref.stencil_fused_ref(store, w1, nbr_h, S=S_MAIN)
    err = (fused() - plain()).abs().max().item()
    # The function's own work: S timesteps of a (multiply, add) per tap on
    # every site; one read and one write of the store, and its two tables
    # (27 neighbour ids, 6 face flags per block) and the weights read once.
    ops = S_MAIN * nb * T3 * 2 * TAPS
    b_ms, b_by = bound(4 * (2 * nb * T3 + nb * 27 + nb * 6 + TAPS), ops)
    # The design's own work, a separate model: each substep also recomputes
    # the halo sites that the shrinking window still needs.
    design_ops = sum(nb * (T_MAIN + 2 * G_MAIN * (S_MAIN - 1 - u)) ** 3 * 2 * TAPS
                     for u in range(S_MAIN))
    log(f"fused work per launch: {ops / 1e9:.3f} GFLOP for the function, "
        f"{design_ops / 1e9:.3f} GFLOP for the design with its recomputed halo "
        f"sites ({design_ops / ops:.2f}x; "
        f"{1e3 * design_ops / F32_FLOP_PER_S:.4f} ms at 67 TFLOP/s)")
    kernels.append(dict(name="stencil_step_fused", ms=cuda_ms(fused),
                        plain_ms=cuda_ms(plain, reps=3, inner=1),
                        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))

    # stencil_sum_resident at the main path's shape
    res = lambda: K.stencil_sum_resident(store, w1, nbr_h, g=G_MAIN, out=out)
    plain = lambda: ref.stencil_sum_resident_ref(store, w1, nbr_h)
    err = (res() - plain()).abs().max().item()
    halo5, w5 = halo_main[:, None], w1[None, None]
    b_ms, b_by = bound(4 * (2 * nb * T3 + nb * 27 + TAPS), nb * T3 * 2 * TAPS)
    kernels.append(dict(name="stencil_sum_resident", ms=cuda_ms(res),
                        plain_ms=cuda_ms(plain, reps=3, inner=1),
                        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                        library_ms=cuda_ms(lambda: F.conv3d(halo5, w5))))

    # stencil_sum_blocks at the repack path's shape
    T_R, G_R = CHIP_REPACK.block_T, CHIP_REPACK.g
    halo_r = blockize_with_halo(rep_app.cube.contiguous(), T_R, G_R,
                                rep_app.block_kind)
    nb_r = halo_r.shape[0]
    w_r = uniform_weights(G_R, dev)
    out_r = torch.empty((nb_r, T_R, T_R, T_R), device=dev)
    blk = lambda: K.stencil_sum_blocks(halo_r, w_r, g=G_R, out=out_r)
    plain = lambda: ref.stencil_sum_ref(halo_r, w_r)
    err = (blk() - plain()).abs().max().item()
    taps_r = (2 * G_R + 1) ** 3
    b_ms, b_by = bound(4 * (nb_r * (T_R + 2 * G_R) ** 3 + nb_r * T_R ** 3 + taps_r),
                       nb_r * T_R ** 3 * 2 * taps_r)
    halo_r5 = halo_r[:, None]
    kernels.append(dict(name="stencil_sum_blocks", ms=cuda_ms(blk),
                        plain_ms=cuda_ms(plain, reps=3, inner=3),
                        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                        library_ms=cuda_ms(lambda: F.conv3d(halo_r5,
                                                            w_r[None, None]))))
    for k in kernels:
        check(k["max_abs_err"] == 0.0, f"{k['name']} differs from plain: {k}")
        k.update(route="cuda", source=SOURCE, replaces=REPLACES[k["name"]],
                 launches=main_launches[k["name"]])
        log(f"kernel {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by {k['bound_by']})")

    # the main path per ordering: end to end (host clock) and kernels only
    item_bytes = 4 * fused_items_per_launch(M_MAIN, T_MAIN, G_MAIN, S_MAIN)
    model = resident_bytes_per_step(M_MAIN, T_MAIN, G_MAIN, K_MAIN, S=S_MAIN)
    log(f"model: {item_bytes / 1e6:.1f} MB streamed per fused launch "
        f"({1e3 * item_bytes / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s), "
        f"compulsory {8 * M_MAIN ** 3 / 1e6:.1f} MB per launch, "
        f"{model / 1e6:.1f} MB modelled per timestep at K={K_MAIN}")
    for kind, app in apps.items():
        app.run_resident(K_MAIN)
        sync()
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            app.run_resident(K_MAIN)
            sync()
            walls.append(time.perf_counter() - t1)
        pipe = app.resident_pipeline()
        st = pipe.to_blocks(app.cube)
        run = pipe.run_fn(K_MAIN)
        k_ms = cuda_ms(lambda: run(st), reps=5, inner=1) / K_MAIN
        log(f"timestep {kind} (block curve {app.block_kind}): end to end "
            f"{1e3 * statistics.median(walls) / K_MAIN:.4f} ms, fused kernels "
            f"{k_ms:.4f} ms")
    for kind in KINDS:  # the block curve itself, same state
        pipe = ResidentPipeline(M=M_MAIN, T=T_MAIN, g=G_MAIN, kind=kind,
                                S=S_MAIN, device=dev)
        st = pipe.to_blocks(cube)
        run = pipe.run_fn(K_MAIN)
        k_ms = cuda_ms(lambda: run(st), reps=5, inner=1) / K_MAIN
        log(f"block curve {kind}: fused kernels {k_ms:.4f} ms/timestep")
    for T_, S_ in ((8, 1), (8, 2), (8, 4), (16, 1), (16, 2), (16, 4)):
        pipe = ResidentPipeline(M=M_MAIN, T=T_, g=G_MAIN, kind="hilbert", S=S_,
                                device=dev)
        st = pipe.to_blocks(cube)
        run = pipe.run_fn(K_MAIN)
        k_ms = cuda_ms(lambda: run(st), reps=5, inner=1) / K_MAIN
        log(f"T={T_} S={S_}: fused kernels {k_ms:.4f} ms/timestep, modelled "
            f"{pipe.bytes_per_step(K_MAIN) / 1e6:.1f} MB/timestep, "
            f"shared memory {pipe.smem_bytes()} B per thread block")
    plan = ResidentPipeline.plan(M_MAIN, g=G_MAIN, kind="hilbert", n_steps=K_MAIN,
                                 device=dev)
    log(f"plan() picks T={plan.T} S={plan.S}")
    st = wave.to_blocks(fields)
    run = wave.run_fn(8)
    log(f"wave C=2 S=2 neumann0: fused kernels "
        f"{cuda_ms(lambda: run(st), reps=5, inner=1) / 8:.4f} ms/timestep")
    sync()
    log(f"timings ({time.perf_counter() - t0:.1f} s)")

    # where the time of one main-path run goes, by kernel (profiler on)
    from torch.profiler import ProfilerActivity, profile

    app = apps["hilbert"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        app.run_resident(K_MAIN)
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    by_name = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}
    if by_name:
        busy = sum(by_name.values())
        log(f"profile run_resident({K_MAIN}) hilbert, profiler on: wall "
            f"{wall_ms:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall_ms:.1f}%)")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  {ms:.4f} ms  {name[:100]}")
    else:
        log("profile: the profiler recorded no device time (not measured)")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
