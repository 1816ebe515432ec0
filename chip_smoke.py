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
   and repack tap sums against each other and their plain versions; the
   fused kernel on extended stores (core + shell blocks filled by the
   distributed path's own exchange and scatter, 2×2×2 local mesh of M=64
   shards) for S ∈ {1, 2, 4} × {gol, wave} × {periodic, neumann0, mixed};
   ``gather_rows`` on the six deep faces (h ∈ {1, 2, 4}) of the M=256,
   T=8 block store under the four block curves, in f32, plus bf16, int32
   and a stacked (2, n) store — every comparison bit-exact (tolerance 0);
3. the main paths at full size (``repro_torch.configs.gol3d.CHIP_*``),
   each with the launch counts set to 0 just before and read just after:
   ``Gol3d.run_resident(16)`` at M=256, T=8, S=4 for the four orderings
   (must equal ``reference_run(16)``; 4 fused launches each); the wave
   pipeline at M=256, S=2, neumann0 (8 steps of ``fields_step_ref``); the
   repack path ``Gol3d.run(2)`` at M=128; the resident tap sum
   ``stencil_sum_resident`` on the M=256 store; the distributed path
   ``Gol3d.run_distributed(mesh, 16)`` at global M=256, S=4, for the four
   orderings on each mesh of ``CHIP_MESHES`` (1×1×1: one M=256 shard;
   2×2×2: eight M=128 shards held by this process on the one card; must
   equal ``reference_run(16)``; per shard ⌈16/4⌉ fused launches and six
   ``gather_rows`` launches a round), and the wave pipeline on 2×2×2
   under mixed(k=neumann0), K=8, S=2 (8 steps of ``fields_step_ref``);
4. timings with CUDA events (median of repeats after a warm-up), and for
   the µs-scale gather and pack calls their device time from a profiler
   trace (CUDA events instead, and said so, when traces hold no device
   events): each kernel at its main-path shape beside its plain version, a single
   PyTorch call that computes the same function where there is one
   (conv3d, TF32 off; index_select for the gather; yardsticks the port
   never calls) and the least time the card could take for the
   function's own work (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s, whichever is larger; the halo sites the fused design
   recomputes are reported apart, as a model of the design's work);
   ms/timestep of the main path per ordering and per block curve; of the
   distributed path per ordering and mesh, with its exchange (pack,
   shift and scatter) beside its fused kernels; and the paper's exchange
   question: rows fetched and ms per face when packing the six faces of
   a path-ordered M=256 cube under each ordering.

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
SOURCES = {"stencil_step_fused": "src/repro_torch/kernels/csrc/stencil3d.cu",
           "stencil_sum_resident": "src/repro_torch/kernels/csrc/stencil3d.cu",
           "stencil_sum_blocks": "src/repro_torch/kernels/csrc/stencil3d.cu",
           "gather_rows": "src/repro_torch/kernels/csrc/sfc_gather.cu"}
REPLACES = {"stencil_step_fused": "src/repro/kernels/stencil3d.py:296",
            "stencil_sum_resident": "src/repro/kernels/stencil3d.py:212",
            "stencil_sum_blocks": "src/repro/kernels/stencil3d.py:114",
            "gather_rows": "src/repro/kernels/sfc_gather.py:33"}
BCS = ("periodic", "dirichlet", "neumann0", "mixed")
FACES = ("k0", "k1", "i0", "i1", "j0", "j1")
LINE = 64  # elements per gathered row (kops.sfc_gather_take's default)
# gather_rows launches per shard and exchange round: stencil/halo.
# exchange_shell packs k0, k1, i0, i1, j0 and j1 once each, every channel
# in one pack, under every boundary contract
PACKS_PER_SHARD = 6


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

    from repro_torch.configs.gol3d import (CHIP_DISTRIBUTED,
                                           CHIP_DISTRIBUTED_STEPS,
                                           CHIP_MAIN, CHIP_MAIN_STEPS,
                                           CHIP_MESHES, CHIP_ORDERINGS,
                                           CHIP_REPACK, CHIP_REPACK_STEPS)
    from repro_torch.core import (apply_ordering, as_boundary, axes_periodic,
                                  blockize, blockize_fields, blockize_with_halo,
                                  boundary_face_table_device, dirichlet,
                                  extended_neighbor_table_device, mixed,
                                  neighbor_table_device, store_spec)
    from repro_torch.core.surfaces import run_stats, surface_path_indices
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stencil3d as K
    from repro_torch.kernels.ops import uniform_weights
    from repro_torch.kernels.sfc_gather import gather_rows
    from repro_torch.stencil.domain import make_stencil_mesh
    from repro_torch.stencil.gol3d import Gol3d
    from repro_torch.stencil.halo import (core_of, extended_store, fill_shells,
                                          shard_boundary_flags, shard_state,
                                          to_store)
    from repro_torch.stencil.pipeline import (DistributedPipeline,
                                              ResidentPipeline,
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

    def device_ms(fn, n=200, tries=3):
        """(ms, how): the device time per call of the kernels ``fn``
        launches — the sum of their durations in a profiler trace of ``n``
        calls, over ``n`` (how = "device"). For a kernel shorter than the
        host's cost of launching it, CUDA events around back-to-back calls
        measure the host instead. A trace can come back without device
        events; after ``tries`` such traces the time is taken with CUDA
        events around the ``n`` calls (how = "events", host cost included)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        sync()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                sync()
            total = sum(e.self_device_time_total for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA"))
            if total > 0:
                return total / 1e3 / n, "device"
        log(f"the profiler recorded no device time in {tries} traces; "
            f"CUDA events around {n} calls instead")
        return cuda_ms(fn, reps=3, inner=n), "events"

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

    # The fused kernel on extended stores: the core and shell blocks of a
    # 2×2×2 local mesh of M=64 shards, the shells filled by the
    # distributed path's own exchange and scatter (halo.fill_shells); its
    # table points at shell rows ≥ nb, its flags are masked by the shard's
    # mesh position, and it writes the core of a second extended store.
    t0 = time.perf_counter()
    n_cmp, T, g = 0, 8, 1
    nt = M // T
    nb = nt ** 3
    mesh_e = make_stencil_mesh((2, 2, 2), device=dev)
    nbr_e = extended_neighbor_table_device("hilbert", nt, dev)
    w = uniform_weights(g, dev)
    for rule in ("gol", "wave"):
        C = 2 if rule == "wave" else 1
        stores = [blockize_fields(cube_for(rule, M, C), T, "hilbert") if C == 2
                  else blockize(cube_for(rule, M)[0], T, "hilbert")
                  for _ in mesh_e.shards]
        for bcn in ("periodic", "neumann0", "mixed"):
            bc = bc_of(bcn)
            for S in (1, 2, 4):
                exts = [extended_store(st, nt) for st in stores]
                fill_shells(mesh_e, exts, kind="hilbert", M=M, h=S * g, bc=bc)
                for co, ext in zip(mesh_e.shards, exts):
                    bnd = shard_boundary_flags("hilbert", nt, co, mesh_e.shape,
                                               dev) if as_boundary(bc).clamped else None
                    spare = torch.zeros_like(ext)
                    got = K.stencil_step_fused(ext, w, nbr_e, bnd, g=g, S=S,
                                               rule=rule, bc=bc,
                                               out=core_of(spare, nb))
                    want = ref.stencil_fused_ref(ext, w, nbr_e, S=S, rule=rule,
                                                 bc=bc, bnd=bnd)
                    check(torch.equal(got, want),
                          f"fused on extended store {rule} {bcn} S={S} shard "
                          f"{co}: max |d| {(got - want).abs().max().item()}")
                    shell = spare[..., nb:, :, :, :]
                    check(not bool(shell.any()), "fused wrote outside the core")
                    n_cmp += 1
    sync()
    log(f"fused on extended stores at M={M} (2x2x2 shards): {n_cmp} "
        f"comparisons bit-equal ({time.perf_counter() - t0:.1f} s)")

    # gather_rows on the deep faces of the M=256, T=8 block store: the rows
    # covering each face, as the exchange's packs fetch them (line 64).
    t0 = time.perf_counter()
    M_D, T_D = CHIP_DISTRIBUTED.M, CHIP_DISTRIBUTED.block_T
    cube_d = cube_for("jacobi", M_D)[0]
    n_cmp = 0

    def face_rows(kind, h, face):
        hspec = store_spec(kind, T_D)
        idx = surface_path_indices(hspec, M_D, h, face)
        rows, _ = kops._row_plan(idx, LINE, (hspec, M_D, h, face))
        return idx, torch.from_numpy(np.array(rows)).to(dev)

    def gather_check(src, rows, what):
        got = gather_rows(src, rows)
        check(torch.equal(got, ref.gather_rows_ref(src, rows))
              and torch.equal(got, torch.index_select(src, 0, rows)),
              f"gather_rows != plain: {what}")

    for kind in KINDS:
        src = blockize(cube_d, T_D, kind).reshape(-1, LINE)
        for h in (1, 2, 4):
            for face in FACES:
                gather_check(src, face_rows(kind, h, face)[1],
                             f"{kind} h={h} {face}")
                n_cmp += 1
    src = blockize(cube_d, T_D, "hilbert").reshape(-1, LINE)
    idx, rows = face_rows("hilbert", 4, "i0")
    for dtype in (torch.bfloat16, torch.int32):
        gather_check(src.to(dtype) if dtype != torch.int32
                     else (src * 1000).to(dtype), rows, f"{dtype} i0 h=4")
        n_cmp += 1
    stacked = torch.stack([src.reshape(-1), -src.reshape(-1)])
    got = kops.sfc_gather_take(stacked, idx, line=LINE)
    want = stacked[:, torch.from_numpy(idx.astype(np.int64)).to(dev)]
    check(torch.equal(got, want),
          "sfc_gather_take on a (2, n) store != data[..., idx]")
    n_cmp += 1
    sync()
    log(f"gather_rows vs plain at M={M_D}: {n_cmp} comparisons bit-equal "
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

    # the distributed path: Gol3d.run_distributed(mesh, 16) per mesh and
    # ordering, at global M=256 (S=4: four exchange rounds)
    K_D, S_D = CHIP_DISTRIBUTED_STEPS, CHIP_DISTRIBUTED.substeps
    rounds = -(-K_D // S_D)
    meshes = {shape: make_stencil_mesh(shape, device=dev) for shape in CHIP_MESHES}
    for shape, mesh in meshes.items():
        n_sh = mesh.size
        for spec in CHIP_ORDERINGS:
            app = Gol3d(dataclasses.replace(CHIP_DISTRIBUTED, ordering=spec))
            want = app.reference_run(K_D)
            _, counts = counted(lambda: app.run_distributed(mesh, K_D))
            got = app.cube
            tag = f"distributed {'x'.join(map(str, shape))} {spec.name}"
            check(counts["stencil_step_fused"] == rounds * n_sh,
                  f"{tag}: {counts} fused launches for K={K_D}, S={S_D}")
            check(counts["gather_rows"] == rounds * n_sh * PACKS_PER_SHARD,
                  f"{tag}: {counts} gather_rows launches")
            check(got.shape == (M_D,) * 3 and bool(torch.isfinite(got).all()),
                  f"{tag}: result not finite or misshapen")
            check(torch.equal(got, want), f"{tag}: run_distributed != reference_run")
            log(f"main {tag}: M={M_D} local {M_D // shape[0]} T={T_D} S={S_D} "
                f"K={K_D} launches fused {counts['stencil_step_fused']} "
                f"gather {counts['gather_rows']}, equal to reference_run, "
                f"live cells {int(got.sum().item())}")
    wmesh = meshes[(2, 2, 2)]
    wbc = mixed(k="neumann0")
    wpipe = DistributedPipeline(mesh=wmesh, spec=CHIP_DISTRIBUTED.ordering,
                                M=M_D // 2, T=T_D, g=G_MAIN, S=2, rule="wave",
                                bc=wbc)
    got, counts = counted(lambda: wpipe.run_cube(fields, 8))
    want = fields
    for _ in range(8):
        want = ref.fields_step_ref(want, uniform_weights(G_MAIN, dev), G_MAIN,
                                   rule="wave", bc=wbc)
    check(counts["stencil_step_fused"] == 4 * wmesh.size
          and counts["gather_rows"] == 4 * wmesh.size * PACKS_PER_SHARD,
          f"distributed wave launches {counts}")
    check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
          "distributed wave != 8 steps of fields_step_ref")
    log(f"main distributed wave: 2x2x2 local {M_D // 2} C=2 S=2 "
        f"mixed(k=neumann0) K=8 launches fused {counts['stencil_step_fused']} "
        f"gather {counts['gather_rows']}, equal to fields_step_ref")

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
    # gather_rows at the distributed path's deep-face shape: the i0 face at
    # h = S·g = 4 of the M=256, T=8 Hilbert block store (8,192 rows of 64
    # f32; a k face is 4,096 rows). The function reads each row and index
    # once and writes each row once.
    src = blockize(cube_d, T_D, "hilbert").reshape(-1, LINE)
    for face in ("k0", "i0"):
        _, rows = face_rows("hilbert", S_D * G_MAIN, face)
        R = rows.shape[0]
        buf = torch.empty((R, LINE), device=dev)
        gat = lambda: gather_rows(src, rows, out=buf)
        plain = lambda: ref.gather_rows_ref(src, rows)
        lib = lambda: torch.index_select(src, 0, rows)
        err = (gat() - plain()).abs().max().item()
        b_ms, b_by = bound(2 * R * LINE * 4 + 4 * R, 0)
        # device time per launch (profiler); per call on the host's clock
        # (CUDA events around back-to-back calls), wrapper included
        (g_ms, g_how), (p_ms, p_how), (l_ms, l_how) = (
            device_ms(fn) for fn in (gat, plain, lib))
        row = dict(name="gather_rows", ms=g_ms, plain_ms=p_ms, max_abs_err=err,
                   bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
        log(f"gather_rows {face} h={S_D * G_MAIN}: {R} rows, {g_how} "
            f"{g_ms:.5f} ms (plain {p_how} {p_ms:.5f}, index_select {l_how} "
            f"{l_ms:.5f}, bound {b_ms:.5f} ms); per call "
            f"{cuda_ms(gat, inner=100):.5f} ms (plain "
            f"{cuda_ms(plain, inner=100):.5f}, index_select "
            f"{cuda_ms(lib, inner=100):.5f})")
    kernels.append(row)  # the i face, the larger of the two
    for k in kernels:
        check(k["max_abs_err"] == 0.0, f"{k['name']} differs from plain: {k}")
        k.update(route="cuda", source=SOURCES[k["name"]],
                 replaces=REPLACES[k["name"]], launches=main_launches[k["name"]])
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

    # the distributed path per mesh and ordering: end to end (host clock
    # around run_distributed, with its sharding and ordering gathers), the
    # pipeline's rounds alone, and one round split into its exchange
    # (pack; then shift, unpack, edge assembly and shell scatter) and its
    # fused kernels, each timed on its own with CUDA events
    for shape, mesh in meshes.items():
        tag = "x".join(map(str, shape))
        for spec in CHIP_ORDERINGS:
            app = Gol3d(dataclasses.replace(CHIP_DISTRIBUTED, ordering=spec))
            app.run_distributed(mesh, K_D)
            sync()
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                app.run_distributed(mesh, K_D)
                sync()
                walls.append(time.perf_counter() - t1)
            pipe = app.distributed_pipeline(mesh)
            st = shard_state(app.cube, spec, pipe.procs)
            shards = [st[co] for co in mesh.shards]
            run = pipe.run_fn(K_D)
            run_ms = cuda_ms(lambda: run(shards), reps=5, inner=1) / K_D
            kind, M_l, T_l, h = pipe.kind, pipe.M, pipe.T, pipe.S * pipe.g
            nt_l = M_l // T_l
            nb_l = nt_l ** 3
            exts = [extended_store(to_store(x, spec, kind, T_l, M_l), nt_l)
                    for x in shards]
            outs = [core_of(torch.zeros_like(e), nb_l) for e in exts]
            flats = [core_of(e, nb_l).reshape(-1) for e in exts]
            hspec = store_spec(kind, T_l)
            nbr_l = extended_neighbor_table_device(kind, nt_l, dev)
            pack = lambda: [kops.pack_surface(f, hspec, M_l, h, face)
                            for f in flats for face in FACES]
            fill = lambda: fill_shells(mesh, exts, kind=kind, M=M_l, h=h,
                                       bc=pipe.bc)
            check(not pipe.bc.clamped, "the timed round assumes periodic")
            fused = lambda: [K.stencil_step_fused(e, w1, nbr_l, g=G_MAIN,
                                                  S=pipe.S, rule=pipe.rule,
                                                  out=o)
                             for e, o in zip(exts, outs)]
            p_ms, f_ms, k_ms = (cuda_ms(fn, reps=5, inner=3)
                                for fn in (pack, fill, fused))
            log(f"distributed {tag} {spec.name} (block curve {kind}, local "
                f"M={M_l}): end to end {1e3 * statistics.median(walls) / K_D:.4f} "
                f"ms/timestep, rounds {run_ms:.4f} ms/timestep; one round: "
                f"exchange {f_ms:.4f} ms (pack {p_ms:.4f}, shift+unpack+scatter "
                f"{f_ms - p_ms:.4f}), fused {k_ms:.4f} ms, exchange share "
                f"{100 * f_ms / (f_ms + k_ms):.1f}%")
        log(f"model {tag}: distributed {pipe.bytes_per_step(K_D) / 1e6:.3f} "
            f"MB/timestep per shard, of which exchange "
            f"{pipe.exchange_bytes_per_step() / 1e6:.3f} MB/timestep "
            f"({pipe.exchange_bytes_per_step() * pipe.S / 4:.0f} items per "
            f"exchange)")

    # the paper's exchange question on this card: pack the six width-g
    # faces of a path-ordered M=256 cube under each ordering; rows of 64
    # fetched (the device-memory traffic of the pack), ms per call and
    # device ms (the gather kernel and the element selection) per face
    for spec in CHIP_ORDERINGS:
        path = apply_ordering(cube_d, spec)
        for g_p in (1, 4):
            parts = []
            for face in FACES:
                idx = surface_path_indices(spec, M_D, g_p, face)
                rows, _ = kops._row_plan(idx, LINE, (spec, M_D, g_p, face))
                rs = run_stats(spec, M_D, g_p, face)
                pk = lambda: kops.pack_surface(path, spec, M_D, g_p, face)
                d_ms, how = device_ms(pk, n=50)
                parts.append(f"{face} {len(rows)} rows {rs.n_runs} runs "
                             f"{cuda_ms(pk, inner=20):.4f} ms per call, "
                             f"{d_ms:.4f} ms {how}")
            log(f"pack {spec.name} g={g_p}: " + "; ".join(parts))

    sync()
    log(f"timings ({time.perf_counter() - t0:.1f} s)")

    # where the time of one main-path run goes, by kernel (profiler on)
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn, what, top=8):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn()
            sync()
            wall_ms = 1e3 * (time.perf_counter() - t1)
        by_name = {e.key: e.self_device_time_total / 1e3
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0}
        if not by_name:
            log(f"profile {what}: the profiler recorded no device time "
                "(not measured)")
            return
        busy = sum(by_name.values())
        log(f"profile {what}, profiler on: wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            log(f"  {ms:.4f} ms  {name[:100]}")

    app = apps["hilbert"]
    profiled(lambda: app.run_resident(K_MAIN), f"run_resident({K_MAIN}) hilbert")
    app = Gol3d(CHIP_DISTRIBUTED)
    for shape, mesh in meshes.items():
        profiled(lambda: app.run_distributed(mesh, K_D),
                 f"run_distributed({K_D}) {CHIP_DISTRIBUTED.ordering.name} "
                 f"{'x'.join(map(str, shape))}", top=12)

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
