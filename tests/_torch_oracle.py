"""Reference harness for the torch package's tests: JAX results, computed
in a subprocess.

Some reference calls of the JAX package reach ``core.layout.
device_constant``, which calls ``jax.core.trace_state_clean``; JAX 0.9
moved that function to ``jax._src.core``. Those calls run here, in a
child process that restores the alias first, computes every array a
test module needs from numpy inputs made from fixed seeds, and writes
them to an ``.npz``. The pytest process is never patched, so the JAX
package's own tests run exactly as they would without this module.

Run as ``python tests/_torch_oracle.py <recipe> <out.npz>``; tests call
:func:`reference_arrays` from a module-scoped fixture. The ``distributed``
recipe runs the JAX package's mesh pipelines on 8 host devices: its
child sets ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` before
it imports JAX.

``python tests/_torch_oracle.py dryrun_table <dir>`` prints the dry run's
mini cells, the torch package's counts beside the JAX package's.

``python tests/_torch_oracle.py ranks <px>x<py>x<pz> <out.npz> [cpu|cuda]``
runs the torch package's process-group mesh instead: it starts one
process per shard, each a gloo rank on the CPU or an NCCL rank on card
``rank`` (``init_method="file://..."`` beside the output, a 60 s group
timeout, one thread), runs :data:`RANK_CASES` and gathers every rank's
result into the ``.npz``; a rank that has not finished within
:data:`RANK_TIMEOUT_S` is killed and the run fails. Tests call
:func:`rank_arrays` (gloo); the NCCL form needs one card per shard.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
KINDS = ("row_major", "column_major", "morton", "hilbert")

# the slice end to end: M=16, T=4, S=2 and K=5, so the remainder runs
GOL_M, GOL_T, GOL_S, GOL_K, GOL_SEED = 16, 4, 2, 5, 3
WAVE_SEED = 7


def cube_input(M: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(M, M, M)).astype(np.float32)


def wave_fields() -> np.ndarray:
    rng = np.random.default_rng(WAVE_SEED)
    return rng.normal(size=(2, GOL_M, GOL_M, GOL_M)).astype(np.float32)


def _child_env() -> dict[str, str]:
    env = dict(os.environ)
    src = str(REPO / "src")
    env["PYTHONPATH"] = src + os.pathsep + env["PYTHONPATH"] \
        if env.get("PYTHONPATH") else src
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def reference_arrays(tmp_path_factory, recipe: str) -> dict[str, np.ndarray]:
    """Run ``recipe`` in a child process; return its arrays by name."""
    return recipe_arrays(tmp_path_factory.mktemp(f"ref_{recipe}"), recipe)


def recipe_arrays(work: Path, recipe: str) -> dict[str, np.ndarray]:
    """Run ``recipe`` in a child process with ``work`` as its directory
    (the checkpoint recipes read and write checkpoint dirs there); return
    its arrays by name."""
    out = Path(work) / "ref.npz"
    proc = subprocess.run([sys.executable, __file__, recipe, str(out)],
                          env=_child_env(), capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"reference recipe {recipe!r} failed:\n{proc.stderr}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _started(args: list[str], out: Path, err: Path, load):
    """Start ``python tests/_torch_oracle.py *args`` and return a function
    that waits for it (at most 600 s from the start) and returns
    ``load(out)``: the test goes on meanwhile."""
    import time

    with open(err, "w") as f:
        proc = subprocess.Popen([sys.executable, __file__, *args], env=_child_env(),
                                stdout=subprocess.DEVNULL, stderr=f, text=True)
    t0 = time.monotonic()

    def wait():
        try:
            proc.wait(timeout=max(600 - (time.monotonic() - t0), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"{args[0]!r} failed:\n{err.read_text()}")
        return load(out)

    return wait


def _load_npz(path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def recipe_started(work: Path, recipe: str):
    """Start ``recipe`` in a child process with ``work`` as its directory;
    return a function that waits for it and returns its arrays by name."""
    return _started([recipe, str(Path(work) / "ref.npz")], Path(work) / "ref.npz",
                    Path(work) / "stderr.txt", _load_npz)


def port_dryrun_started(work: Path, archs):
    """Start the torch package's dry run of the mini cells of ``archs``
    (:func:`_port_dryrun`) in a child process; return a function that waits
    for it and returns ``{(arch, mode): record}``."""
    out = Path(work) / "port.json"

    def load(path):
        return {tuple(k.split("|")): v for k, v in json.loads(path.read_text()).items()}

    return _started(["port_dryrun", str(out), *archs], out,
                    Path(work) / "stderr.txt", load)


def _dryrun_table(work: Path) -> None:
    """Print the mini cells' per-device counts, the port's beside the JAX
    package's HLO counts, as a markdown table (the recipe and the port's
    cells run in children, ``work`` their directory)."""
    for sub in ("jax", "port"):
        (work / sub).mkdir(parents=True, exist_ok=True)
    ref = recipe_started(work / "jax", "dryrun")
    port = port_dryrun_started(work / "port", DRYRUN_ARCHS)
    want, got = ref(), port()
    print("| arch | cell | flops, port / JAX | bytes, port / JAX | collective "
          "bytes, port / JAX | argument bytes (both) |")
    print("| --- | --- | --- | --- | --- | --- |")
    for arch in DRYRUN_ARCHS:
        for mode in ("train", "decode"):
            rec, pre = got[(arch, mode)], f"{arch}/{mode}/"
            coll = sum(rec["coll_bytes"].values())
            jcoll = sum(json.loads(str(want[pre + "coll_bytes"])).values())
            print(f"| {arch} | {mode} | {rec['flops_per_dev']:.4g} / "
                  f"{float(want[pre + 'flops']):.4g} | {rec['bytes_per_dev']:.4g} / "
                  f"{float(want[pre + 'bytes']):.4g} | {coll:.4g} / {jcoll:.4g} | "
                  f"{int(want[pre + 'argument_bytes'])} |")


def _port_dryrun(out: str, archs) -> None:
    """The torch package's dry run of the mini cells (:data:`DRYRUN_MESH`
    under torch's fake process group, meta tensors): each arch's train and
    decode records, as JSON."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.registry import ShapeSpec, get_smoke
    from repro_torch.launch import dryrun

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(DRYRUN_MESH),
                      mesh_dim_names=("data", "model"))
    res = {}
    for arch in archs:
        for mode in ("train", "decode"):
            shape = ShapeSpec(f"mini_{mode}", DRYRUN_SEQ, DRYRUN_BATCH, mode)
            res[f"{arch}|{mode}"] = dryrun.run_cell(get_smoke(arch), shape, mesh,
                                                    "mini", dryrun.DEFAULT_OPTS)
    dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


# ------------------------------------------------------- stencil cases
# Shared by the stencil test modules: the same numpy inputs and tables go
# to both packages' fused stencils.

BCS = ("periodic", "dirichlet", "neumann0", "mixed")
RULES = ("gol", "jacobi", "wave")


def boundary(pkg, name):
    """The same contract in either package's boundary module: dirichlet
    at 0.5, mixed = clamped k under neumann0 with periodic i/j."""
    return {"periodic": lambda: pkg.PERIODIC,
            "dirichlet": lambda: pkg.dirichlet(0.5),
            "neumann0": lambda: pkg.NEUMANN0,
            "mixed": lambda: pkg.mixed(k="neumann0")}[name]()


def random_store(rule: str, nb: int, T: int, seed: int) -> np.ndarray:
    """0/1 cells for gol, normal values otherwise, stacked (2, nb, T³)
    for wave."""
    rng = np.random.default_rng(seed)
    if rule == "gol":
        return (rng.random((nb, T, T, T)) < 0.3).astype(np.float32)
    shape = (2, nb, T, T, T) if rule == "wave" else (nb, T, T, T)
    return rng.normal(size=shape).astype(np.float32)


FP8 = ("float8_e4m3fn", "float8_e5m2")


def fp8_values(shape, seed: int, *, lo: float = 440.0, hi: float = 500.0,
               base=None) -> np.ndarray:
    """f32 values for an fp8 store: ``base`` (default normals) with a fifth
    of the sites drawn from [lo, hi] with either sign, where e4m3fn's 448
    and its NaN above 464 lie, and one site in fifty NaN."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) if base is None \
        else np.array(base, dtype=np.float32)
    big = rng.random(shape) < 0.2
    x[big] = (rng.uniform(lo, hi, size=int(big.sum()))
              * rng.choice([-1.0, 1.0], size=int(big.sum())))
    x[rng.random(shape) < 0.02] = np.nan
    return x


def fp8_pair(x: np.ndarray, dtype: str):
    """``x`` converted to the fp8 ``dtype`` by the JAX package's XLA, and
    the same bits as a torch tensor: ``(jax_array, torch_tensor)``."""
    import jax.numpy as jnp
    import torch

    js = jnp.asarray(x).astype(getattr(jnp, dtype))
    ts = torch.from_numpy(np.asarray(js).view(np.uint8).copy()).view(
        getattr(torch, dtype))
    return js, ts


def bits(a) -> np.ndarray:
    """The bit patterns of a torch tensor or a JAX/numpy array, as
    unsigned integers of its width: equal bits, NaN included."""
    import torch

    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        width = a.element_size()
        return a.contiguous().view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32}[width]).numpy() \
            .view({1: np.uint8, 2: np.uint16, 4: np.uint32}[width])
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def same_bits(got, want) -> bool:
    """Bit-equal wherever ``want`` is a number, and NaN exactly where it
    is NaN. A NaN's sign and payload are left out: they follow the
    machine's arithmetic (x86 and the card differ) and the JAX package
    itself writes e5m2 NaN as 0x7E or 0x7F by path."""
    import torch

    g = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got).astype(np.float32)
    w = want.detach().cpu().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want).astype(np.float32)
    nan = np.isnan(w)
    return g.shape == w.shape and bool((np.isnan(g) == nan).all()) \
        and bool((bits(got)[~nan] == bits(want)[~nan]).all())


def tables(kind: str, nt: int, bc: str):
    """(nbr, bnd) numpy tables from each package's own builders:
    ``(jax_tables, torch_tables)``, the neighbour tables checked equal."""
    from repro.core import boundary as jbnd
    from repro.core import neighbors as jnbr
    from repro_torch.core import boundary as tbnd
    from repro_torch.core import neighbors as tnbr

    jt = (jnbr.neighbor_table(kind, nt, periodic=jbnd.axes_periodic(boundary(jbnd, bc))),
          jnbr.boundary_face_table(kind, nt))
    tt = (tnbr.neighbor_table(kind, nt, periodic=tbnd.axes_periodic(boundary(tbnd, bc))),
          tnbr.boundary_face_table(kind, nt))
    np.testing.assert_array_equal(jt[0], tt[0])
    return jt, tt


def to_torch(a):
    import torch

    return torch.from_numpy(np.array(a))


def port_fused(store, kind, nt, bc, S, rule, g=1):
    """The torch package's stencil_step_fused on CPU tensors."""
    from repro_torch.core import boundary as tbnd
    from repro_torch.kernels import stencil3d as tk
    from repro_torch.kernels.ops import uniform_weights

    _, (nbr, bnd) = tables(kind, nt, bc)
    return tk.stencil_step_fused(to_torch(store), uniform_weights(g, "cpu"),
                                 to_torch(nbr), to_torch(bnd), g=g, S=S,
                                 rule=rule, bc=boundary(tbnd, bc))


def jax_fused(store, kind, nt, bc, S, rule, g=1):
    """The JAX package's jnp oracle ref.stencil_fused_ref (no
    device_constant on its path: runs in-process)."""
    import jax.numpy as jnp

    from repro.core import boundary as jbnd
    from repro.kernels import ref as jref
    from repro.kernels.ops import _build_uniform_weights

    (nbr, bnd), _ = tables(kind, nt, bc)
    out = jref.stencil_fused_ref(jnp.asarray(store),
                                 jnp.asarray(_build_uniform_weights(g)),
                                 jnp.asarray(nbr), S=S, rule=rule,
                                 bc=boundary(jbnd, bc), bnd=jnp.asarray(bnd))
    return np.asarray(out)


def assert_matches(got, want, rule, ctx):
    """gol and wave bit-equal; jacobi within rtol=atol=1e-6, because XLA
    may contract or rewrite the JAX side's arithmetic (DESIGN.md §4)."""
    import torch

    want = to_torch(want)
    if rule == "jacobi":
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-6), ctx
    else:
        assert torch.equal(got, want), ctx


# --------------------------------------------------------------- recipes
# Each runs in the child process only and returns {name: array}.

def _recipe_core() -> dict[str, np.ndarray]:
    import jax.numpy as jnp

    from repro.core import layout
    from repro.core.orderings import ordering_from_name

    res = {}
    for M, T in ((8, 4), (16, 4), (16, 8)):
        x = cube_input(M, seed=M + T)
        fields = np.stack([x, -x])
        for kind in KINDS:
            b = layout.blockize(jnp.asarray(x), T, kind)
            res[f"blockize/{M}/{T}/{kind}"] = np.asarray(b)
            res[f"unblockize/{M}/{T}/{kind}"] = np.asarray(
                layout.unblockize(b, M, kind))
            bf = layout.blockize_fields(jnp.asarray(fields), T, kind)
            res[f"blockize_fields/{M}/{T}/{kind}"] = np.asarray(bf)
            res[f"unblockize_fields/{M}/{T}/{kind}"] = np.asarray(
                layout.unblockize_fields(bf, M, kind))
    for M in (4, 8, 16):
        x = cube_input(M, seed=M)
        for name in KINDS + ("morton_r1", "hybrid_hilbert_morton_T4"):
            spec = ordering_from_name(name)
            if spec.kind == "hybrid" and M % spec.tile:
                continue
            v = layout.apply_ordering(jnp.asarray(x), spec)
            res[f"apply/{M}/{name}"] = np.asarray(v)
            res[f"undo/{M}/{name}"] = np.asarray(layout.undo_ordering(v, spec, M))
    return res


def _recipe_gol3d() -> dict[str, np.ndarray]:
    import jax.numpy as jnp

    from repro.core.boundary import NEUMANN0
    from repro.core.orderings import ordering_from_name
    from repro.stencil import Gol3d, Gol3dConfig
    from repro.stencil.pipeline import ResidentPipeline

    res = {}
    for kind in KINDS:
        cfg = Gol3dConfig(M=GOL_M, g=1, ordering=ordering_from_name(kind),
                          block_T=GOL_T, substeps=GOL_S, seed=GOL_SEED)
        app = Gol3d(cfg)
        res[f"state0/{kind}"] = np.asarray(app.state_path)
        res[f"reference/{kind}"] = np.asarray(app.reference_run(GOL_K))
        res[f"resident/{kind}"] = np.asarray(app.run_resident(GOL_K))
        pipe = ResidentPipeline(M=GOL_M, T=GOL_T, g=1, kind=kind, S=GOL_S,
                                rule="wave", bc=NEUMANN0)
        res[f"wave/{kind}"] = np.asarray(pipe.run(jnp.asarray(wave_fields()), GOL_K))
    return res


# ------------------------------------------------ pack and halo cases

PACK_M, PACK_H, PACK_SEED = 8, 2, 13
FACES = ("k0", "k1", "i0", "i1", "j0", "j1")


def pack_inputs(face: str) -> tuple[np.ndarray, np.ndarray]:
    """(state, buffer) for unpack_surface at M=PACK_M, h=PACK_H."""
    rng = np.random.default_rng(PACK_SEED + FACES.index(face))
    return (rng.normal(size=PACK_M ** 3).astype(np.float32),
            rng.normal(size=PACK_H * PACK_M ** 2).astype(np.float32))


# (procs, global shape) of the shard_state checks, non-cubic boxes included
SHARD_CASES = (((2, 2, 2), (16, 16, 16)), ((4, 2, 1), (32, 16, 8)),
               ((1, 2, 2), (8, 16, 16)))


def shard_input(gshape, C=1) -> np.ndarray:
    rng = np.random.default_rng(sum(gshape) + C)
    shape = ((C,) if C > 1 else ()) + tuple(gshape)
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------- the distributed slice
# Global 16³ over a 2×2×2 mesh of local M=8 shards, T=4, K=5 steps (so an
# S=2 run has a remainder round); one 4×2×1 case over a (32, 16, 8) box.

DIST_M, DIST_T, DIST_K, DIST_SEED = 8, 4, 5, 11


def dist_cube(rule: str, shape=(2, 2, 2), seed: int = DIST_SEED) -> np.ndarray:
    """The global state of one case: 0/1 cells for gol, normal values
    otherwise, stacked (2, ...) for wave."""
    rng = np.random.default_rng(seed)
    G = tuple(DIST_M * p for p in shape)
    if rule == "gol":
        return (rng.random(G) < 0.3).astype(np.float32)
    lead = (2,) if rule == "wave" else ()
    return rng.normal(size=lead + G).astype(np.float32)


def dist_cases():
    """(name, kind, rule, bc, S, mesh shape) of the cases held against the
    JAX package: 4 orderings × gol periodic × S ∈ {1, 2}; {gol, jacobi,
    wave} × {dirichlet(0.5), neumann0, mixed(k=neumann0)} on hilbert; one
    4×2×1 box."""
    cases = [(f"{k}/gol/periodic/S{S}", k, "gol", "periodic", S, (2, 2, 2))
             for k in KINDS for S in (1, 2)]
    cases += [(f"hilbert/{r}/{b}/S2", "hilbert", r, b, 2, (2, 2, 2))
              for r in RULES for b in ("dirichlet", "neumann0", "mixed")]
    cases.append(("morton/gol/periodic/S2/4x2x1", "morton", "gol", "periodic",
                  2, (4, 2, 1)))
    return cases


# the process-group runs: every case on each rank of each mesh
RANK_CASES = (("gol", "periodic"), ("wave", "mixed"))
RANK_KIND, RANK_S = "hilbert", 2
RANK_TIMEOUT_S = 150


def rank_arrays(tmp_path, shape) -> dict[str, np.ndarray]:
    """Run :data:`RANK_CASES` on a gloo process-group mesh of ``shape``,
    one process per shard; return ``{"<rule>/<bc>/rank<r>": cube}``."""
    out = tmp_path / "ranks.npz"
    mesh = "x".join(str(p) for p in shape)
    proc = subprocess.run([sys.executable, __file__, "ranks", mesh, str(out)],
                          env=_child_env(), capture_output=True, text=True,
                          timeout=RANK_TIMEOUT_S + 60)
    if proc.returncode != 0:
        raise RuntimeError(f"ranks {mesh} failed:\n{proc.stdout}\n{proc.stderr}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _rank_main(rank: int, shape, init_file: str, out: str, device: str) -> None:
    """One rank: hold one shard, run every case, save the cubes. On
    ``device="cuda"`` the rank uses card ``rank`` and NCCL, and also runs
    a case at local M=128 against a local mesh of every shard on its own
    card, saving whether the two agree bit for bit and each one's ms."""
    import time
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.core import boundary as tbnd
    from repro_torch.core.orderings import ordering_from_name
    from repro_torch.stencil import DistributedPipeline, make_stencil_mesh

    torch.set_num_threads(1)
    n = int(np.prod(shape))
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{init_file}",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_stencil_mesh(shape, device=dev, group=dist.group.WORLD)
        spec = ordering_from_name(RANK_KIND)
        res = {}
        for rule, bc in RANK_CASES:
            pipe = DistributedPipeline(mesh=mesh, spec=spec, M=DIST_M,
                                       T=DIST_T, g=1, S=RANK_S, rule=rule,
                                       bc=boundary(tbnd, bc))
            cube = torch.from_numpy(dist_cube(rule, shape)).to(dev)
            res[f"{rule}/{bc}/rank{rank}"] = pipe.run_cube(cube, DIST_K).cpu().numpy()
        if device == "cuda":
            local = make_stencil_mesh(shape, device=dev)
            G = tuple(128 * p for p in shape)
            cube = torch.from_numpy((np.random.default_rng(1).random(G) < 0.3)
                                    .astype(np.float32)).to(dev)
            outs = []
            for m in (mesh, local, mesh, local):
                pipe = DistributedPipeline(mesh=m, spec=spec, M=128, T=8, g=1,
                                           S=4)
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(pipe.run_cube(cube, 16))
                torch.cuda.synchronize()
                res[f"ms/{'group' if m is mesh else 'local'}/{len(outs)}/rank{rank}"] = \
                    np.float64(1e3 * (time.perf_counter() - t0) / 16)
            res[f"big_equal/rank{rank}"] = np.bool_(
                all(torch.equal(o, outs[1]) for o in outs))
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def _run_ranks(mesh: str, path: str, device: str = "cpu") -> None:
    """Start one process per shard of ``mesh``, wait for all (killing any
    left at the time limit), and merge their results into ``path``."""
    import time

    shape = tuple(int(p) for p in mesh.split("x"))
    n = int(np.prod(shape))
    work = Path(path).resolve().parent
    init_file = work / f"rendezvous-{mesh}"
    init_file.unlink(missing_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, "rank", mesh,
                               str(r), str(init_file),
                               str(work / f"rank{r}-{mesh}.npz"), device],
                              env=env) for r in range(n)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f"ranks exited {codes}")
    merged = {}
    for r in range(n):
        with np.load(work / f"rank{r}-{mesh}.npz") as z:
            merged.update({k: z[k] for k in z.files})
    np.savez(path, **merged)


# ----------------------------------------------------- more JAX recipes

def _recipe_pack() -> dict[str, np.ndarray]:
    import jax.numpy as jnp

    from repro.kernels import ops
    from repro.core.orderings import ordering_from_name

    res = {}
    for kind in KINDS:
        spec = ordering_from_name(kind)
        for face in FACES:
            state, buf = pack_inputs(face)
            res[f"unpack/{kind}/{face}"] = np.asarray(ops.unpack_surface(
                jnp.asarray(state), jnp.asarray(buf), spec, PACK_M, PACK_H, face))
    return res


def _recipe_halo() -> dict[str, np.ndarray]:
    import jax.numpy as jnp

    from repro.core.orderings import ordering_from_name
    from repro.stencil.halo import shard_state, unshard_state

    res = {}
    for procs, gshape in SHARD_CASES:
        for kind in ("row_major", "hilbert"):
            spec = ordering_from_name(kind)
            for C in (1, 2):
                tag = f"{'x'.join(map(str, procs))}/{kind}/C{C}"
                st = shard_state(jnp.asarray(shard_input(gshape, C)), spec, procs)
                res[f"shard/{tag}"] = np.asarray(st)
                res[f"unshard/{tag}"] = np.asarray(
                    unshard_state(jnp.asarray(np.asarray(st)), spec, gshape))
    return res


def _recipe_distributed() -> dict[str, np.ndarray]:
    """The JAX package's DistributedPipeline on 8 host devices. Its
    ``run_cube`` ends in ``unshard_state`` of a sharded array, which JAX
    0.9 refuses to reshape; the recipe runs ``shard_state`` →
    ``DistributedPipeline.run`` → ``unshard_state`` of the result brought
    to the host, which is what ``run_cube`` computes."""
    import jax.numpy as jnp

    from repro.core import boundary as jbnd
    from repro.core.orderings import ordering_from_name
    from repro.stencil import DistributedPipeline, make_stencil_mesh
    from repro.stencil.halo import shard_state, unshard_state

    meshes = {}
    res = {}
    for name, kind, rule, bc, S, shape in dist_cases():
        mesh = meshes.setdefault(shape, make_stencil_mesh(shape))
        pipe = DistributedPipeline(mesh=mesh, spec=ordering_from_name(kind),
                                   M=DIST_M, T=DIST_T, g=1, S=S, rule=rule,
                                   bc=boundary(jbnd, bc))
        st = shard_state(jnp.asarray(dist_cube(rule, shape)), pipe.spec, shape)
        st = np.asarray(pipe.run(st, DIST_K))
        res[name] = np.asarray(unshard_state(jnp.asarray(st), pipe.spec,
                                             pipe.global_shape))
    return res


# --------------------------------------------- flash attention and LM cases

# (BH, Sq, Sk, D) of tests/test_kernels.py's flash checks, blocks of 16
FLASH_SHAPES = ((2, 64, 64, 16), (1, 128, 128, 32), (2, 32, 128, 16))
FLASH_SCHEDULES = ("row_major", "morton", "hilbert")
FLASH_BF16_SHAPE, FLASH_BF16_BLOCK = (2, 64, 32), 32
GQA_Q, GQA_KV = (2, 4, 32, 8), (2, 2, 32, 8)
# (nq, nk, block_q, block_k, offs): square, non-square, non-power-of-two
# grids, and the diagonal moved by Sk - Sq > 0
SCHEDULE_GRIDS = ((4, 4, 16, 16, 0), (8, 8, 16, 16, 0), (4, 8, 16, 16, 64),
                  (8, 4, 32, 64, 0), (3, 5, 16, 16, 32), (6, 6, 32, 32, 0),
                  (5, 3, 16, 32, 0), (16, 16, 128, 128, 0), (2, 6, 16, 16, 64),
                  (1, 1, 16, 16, 0))


def flash_inputs(shape, seed: int) -> tuple[np.ndarray, ...]:
    """q, k, v as f32 normals for (BH, Sq, Sk, D)."""
    BH, Sq, Sk, D = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, Sq, D)).astype(np.float32),
            rng.normal(size=(BH, Sk, D)).astype(np.float32),
            rng.normal(size=(BH, Sk, D)).astype(np.float32))


# ops.flash_attention at sequence lengths whose blocks, halved from 128
# until they divide S, are not multiples of 16 (S=100 takes one block of
# 100), at a head dim that is not a multiple of 8, and at head dims above
# 128 (gemma3-1b's 256): (S, Hq, Hkv, D)
BLOCK_CASES = (tuple((S, 3, 1, 64) for S in (8, 12, 24, 100))
               + ((24, 2, 1, 12), (24, 2, 1, 160), (48, 2, 1, 256)))


# q, k, v in the narrow dtypes the JAX kernel takes (F3): (BH, S, D),
# 16-blocks, and the head dims above 256 (F1): (BH, S, D) per D, f32 and
# bf16, 16-blocks
FLASH_NARROW_SHAPE, FLASH_NARROW_DTYPES = (2, 64, 32), ("float16",) + FP8
FLASH_WIDE_SHAPES = ((1, 32, 320), (1, 32, 512), (1, 32, 1024))
# F1 above 1024 (the simple design's wide instance on the card), and F4:
# more folded heads than a CUDA grid's 65535 rows, (BH, S, D)
FLASH_XWIDE_SHAPES = ((1, 32, 1152), (1, 32, 2048))
FLASH_MANY_HEADS = (65536, 8, 8)


def narrow_flash_inputs(dtype: str, seed: int):
    """q, k, v converted to ``dtype`` by XLA, as numpy arrays of their bits
    (uint16 for f16, uint8 for fp8) for the torch side to view."""
    import jax.numpy as jnp

    BH, S, D = FLASH_NARROW_SHAPE
    return tuple(np.asarray(jnp.asarray(a).astype(getattr(jnp, dtype)))
                 for a in flash_inputs((BH, S, S, D), seed))


def any_block_inputs(case) -> tuple[np.ndarray, ...]:
    """q (1, Hq, S, D) and k, v (1, Hkv, S, D), f32 normals."""
    S, hq, hkv, D = case
    rng = np.random.default_rng(S + D)
    return (rng.normal(size=(1, hq, S, D)).astype(np.float32),
            rng.normal(size=(1, hkv, S, D)).astype(np.float32),
            rng.normal(size=(1, hkv, S, D)).astype(np.float32))


def gqa_inputs() -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(17)
    return (rng.normal(size=GQA_Q).astype(np.float32),
            rng.normal(size=GQA_KV).astype(np.float32),
            rng.normal(size=GQA_KV).astype(np.float32))


LM_SEED, LM_B, LM_S = 5, 2, 16
# a prompt length whose flash block (12) is not a multiple of 16
LM_S_ODD = 12
GREEDY_P, GREEDY_NEW = 8, 6
# the 4-layer tiny dense config of tests/test_models.py (GQA 4 -> 2 heads)
TINY_DENSE = dict(name="tiny-dense", family="dense", n_layers=4, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                  activation_dtype="float32", flash_schedule="hilbert")


def lm_configs(pkg: str) -> dict:
    """The LM test configurations, built from package ``pkg`` ("repro" or
    "repro_torch"), the flash kernel's path on: SMOKE of smollm-360m, the
    tiny dense config, and that config with bf16 activations (forward and
    prefill only: the JAX decode scan refuses an f32 cache under bf16
    activations)."""
    import dataclasses
    import importlib

    cmod = importlib.import_module(f"{pkg}.models.config")
    smoke = importlib.import_module(f"{pkg}.configs.smollm_360m").SMOKE
    tiny = cmod.ModelConfig(**TINY_DENSE, use_flash_kernel=True)
    return {"smoke": dataclasses.replace(smoke, use_flash_kernel=True),
            "tiny": tiny,
            "tiny_bf16": dataclasses.replace(tiny, name="tiny-dense-bf16",
                                             activation_dtype="bfloat16")}


def lm_tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _recipe_flash() -> dict[str, np.ndarray]:
    import jax.numpy as jnp

    from repro.kernels import ops
    from repro.kernels.flash_attn import build_schedule, flash_attention_fwd

    res = {}
    for causal in (True, False):
        for kind in FLASH_SCHEDULES:
            for nq, nk, bq, bk, offs in SCHEDULE_GRIDS:
                iq, ik = build_schedule(nq, nk, causal=causal, block_q=bq,
                                        block_k=bk, kind=kind, offs=offs)
                tag = f"{kind}/{int(causal)}/{nq}x{nk}/{bq}x{bk}/{offs}"
                res[f"sched_iq/{tag}"] = iq
                res[f"sched_ik/{tag}"] = ik
            for n, shape in enumerate(FLASH_SHAPES):
                q, k, v = (jnp.asarray(a) for a in flash_inputs(shape, n))
                res[f"fwd/{kind}/{int(causal)}/{n}"] = np.asarray(flash_attention_fwd(
                    q, k, v, causal=causal, block_q=16, block_k=16,
                    schedule=kind, interpret=True))
    BH, S, D = FLASH_BF16_SHAPE
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16)
               for a in flash_inputs((BH, S, S, D), 99))
    res["fwd_bf16"] = np.asarray(flash_attention_fwd(
        q, k, v, causal=True, block_q=FLASH_BF16_BLOCK,
        block_k=FLASH_BF16_BLOCK, interpret=True)).astype(np.float32)
    q, k, v = (jnp.asarray(a) for a in gqa_inputs())
    res["gqa"] = np.asarray(ops.flash_attention(q, k, v, True, "hilbert", 64, 64))
    res["gqa_fold_k"] = np.asarray(ops._fold_gqa(q, k, v)[1])
    for case in BLOCK_CASES:
        q, k, v = (jnp.asarray(a) for a in any_block_inputs(case))
        for causal in (True, False):
            res[f"any_block/{case}/{int(causal)}"] = np.asarray(
                ops.flash_attention(q, k, v, causal, "morton", 128, 128))
    for n, dtype in enumerate(FLASH_NARROW_DTYPES):
        q, k, v = narrow_flash_inputs(dtype, 60 + n)
        for causal in (True, False):
            out = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      block_q=16, block_k=16,
                                      schedule="hilbert", interpret=True)
            res[f"narrow/{dtype}/{int(causal)}"] = np.asarray(out).view(
                np.uint16 if dtype == "float16" else np.uint8)
    for BH, S, D in FLASH_WIDE_SHAPES:
        for dtype in ("float32", "bfloat16"):
            q, k, v = (jnp.asarray(a).astype(getattr(jnp, dtype))
                       for a in flash_inputs((BH, S, S, D), D))
            res[f"wide/{D}/{dtype}"] = np.asarray(flash_attention_fwd(
                q, k, v, causal=True, block_q=16, block_k=16,
                schedule="morton", interpret=True)).astype(np.float32)
    for BH, S, D in FLASH_XWIDE_SHAPES:
        for dtype in ("float32", "bfloat16"):
            for causal in (True, False):
                q, k, v = (jnp.asarray(a).astype(getattr(jnp, dtype))
                           for a in flash_inputs((BH, S, S, D), D))
                res[f"xwide/{D}/{dtype}/{int(causal)}"] = np.asarray(flash_attention_fwd(
                    q, k, v, causal=causal, block_q=16, block_k=16,
                    schedule="hilbert", interpret=True)).astype(np.float32)
    from repro.kernels.ref import attention_ref

    BH, S, D = FLASH_MANY_HEADS
    q, k, v = (jnp.asarray(a) for a in flash_inputs((BH, S, S, D), 65))
    res["many_heads"] = np.asarray(attention_ref(q, k, v, causal=True))
    return res


def _recipe_lm() -> dict[str, np.ndarray]:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.registry import SHAPES, ShapeSpec, concrete_batch
    from repro.configs.smollm_360m import CONFIG
    from repro.models import build_model
    from repro.serve import greedy_decode

    res = {"n_params/smollm-360m": np.asarray(build_model(CONFIG).n_params())}
    for name, cfg in lm_configs("repro").items():
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(LM_SEED))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            res["params/" + name + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)
        toks = jnp.asarray(lm_tokens(cfg.vocab, (LM_B, LM_S), LM_SEED))
        batch = {"tokens": toks, "labels": toks}
        res[f"forward/{name}"] = np.asarray(m.forward(params, batch)[0])
        res[f"prefill/{name}"] = np.asarray(m.prefill(params, batch))
        if name == "smoke":
            odd = jnp.asarray(lm_tokens(cfg.vocab, (LM_B, LM_S_ODD), LM_SEED))
            res[f"prefill_s{LM_S_ODD}/{name}"] = np.asarray(
                m.prefill(params, {"tokens": odd, "labels": odd}))
        plain = build_model(dataclasses.replace(cfg, use_flash_kernel=False))
        res[f"forward_sdpa/{name}"] = np.asarray(plain.forward(params, batch)[0])
        if cfg.activation_dtype != "float32":
            continue
        cache = m.init_cache(LM_B, LM_S, jnp.float32)
        dec = jax.jit(m.decode)
        steps = []
        for t in range(LM_S):
            lg, cache = dec(params, cache, {"tokens": toks[:, t:t + 1],
                                            "cur": jnp.asarray(t, jnp.int32)})
            steps.append(np.asarray(lg[:, 0]))
        res[f"decode/{name}"] = np.stack(steps)
        prompts = jnp.asarray(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 1))
        res[f"greedy/{name}"] = np.asarray(greedy_decode(
            m, params, prompts, GREEDY_NEW, GREEDY_P + GREEDY_NEW + 1))
    for sname, shape in (("prefill", ShapeSpec("t", LM_S, LM_B, "prefill")),
                         ("decode", SHAPES["decode_32k"])):
        b = concrete_batch(lm_configs("repro")["smoke"], shape,
                           batch_override=3, seed=LM_SEED)
        for key, val in b.items():
            res[f"batch/{sname}/{key}"] = np.asarray(val)
    return res


# ------------------------------------------- checkpoints across packages
# The checkpoint recipes work in the directory of their output: they
# write the JAX package's checkpoints there and read those the torch
# package wrote there before the recipe ran.

CKPT_STEP = 3


def ckpt_tree() -> dict[str, np.ndarray]:
    """The leaves of the cross-package checkpoint, as f32 values: an f32
    state, a bf16 and an fp8 leaf (rounded by each package's own
    conversion, so the values are chosen exact in both) and an int32
    cursor."""
    rng = np.random.default_rng(31)
    return {"state": rng.normal(size=(4, 6, 8)).astype(np.float32),
            "params/w": (rng.integers(-64, 64, size=(5, 7)) / 8).astype(np.float32),
            "params/e4": (rng.integers(-16, 16, size=(9,)) / 4).astype(np.float32),
            "cursor": np.arange(6, dtype=np.int32)}


CKPT_META = {"step": CKPT_STEP, "note": "cross-package", "bounds": [-1.5, 2.0]}
CKPT_DTYPES = {"params/w": "bfloat16", "params/e4": "float8_e4m3fn"}


def _recipe_ckpt() -> dict[str, np.ndarray]:
    """The JAX package writes ``jax_ckpt`` and reads ``port_ckpt``."""
    import json

    import jax.numpy as jnp

    from repro.checkpoint import ckpt

    work = Path(sys.argv[2]).parent
    leaves = ckpt_tree()
    tree = {"params": {}}
    for key, v in leaves.items():
        a = jnp.asarray(v).astype(CKPT_DTYPES[key]) if key in CKPT_DTYPES \
            else jnp.asarray(v)
        node = tree["params"] if key.startswith("params/") else tree
        node[key.split("/")[-1]] = a
    ckpt.save(str(work / "jax_ckpt"), CKPT_STEP, tree, meta=CKPT_META)
    got, meta = ckpt.restore(str(work / "port_ckpt"))
    res = {"port_meta": np.array(json.dumps(meta, sort_keys=True))}
    for key in leaves:
        node = got["params"] if key.startswith("params/") else got
        v = np.asarray(node[key.split("/")[-1]])
        res[f"port/{key}/dtype"] = np.array(str(v.dtype))
        res[f"port/{key}"] = v.astype(np.float32)
    return res


# (rule, interval, steps, kill step, the resuming pipeline's ordering, T, S)
# of the runs killed in one package and resumed in the other, resident M=8
XRUN_M, XRUN_SEED = 8, 12
XRUN_CASES = (("gol", 4, 10, 5, "hilbert", 8, 2),
              ("jacobi", 4, 10, 6, "hilbert", 8, 1),
              ("wave", 3, 9, 5, "row_major", 4, 1))


def _recipe_xrun() -> dict[str, np.ndarray]:
    """For each case: the JAX package's uninterrupted run, its run killed
    in ``jax_kill/<rule>`` (Morton, T=4, S=1), and its resume of the
    torch package's killed run in ``port_kill/<rule>`` on another
    ordering/T/S."""
    import jax.numpy as jnp

    from repro.launch.faults import FaultPlan, SimulatedCrash, initial_state
    from repro.stencil import CheckpointedRun, ResidentPipeline

    work = Path(sys.argv[2]).parent
    res = {}
    for rule, interval, steps, kill, kind, T, S in XRUN_CASES:
        state0 = initial_state(rule, XRUN_M, seed=XRUN_SEED)
        first = ResidentPipeline(M=XRUN_M, T=4, S=1, rule=rule, kind="morton")
        res[f"plain/{rule}"] = np.asarray(first.run(jnp.asarray(state0), steps))
        try:
            CheckpointedRun(first, str(work / "jax_kill" / rule),
                            interval=interval,
                            hooks=FaultPlan(kill_at_step=kill,
                                            kill_mode="raise").hooks()
                            ).run(state0, steps)
        except SimulatedCrash:
            pass
        then = ResidentPipeline(M=XRUN_M, T=T, S=S, rule=rule, kind=kind)
        res[f"resumed/{rule}"] = CheckpointedRun(
            then, str(work / "port_kill" / rule), interval=interval
        ).run(state0, steps)
    return res


# the stencil serving CLI on the CPU at M=16 with --faults: one query at a
# time under each ordering (sequential, so every count is deterministic),
# and the 12-query batch with room for every query in flight and a long
# deadline (no query shed or timed out; which queries absorb the injected
# faults depends on the pool's interleaving, in either package)
SERVE_CLI_CASES = tuple(
    ("--M", "16", "--T", "4", "--ordering", kind, "--queries", str(n), "--faults",
     "--seed", str(seed))
    for kind, n, seed in (("hilbert", 1, 0), ("row_major", 1, 0),
                          ("morton", 1, 1), ("column_major", 1, 2))
) + (("--M", "16", "--T", "4", "--faults", "--max-in-flight", "12",
      "--deadline-ms", "60000"),)


def _recipe_serve_cli() -> dict[str, np.ndarray]:
    """The JAX package's ``launch.serve --stencil`` on each of
    :data:`SERVE_CLI_CASES`: its standard output, by case number."""
    import contextlib
    import io

    from repro.launch import serve

    res = {}
    for n, args in enumerate(SERVE_CLI_CASES):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve.stencil_main(serve.build_parser().parse_args(["--stencil", *args]))
        res[f"stdout/{n}"] = np.array(out.getvalue())
    return res


# ------------------------------------------------------------ training
# The training slice on the CPU, f32 activations throughout: the seeded
# inputs and configurations that tests/test_torch_train.py hands to both
# packages, and the recipe that runs the JAX package's side.

TRAIN_SEED = 9
# ops.flash_attention's gradients: (S, GQA rep, causal) at B=2, Hkv=2,
# D=16, 128-blocks halved until they divide S (S=100 takes one block)
FLASH_GRAD_CASES = tuple((S, rep, causal) for S in (32, 100) for rep in (1, 2)
                         for causal in (True, False))
# loss_fn and its gradients: (config of lm_configs, S, with a loss_mask) at
# B=2; S=1024 takes the chunked cross-entropy, S=32 the full logits
LOSS_CASES = tuple((name, S, masked) for name in ("smoke", "tiny")
                   for S in (1024, 32) for masked in (False, True))
LOSS_B = 2
# one adamw_update: (opt_state step, gradient scale): clipped at step 0,
# unclipped in the warmup's cosine, past total_steps
ADAMW_CASES = ((0, 10.0), (3, 0.01), (12, 1.0))
ADAMW_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# three make_train_step steps of the tiny config (flash path on)
STEP_PIPE = dict(batch=4, seq=32, seed=3)
STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_STEPS = 3
# TokenPipeline.batch_at: (seed, step) at vocab 512, batch 3, seq 40
PIPE_CASES = ((0, 0), (1, 7), (5, 123))
PIPE_SHAPE = dict(vocab=512, batch=3, seq=40)
# the Trainers killed at TRAINER_KILL and resumed to TRAINER_STEPS (the
# model of tests/test_checkpoint.py with the flash path on)
TRAINER_CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab=128, activation_dtype="float32",
                   use_flash_kernel=True)
TRAINER_PIPE = dict(vocab=128, batch=4, seq=16, seed=0)
TRAINER_OPT = dict(warmup_steps=2, total_steps=6)
TRAINER_KILL, TRAINER_STEPS = 3, 6


def flash_grad_inputs(case) -> tuple[np.ndarray, ...]:
    """q (2, 2·rep, S, 16), k and v (2, 2, S, 16) and the output's
    cotangent, f32 normals."""
    S, rep, causal = case
    rng = np.random.default_rng(S + 10 * rep + int(causal))
    return (rng.normal(size=(2, 2 * rep, S, 16)).astype(np.float32),
            rng.normal(size=(2, 2, S, 16)).astype(np.float32),
            rng.normal(size=(2, 2, S, 16)).astype(np.float32),
            rng.normal(size=(2, 2 * rep, S, 16)).astype(np.float32))


def loss_batch(vocab: int, S: int, masked: bool) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(S + int(masked))
    b = {"tokens": rng.integers(0, vocab, (LOSS_B, S), dtype=np.int32),
         "labels": rng.integers(0, vocab, (LOSS_B, S), dtype=np.int32)}
    if masked:
        b["loss_mask"] = (rng.random((LOSS_B, S)) < 0.7).astype(np.float32)
    return b


def adamw_inputs(case):
    """(params, grads, opt_state) as numpy trees: matrices, a stacked norm
    and a vector (decayed by ndim >= 2, as the JAX package decays)."""
    step, scale = case
    rng = np.random.default_rng(100 + step)
    shapes = {"w": (6, 5), "layers": {"norm": (2, 5), "wq": (2, 5, 4)},
              "bias": (7,)}

    def draw(f):
        return {k: {kk: f(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else f(v) for k, v in shapes.items()}

    normal = lambda shp: rng.normal(size=shp).astype(np.float32)
    params = draw(normal)
    grads = draw(lambda shp: (scale * rng.normal(size=shp)).astype(np.float32))
    m = draw(lambda shp: (0.1 * rng.normal(size=shp)).astype(np.float32))
    v = draw(lambda shp: (0.01 * rng.random(size=shp)).astype(np.float32))
    return params, grads, {"m": m, "v": v, "step": np.asarray(step, np.int32)}


def put_tree(res: dict, prefix: str, tree) -> None:
    """Every leaf of a JAX or numpy tree into ``res`` under
    ``prefix/<path>``."""
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)


def _recipe_train() -> dict[str, np.ndarray]:
    """The JAX package's training slice: flash_attention's gradients, loss_fn
    and its gradients, one adamw_update, three train steps, the token
    pipeline, and Trainers that write and resume checkpoints in the
    recipe's directory (the torch package's killed run is in
    ``port_kill`` before the recipe runs)."""
    import jax
    import jax.numpy as jnp

    from repro.data import TokenPipeline
    from repro.kernels import ops
    from repro.models import build_model
    from repro.models.config import ModelConfig
    from repro.train import OptConfig, TrainConfig, Trainer, TrainerConfig
    from repro.train.optimizer import adamw_update, init_opt_state
    from repro.train.train_step import make_train_step

    work = Path(sys.argv[2]).parent
    res = {}
    for case in FLASH_GRAD_CASES:
        q, k, v, g = (jnp.asarray(a) for a in flash_grad_inputs(case))
        o, vjp = jax.vjp(lambda q, k, v: ops.flash_attention(
            q, k, v, case[2], "morton", 128, 128), q, k, v)
        res[f"flash/{case}/o"] = np.asarray(o)
        for name, d in zip("qkv", vjp(g)):
            res[f"flash/{case}/d{name}"] = np.asarray(d)
    cfgs = lm_configs("repro")
    for name in ("smoke", "tiny"):
        m = build_model(cfgs[name])
        params = m.init(jax.random.PRNGKey(TRAIN_SEED))
        put_tree(res, f"params/{name}", params)
        grad_fn = jax.value_and_grad(
            lambda p, b: m.loss(p, b, remat=True)[0])
        for case in LOSS_CASES:
            if case[0] != name:
                continue
            batch = {k: jnp.asarray(a)
                     for k, a in loss_batch(cfgs[name].vocab, *case[1:]).items()}
            loss, grads = grad_fn(params, batch)
            res[f"loss/{case}/loss"] = np.asarray(loss)
            put_tree(res, f"loss/{case}/grads", grads)
    for case in ADAMW_CASES:
        params, grads, state = adamw_inputs(case)
        p2, s2, om = adamw_update(params, grads, state, OptConfig(**ADAMW_OPT))
        put_tree(res, f"adamw/{case}/params", p2)
        put_tree(res, f"adamw/{case}/state", s2)
        res[f"adamw/{case}/lr"] = np.asarray(om["lr"])
        res[f"adamw/{case}/grad_norm"] = np.asarray(om["grad_norm"])
    tiny = cfgs["tiny"]
    m = build_model(tiny)
    params = m.init(jax.random.PRNGKey(TRAIN_SEED))
    opt = init_opt_state(params)
    step = jax.jit(make_train_step(m, TrainConfig(opt=OptConfig(**STEP_OPT))))
    pipe = TokenPipeline(vocab=tiny.vocab, **STEP_PIPE)
    for i in range(TRAIN_STEPS):
        batch = {k: jnp.asarray(a) for k, a in pipe.batch_at(i).items()}
        params, opt, metrics = step(params, opt, batch)
        res[f"steps/{i}/loss"] = np.asarray(metrics["loss"])
        put_tree(res, f"steps/{i}/params", params)
    for seed, st in PIPE_CASES:
        for k, a in TokenPipeline(seed=seed, **PIPE_SHAPE).batch_at(st).items():
            res[f"pipe/{seed}/{st}/{k}"] = a
    cfg = ModelConfig(**TRAINER_CFG)
    model = build_model(cfg)
    pipe = TokenPipeline(**TRAINER_PIPE)

    def trainer(steps, where):
        return Trainer(model, pipe, TrainerConfig(
            total_steps=steps, ckpt_every=TRAINER_KILL, ckpt_dir=str(work / where),
            log_every=100, train=TrainConfig(opt=OptConfig(**TRAINER_OPT))))

    p_full, _, _ = trainer(TRAINER_STEPS, "jax_full").run(resume=False)
    put_tree(res, "trainer/jax_full", p_full)
    trainer(TRAINER_KILL, "jax_kill").run(resume=False)
    p_res, _, _ = trainer(TRAINER_STEPS, "port_kill").run(resume=True)
    put_tree(res, "trainer/port_resumed", p_res)
    return res


# ----------------------------------------------- flash attention's backward
# tests/test_torch_flash_bwd.py: jax.vjp of the JAX package's
# ops.flash_attention (its Pallas forward in interpret mode, its backward
# _fa_bwd, the dense oracle's vjp) at (B, Hkv, GQA rep, Sq, Sk, D, causal,
# dtype), 16-blocks; Sq > Sk with the causal mask leaves rows with no key
FLASH_BWD_CASES = (
    (2, 2, 1, 32, 32, 64, True, "float32"),
    (1, 2, 3, 32, 32, 40, True, "float32"),
    (1, 1, 3, 32, 48, 128, True, "float32"),
    (1, 2, 1, 48, 32, 64, True, "float32"),
    (1, 1, 3, 48, 16, 40, True, "float32"),
    (2, 1, 3, 32, 48, 64, False, "float32"),
    (1, 2, 1, 32, 32, 40, False, "float32"),
    (1, 1, 1, 48, 32, 128, False, "float32"),
    (1, 2, 3, 32, 32, 64, True, "bfloat16"),
    (1, 1, 1, 48, 32, 128, True, "bfloat16"),
    (1, 1, 3, 32, 48, 40, False, "bfloat16"),
)


def flash_bwd_inputs(case) -> tuple[np.ndarray, ...]:
    """q (B, Hkv·rep, Sq, D), k and v (B, Hkv, Sk, D) and the output's
    cotangent, f32 normals (each side rounds them to the case's dtype)."""
    B, hkv, rep, sq, sk, D, causal, _ = case
    rng = np.random.default_rng(sq + 3 * sk + 7 * D + 11 * rep + int(causal))
    return (rng.normal(size=(B, hkv * rep, sq, D)).astype(np.float32),
            rng.normal(size=(B, hkv, sk, D)).astype(np.float32),
            rng.normal(size=(B, hkv, sk, D)).astype(np.float32),
            rng.normal(size=(B, hkv * rep, sq, D)).astype(np.float32))


def _recipe_flash_bwd() -> dict[str, np.ndarray]:
    """dq, dk and dv of every FLASH_BWD_CASES case (as f32); where rows
    have no key, also those of the rows that have one alone (the last Sk
    rows: the JAX vjp is NaN wherever an empty row reaches)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops

    res = {}
    for case in FLASH_BWD_CASES:
        sq, sk, causal = case[3], case[4], case[6]
        q, k, v, g = (jnp.asarray(a).astype(getattr(jnp, case[-1]))
                      for a in flash_bwd_inputs(case))

        def grads(q, g):
            _, vjp = jax.vjp(lambda q, k, v: ops.flash_attention(
                q, k, v, causal, "morton", 16, 16), q, k, v)
            return [np.asarray(d.astype(jnp.float32)) for d in vjp(g)]

        for name, d in zip("qkv", grads(q, g)):
            res[f"{case}/d{name}"] = d
        if causal and sq > sk:
            for name, d in zip("qkv", grads(q[:, :, sq - sk:], g[:, :, sq - sk:])):
                res[f"{case}/keyed/d{name}"] = d
    return res


# ----------------------------------------- the other decoder LMs
# The dense archs (gemma3-1b, deepseek-coder-33b, phi4-mini-3.8b) with
# temperature sampling, and the moe archs (MoE and MLA), at their SMOKE
# sizes (f32 activations) with the flash kernel's path on, as the card
# serves them. Each recipe writes every arch's JAX parameter tree, which
# crosses by ``interop.lm_params_from_numpy``.

DENSE_ARCHS = ("gemma3-1b", "deepseek-coder-33b", "phi4-mini-3.8b")
MOE_ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
# sampled decode: prompts of GREEDY_P, GREEDY_NEW tokens at each
# temperature, the step's key jax.random.fold_in(PRNGKey(SAMPLE_SEED), t)
SAMPLE_TEMPS = (0.7, 1.3)
SAMPLE_SEED = 11
# a capacity factor at which the SMOKE MoE layer drops assignments:
# C = ceil(16·2/8·0.5) = 2 places per expert for 32 assignments a row
MOE_DROP_CF = 0.5
MOE_X_SEED = 13
# the ssm and hybrid archs, and the encdec and vlm archs
SSM_ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
ENCDEC_ARCHS = ("whisper-small", "internvl2-76b")
FRONTEND_SEED = 17
# the SSD scan alone: (T, chunk) at B=1, H=4, P=8, G=2, N=16; 256 is the
# production chunk, where the JAX package's gradient is non-finite (its
# finite twin is taken at SSD_GRAD_CHUNK: the scan's value does not depend
# on the chunk)
SSD_CASES = ((32, 8), (512, 256))
SSD_GRAD_CHUNK = 32
SSD_SEED = 19
# draws of each custom init, to compare the two packages' distributions
INIT_DRAWS = 20000
# concrete_batch of the frontends: (seq_len, batch, seed)
FRONTEND_BATCH = (16, 3, LM_SEED)


def arch_configs(pkg: str, archs) -> dict:
    """SMOKE of each arch from package ``pkg``'s registry, flash path on."""
    import dataclasses
    import importlib

    reg = importlib.import_module(f"{pkg}.configs.registry")
    return {a: dataclasses.replace(reg.get_smoke(a), use_flash_kernel=True)
            for a in archs}


def tree_of(ref: dict, prefix: str) -> dict:
    """The tree of nested dicts that ``put_tree`` wrote under ``prefix``."""
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


def moe_input(cfg) -> np.ndarray:
    """(LM_B, LM_S, d_model) f32 normals: the input of one MoE layer."""
    rng = np.random.default_rng(MOE_X_SEED)
    return rng.normal(size=(LM_B, LM_S, cfg.d_model)).astype(np.float32)


def frontend_inputs(cfg, B: int = LM_B) -> dict[str, np.ndarray]:
    """The stubbed frontends' f32 inputs of a batch of B: an encdec
    model's frames (B, n_frames, d_model), a vlm's patches (B, n_patches,
    vit_dim); nothing for the other families."""
    rng = np.random.default_rng(FRONTEND_SEED)
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(B, cfg.encdec.n_frames, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(B, cfg.vlm.n_patches, cfg.vlm.vit_dim))
                .astype(np.float32)}
    return {}


def _lm_common(res: dict, arch: str, cfg, m, params, cross=None) -> None:
    """Parameters, forward, prefill, decode steps and greedy tokens of one
    arch under ``arch/``; the batch carries ``frontend_inputs``, and
    ``cross`` (an encdec model's (k, v) from ``_enc_kv_all``) fills the
    decode steps' cross cache (greedy decode runs on the zero cache, as
    the JAX package's ``greedy_decode`` does)."""
    import jax
    import jax.numpy as jnp

    from repro.serve import greedy_decode

    put_tree(res, f"params/{arch}", params)
    toks = jnp.asarray(lm_tokens(cfg.vocab, (LM_B, LM_S), LM_SEED))
    batch = {"tokens": toks, "labels": toks,
             **{k: jnp.asarray(a) for k, a in frontend_inputs(cfg).items()}}
    logits, aux = m.forward(params, batch)
    res[f"forward/{arch}"] = np.asarray(logits)
    res[f"forward_aux/{arch}"] = np.asarray(aux)
    res[f"prefill/{arch}"] = np.asarray(m.prefill(params, batch))
    cache = m.init_cache(LM_B, LM_S, jnp.float32)
    if cross is not None:
        cache["cross"] = {"k": cross[0], "v": cross[1]}
    dec = jax.jit(m.decode)
    steps = []
    for t in range(LM_S):
        lg, cache = dec(params, cache, {"tokens": toks[:, t:t + 1],
                                        "cur": jnp.asarray(t, jnp.int32)})
        steps.append(np.asarray(lg[:, 0]))
    res[f"decode/{arch}"] = np.stack(steps)
    prompts = jnp.asarray(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 1))
    res[f"greedy/{arch}"] = np.asarray(greedy_decode(
        m, params, prompts, GREEDY_NEW, GREEDY_P + GREEDY_NEW + 1))


def _recipe_lm_archs() -> dict[str, np.ndarray]:
    """The dense archs: full-width parameter counts; SMOKE parameters,
    forward, prefill, decode, greedy tokens; a sampled decode at each of
    SAMPLE_TEMPS through ``make_serve_step(sample=True)`` with the Gumbel
    noise ``jax.random.categorical`` draws from each step's key; one
    ``make_train_step`` step."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.data import TokenPipeline
    from repro.models import build_model
    from repro.serve import make_serve_step
    from repro.train import OptConfig, TrainConfig
    from repro.train.optimizer import init_opt_state
    from repro.train.train_step import make_train_step

    res = {}
    for arch, cfg in arch_configs("repro", DENSE_ARCHS).items():
        res[f"n_params/{arch}"] = np.asarray(build_model(get_config(arch)).n_params())
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(LM_SEED))
        _lm_common(res, arch, cfg, m, params)
        step = jax.jit(lambda p, c, b, temp: make_serve_step(
            m, sample=True, temperature=temp)(p, c, b))
        prompts = jnp.asarray(lm_tokens(cfg.vocab, (LM_B, GREEDY_P), LM_SEED + 2))
        for temp in SAMPLE_TEMPS:
            cache = m.init_cache(LM_B, GREEDY_P + GREEDY_NEW, jnp.float32)
            tok, noise, out = prompts[:, :1], [], []
            for t in range(GREEDY_P + GREEDY_NEW - 1):
                key = jax.random.fold_in(jax.random.PRNGKey(SAMPLE_SEED), t)
                noise.append(np.asarray(jax.random.gumbel(
                    key, (LM_B, cfg.vocab_padded), jnp.float32)))
                nxt, cache = step(params, cache, {
                    "tokens": tok, "cur": jnp.asarray(t, jnp.int32), "rng": key},
                    temp)
                tok = prompts[:, t + 1:t + 2] if t + 1 < GREEDY_P else nxt[:, None]
                out.append(np.asarray(nxt))
            res[f"sample/{arch}/{temp}/gumbel"] = np.stack(noise)
            res[f"sample/{arch}/{temp}/tokens"] = np.stack(out, axis=1)
        tstep = make_train_step(m, TrainConfig(opt=OptConfig(**STEP_OPT)))
        b = {k: jnp.asarray(a) for k, a in
             TokenPipeline(vocab=cfg.vocab, **STEP_PIPE).batch_at(0).items()}
        p1, _, metrics = tstep(params, init_opt_state(params), b)
        res[f"train/{arch}/loss"] = np.asarray(metrics["loss"])
        res[f"train/{arch}/grad_norm"] = np.asarray(metrics["grad_norm"])
        put_tree(res, f"train/{arch}/params", p1)
    return res


def _recipe_lm_moe() -> dict[str, np.ndarray]:
    """The moe archs: full-width parameter and active-parameter counts;
    SMOKE parameters, forward (with its aux loss), prefill, decode, greedy
    tokens; ``loss_fn``'s ce and aux and its gradients; one MoE layer at
    capacity factor MOE_DROP_CF (its output, aux and dropped count)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models import build_model
    from repro.models import moe as jmoe

    res = {}
    for arch, cfg in arch_configs("repro", MOE_ARCHS).items():
        full = build_model(get_config(arch))
        res[f"n_params/{arch}"] = np.asarray(full.n_params())
        res[f"n_active/{arch}"] = np.asarray(full.n_active_params())
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(LM_SEED))
        _lm_common(res, arch, cfg, m, params)
        batch = {k: jnp.asarray(a) for k, a in
                 loss_batch(cfg.vocab, 32, False).items()}
        (loss, (ce, aux)), grads = jax.value_and_grad(
            lambda p: m.loss(p, batch, remat=True), has_aux=True)(params)
        res[f"loss/{arch}/ce"] = np.asarray(ce)
        res[f"loss/{arch}/aux"] = np.asarray(aux)
        put_tree(res, f"grads/{arch}", grads)
        drop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_DROP_CF))
        p0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        x = jnp.asarray(moe_input(cfg))
        out, aux = jmoe.moe_ffn(p0, x, drop)
        res[f"moe_drop/{arch}/out"] = np.asarray(out)
        res[f"moe_drop/{arch}/aux"] = np.asarray(aux)
        mo = drop.moe
        C = max(int(np.ceil(LM_S * mo.top_k / mo.n_routed * mo.capacity_factor)), 1)
        logits = jnp.einsum("bsd,de->bse", x, p0["router"])
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), mo.top_k)
        keep = jax.vmap(lambda xr, ir: jmoe._dispatch_row(
            xr, None, ir, mo.n_routed, mo.top_k, C)[1][4])(x, ids)
        res[f"moe_drop/{arch}/dropped"] = np.asarray((~keep).sum())
        res[f"moe_drop/{arch}/C"] = np.asarray(C)
    return res


def ssd_inputs(T: int, seed: int = SSD_SEED):
    """x (1,T,4,8), dt (1,T,4), A (4,), Bm and Cm (1,T,2,16), f32, with the
    inits' ranges: A = −U[1, 16] and dt log-uniform in [1e-3, 1e-1]; the
    last head at the extremes (A = −16, dt = 0.1: −dt·A = 1.6 a step, so
    ``exp`` overflows within a 256-token chunk)."""
    rng = np.random.default_rng(seed + T)
    H, P, G, N = 4, 8, 2, 16
    A = -rng.uniform(1.0, 16.0, H).astype(np.float32)
    A[-1] = -16.0
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (1, T, H))).astype(np.float32)
    dt[..., -1] = 0.1
    x = rng.normal(size=(1, T, H, P)).astype(np.float32)
    Bm = rng.normal(size=(1, T, G, N)).astype(np.float32)
    Cm = rng.normal(size=(1, T, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def ssd_cotangent(T: int) -> np.ndarray:
    """The weights g of the scalar sum(y·g) whose gradient is compared."""
    return np.random.default_rng(SSD_SEED * 1000 + T).normal(size=(1, T, 4, 8)).astype(np.float32)


def mamba_layer_inputs(cfg):
    """One Mamba2 layer's inputs: x (LM_B, LM_S, D), and a decode step's x
    (LM_B, 1, D) and cache {conv, ssm}, f32 normals."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    H = d_inner // ssm.head_dim
    rng = np.random.default_rng(MOE_X_SEED + 1)
    f = lambda *shp: rng.normal(size=shp).astype(np.float32)
    return (f(LM_B, LM_S, cfg.d_model), f(LM_B, 1, cfg.d_model),
            {"conv": f(LM_B, ssm.conv_width - 1, d_inner + 2 * ssm.n_groups * ssm.d_state),
             "ssm": f(LM_B, H, ssm.head_dim, ssm.d_state)})


def _recipe_lm_ssm() -> dict[str, np.ndarray]:
    """The ssm and hybrid archs: full-width parameter counts and shared-
    block applications; SMOKE parameters, forward, prefill, decode, greedy
    tokens, ``loss_fn``'s ce and gradients; one Mamba2 layer (block and a
    decode step); the SSD scan and its decode step on SSD_CASES, the scan's
    gradient at chunk 256 and at SSD_GRAD_CHUNK; the custom inits' draws."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models import build_model
    from repro.models import mamba2 as jm
    from repro.models import params as jparams
    from repro.models import transformer as jt

    res = {}
    for arch, cfg in arch_configs("repro", SSM_ARCHS).items():
        full = get_config(arch)
        res[f"n_params/{arch}"] = np.asarray(build_model(full).n_params())
        if cfg.family == "hybrid":
            res[f"n_apps/{arch}"] = np.asarray([jt._n_shared_apps(full),
                                                jt._n_shared_apps(cfg)])
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(LM_SEED))
        _lm_common(res, arch, cfg, m, params)
        batch = {k: jnp.asarray(a) for k, a in loss_batch(cfg.vocab, 32, False).items()}
        (_, (ce, _)), grads = jax.jit(jax.value_and_grad(
            lambda p, b: m.loss(p, b, remat=True), has_aux=True))(params, batch)
        res[f"loss/{arch}/ce"] = np.asarray(ce)
        put_tree(res, f"grads/{arch}", grads)
        p0 = jax.tree.map(lambda a: a[0], params["layers"])
        x, x1, cache = mamba_layer_inputs(cfg)
        res[f"block/{arch}"] = np.asarray(jm.mamba2_block(p0, jnp.asarray(x), cfg))
        out, new = jm.mamba2_decode(p0, jnp.asarray(x1),
                                    jax.tree.map(jnp.asarray, cache), cfg)
        res[f"block_decode/{arch}/out"] = np.asarray(out)
        put_tree(res, f"block_decode/{arch}/cache", new)
    for T, chunk in SSD_CASES:
        x, dt, A, Bm, Cm = (jnp.asarray(a) for a in ssd_inputs(T))
        res[f"ssd/{T}/{chunk}"] = np.asarray(jax.jit(
            jm.ssd_chunked, static_argnums=5)(x, dt, A, Bm, Cm, chunk))
        g = jnp.asarray(ssd_cotangent(T))
        for ck in (chunk, SSD_GRAD_CHUNK):
            grads = jax.jit(jax.grad(lambda *a: jnp.sum(jm.ssd_chunked(*a, ck) * g),
                                     argnums=(0, 1, 2, 3, 4)))(x, dt, A, Bm, Cm)
            for name, gr in zip(("x", "dt", "A", "Bm", "Cm"), grads):
                res[f"ssd_grad/{T}/{ck}/{name}"] = np.asarray(gr)
        h = jnp.asarray(np.random.default_rng(T).normal(size=(1, 4, 8, 16))
                        .astype(np.float32))
        y, h_new = jm.ssd_decode_step(h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        res[f"ssd_step/{T}/y"] = np.asarray(y)
        res[f"ssd_step/{T}/h"] = np.asarray(h_new)
    for name in ("a_log", "dt_bias"):
        res[f"init/{name}"] = np.asarray(jparams._custom_init(
            name, (INIT_DRAWS,), jax.random.PRNGKey(LM_SEED)))
    return res


def _recipe_lm_encdec() -> dict[str, np.ndarray]:
    """The encdec and vlm archs: full-width parameter counts; SMOKE
    parameters, forward, prefill, decode (whisper's with the cross cache
    from ``_enc_kv_all`` of the batch's frames), greedy tokens,
    ``loss_fn``'s ce and gradients; ``concrete_batch`` at
    FRONTEND_BATCH."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import ShapeSpec, concrete_batch, get_config
    from repro.models import build_model
    from repro.models import transformer as jt

    res = {}
    for arch, cfg in arch_configs("repro", ENCDEC_ARCHS).items():
        res[f"n_params/{arch}"] = np.asarray(build_model(get_config(arch)).n_params())
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(LM_SEED))
        cross = None
        if cfg.family == "encdec":
            frames = jnp.asarray(frontend_inputs(cfg)["frames"])
            cross = jt._enc_kv_all(params, jt._encode(params, frames, cfg, False), cfg)
            res[f"cross/{arch}/k"] = np.asarray(cross[0])
        _lm_common(res, arch, cfg, m, params, cross)
        batch = {k: jnp.asarray(a) for k, a in
                 {**loss_batch(cfg.vocab, 32, False),
                  **frontend_inputs(cfg, LOSS_B)}.items()}
        (_, (ce, _)), grads = jax.jit(jax.value_and_grad(
            lambda p, b: m.loss(p, b, remat=True), has_aux=True))(params, batch)
        res[f"loss/{arch}/ce"] = np.asarray(ce)
        put_tree(res, f"grads/{arch}", grads)
        S, B, seed = FRONTEND_BATCH
        b = concrete_batch(cfg, ShapeSpec("t", S, B, "prefill"), seed=seed)
        for key, val in b.items():
            res[f"batch/{arch}/{key}"] = np.asarray(val)
    return res


# ------------------------------------------------------- the device mesh

# the meshes sanitize_specs is held on, as axis sizes (the JAX function
# reads only mesh.shape)
SHARD_MESHES = {"16x16": {"data": 16, "model": 16},
                "2x16x16": {"pod": 2, "data": 16, "model": 16},
                "4x2": {"data": 4, "model": 2}, "2x2": {"data": 2, "model": 2}}
# the dry run's decode cache rules (repro.launch.dryrun, decode): B >= 8
# splits the batch over the batch axes and the sequence over "model"; B=1
# splits the sequence over ("data", "model")
DECODE_RULES = {"b8": (8, 64, {"batch": "data", "seq": "model",
                               "kv_heads": None, "heads": None}),
                "b1": (1, 64, {"batch": None, "seq": ("data", "model"),
                               "kv_heads": None, "heads": None})}
HILBERT_NS = tuple(2 ** i for i in range(10))
TORUS_SHAPE, TORUS_SEED = (4, 4, 4), 5
SHARD_STEPS = 3
SHARD_TIMEOUT_S = 300  # 8 gloo ranks take about a minute alone, more beside other tests


class TorusDevice:
    """A device with torus ``coords``, as a TPU device has them."""

    def __init__(self, id_: int, coords):
        self.id, self.coords = id_, coords


def torus_devices() -> list:
    """The devices of a 4x4x4 torus, ids in coordinate order, shuffled."""
    n = int(np.prod(TORUS_SHAPE))
    devs = [TorusDevice(i, tuple(int(c) for c in np.unravel_index(i, TORUS_SHAPE)))
            for i in range(n)]
    return [devs[i] for i in np.random.default_rng(TORUS_SEED).permutation(n)]


def spec_code(spec) -> str:
    """A partition spec (JAX's or the port's) as JSON, read as a tuple."""
    return json.dumps([list(a) if isinstance(a, tuple) else a for a in tuple(spec)])


def put_specs(res: dict, prefix: str, tree) -> None:
    """Every spec of a nested-dict spec tree into ``res`` as JSON."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            put_specs(res, f"{prefix}/{k}", v)
        else:
            res[f"{prefix}/{k}"] = np.asarray(spec_code(v))


def _recipe_sharding() -> dict[str, np.ndarray]:
    """The JAX package's sharding pieces, on 512 host devices: every arch's
    partition specs and decode cache specs, ``sanitize_specs`` over
    :data:`SHARD_MESHES`, the Hilbert device order, the production meshes,
    and three single-device train steps of the elastic configuration from
    its initial weights (which it exports)."""
    import dataclasses
    import types

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.configs.registry import ARCHS
    from repro.data import TokenPipeline
    from repro.launch.dryrun import sanitize_specs
    from repro.launch.mesh import (batch_axes, hilbert_device_permutation,
                                   make_production_mesh)
    from repro.models import build_model
    from repro.train import OptConfig, TrainConfig, make_train_step
    from repro.train.optimizer import init_opt_state

    res = {}
    for arch in ARCHS:
        m = build_model(get_config(arch))
        specs, abst = m.specs(), m.abstract()
        put_specs(res, f"specs/{arch}", specs)
        for mesh_name, sizes in SHARD_MESHES.items():
            mesh = types.SimpleNamespace(shape=sizes)
            put_specs(res, f"sanitized/{arch}/{mesh_name}",
                      sanitize_specs(mesh, specs, abst))
        for case, (B, S, rules) in DECODE_RULES.items():
            cs = m.cache_specs(B, S, extra_rules=rules)
            put_specs(res, f"cache/{arch}/{case}", cs)
            mesh = types.SimpleNamespace(shape=SHARD_MESHES["16x16"])
            put_specs(res, f"cache_sanitized/{arch}/{case}",
                      sanitize_specs(mesh, cs, m.abstract_cache(B, S)))
    for n in HILBERT_NS:
        res[f"hilbert/{n}"] = np.asarray(hilbert_device_permutation(list(range(n))))
    res["hilbert/torus"] = np.asarray([d.id for d in hilbert_device_permutation(
        torus_devices())])
    for name, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        res[f"mesh/{name}/ids"] = np.vectorize(lambda d: d.id)(mesh.devices)
        res[f"mesh/{name}/names"] = np.asarray(json.dumps(list(mesh.axis_names)))
        res[f"mesh/{name}/batch_axes"] = np.asarray(json.dumps(list(batch_axes(mesh))))
    cfg = dataclasses.replace(get_config("smollm-360m"), **elastic_cfg())
    m = build_model(cfg)
    params = m.init(jax.random.PRNGKey(0))
    put_tree(res, "init", params)
    opt = init_opt_state(params)
    step = jax.jit(make_train_step(m, TrainConfig(opt=OptConfig(**elastic_opt()))))
    pipe = TokenPipeline(vocab=cfg.vocab, **elastic_pipe())
    for i in range(SHARD_STEPS):
        batch = {k: jnp.asarray(a) for k, a in pipe.batch_at(i).items()}
        params, opt, metrics = step(params, opt, batch)
        res[f"steps/{i}/loss"] = np.asarray(metrics["loss"])
        res[f"steps/{i}/grad_norm"] = np.asarray(metrics["grad_norm"])
    put_tree(res, "final", params)
    return res


# the dry run's mini cells (tests/test_dryrun_mini.py's): SMOKE configs on
# a (2, 4) ("data", "model") mesh, a train cell and a decode cell of S=64,
# B=8 each
DRYRUN_ARCHS = ("smollm-360m", "gemma3-1b", "deepseek-moe-16b", "mamba2-2.7b",
                "zamba2-1.2b")
DRYRUN_MESH = (2, 4)
DRYRUN_SEQ, DRYRUN_BATCH = 64, 8


def _recipe_dryrun() -> dict[str, np.ndarray]:
    """The JAX package's dry run of the mini cells, as its ``run_cell``
    builds them (act_seq_shard, ep_axis, score_shard, donation): per arch
    and cell ``n_params``, ``n_active``, ``model_flops_global`` and the
    compiled module's ``memory_analysis`` argument bytes, and the HLO
    counts of ``roofline.analysis.analyze`` (flops, bytes and collective
    bytes per device). The mesh is the first 8 of the 512 host devices
    (``repro.launch.dryrun`` sets 512 at import) with Auto axes:
    ``jax.make_mesh`` gives Explicit ones in JAX 0.9, on which the
    models' ``with_sharding_constraint`` raises."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke
    from repro.configs.registry import ShapeSpec, input_specs
    from repro.launch.dryrun import _batch_specs, _ns, sanitize_specs
    from repro.models import build_model
    from repro.roofline.analysis import analyze
    from repro.serve import make_serve_step
    from repro.train import TrainConfig, make_train_step

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(DRYRUN_MESH), ("data", "model"))
    baxes = ("data",)
    B, S = DRYRUN_BATCH, DRYRUN_SEQ
    res = {}

    def put(arch, cell, model, compiled, model_flops, n_dev=8):
        rc = analyze(arch, cell, "mini", n_dev, compiled, model_flops)
        pre = f"{arch}/{cell}/"
        res[pre + "n_params"] = np.asarray(model.n_params())
        res[pre + "n_active"] = np.asarray(model.n_active_params())
        res[pre + "model_flops_global"] = np.asarray(model_flops)
        res[pre + "argument_bytes"] = np.asarray(
            compiled.memory_analysis().argument_size_in_bytes)
        res[pre + "flops"] = np.asarray(rc.flops)
        res[pre + "bytes"] = np.asarray(rc.bytes_accessed)
        res[pre + "coll_bytes"] = np.asarray(json.dumps(rc.coll_bytes))

    for arch in DRYRUN_ARCHS:
        base = get_smoke(arch)
        if base.family == "moe":
            base = dataclasses.replace(base, ep_axis="model")
        # train: f32 params, m and v on the params' specs
        cfg = dataclasses.replace(base, act_spec=(baxes, "model", None))
        model = build_model(cfg)
        pa = model.abstract(jnp.float32)
        ps = sanitize_specs(mesh, model.specs(), pa)
        oa = {"m": pa, "v": pa, "step": jax.ShapeDtypeStruct((), jnp.int32)}
        os_ = {"m": ps, "v": ps, "step": P()}
        ba = input_specs(cfg, ShapeSpec("mini_train", S, B, "train"))
        bs = _batch_specs(ba, baxes)
        scalars = jax.tree.map(lambda _: P(), {"loss": 0, "grad_norm": 0, "lr": 0})
        j = jax.jit(make_train_step(model, TrainConfig()),
                    in_shardings=(_ns(mesh, ps), _ns(mesh, os_), _ns(mesh, bs)),
                    out_shardings=(_ns(mesh, ps), _ns(mesh, os_), _ns(mesh, scalars)),
                    donate_argnums=(0, 1))
        with mesh:
            c = j.lower(pa, oa, ba).compile()
        put(arch, "train", model, c, 6.0 * model.n_active_params() * B * S)
        # decode: bf16 params and cache, the cache's sequence over "model"
        cfg = dataclasses.replace(base, score_spec=(baxes, None, None, "model"))
        model = build_model(cfg)
        pa = model.abstract(jnp.bfloat16)
        ps = sanitize_specs(mesh, model.specs(), pa)
        ca = model.abstract_cache(B, S, jnp.bfloat16)
        cs = sanitize_specs(mesh, model.cache_specs(
            B, S, extra_rules={"batch": baxes, "seq": "model", "kv_heads": None,
                               "heads": None}), ca)
        da = input_specs(cfg, ShapeSpec("mini_decode", S, B, "decode"))
        j = jax.jit(make_serve_step(model),
                    in_shardings=(_ns(mesh, ps), _ns(mesh, cs),
                                  _ns(mesh, _batch_specs(da, baxes))),
                    out_shardings=(NamedSharding(mesh, P(baxes)), _ns(mesh, cs)),
                    donate_argnums=(1,))
        with mesh:
            c = j.lower(pa, ca, da).compile()
        put(arch, "decode", model, c, 2.0 * model.n_active_params() * B)
    return res


def _recipe_elastic() -> dict[str, np.ndarray]:
    """The JAX package's elastic training run on 8 host devices: 3 steps
    on a (4, 2) mesh, a checkpoint, a restore onto (2, 2), 3 more steps,
    from ``PRNGKey(0)``'s weights (exported): the six losses and whether
    the reshard kept the parameters bit for bit."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.checkpoint import ckpt
    from repro.configs import get_config
    from repro.data import TokenPipeline
    from repro.launch.dryrun import sanitize_specs
    from repro.models import build_model
    from repro.train import OptConfig, TrainConfig, make_train_step
    from repro.train.optimizer import init_opt_state

    work = Path(sys.argv[2]).parent
    cfg = dataclasses.replace(get_config("smollm-360m"), **elastic_cfg())
    model = build_model(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, **elastic_pipe())
    step = jax.jit(make_train_step(model, TrainConfig(opt=OptConfig(**elastic_opt()))))

    def mesh_of(shape):
        n = int(np.prod(shape))
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("data", "model"))

    def shardings(mesh):
        specs = sanitize_specs(mesh, model.specs(), model.abstract())
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    res = {}
    params = model.init(jax.random.PRNGKey(0))
    put_tree(res, "init", params)
    mesh_a = mesh_of((4, 2))
    sh_a = shardings(mesh_a)
    opt = init_opt_state(params)
    params = jax.device_put(params, sh_a)
    opt = {"m": jax.device_put(opt["m"], sh_a), "v": jax.device_put(opt["v"], sh_a),
           "step": opt["step"]}
    losses = []
    with mesh_a:
        for i in range(SHARD_STEPS):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
    ckpt_dir = str(work / "jax_elastic")
    ckpt.save(ckpt_dir, SHARD_STEPS, {"params": params, "opt_state": opt},
              meta={"step": SHARD_STEPS})
    before = jax.tree.map(np.asarray, params)
    mesh_b = mesh_of((2, 2))
    sh_b = shardings(mesh_b)
    tree, meta = ckpt.restore(ckpt_dir, shardings={
        "params": sh_b, "opt_state": {"m": sh_b, "v": sh_b}})
    params_b, opt_b = tree["params"], tree["opt_state"]
    opt_b["step"] = jnp.asarray(opt_b["step"])
    res["bit_exact"] = np.bool_(all(
        np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(before), jax.tree.leaves(jax.tree.map(np.asarray, params_b)))))
    with mesh_b:
        for i in range(meta["step"], meta["step"] + SHARD_STEPS):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
            params_b, opt_b, m = step(params_b, opt_b, batch)
            losses.append(float(m["loss"]))
    res["losses"] = np.asarray(losses)
    return res


def elastic_cfg() -> dict:
    """The elastic run's reduced smollm-360m, the same in both packages."""
    from repro_torch.launch.elastic import ELASTIC_CFG
    return dict(ELASTIC_CFG)


def elastic_pipe() -> dict:
    from repro_torch.launch.elastic import ELASTIC_PIPE
    return dict(ELASTIC_PIPE)


def elastic_opt() -> dict:
    from repro_torch.launch.elastic import ELASTIC_OPT
    return dict(ELASTIC_OPT)


def shard_arrays(tmp_path, case: str, n: int, inputs: dict | None = None
                 ) -> dict[str, np.ndarray]:
    """Run the torch package's mesh case ``case`` on ``n`` gloo ranks (one
    process each, file rendezvous under ``tmp_path``, killed after
    :data:`SHARD_TIMEOUT_S`), with ``inputs`` saved for them; return what
    the ranks saved, merged."""
    import time

    tmp_path = Path(tmp_path)
    src = tmp_path / f"{case}-in.npz"
    np.savez(src, **(inputs or {}))
    init_file = tmp_path / f"{case}-rendezvous"
    init_file.unlink(missing_ok=True)
    env = dict(_child_env(), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, "shard_rank", case,
                               str(r), str(n), str(init_file), str(src),
                               str(tmp_path / f"{case}-rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    codes, logs = [], []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                codes.append(p.returncode)
                logs.append(out)
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(c != 0 for c in codes):
        raise RuntimeError(f"{case} ranks exited {codes}:\n" + "\n".join(
            log[-3000:] for log in logs))
    merged = {}
    for r in range(n):
        with np.load(tmp_path / f"{case}-rank{r}.npz") as z:
            merged.update({k: z[k] for k in z.files})
    return merged


def _shard_rank_main(case: str, rank: int, n: int, init_file: str, src: str,
                     out: str) -> None:
    """One gloo rank of a mesh case (``tests/_torch_shard_cases.py``), with
    the case's directory for any files its ranks share."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import _torch_shard_cases

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        with np.load(src) as z:
            inputs = {k: z[k] for k in z.files}
        res = getattr(_torch_shard_cases, case)(rank, inputs, Path(src).parent)
        np.savez(out, **{f"{k}/rank{rank}": v for k, v in res.items()})
    finally:
        dist.destroy_process_group()


RECIPES = {"core": _recipe_core, "gol3d": _recipe_gol3d, "pack": _recipe_pack,
           "halo": _recipe_halo, "distributed": _recipe_distributed,
           "flash": _recipe_flash, "lm": _recipe_lm, "ckpt": _recipe_ckpt,
           "xrun": _recipe_xrun, "serve_cli": _recipe_serve_cli,
           "train": _recipe_train, "flash_bwd": _recipe_flash_bwd,
           "lm_archs": _recipe_lm_archs,
           "lm_moe": _recipe_lm_moe, "lm_ssm": _recipe_lm_ssm,
           "lm_encdec": _recipe_lm_encdec, "sharding": _recipe_sharding,
           "elastic": _recipe_elastic, "dryrun": _recipe_dryrun}


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _run_ranks(*sys.argv[2:5])
        sys.exit(0)
    if sys.argv[1] == "rank":
        mesh, rank, init_file, out, device = sys.argv[2:7]
        _rank_main(int(rank), tuple(int(p) for p in mesh.split("x")),
                   init_file, out, device)
        sys.exit(0)
    if sys.argv[1] == "port_dryrun":
        _port_dryrun(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    if sys.argv[1] == "dryrun_table":
        _dryrun_table(Path(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1] == "shard_rank":
        case, rank, n, init_file, src, out = sys.argv[2:8]
        _shard_rank_main(case, int(rank), int(n), init_file, src, out)
        sys.exit(0)
    if sys.argv[1] in ("distributed", "elastic"):
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    if sys.argv[1] in ("sharding", "dryrun"):
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    import jax._src.core

    jax.core.trace_state_clean = jax._src.core.trace_state_clean
    recipe, path = sys.argv[1], sys.argv[2]
    np.savez(path, **RECIPES[recipe]())
