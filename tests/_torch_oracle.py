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
    out = tmp_path_factory.mktemp(f"ref_{recipe}") / "ref.npz"
    proc = subprocess.run([sys.executable, __file__, recipe, str(out)],
                          env=_child_env(), capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"reference recipe {recipe!r} failed:\n{proc.stderr}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


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


RECIPES = {"core": _recipe_core, "gol3d": _recipe_gol3d, "pack": _recipe_pack,
           "halo": _recipe_halo, "distributed": _recipe_distributed}


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _run_ranks(*sys.argv[2:5])
        sys.exit(0)
    if sys.argv[1] == "rank":
        mesh, rank, init_file, out, device = sys.argv[2:7]
        _rank_main(int(rank), tuple(int(p) for p in mesh.split("x")),
                   init_file, out, device)
        sys.exit(0)
    if sys.argv[1] == "distributed":
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax._src.core

    jax.core.trace_state_clean = jax._src.core.trace_state_clean
    recipe, path = sys.argv[1], sys.argv[2]
    np.savez(path, **RECIPES[recipe]())
