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
:func:`reference_arrays` from a module-scoped fixture.
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


def reference_arrays(tmp_path_factory, recipe: str) -> dict[str, np.ndarray]:
    """Run ``recipe`` in a child process; return its arrays by name."""
    out = tmp_path_factory.mktemp(f"ref_{recipe}") / "ref.npz"
    env = dict(os.environ)
    src = str(REPO / "src")
    env["PYTHONPATH"] = src + os.pathsep + env["PYTHONPATH"] \
        if env.get("PYTHONPATH") else src
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, __file__, recipe, str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
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


RECIPES = {"core": _recipe_core, "gol3d": _recipe_gol3d}


if __name__ == "__main__":
    import jax
    import jax._src.core

    jax.core.trace_state_clean = jax._src.core.trace_state_clean
    recipe, path = sys.argv[1], sys.argv[2]
    np.savez(path, **RECIPES[recipe]())
