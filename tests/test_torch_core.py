"""The torch package's core (curves, tables, layouts, boundaries) against
the JAX package, on the same numpy inputs.

Tables and permutations must be array-equal; relayouts and pads are pure
data movement and must be bit-equal. Reference calls that reach the JAX
package's ``device_constant`` run in a subprocess (tests/_torch_oracle.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import KINDS, cube_input, reference_arrays
from repro.core import boundary as jbnd
from repro.core import layout as jlayout
from repro.core import neighbors as jnbr
from repro.core import orderings as jord
from repro_torch.core import boundary as tbnd
from repro_torch.core import layout as tlayout
from repro_torch.core import neighbors as tnbr
from repro_torch.core import orderings as tord

ORDERING_NAMES = KINDS + ("morton_r1", "hybrid_hilbert_morton_T4")
BCS = ("periodic", "dirichlet", "neumann0", "mixed")


def _bcs(pkg, name):
    """The same contract in either package (dirichlet at 0.5, mixed =
    clamped k under neumann0, periodic i/j)."""
    return {"periodic": lambda: pkg.PERIODIC,
            "dirichlet": lambda: pkg.dirichlet(0.5),
            "neumann0": lambda: pkg.NEUMANN0,
            "mixed": lambda: pkg.mixed(k="neumann0")}[name]()


@pytest.fixture(scope="module")
def ref_core(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "core")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("M", [4, 8, 16])
def test_permutations_equal_reference(M):
    for name in ORDERING_NAMES + ("store_spec",):
        if name == "store_spec":
            js, ts = jlayout.store_spec("hilbert", 4), tlayout.store_spec("hilbert", 4)
        else:
            js, ts = jord.ordering_from_name(name), tord.ordering_from_name(name)
        if js.kind == "hybrid" and M % js.tile:
            continue
        assert ts.name == js.name
        p = tord.rmo_to_path(ts, M)
        np.testing.assert_array_equal(p, jord.rmo_to_path(js, M))
        np.testing.assert_array_equal(tord.path_to_rmo(ts, M),
                                      jord.path_to_rmo(js, M))
        assert p.dtype == np.int32


def test_int32_guard_and_single_cell_index():
    with pytest.raises(ValueError, match="int32"):
        tord.rmo_to_path(tord.MORTON, 2048)  # 2048³ ≥ 2³¹
    for kind in KINDS:
        assert tord.block_index_3d(kind, 0, 0, 0, 1) == \
            jord.block_index_3d(kind, 0, 0, 0, 1) == 0
        k, i, j = np.meshgrid(*(np.arange(4),) * 3, indexing="ij")
        np.testing.assert_array_equal(tord.block_index_3d(kind, k, i, j, 4),
                                      jord.block_index_3d(kind, k, i, j, 4))


@pytest.mark.parametrize("kind", KINDS)
def test_block_order_and_tables_equal_reference(kind):
    for nt in (1, 2, 4):
        np.testing.assert_array_equal(tlayout.block_order(kind, nt),
                                      jlayout.block_order(kind, nt))
        for periodic in (True, False, (False, True, True), (True, False, True)):
            for conn in ("full", "face"):
                np.testing.assert_array_equal(
                    tnbr.neighbor_table(kind, nt, connectivity=conn, periodic=periodic),
                    jnbr.neighbor_table(kind, nt, connectivity=conn, periodic=periodic))
        np.testing.assert_array_equal(tnbr.boundary_face_table(kind, nt),
                                      jnbr.boundary_face_table(kind, nt))
    assert (tnbr.OFFSETS_FULL, tnbr.OFFSETS_FACE, tnbr.FACE_COLS, tnbr.SELF_COL) == \
        (jnbr.OFFSETS_FULL, jnbr.OFFSETS_FACE, jnbr.FACE_COLS, jnbr.SELF_COL)


@pytest.mark.parametrize("kind", KINDS)
def test_blockize_matches_reference(kind, ref_core):
    for M, T in ((8, 4), (16, 4), (16, 8)):
        x = _t(cube_input(M, seed=M + T))
        fields = torch.stack([x, -x])
        b = tlayout.blockize(x, T, kind)
        assert torch.equal(b, _t(ref_core[f"blockize/{M}/{T}/{kind}"]))
        assert torch.equal(tlayout.unblockize(b, M, kind), x)
        assert torch.equal(tlayout.unblockize(b, M, kind),
                           _t(ref_core[f"unblockize/{M}/{T}/{kind}"]))
        bf = tlayout.blockize_fields(fields, T, kind)
        assert torch.equal(bf, _t(ref_core[f"blockize_fields/{M}/{T}/{kind}"]))
        assert torch.equal(tlayout.unblockize_fields(bf, M, kind), fields)


@pytest.mark.parametrize("name", ORDERING_NAMES)
def test_apply_ordering_matches_reference(name, ref_core):
    spec = tord.ordering_from_name(name)
    for M in (4, 8, 16):
        if spec.kind == "hybrid" and M % spec.tile:
            continue
        x = _t(cube_input(M, seed=M))
        v = tlayout.apply_ordering(x, spec)
        assert torch.equal(v, _t(ref_core[f"apply/{M}/{name}"]))
        assert torch.equal(tlayout.undo_ordering(v, spec, M), x)


def test_store_is_hybrid_ordered_path_state():
    x = _t(cube_input(16, seed=1))
    for kind in KINDS:
        assert torch.equal(tlayout.blockize(x, 4, kind).reshape(-1),
                           tlayout.apply_ordering(x, tlayout.store_spec(kind, 4)))


@pytest.mark.parametrize("bc", BCS)
def test_pad_cube_matches_reference(bc):
    x = cube_input(8, seed=5)
    for g in (1, 2, 3):
        got = tbnd.pad_cube(_t(x), g, _bcs(tbnd, bc))
        want = np.asarray(jbnd.pad_cube(jnp.asarray(x), g, _bcs(jbnd, bc)))
        assert torch.equal(got, _t(want)), (bc, g)


@pytest.mark.parametrize("bc", BCS)
def test_blockize_with_halo_matches_reference(bc):
    x = cube_input(16, seed=9)
    for kind in KINDS:
        for T, g in ((4, 1), (8, 2), (4, 4)):
            got = tlayout.blockize_with_halo(_t(x), T, g, kind, bc=_bcs(tbnd, bc))
            want = jlayout.blockize_with_halo(jnp.asarray(x), T, g, kind,
                                              bc=_bcs(jbnd, bc))
            assert torch.equal(got, _t(np.asarray(want))), (kind, T, g)


def test_boundary_specs_and_mixed_collapse():
    assert tbnd.mixed(k="neumann0", i="neumann0", j="neumann0") == tbnd.NEUMANN0
    m = tbnd.mixed(k=tbnd.dirichlet(1.0))
    assert m.kind == "mixed" and m.clamped
    assert tbnd.axes_periodic(m) == jbnd.axes_periodic(jbnd.mixed(k=jbnd.dirichlet(1.0)))
    with pytest.raises(ValueError):
        tbnd.BoundarySpec("reflect")


def test_device_constant_is_an_lru_keyed_on_device():
    calls = []

    def build():
        calls.append(1)
        return np.arange(4, dtype=np.int32)

    key = ("test-table", id(calls))
    a = tlayout.device_constant(key, build, "cpu")
    b = tlayout.device_constant(key, build, torch.device("cpu"))
    assert a is b and len(calls) == 1
    assert a.dtype == torch.int32 and torch.equal(a, torch.arange(4, dtype=torch.int32))
