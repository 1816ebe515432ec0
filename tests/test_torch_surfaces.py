"""The torch package's numpy copies of the surface and cache models, and its
distributed block tables, array-equal to the JAX package's: face masks and
face index lists, run statistics, shell slabs, offset histograms and LRU
misses; shell block ids, the extended neighbour table and the ring pairs.

All of these are numpy on both sides and reach no ``device_constant``, so
the JAX side runs in-process.
"""

import numpy as np
import pytest

from repro.core import cache_model as jcm
from repro.core import neighbors as jnbr
from repro.core import surfaces as jsurf
from repro.core.layout import store_spec as jstore_spec
from repro.core.orderings import ordering_from_name as jordering
from repro_torch.core import cache_model as tcm
from repro_torch.core import neighbors as tnbr
from repro_torch.core import surfaces as tsurf
from repro_torch.core.layout import store_spec as tstore_spec
from repro_torch.core.orderings import ordering_from_name as tordering

KINDS = ("row_major", "column_major", "morton", "hilbert")
FACES = ("k0", "k1", "i0", "i1", "j0", "j1")


def _specs(name):
    """The same ordering in both packages; "store" is the hybrid order of
    a Hilbert block store with T=4."""
    if name == "store":
        return jstore_spec("hilbert", 4), tstore_spec("hilbert", 4)
    return jordering(name), tordering(name)


@pytest.mark.parametrize("face", FACES)
def test_face_mask_equal(face):
    for M, g in ((4, 1), (8, 2), (8, 4)):
        np.testing.assert_array_equal(tcm.face_mask(face, M, g),
                                      jcm.face_mask(face, M, g))
    with pytest.raises(ValueError):
        tcm.face_mask("x0", 4, 1)


@pytest.mark.parametrize("name", KINDS + ("store",))
def test_surface_path_indices_equal(name):
    jspec, tspec = _specs(name)
    for face in FACES:
        for g in (1, 2, 4):
            got = tsurf.surface_path_indices(tspec, 16, g, face)
            np.testing.assert_array_equal(
                got, jsurf.surface_path_indices(jspec, 16, g, face))
            assert got.dtype == np.int32 and not got.flags.writeable


@pytest.mark.parametrize("name", KINDS + ("store",))
def test_run_stats_and_runs_equal(name):
    jspec, tspec = _specs(name)
    for face in FACES:
        assert vars(tsurf.run_stats(tspec, 8, 2, face)) == \
            vars(jsurf.run_stats(jspec, 8, 2, face))
        for a, b in zip(tsurf.surface_runs(tspec, 8, 2, face),
                        jsurf.surface_runs(jspec, 8, 2, face)):
            np.testing.assert_array_equal(a, b)


def test_run_lengths_equal():
    for arr in (np.array([], np.int64), np.array([3]), np.array([0, 1, 2, 5, 6, 9])):
        np.testing.assert_array_equal(tsurf.run_lengths(arr), jsurf.run_lengths(arr))


@pytest.mark.parametrize("h", [1, 2, 4])
def test_shell_slabs_equal(h):
    for nt, T in ((1, 4), (2, 4), (4, 4), (2, 8)):
        if h > T:
            continue
        M = nt * T
        assert tsurf.shell_slab_shapes(M, h) == jsurf.shell_slab_shapes(M, h)
        np.testing.assert_array_equal(tsurf.shell_slab_positions(nt, T, h),
                                      jsurf.shell_slab_positions(nt, T, h))


@pytest.mark.parametrize("name", KINDS)
def test_offset_histogram_and_cache_misses_equal(name):
    jspec, tspec = _specs(name)
    for a, b in zip(tcm.offset_histogram(tspec, 8, 1),
                    jcm.offset_histogram(jspec, 8, 1)):
        np.testing.assert_array_equal(a, b)
    assert vars(tcm.offset_summary(tspec, 8, 1)) == vars(jcm.offset_summary(jspec, 8, 1))
    assert tcm.cache_misses(tspec, 8, 1, 8, 16) == jcm.cache_misses(jspec, 8, 1, 8, 16)
    for stencil in (False, True):
        assert tcm.surface_cache_misses(tspec, 8, 1, 8, 16, "j0", stencil) == \
            jcm.surface_cache_misses(jspec, 8, 1, 8, 16, "j0", stencil)


def test_simulate_lru_equal():
    lines = np.random.default_rng(0).integers(0, 20, size=300)
    for c in (1, 4, 16, 32):
        assert tcm.simulate_lru(lines, c) == jcm.simulate_lru(lines, c)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_shell_tables_equal(nt):
    assert tnbr.shell_block_count(nt) == jnbr.shell_block_count(nt)
    np.testing.assert_array_equal(tnbr.shell_block_index(nt),
                                  jnbr.shell_block_index(nt))
    for kind in KINDS:
        got = tnbr.extended_neighbor_table(kind, nt)
        np.testing.assert_array_equal(got, jnbr.extended_neighbor_table(kind, nt))
        assert got.dtype == np.int32 and got.shape == (nt ** 3, 27)
        assert got.max() < nt ** 3 + tnbr.shell_block_count(nt)
        np.testing.assert_array_equal(got[:, tnbr.SELF_COL], np.arange(nt ** 3))


def test_extended_table_device_copy():
    got = tnbr.extended_neighbor_table_device("morton", 2, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  tnbr.extended_neighbor_table("morton", 2))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_ring_perms_equal(n, periodic):
    got = tnbr.ring_perms(n, periodic=periodic)
    assert got == jnbr.ring_perms(n, periodic=periodic)
    if not periodic:  # open rings carry no wrap pairs
        assert (n - 1, 0) not in got[0] or n == 1
        assert all(abs(s - d) == 1 for pairs in got for s, d in pairs)
