"""The halo exchange and its round on a local mesh, in-process: the shell of
a one-shard mesh against padding, one deep round against S oracle steps,
the slab scatter and the sharded-state layout against the JAX package,
the exchange and distributed byte models as integers, and plan().

The JAX ``shard_state`` reaches ``device_constant``, so it runs in the
reference subprocess (tests/_torch_oracle.py); the rest of the JAX side
is numpy or integer arithmetic and runs here.
"""

import numpy as np
import pytest
import torch

import repro.stencil.pipeline as jpipe
from _torch_oracle import SHARD_CASES, boundary, reference_arrays, shard_input
from repro.core import boundary as jbnd
from repro.core.orderings import ordering_from_name as jordering
from repro.stencil import halo as jhalo
from repro_torch.core import boundary as tbnd
from repro_torch.core.boundary import pad_cube
from repro_torch.core.layout import blockize, unblockize
from repro_torch.core.orderings import ordering_from_name as tordering
from repro_torch.core.surfaces import shell_slab_shapes
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import uniform_weights
from repro_torch.kernels.stencil3d import SMEM_LIMIT_BYTES, fused_smem_bytes
from repro_torch.stencil import halo, make_stencil_mesh
from repro_torch.stencil import pipeline as tpipe
from repro_torch.stencil.pipeline import DistributedPipeline

rng = np.random.default_rng(5)
ONE = make_stencil_mesh((1, 1, 1), device="cpu")


@pytest.fixture(scope="module")
def ref_halo(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "halo")


def _pad_slabs(cube, h, bc):
    """The six shell slabs of the (M+2h)³ cube padded under ``bc``."""
    xp = pad_cube(cube, h, bc)
    M = cube.shape[0]
    e = M + 2 * h
    return (xp[:h, h:h + M, h:h + M], xp[e - h:, h:h + M, h:h + M],
            xp[:, :h, h:h + M], xp[:, e - h:, h:h + M],
            xp[:, :, :h], xp[:, :, e - h:])


@pytest.mark.parametrize("bc", ["periodic", "dirichlet", "neumann0", "mixed"])
def test_exchange_shell_one_shard_matches_pad(bc):
    """On a one-shard mesh every shift is a self-copy (periodic) or
    delivers zeros that the edge fill replaces (clamped): the shell is
    the padded cube's, mirroring the JAX package's np.pad(mode="wrap")
    check and its clamped form."""
    M, T, h = 16, 8, 2
    cube = torch.from_numpy(rng.normal(size=(M, M, M)).astype(np.float32))
    store = blockize(cube, T, kind="hilbert")
    spec = boundary(tbnd, bc)
    (slabs,) = halo.exchange_shell(ONE, [store.reshape(-1)], "hilbert", M, T, h,
                                   bc=spec)
    for got, want, shape in zip(slabs, _pad_slabs(cube, h, spec),
                                shell_slab_shapes(M, h)):
        assert tuple(got.shape) == shape
        assert torch.equal(got, want)
    if bc == "periodic":
        xp = np.pad(cube.numpy(), h, mode="wrap")
        np.testing.assert_array_equal(slabs[4].numpy(), xp[:, :, :h])


@pytest.mark.parametrize("kind", ["morton", "hilbert"])
def test_exchange_shell_stacked_store_is_per_channel(kind):
    """A (C, n) store exchanges every channel through the same messages:
    each channel's slabs equal those of its own 1-channel exchange."""
    M, T, h = 8, 4, 2
    fields = torch.from_numpy(rng.normal(size=(2, M, M, M)).astype(np.float32))
    stores = [blockize(fields[c], T, kind=kind).reshape(-1) for c in range(2)]
    (both,) = halo.exchange_shell(ONE, [torch.stack(stores)], kind, M, T, h,
                                  bc=tbnd.NEUMANN0)
    for c in range(2):
        (one,) = halo.exchange_shell(ONE, [stores[c]], kind, M, T, h,
                                     bc=tbnd.NEUMANN0)
        for a, b in zip(both, one):
            assert torch.equal(a[c], b)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("bc", ["periodic", "mixed"])
def test_shard_substeps_one_shard_matches_oracle(S, bc):
    """One deep round on a 1×1×1 mesh == S oracle steps (gol)."""
    M, T, g = 16, 8, 1
    spec = boundary(tbnd, bc)
    cube = torch.from_numpy((rng.random((M, M, M)) < 0.3).astype(np.float32))
    store = blockize(cube, T, kind="morton")
    (out,) = halo.shard_substeps(ONE, [store], kind="morton", M=M, g=g, S=S,
                                 bc=spec)
    want = cube
    for _ in range(S):
        want = tref.gol3d_step_ref(want, g, bc=spec)
    assert torch.equal(unblockize(out, M, kind="morton"), want)


@pytest.mark.parametrize("kind", ["row_major", "column_major", "morton", "hilbert"])
def test_surface_slab_scatter_matches_jax(kind):
    tspec, jspec = tordering(kind), jordering(kind)
    for face in ("k0", "k1", "i0", "i1", "j0", "j1"):
        for M, h in ((8, 1), (8, 4), (16, 3)):
            got = halo.surface_slab_scatter(tspec, M, h, face)
            np.testing.assert_array_equal(
                got, jhalo.surface_slab_scatter(jspec, M, h, face))
            assert np.array_equal(np.sort(got), np.arange(h * M * M))


@pytest.mark.parametrize("procs,gshape", SHARD_CASES,
                         ids=lambda v: "x".join(map(str, v)))
def test_shard_state_matches_jax(procs, gshape, ref_halo):
    for kind in ("row_major", "hilbert"):
        spec = tordering(kind)
        for C in (1, 2):
            tag = f"{'x'.join(map(str, procs))}/{kind}/C{C}"
            cube = torch.from_numpy(shard_input(gshape, C))
            st = halo.shard_state(cube, spec, procs)
            np.testing.assert_array_equal(st.numpy(), ref_halo[f"shard/{tag}"])
            back = halo.unshard_state(st, spec, gshape)
            np.testing.assert_array_equal(back.numpy(), ref_halo[f"unshard/{tag}"])
            assert torch.equal(back, cube)


def test_shard_state_rejects_bad_boxes():
    spec = tordering("morton")
    with pytest.raises(ValueError, match="divide"):
        halo.shard_state(torch.zeros(8, 8, 8), spec, (3, 1, 1))
    with pytest.raises(ValueError, match="cubic"):
        halo.shard_state(torch.zeros(16, 8, 8), spec, (1, 1, 1))
    st = halo.shard_state(torch.zeros(16, 16, 16), spec, (2, 2, 2))
    with pytest.raises(ValueError, match="implies"):
        halo.unshard_state(st, spec, 32)


def test_shard_boundary_flags_mask_by_mesh_position():
    base = halo.boundary_face_table("hilbert", 2)
    for co in ((0, 0, 0), (1, 0, 1), (0, 1, 0)):
        got = halo.shard_boundary_flags("hilbert", 2, co, (2, 2, 2), "cpu").numpy()
        for ax in range(3):
            assert got[:, 2 * ax].any() == (co[ax] == 0)
            assert got[:, 2 * ax + 1].any() == (co[ax] == 1)
        assert (got <= base).all()
    one = halo.shard_boundary_flags("hilbert", 2, (0, 0, 0), (1, 1, 1), "cpu")
    np.testing.assert_array_equal(one.numpy(), base)


_MODEL_GRID = [(M, g, S) for M in (8, 16, 64) for g in (1, 2) for S in (1, 2, 4)]
_BCS = ("periodic", "dirichlet", "neumann0", "mixed")
_MESHES = ((1, 1, 1), (2, 2, 2), (4, 2, 1))


@pytest.mark.parametrize("name", ["exchange_face_items",
                                  "exchange_items_per_exchange",
                                  "exchange_bytes_per_step",
                                  "distributed_bytes_per_step"])
def test_exchange_models_equal_reference(name):
    """Integer-equal (same value, same type) to the JAX package over
    (M, T, g, S, C, procs, coords, bc), the clamped mean and per-shard
    forms included."""
    mine, theirs = getattr(tpipe, name), getattr(jpipe, name)
    n = 0
    for M, g, S in _MODEL_GRID:
        if name == "exchange_face_items":
            a, b = mine(M, g, S), theirs(M, g, S)
            assert a == b and type(a[0]) is type(b[0])
            n += 1
            continue
        for bc in _BCS:
            for procs in _MESHES:
                coords_list = [None, (0, 0, 0), tuple(p - 1 for p in procs),
                               tuple(p // 2 for p in procs)]
                for coords in coords_list:
                    for C in (1, 2):
                        kw_t = dict(bc=boundary(tbnd, bc), procs=procs,
                                    coords=coords, fields=C)
                        kw_j = dict(kw_t, bc=boundary(jbnd, bc))
                        if name == "distributed_bytes_per_step":
                            for T in (8, 16):
                                if T % (S * g) or M % T:
                                    continue
                                a = mine(M, T, g, 10, S=S, **kw_t)
                                b = theirs(M, T, g, 10, S=S, **kw_j)
                                assert a == b and type(a) is type(b)
                                n += 1
                        else:
                            a, b = mine(M, g, S, **kw_t), theirs(M, g, S, **kw_j)
                            assert a == b and type(a) is type(b), (M, g, S, bc)
                            n += 1
    assert n >= len(_MODEL_GRID)
    if name == "exchange_items_per_exchange":
        with pytest.raises(ValueError, match="procs"):
            mine(8, 1, 1, bc=tbnd.NEUMANN0)


def test_exchange_model_is_the_slab_volume():
    for M, g, S in ((16, 1, 1), (16, 1, 4), (64, 2, 2)):
        slabs = sum(int(np.prod(s)) for s in shell_slab_shapes(M, S * g))
        assert tpipe.exchange_items_per_exchange(M, g, S) == slabs
        assert tpipe.exchange_bytes_per_step(M, g, S) == 4.0 * slabs / S


@pytest.mark.parametrize("rule", ["gol", "wave"])
def test_distributed_plan_fits_shared_memory(rule):
    for shape in ((1, 1, 1), (2, 2, 2)):
        mesh = make_stencil_mesh(shape, device="cpu")
        for M in (16, 64, 128):
            for bc in ("periodic", "mixed"):
                p = DistributedPipeline.plan(mesh, tordering("hilbert"), M,
                                             rule=rule, bc=boundary(tbnd, bc))
                assert p.smem_bytes() == fused_smem_bytes(p.T, 1, p.S,
                                                          fields=p.channels)
                assert p.smem_bytes() <= SMEM_LIMIT_BYTES
                assert M % p.T == 0 and p.T % p.S == 0
                best = p.bytes_per_step(10)
                for T in (2, 4, 8, 16, 32):
                    for S in (1, 2, 4, 8):
                        if M % T or T % S or fused_smem_bytes(
                                T, 1, S, fields=p.channels) > SMEM_LIMIT_BYTES:
                            continue
                        q = DistributedPipeline(mesh=mesh, spec=p.spec, M=M,
                                                T=T, S=S, rule=rule, bc=p.bc)
                        assert best <= q.bytes_per_step(10)
    with pytest.raises(ValueError, match="smem_limit"):
        DistributedPipeline.plan(mesh, tordering("hilbert"), 64, rule=rule,
                                 smem_limit=100)


def test_pipeline_rejects_bad_arguments():
    spec = tordering("morton")
    with pytest.raises(ValueError):
        DistributedPipeline(mesh=ONE, spec=spec, M=16, T=8, g=1, S=3)
    with pytest.raises(ValueError):
        DistributedPipeline(mesh=ONE, spec=spec, M=16, T=8, g=2, S=8)
    with pytest.raises(ValueError, match="OrderingSpec"):
        DistributedPipeline(mesh=ONE, M=16, T=8)
    pipe = DistributedPipeline(mesh=ONE, spec=spec, M=8, T=4)
    with pytest.raises(ValueError, match="shard states"):
        pipe.run([torch.zeros(8 ** 3), torch.zeros(8 ** 3)], 1)
    with pytest.raises(ValueError, match="shard states"):
        pipe.run([torch.zeros(7 ** 3)], 1)


def test_fused_writes_the_core_of_an_extended_store():
    """The ping-pong target: a stacked store's core view, channels
    ``nb + shell`` blocks apart, takes the fused step's output and leaves
    the shell alone; a view whose channels are not contiguous blocks
    raises, as does a core of the input store itself."""
    from repro_torch.core.neighbors import extended_neighbor_table
    from repro_torch.kernels.stencil3d import stencil_step_fused

    nt, T = 2, 4
    nb = nt ** 3
    fields = torch.from_numpy(rng.normal(size=(2, nb, T, T, T)).astype(np.float32))
    ext = halo.extended_store(fields, nt)
    halo.fill_shells(ONE, [ext], kind="morton", M=nt * T, h=2)
    nbr = torch.from_numpy(np.array(extended_neighbor_table("morton", nt)))
    w = uniform_weights(1, "cpu")
    spare = torch.zeros_like(ext)
    core = halo.core_of(spare, nb)
    got = stencil_step_fused(ext, w, nbr, g=1, S=2, rule="wave", out=core)
    assert got is core and not core.is_contiguous()
    assert torch.equal(core, stencil_step_fused(ext, w, nbr, g=1, S=2,
                                                rule="wave"))
    assert not spare[:, nb:].any()
    with pytest.raises(ValueError, match="contiguous"):
        stencil_step_fused(ext, w, nbr, g=1, S=2, rule="wave",
                           out=torch.zeros(2, nb, T, T, 2 * T)[..., :T])
    with pytest.raises(ValueError, match="share memory"):
        stencil_step_fused(ext, w, nbr, g=1, S=2, rule="wave",
                           out=halo.core_of(ext, nb))
