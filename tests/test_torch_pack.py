"""The pack primitive: the torch package's gather_rows (its plain version on
the CPU), sfc_gather_take, pack_surface and unpack_surface against the JAX
package's, on the same numpy inputs; the row-plan LRU; the wrapper's
checks.

The JAX gather runs as its own tests run it on the CPU, in interpret mode
(``gather_rows(..., interpret=True)`` and ``sfc_gather_take(...,
use_kernel=True, interpret=True)``), and through its plain form
(``use_kernel=False``). ``unpack_surface`` reaches ``device_constant`` on
the JAX side, so it runs in the reference subprocess
(tests/_torch_oracle.py).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import FACES, KINDS, PACK_H, PACK_M, pack_inputs, reference_arrays
from repro.core.layout import store_spec as jstore_spec
from repro.core.orderings import ordering_from_name as jordering
from repro.core.surfaces import surface_path_indices
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sfc_gather import gather_rows as jgather_rows
from repro_torch.core.layout import store_spec as tstore_spec
from repro_torch.core.orderings import ordering_from_name as tordering
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sfc_gather
from repro_torch.kernels.sfc_gather import gather_rows

rng = np.random.default_rng(21)


@pytest.fixture(scope="module")
def ref_pack(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "pack")


def _as_jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(jnp.bfloat16) if dtype == "bfloat16" \
        else jnp.asarray(a)


def _as_torch(a: np.ndarray, dtype: str):
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_gather_rows_matches_interpret_kernel(dtype):
    """One interpret-mode JAX kernel call per dtype, against the port's
    plain version and its wrapper's CPU path (bf16 compared as f32 bits:
    the values are the same bf16 numbers on both sides)."""
    N, L, R = 37, 16, 50
    src = rng.normal(size=(N, L)) * 100
    src = src.astype(np.int32) if dtype == "int32" else src.astype(np.float32)
    idx = rng.integers(0, N, size=R).astype(np.int32)
    want = np.asarray(jgather_rows(_as_jax(src, dtype), jnp.asarray(idx),
                                   interpret=True).astype(
        jnp.float32 if dtype == "bfloat16" else src.dtype))
    np.testing.assert_array_equal(
        want, np.asarray(jref.gather_rows_ref(_as_jax(src, dtype), jnp.asarray(idx))
                         .astype(want.dtype)))
    t_src, t_idx = _as_torch(src, dtype), torch.from_numpy(idx)
    for got in (tref.gather_rows_ref(t_src, t_idx), gather_rows(t_src, t_idx)):
        assert got.dtype == t_src.dtype and got.shape == (R, L)
        if dtype == "bfloat16":
            got = got.float()
        np.testing.assert_array_equal(got.numpy(), want)
    out = torch.empty((R, L), dtype=t_src.dtype)
    assert gather_rows(t_src, t_idx, out=out) is out
    assert torch.equal(out, gather_rows(t_src, t_idx))


def test_sfc_gather_take_1d_matches_both_jax_forms():
    """1-D data: the port's CPU path (index_select) and its card route
    run on the CPU (whole rows through gather_rows, then the elements)
    equal the JAX kernel form (interpret) and plain form."""
    data = rng.normal(size=512).astype(np.float32)
    idx = np.sort(rng.choice(512, size=70, replace=False))
    j_kernel = np.asarray(jops.sfc_gather_take(jnp.asarray(data), idx, line=16,
                                               use_kernel=True, interpret=True))
    j_plain = np.asarray(jops.sfc_gather_take(jnp.asarray(data), idx,
                                              use_kernel=False))
    np.testing.assert_array_equal(j_kernel, j_plain)
    t = torch.from_numpy(data)
    for got in (tops.sfc_gather_take(t, idx, line=16),
                tops._row_take(t, idx, 16, None),
                tops._row_take(t, idx, 16, ("test-1d",))):
        np.testing.assert_array_equal(got.numpy(), j_kernel)


def test_sfc_gather_take_stacked_store_matches_jax():
    """(C, n) store: one row gather over every channel (per-channel row
    offsets) equals the JAX plain form and the JAX kernel form per
    channel; a channel-strided view (the core of a larger store) too."""
    C, n = 2, 256
    data = rng.normal(size=(C, n)).astype(np.float32)
    idx = rng.integers(0, n, size=40)
    j_plain = np.asarray(jops.sfc_gather_take(jnp.asarray(data), idx))
    j_kernel = np.stack([np.asarray(jops.sfc_gather_take(
        jnp.asarray(data[c]), idx, line=32, use_kernel=True, interpret=True))
        for c in range(C)])
    np.testing.assert_array_equal(j_plain, j_kernel)
    big = torch.from_numpy(rng.normal(size=(C, 3 * n)).astype(np.float32))
    big[:, :n] = torch.from_numpy(data)
    for t in (torch.from_numpy(data), big[:, :n]):
        for got in (tops.sfc_gather_take(t, idx, line=32),
                    tops._row_take(t, idx, 32, None),
                    tops._row_take(t, idx, 32, ("test-2d",))):
            np.testing.assert_array_equal(got.numpy(), j_plain)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("source", ["cube", "store"])
def test_pack_surface_matches_jax(kind, source):
    """Every face at h ∈ {1, 2}, M=16: from a cube in the ordering's path
    order, or from a T=4 block store (its hybrid store_spec order), both
    routes of the port against the JAX plain form."""
    M = 16
    if source == "cube":
        jspec, tspec = jordering(kind), tordering(kind)
    else:
        jspec, tspec = jstore_spec(kind, 4), tstore_spec(kind, 4)
    data = rng.normal(size=(2, M ** 3)).astype(np.float32)
    t = torch.from_numpy(data)
    for face in FACES:
        for h in (1, 2):
            want = np.asarray(jops.pack_surface(jnp.asarray(data), jspec, M, h,
                                                face))
            np.testing.assert_array_equal(
                tops.pack_surface(t, tspec, M, h, face).numpy(), want)
            np.testing.assert_array_equal(
                tops.pack_surface(t[1], tspec, M, h, face).numpy(), want[1])
            idx = surface_path_indices(jspec, M, h, face)
            np.testing.assert_array_equal(
                tops._row_take(t, idx, 64, (tspec, M, h, face)).numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_unpack_surface_matches_jax(kind, ref_pack):
    spec = tordering(kind)
    for face in FACES:
        state, buf = pack_inputs(face)
        s = torch.from_numpy(state)
        got = tops.unpack_surface(s, torch.from_numpy(buf), spec, PACK_M,
                                  PACK_H, face)
        np.testing.assert_array_equal(got.numpy(), ref_pack[f"unpack/{kind}/{face}"])
        assert torch.equal(s, torch.from_numpy(state))  # input untouched
        back = tops.pack_surface(got, spec, PACK_M, PACK_H, face)
        np.testing.assert_array_equal(back.numpy(), buf)


@pytest.fixture
def fresh_plans(monkeypatch):
    monkeypatch.setattr(tops, "_ROW_PLANS", {})
    return tops._ROW_PLANS


def test_row_plan_matches_jax_and_hits(fresh_plans):
    idx = np.sort(rng.choice(4096, size=300, replace=False))
    rows, pos = tops._row_plan(idx, 64, plan_key="k")
    jrows, jpos = jops._row_plan(idx, 64)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(pos, jpos)
    assert tops._row_plan(idx, 64, plan_key="k")[0] is rows  # a hit
    assert tops._row_plan(idx, 32, plan_key="k")[0] is not rows  # keyed on line
    assert tops._row_plan(idx, 64)[0] is not rows  # no key: not cached
    assert list(fresh_plans) == [("k", 64), ("k", 32)]
    tops._row_plan(idx, 64, plan_key="k")  # hit moves to the back
    assert list(fresh_plans) == [("k", 32), ("k", 64)]


def test_row_plan_cap_evicts_oldest(fresh_plans, monkeypatch):
    monkeypatch.setattr(tops, "_ROW_PLANS_CAP", 4)
    idx = np.arange(10)
    for k in range(6):
        tops._row_plan(idx, 8, plan_key=k)
    assert list(fresh_plans) == [(k, 8) for k in (2, 3, 4, 5)]


def test_row_plan_lock_under_threads(fresh_plans, monkeypatch):
    """Eight threads hammer a small LRU with a short switch interval: the
    dict never exceeds its cap and every call returns the right plan."""
    import sys

    monkeypatch.setattr(tops, "_ROW_PLANS_CAP", 3)
    idxs = [np.sort(np.random.default_rng(k).choice(512, 40, replace=False))
            for k in range(6)]
    want = [jops._row_plan(i, 16) for i in idxs]
    errors = []

    def work(t):
        for n in range(200):
            k = (n + t) % 6
            rows, pos = tops._row_plan(idxs[k], 16, plan_key=k)
            if not (np.array_equal(rows, want[k][0]) and
                    np.array_equal(pos, want[k][1])):
                errors.append(k)
            if len(fresh_plans) > 3:
                errors.append("cap")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []


def test_gather_rows_checks():
    src = torch.zeros((8, 4))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(src, idx.long())
    with pytest.raises(TypeError, match="int32"):
        gather_rows(src, idx[None])
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(src.t(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(src[None], idx)
    with pytest.raises(TypeError, match="element size"):
        gather_rows(torch.zeros((8, 4), dtype=torch.complex128), idx)
    with pytest.raises(ValueError, match="share memory"):
        gather_rows(src, idx, out=src[:3])
    with pytest.raises(ValueError, match=r"\(3, 4\)"):
        gather_rows(src, idx, out=torch.empty(3, 5))
    with pytest.raises(ValueError, match="meta"):
        gather_rows(torch.empty((8, 4), device="meta"),
                    torch.empty(3, dtype=torch.int32, device="meta"))


def test_gather_rows_kernel_needs_a_compiler(monkeypatch, tmp_path):
    """Without nvcc the kernel cannot be built: loading it raises and
    nothing falls back (on a card, a CUDA tensor would get this error)."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    sfc_gather._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            sfc_gather._lib()
    finally:
        sfc_gather._lib.cache_clear()
    assert "sfc_gather" in _build.SOURCES
