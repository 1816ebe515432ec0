"""The ROI-query service: the torch package's serve/roi.py, serve/service.py,
launch/faults.ServeFaultPlan and ``launch/serve.py --stencil`` against the
JAX package's, on the same numpy inputs.

- ``roi_to_ranges`` and ``roi_model`` equal (integers exactly) for the four
  orderings at M ∈ {8, 16, 32, 256}, over the benchmark's ROI suite and
  seeded random boxes;
- ``extract_roi`` bit-equal across ordering × C × dtype (f32, bf16, fp8),
  with blocks skipped too (fp8: NaN where NaN, the frameworks write
  different NaN payloads);
- the integrity manifests' crc32s equal in every store dtype;
- every case of the serving fault matrix (tests/test_serve_roi.py, section
  3) run through both services under the same fake clock: every field of
  every QueryResult, the payload's bits and the stats equal;
- the stencil CLI on the CPU at M=16 with ``--faults``: the same statuses
  and counts as the JAX package's (its run in the reference subprocess,
  recipe ``serve_cli``, since its pipeline reaches ``device_constant``).

The JAX package's roi and service modules are host-side numpy, so they run
in this process; ml_dtypes (which JAX brings) builds its bf16 and fp8
stores, and the port receives the same bits.
"""

import contextlib
import io
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_oracle import KINDS, SERVE_CLI_CASES, bits, reference_arrays, same_bits
from repro import serve as jserve
from repro.launch import faults as jfaults
from repro_torch import serve as tserve
from repro_torch.configs import gol3d as tconfigs
from repro_torch.launch import faults as tfaults
from repro_torch.launch import serve as tlaunch

PKGS = {"jax": (jserve, jfaults), "torch": (tserve, tfaults)}
MS = ((8, 4), (16, 4), (32, 8), (256, 8))  # (M, T)
DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")


def _random_boxes(M: int, n: int, seed: int) -> list[tuple]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lo = rng.integers(0, M, 3)
        hi = np.minimum(lo + rng.integers(1, M // 2 + 2, 3), M)
        out.append((tuple(int(v) for v in lo), tuple(int(v) for v in hi)))
    return out


def _suite_boxes(M: int) -> list[tuple]:
    return [(roi.lo, roi.hi) for _, roi in tconfigs.roi_suite(M)]


def _np_store(dtype: str, shape, seed: int) -> np.ndarray:
    """A store of ``dtype`` as the JAX package holds it (ml_dtypes for
    bf16 and fp8): normals, a tenth of them NaN in the narrow floats."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype != "float32":
        x[rng.random(shape) < 0.1] = np.nan
    return x.astype(getattr(ml_dtypes, dtype, None) or np.dtype(dtype))


def _torch_store(a: np.ndarray) -> torch.Tensor:
    """The same bits as a CPU tensor of the same dtype."""
    tdt = getattr(torch, a.dtype.name)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    width = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16)}[a.itemsize]
    raw = a.view(width[0]).copy()
    return torch.from_numpy(raw.view(np.int16) if a.itemsize == 2 else raw).view(tdt)


# ---------------------------------------------------------------------------
# 1. decomposition and the byte model
# ---------------------------------------------------------------------------

def test_roi_suite_is_the_benchmarks():
    from benchmarks.roi import roi_suite

    for M in (32, 64, 256):
        want = roi_suite(M)
        got = tconfigs.roi_suite(M)
        assert [n for n, _ in got] == [n for n, _ in want] == \
            ["octant", "octant_hi", "slab", "tile", "viewport"]
        assert [(r.lo, r.hi) for _, r in got] == [(r.lo, r.hi) for _, r in want]


@pytest.mark.parametrize("M,T", MS, ids=[f"M{m}" for m, _ in MS])
@pytest.mark.parametrize("kind", KINDS)
def test_roi_to_ranges_and_model_equal_jax(kind, M, T):
    """Ranges equal, model integers equal and utilization the same float,
    over the suite and random boxes; a box the reference refuses (the
    suite's viewport passes the edge at M=8) is refused alike."""
    tl = tserve.StoreLayout(M=M, T=T, kind=kind)
    jl = jserve.StoreLayout(M=M, T=T, kind=kind)
    tl2 = tserve.StoreLayout(M=M, T=T, kind=kind, channels=2)
    jl2 = jserve.StoreLayout(M=M, T=T, kind=kind, channels=2)
    boxes = _suite_boxes(M) + _random_boxes(M, 12, M + len(kind))
    checked = 0
    for lo, hi in boxes:
        try:
            want = jserve.roi_to_ranges(jl, jserve.ROI(lo, hi))
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tserve.roi_to_ranges(tl, tserve.ROI(lo, hi))
            continue
        roi_t = tserve.ROI(lo, hi)
        assert tserve.roi_to_ranges(tl, roi_t) == want
        assert all(type(a) is int and type(b) is int
                   for a, b in tserve.roi_to_ranges(tl, roi_t))
        for t_lay, j_lay, item in ((tl, jl, 4), (tl2, jl2, 2)):
            got = tserve.roi_model(t_lay, roi_t, itemsize=item)
            ref = jserve.roi_model(j_lay, jserve.ROI(lo, hi), itemsize=item)
            assert got == ref
        checked += 1
    assert checked >= len(boxes) - 1
    if M >= 32:  # the suite's contract: Hilbert below row-major on each ROI
        for name, roi in tconfigs.roi_suite(M):
            lay = lambda k: tserve.StoreLayout(M=M, T=T, kind=k)  # noqa: E731
            assert tserve.roi_model(lay("hilbert"), roi)["ranges"] < \
                tserve.roi_model(lay("row_major"), roi)["ranges"], name


def test_merge_ranges_and_validation_equal_jax():
    for idx in ([], [3], [5, 1, 2, 3, 9, 9, 10], list(range(8))):
        assert tserve.merge_blocks_to_ranges(np.asarray(idx)) == \
            jserve.merge_blocks_to_ranges(np.asarray(idx))
    rs = [(0, 3), (7, 9)]
    np.testing.assert_array_equal(tserve.ranges_to_blocks(rs),
                                  jserve.ranges_to_blocks(rs))
    assert tserve.ranges_to_blocks([]).dtype == np.int64
    for bad in (((0, 0, 0), (0, 1, 1)), ((1, 1), (2, 2)), ((-1, 0, 0), (1, 1, 1))):
        for pkg in (jserve, tserve):
            with pytest.raises(ValueError):
                pkg.ROI(*bad)
    for kw in ({"M": 16, "T": 5}, {"M": 4, "T": 8}, {"M": 16, "T": 4, "channels": 0}):
        for pkg in (jserve, tserve):
            with pytest.raises(ValueError):
                pkg.StoreLayout(**kw)
    for pkg in (jserve, tserve):
        with pytest.raises(ValueError, match="exceeds cube edge"):
            pkg.roi_to_ranges(pkg.StoreLayout(M=8, T=4), pkg.ROI((0, 0, 0), (9, 1, 1)))
    assert tserve.QUERY_STATUSES == jserve.QUERY_STATUSES
    with pytest.raises(ValueError, match="unknown status"):
        tserve.QueryResult(status="fine", roi=tserve.ROI((0, 0, 0), (1, 1, 1)))
    assert issubclass(tserve.FetchError, RuntimeError)


# ---------------------------------------------------------------------------
# 2. extraction and the manifest
# ---------------------------------------------------------------------------

def _extract_boxes(M):
    return [((0, 0, 0), (M, M, M)), ((0, 0, 0), (M // 2,) * 3),
            ((1, 2, 3), (M - 3, M - 1, M)), ((M - 1, 0, M // 2), (M, 1, M // 2 + 1))] \
        + _random_boxes(M, 4, 11)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e5m2"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_extract_roi_bit_equal_jax(kind, C, dtype):
    """Whole boxes, and boxes with two of their blocks skipped (their
    footprint NaN in the store's dtype): bit-equal, fp8 NaN where NaN."""
    M, T = 16, 4
    tl = tserve.StoreLayout(M=M, T=T, kind=kind, channels=C)
    jl = jserve.StoreLayout(M=M, T=T, kind=kind, channels=C)
    shape = (tl.nb, T, T, T) if C == 1 else (C, tl.nb, T, T, T)
    a = _np_store(dtype, shape, 3 + C)
    t = _torch_store(a)
    for lo, hi in _extract_boxes(M):
        rt, rj = tserve.ROI(lo, hi), jserve.ROI(lo, hi)
        blocks = tserve.ranges_to_blocks(tserve.roi_to_ranges(tl, rt))
        for skip in ((), tuple(int(b) for b in blocks[::max(1, len(blocks) // 2)][:2])):
            got = tserve.extract_roi(t, tl, rt, skip_blocks=skip)
            want = jserve.extract_roi(a, jl, rj, skip_blocks=skip)
            assert got.dtype == t.dtype and tuple(got.shape) == want.shape
            if dtype.startswith("float8"):
                assert same_bits(got, want)
            else:
                np.testing.assert_array_equal(bits(got), bits(want))
            if skip:
                assert bool(torch.isnan(got.float()).any())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rule", ["gol", "wave"])
def test_extract_roi_of_a_pipeline_store_is_the_dense_slice(kind, rule):
    """A ResidentPipeline's store, run two steps on the CPU: every box
    equals the slice of the unblockized cube, bit for bit."""
    from repro_torch.stencil import ResidentPipeline

    M = 8
    pipe = ResidentPipeline(M=M, T=4, rule=rule, kind=kind, device="cpu")
    cube = pipe.run(torch.from_numpy(tfaults.initial_state(rule, M, seed=1)), 2)
    store = pipe.to_blocks(cube)
    lay = tserve.StoreLayout.from_pipeline(pipe)
    for lo, hi in _extract_boxes(M):
        got = tserve.extract_roi(store, lay, tserve.ROI(lo, hi))
        sl = tuple(slice(l, h) for l, h in zip(lo, hi))
        assert torch.equal(got, cube[(Ellipsis,) + sl])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [1, 2])
def test_manifest_crcs_equal_jax(C, dtype):
    M, T = 16, 4
    nb = (M // T) ** 3
    shape = (nb, T, T, T) if C == 1 else (C, nb, T, T, T)
    a = _np_store(dtype, shape, 20 + C)
    lay_t = tserve.StoreLayout(M=M, T=T, kind="hilbert", channels=C)
    lay_j = jserve.StoreLayout(M=M, T=T, kind="hilbert", channels=C)
    got = tserve.StencilQueryService(store=_torch_store(a), layout=lay_t)._manifest
    want = jserve.StencilQueryService(store=a, layout=lay_j)._manifest
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_fault_plan_and_poison_flip_the_same_bytes():
    """ServeFaultPlan flips byte size//3 by 0x20 and poison_cache byte
    size//2 by 0x04, in both packages: the same bytes come out."""
    a = _np_store("float32", (2, 8, 4, 4, 4), 5)
    outs = {}
    for name, (serve, faults) in PKGS.items():
        plan = faults.ServeFaultPlan(fail_first=1, bitflip_first=1)
        fetch = plan.wrap_fetch(lambda s, e: a[:, s:e])
        with pytest.raises(serve.FetchError, match="injected fetch failure #1"):
            fetch(0, 8)
        flipped, clean = fetch(0, 8), fetch(0, 8)
        outs[name] = (bits(flipped), bits(clean))
        assert plan.calls == 3
    np.testing.assert_array_equal(outs["torch"][0], outs["jax"][0])
    np.testing.assert_array_equal(outs["torch"][1], bits(a))
    assert (outs["jax"][0] != bits(a)).sum() == 1
    poisoned = {}
    for name, (serve, _) in PKGS.items():
        svc, _, lay = _service(name)
        svc.query(OCTANT[name])
        b = int(serve.ranges_to_blocks(serve.roi_to_ranges(lay, OCTANT[name]))[0])
        assert svc.poison_cache(b) and not svc.poison_cache(10 ** 6)
        poisoned[name] = bits(svc._cache[b][0])
    np.testing.assert_array_equal(poisoned["torch"], poisoned["jax"])


# ---------------------------------------------------------------------------
# 3. the serving fault matrix, through both services
# ---------------------------------------------------------------------------

class FakeClock:
    """Injectable monotonic clock; ``sleep`` advances it (no real wait)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _service(pkg, kind="hilbert", M=16, T=4, C=1, clock=None, **kw):
    """tests/test_serve_roi.py's service, in package ``pkg``, on the same
    numpy store, under a fake clock (its own or ``clock``)."""
    serve = PKGS[pkg][0]
    rng = np.random.default_rng(7)
    lay = serve.StoreLayout(M=M, T=T, kind=kind, channels=C)
    shape = (lay.nb, T, T, T) if C == 1 else (C, lay.nb, T, T, T)
    store = rng.standard_normal(shape).astype(np.float32)
    kw.setdefault("backoff_s", 1e-4)
    clock = clock or FakeClock()
    kw.setdefault("clock", clock)
    kw.setdefault("sleep", clock.advance)
    return serve.StencilQueryService(store=store, layout=lay, **kw), store, lay


OCTANT = {p: PKGS[p][0].ROI((0, 0, 0), (8, 8, 8)) for p in PKGS}
MULTI = {p: PKGS[p][0].ROI((0, 0, 0), (16, 8, 8)) for p in PKGS}
FIELDS = ("status", "missing_ranges", "ranges", "retries", "integrity_failures",
          "quarantined", "cache_hits", "cache_misses", "fetch_calls", "elapsed_s",
          "error")


def _same_result(got, want):
    assert (got.roi.lo, got.roi.hi) == (want.roi.lo, want.roi.hi)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.complete == want.complete
    if want.payload is None:
        assert got.payload is None
    else:
        assert isinstance(got.payload, torch.Tensor)
        np.testing.assert_array_equal(bits(got.payload), bits(want.payload))


def _with_faults(svc, pkg, clock=None, **plan_kw):
    plan = PKGS[pkg][1].ServeFaultPlan(**plan_kw)
    svc.fetch = plan.wrap_fetch(svc.fetch, sleep=None if clock is None else clock.advance)
    return plan


def _s_query_ok(pkg, C):
    svc, _, _ = _service(pkg, C=C)
    return [svc.query(OCTANT[pkg])], svc


def _s_cache_hits_and_disabled(pkg):
    svc, _, _ = _service(pkg)
    out = [svc.query(OCTANT[pkg]), svc.query(OCTANT[pkg])]
    svc0, _, _ = _service(pkg, cache_blocks=0)
    out += [svc0.query(OCTANT[pkg]), svc0.query(OCTANT[pkg])]
    return out, svc


def _s_cache_poison(pkg):
    serve = PKGS[pkg][0]
    svc, _, lay = _service(pkg)
    out = [svc.query(OCTANT[pkg])]
    svc.poison_cache(int(serve.ranges_to_blocks(serve.roi_to_ranges(lay, OCTANT[pkg]))[0]))
    out += [svc.query(OCTANT[pkg]), svc.query(OCTANT[pkg])]
    return out, svc


def _s_transient(pkg):
    svc, _, _ = _service(pkg, max_retries=2)
    _with_faults(svc, pkg, svc.clock, fail_first=2)
    return [svc.query(OCTANT[pkg])], svc


def _s_exhausted_error(pkg):
    svc, _, _ = _service(pkg, max_retries=2)
    _with_faults(svc, pkg, svc.clock, fail_first=99)
    return [svc.query(OCTANT[pkg])], svc


def _s_exhausted_degraded(pkg):
    svc, _, _ = _service(pkg, kind="row_major", max_retries=2)
    _with_faults(svc, pkg, svc.clock, fail_first=3)
    return [svc.query(MULTI[pkg])], svc


def _s_bitflip_retried(pkg):
    svc, _, _ = _service(pkg, max_retries=2)
    _with_faults(svc, pkg, svc.clock, bitflip_first=1)
    return [svc.query(OCTANT[pkg])], svc


def _s_bitflip_every_fetch(pkg):
    svc, _, _ = _service(pkg, max_retries=1)
    _with_faults(svc, pkg, svc.clock, bitflip_first=99)
    return [svc.query(OCTANT[pkg])], svc


def _s_deadline(pkg):
    clock = FakeClock()
    svc, _, _ = _service(pkg, kind="row_major", clock=clock, deadline_s=0.5)
    plan = _with_faults(svc, pkg, clock, slow_first=99, slow_s=0.2)
    out = [svc.query(MULTI[pkg])]
    plan.slow_first = 0
    return out + [svc.query(MULTI[pkg])], svc


def _s_short_read(pkg):
    svc, _, _ = _service(pkg, max_retries=0)
    svc.fetch = lambda a, b: np.zeros((1, 1, 4, 4, 4), np.float32)
    return [svc.query(OCTANT[pkg])], svc


def _s_batch(pkg, workers):
    serve = PKGS[pkg][0]
    svc, _, _ = _service(pkg)
    rois = [OCTANT[pkg], serve.ROI((8, 8, 8), (16, 16, 16)),
            serve.ROI((1, 2, 3), (5, 9, 13)), serve.ROI((0, 0, 0), (16, 16, 16))]
    return svc.query_batch(rois, max_workers=workers), svc


def _s_batch_faults(pkg, workers):
    serve = PKGS[pkg][0]
    svc, _, _ = _service(pkg, max_retries=3)
    _with_faults(svc, pkg, svc.clock, fail_first=2, bitflip_first=1)
    rois = [OCTANT[pkg], serve.ROI((8, 0, 0), (16, 8, 8)), serve.ROI((0, 8, 0), (8, 16, 8))]
    return svc.query_batch(rois, max_workers=workers), svc


def _s_admission(pkg):
    svc, _, _ = _service(pkg, max_in_flight=2, cache_blocks=0)
    base = svc.fetch
    entered = threading.Semaphore(0)
    release = threading.Event()

    def gated(a, b):
        entered.release()
        assert release.wait(10)
        return base(a, b)

    svc.fetch = gated
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(svc.query, OCTANT[pkg], deadline_s=30) for _ in range(2)]
        assert entered.acquire(timeout=10) and entered.acquire(timeout=10)
        shed = [svc.query(OCTANT[pkg]) for _ in range(4)]
        release.set()
        held = [f.result(timeout=30) for f in futs]
    return shed + held, svc


SCENARIOS = {
    "query_ok_C1": lambda p: _s_query_ok(p, 1),
    "query_ok_C2": lambda p: _s_query_ok(p, 2),
    "cache_hits_and_disabled_cache": _s_cache_hits_and_disabled,
    "cache_poison_quarantined_and_refetched": _s_cache_poison,
    "transient_fetch_failures_recover": _s_transient,
    "exhausted_retries_all_missing_is_error": _s_exhausted_error,
    "exhausted_retries_partial_is_degraded": _s_exhausted_degraded,
    "bitflipped_fetch_caught_and_retried": _s_bitflip_retried,
    "bitflip_every_fetch_never_serves_wrong_bytes": _s_bitflip_every_fetch,
    "deadline_pressure_degrades_with_fake_clock": _s_deadline,
    "short_read_is_a_typed_fetch_error": _s_short_read,
    "query_batch_one_worker": lambda p: _s_batch(p, 1),
    "fault_plan_under_batch_one_worker": lambda p: _s_batch_faults(p, 1),
    "admission_control_sheds_typed_rejections": _s_admission,
}
# what each scenario must show, in both packages (tests/test_serve_roi.py)
EXPECT = {
    "query_ok_C1": ["ok"], "query_ok_C2": ["ok"],
    "cache_hits_and_disabled_cache": ["ok"] * 4,
    "cache_poison_quarantined_and_refetched": ["ok"] * 3,
    "transient_fetch_failures_recover": ["ok"],
    "exhausted_retries_all_missing_is_error": ["error"],
    "exhausted_retries_partial_is_degraded": ["degraded"],
    "bitflipped_fetch_caught_and_retried": ["ok"],
    "bitflip_every_fetch_never_serves_wrong_bytes": ["error"],
    "deadline_pressure_degrades_with_fake_clock": ["degraded", "ok"],
    "short_read_is_a_typed_fetch_error": ["error"],
    "query_batch_one_worker": ["ok"] * 4,
    "fault_plan_under_batch_one_worker": ["ok"] * 3,
    "admission_control_sheds_typed_rejections": ["rejected"] * 4 + ["ok"] * 2,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fault_matrix_equals_jax(name):
    """Every field of every QueryResult (elapsed_s on the fake clock
    included), the payload's bits and the service's stats equal."""
    want, jsvc = SCENARIOS[name]("jax")
    got, tsvc = SCENARIOS[name]("torch")
    assert [r.status for r in want] == EXPECT[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_result(g, w)
    assert tsvc.stats() == jsvc.stats()


@pytest.mark.parametrize("scenario", ["query_batch", "fault_plan_under_batch"])
def test_concurrent_batches_equal_jax(scenario):
    """The batches on a pool (which query meets which fault, and hits or
    misses a block another query cached, follows the interleaving): order
    kept, every outcome typed and ok, payloads equal to the reference's,
    the faults' retries and integrity failures counted in full."""
    fn = _s_batch if scenario == "query_batch" else _s_batch_faults
    want, _ = fn("jax", None)
    got, tsvc = fn("torch", None)
    assert [(r.roi.lo, r.roi.hi) for r in got] == [(r.roi.lo, r.roi.hi) for r in want]
    assert [r.status for r in got] == [r.status for r in want] == ["ok"] * len(want)
    for g, w in zip(got, want):
        assert g.ranges == w.ranges
        np.testing.assert_array_equal(bits(g.payload), bits(w.payload))
    if scenario == "fault_plan_under_batch":
        s = tsvc.stats()
        assert s["retries"] == 3 and s["integrity_failures"] == 1
    assert tsvc.stats()["in_flight"] == 0


def test_service_serves_bf16_and_fp8_stores_with_nan_fill():
    """Narrow stores: payloads in the store's dtype; a degraded query's
    missing footprint NaN in that dtype, the rest bit-equal to the JAX
    package's."""
    for dtype in ("bfloat16", "float8_e4m3fn"):
        a = _np_store(dtype, (64, 4, 4, 4), 9)
        out = {}
        for name, (serve, faults) in PKGS.items():
            lay = serve.StoreLayout(M=16, T=4, kind="row_major")
            clock = FakeClock()
            svc = serve.StencilQueryService(
                store=_torch_store(a) if name == "torch" else a, layout=lay,
                max_retries=2, backoff_s=1e-4, clock=clock, sleep=clock.advance)
            plan = faults.ServeFaultPlan(fail_first=3)
            svc.fetch = plan.wrap_fetch(svc.fetch, sleep=clock.advance)
            out[name] = svc.query(serve.ROI((0, 0, 0), (16, 8, 8)))
        got, want = out["torch"], out["jax"]
        assert got.status == want.status == "degraded"
        assert got.payload.dtype == getattr(torch, dtype)
        assert got.missing_ranges == want.missing_ranges
        assert same_bits(got.payload, want.payload)


# ---------------------------------------------------------------------------
# 4. the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_cli(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "serve_cli")


_Q = re.compile(r"^\[serve\]\s+(q\d+) (.*) status=(\S+)\s+ranges=\s*(\d+) "
                r"hits=\s*(\d+) misses=\s*(\d+) retries=(\d+) deadline=\s*[\d.]+ms"
                r"(?: exact=(\w+) missing=(.*))?$")


def _parse(text: str) -> dict:
    """Per query (roi, status, ranges, hits, misses, retries, exact,
    missing), the status counts, the cache line without its times, and
    whether it ended in SERVE_DONE."""
    lines = text.splitlines()
    queries = [m.groups() for m in map(_Q.match, lines) if m]
    counts = next(ln.split(": ", 1)[1] for ln in lines if " queries in " in ln)
    cache = next(ln for ln in lines if ln.startswith("[serve] cache:"))
    return {"queries": queries, "counts": counts, "cache": cache,
            "done": "SERVE_DONE" in lines}


@pytest.mark.parametrize("case", range(len(SERVE_CLI_CASES)))
def test_stencil_cli_on_cpu_equals_jax(ref_cli, case):
    args = tlaunch.build_parser().parse_args(
        ["--stencil", "--device", "cpu", *SERVE_CLI_CASES[case]])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results, stats, launches = tlaunch.stencil_main(args)
    got, want = _parse(out.getvalue()), _parse(str(ref_cli[f"stdout/{case}"]))
    assert got["done"] and want["done"]
    assert "SERVE_LAUNCHES " in out.getvalue() and not any(launches.values())
    assert all(q[7] in (None, "True") for q in got["queries"])
    if args.queries == 1:  # one query: every count is deterministic
        assert got == want
        return
    # the batch: the same boxes and decompositions, nothing shed, every
    # payload exact; the pool decides which query absorbs the faults
    assert [(q[0], q[1], q[3]) for q in got["queries"]] == \
        [(q[0], q[1], q[3]) for q in want["queries"]]
    assert len(got["queries"]) == args.queries
    for parsed in (got, want):
        assert {q[2] for q in parsed["queries"]} <= {"ok", "degraded", "error"}
        assert "shed=0" in parsed["cache"] and "integrity_failures=1" in parsed["cache"]
    assert [r.status for r in results] == [q[2] for q in got["queries"]]
    assert stats["integrity_failures"] == 1 and stats["shed"] == 0
