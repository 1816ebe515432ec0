"""Hardened ROI-query service over the curve-ordered block store.

The torch counterpart of ``repro.serve.service``.
:class:`StencilQueryService` fronts a ``(C, nb, T³)`` block-store
snapshot with a robustness layer: a query that cannot be answered
correctly and on time degrades into a *typed* partial response — never a
hang, never a silently wrong payload.

The contract, fault by fault (launch/faults.ServeFaultPlan injects all
of these):

- **slow fetch** — each fetch attempt is preceded by a deadline check;
  time lost to a slow storage tier surfaces as ``status="degraded"``
  with the undelivered blocks named in ``missing_ranges``.
- **failed fetch** — bounded retry with exponential backoff (sleeps
  never overshoot the deadline); transient faults recover to
  ``status="ok"``, exhausted budgets degrade.
- **bit-flipped block** — every fetched block is crc32-verified against
  the integrity manifest built from the snapshot at construction; a
  mismatch counts as a failed attempt and is retried.
- **cache poison** — cache entries carry their crc and are verified on
  every hit; a corrupt entry is quarantined (dropped, counted) and the
  block re-fetched, so poison can never reach a payload.
- **deadline exceeded / overload** — per-request deadlines bound every
  loop, and admission control sheds load beyond ``max_in_flight``
  concurrent queries with ``status="rejected"`` before any work starts.

Cache misses are fetched one contiguous run of curve indices at a time,
so on a curve with good 3-D locality a whole query is a handful of
sequential reads (``fetch_calls`` in the result counts them).

The snapshot is a CPU tensor in the store's dtype, copied once from the
card when the store lives there; the crc32 of a block is that of its
C-order bytes, the JAX package's ``_crc`` of the same block. Payloads are
CPU tensors in the store's dtype, written straight from the delivered
blocks (the reference assembles a zeroed copy of the whole store first;
the payload is the same, bit for bit). The service is thread-safe (one
``RLock`` over the cache, the in-flight count and the stats;
``query_batch`` drives it from a pool); the clock and sleep are
injectable so the deadline machinery is exactly testable without real
waiting.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .roi import (ROI, StoreLayout, _as_store5, as_host, decode_blocks,
                  merge_blocks_to_ranges, roi_to_ranges)

__all__ = ["StencilQueryService", "QueryResult", "FetchError",
           "QUERY_STATUSES"]

#: the typed outcome vocabulary — every query ends in exactly one of these
QUERY_STATUSES = ("ok", "degraded", "rejected", "error")


class FetchError(RuntimeError):
    """A storage fetch failed (transient or injected). Retried with
    backoff up to the service's budget; never propagates to callers —
    exhausted budgets surface as a degraded/error QueryResult."""


@dataclass(frozen=True)
class QueryResult:
    """Typed outcome of one ROI query.

    status:         "ok" (full payload) | "degraded" (partial payload,
                    ``missing_ranges`` non-empty) | "rejected" (load
                    shed at admission, no work done) | "error" (nothing
                    deliverable)
    roi:            the query box
    payload:        dense ``(C,) + roi.shape`` CPU tensor in the store's
                    dtype (C=1: plain 3-D); missing blocks' footprints
                    hold NaN; None for rejected/error
    missing_ranges: contiguous curve ranges NOT delivered
    ranges:         the full decomposition of the ROI
    retries:        fetch attempts beyond the first, summed over ranges
    integrity_failures: fetched blocks that failed the manifest crc —
                    each also counts one retry
    quarantined:    poisoned cache entries dropped by verify-on-hit
    cache_hits/cache_misses/fetch_calls: cache economics of this query
    elapsed_s:      service-clock duration
    error:          human-readable reason for degraded/rejected/error
    """
    status: str
    roi: ROI
    payload: "torch.Tensor | None" = None
    missing_ranges: tuple = ()
    ranges: tuple = ()
    retries: int = 0
    integrity_failures: int = 0
    quarantined: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    fetch_calls: int = 0
    elapsed_s: float = 0.0
    error: "str | None" = None

    def __post_init__(self):
        if self.status not in QUERY_STATUSES:
            raise ValueError(f"unknown status {self.status!r} "
                             f"(expected one of {QUERY_STATUSES})")

    @property
    def complete(self) -> bool:
        return self.status == "ok"


def _bytes(t: torch.Tensor) -> np.ndarray:
    """The bytes of a CPU tensor as a uint8 array, its last axis widened
    by the element size (a view where the tensor is contiguous)."""
    return t.contiguous().view(torch.uint8).numpy()


def _crc(raw: np.ndarray) -> int:
    """crc32 of a ``(C, ...)`` block's bytes (:func:`_bytes`) in C order:
    zlib's running crc over each channel's contiguous bytes in turn."""
    crc = 0
    for ch in raw:
        crc = zlib.crc32(ch, crc)
    return crc


@dataclass
class StencilQueryService:
    """ROI queries over one block-store snapshot, hardened end to end.

    store:        the ``(nb, T³)`` / ``(C, nb, T³)`` snapshot (a tensor
                  on the card or the host, or a numpy array; copied to
                  the host once)
    layout:       :class:`StoreLayout` (or use :meth:`from_pipeline`)
    fetch:        ``fetch(start, stop) -> (C, n, T, T, T)`` storage read
                  of one contiguous curve range; default reads the
                  snapshot. Fault injection wraps this
                  (launch/faults.ServeFaultPlan).
    cache_blocks: LRU capacity in blocks (0 disables caching)
    deadline_s:   default per-request wall budget
    max_retries:  fetch attempts per contiguous run beyond the first
    backoff_s:    base of the exponential retry backoff
    max_in_flight: admission budget — queries beyond this many
                  concurrent are shed with status="rejected"
    clock/sleep:  injectable time sources (tests pin them)
    """
    store: torch.Tensor
    layout: StoreLayout
    fetch: "callable | None" = None
    cache_blocks: int = 256
    deadline_s: float = 1.0
    max_retries: int = 2
    backoff_s: float = 0.01
    max_in_flight: int = 8
    clock: "callable" = time.monotonic
    sleep: "callable" = time.sleep

    # internal state ------------------------------------------------------
    _cache: "OrderedDict[int, tuple[torch.Tensor, int]]" = field(
        default_factory=OrderedDict, repr=False)
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False)
    _in_flight: int = field(default=0, repr=False)
    _stats: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.store = as_host(self.store)
        store5 = _as_store5(self.store, self.layout)
        if self.fetch is None:
            self.fetch = lambda a, b: store5[:, a:b]
        # integrity manifest: each block's crc32, computed once from the
        # snapshot — every fetched block and every cache hit is verified
        # against it
        raw = _bytes(store5)
        self._manifest = np.array([_crc(raw[:, b]) for b in range(self.layout.nb)],
                                  dtype=np.int64)
        self._stats = {"queries": 0, "shed": 0, "cache_hits": 0,
                       "cache_misses": 0, "fetch_calls": 0,
                       "quarantined": 0, "integrity_failures": 0,
                       "retries": 0, "degraded": 0, "errors": 0}

    @classmethod
    def from_pipeline(cls, pipeline, store, **kw) -> "StencilQueryService":
        """Front a pipeline's block store (e.g. the state a
        ResidentPipeline run left behind)."""
        return cls(store=store, layout=StoreLayout.from_pipeline(pipeline),
                   **kw)

    # -- cache (LRU, crc-carrying, verify-on-hit) -------------------------
    def _cache_get(self, b: int) -> "torch.Tensor | str | None":
        """A verified cache hit, or None. A corrupt entry (crc mismatch
        — cache poison) is quarantined: dropped, counted, re-fetched by
        the caller. Never returns poisoned bytes."""
        with self._lock:
            hit = self._cache.get(b)
            if hit is None:
                return None
            data, crc = hit
            if _crc(_bytes(data)) != crc:
                del self._cache[b]
                self._stats["quarantined"] += 1
                return "quarantined"
            self._cache.move_to_end(b)
            return data

    def _cache_put(self, b: int, data: torch.Tensor) -> None:
        if self.cache_blocks <= 0:
            return
        data = data.contiguous()  # a view of the fetched run; never written
        with self._lock:
            self._cache[b] = (data, _crc(_bytes(data)))
            self._cache.move_to_end(b)
            while len(self._cache) > self.cache_blocks:
                self._cache.popitem(last=False)

    def poison_cache(self, b: int) -> bool:
        """Fault injection: flip one bit of a cached block (True when the
        block was cached), in a copy that keeps the recorded crc.
        Verify-on-hit must quarantine it."""
        with self._lock:
            hit = self._cache.get(b)
            if hit is None:
                return False
            data = hit[0].clone()
            raw = data.reshape(-1).view(torch.uint8)
            raw[raw.numel() // 2] ^= 0x04
            self._cache[b] = (data, hit[1])
            return True

    # -- fetch with deadline/retry/integrity ------------------------------
    def _fetch_run(self, start: int, stop: int, t_end: float, res: dict
                   ) -> "torch.Tensor | None":
        """One contiguous run read under the deadline: bounded retry with
        exponential backoff; every block crc-verified against the
        manifest. None when the budget (time or retries) is exhausted."""
        attempt = 0
        while True:
            if self.clock() >= t_end:
                res["error"] = "deadline exceeded"
                return None
            try:
                res["fetch_calls"] += 1
                data = as_host(self.fetch(start, stop))
                if tuple(data.shape) != (self.layout.channels, stop - start) + \
                        (self.layout.T,) * 3:
                    raise FetchError(f"short read: got {tuple(data.shape)} "
                                     f"for range [{start}, {stop})")
                raw = _bytes(data)
                bad = [b for b in range(start, stop)
                       if _crc(raw[:, b - start]) != self._manifest[b]]
                if bad:
                    res["integrity_failures"] += len(bad)
                    raise FetchError(
                        f"integrity failure: crc mismatch on block(s) "
                        f"{bad} of range [{start}, {stop})")
                return data
            except FetchError as e:
                res["error"] = str(e)
                if attempt >= self.max_retries:
                    return None
                attempt += 1
                res["retries"] += 1
                delay = self.backoff_s * (2 ** (attempt - 1))
                remaining = t_end - self.clock()
                if remaining <= 0:
                    res["error"] = "deadline exceeded"
                    return None
                self.sleep(min(delay, remaining))

    # -- the query --------------------------------------------------------
    def query(self, roi: ROI, *, deadline_s: "float | None" = None
              ) -> QueryResult:
        """Answer one ROI query with a typed outcome — see the module
        docstring for the full fault contract."""
        t0 = self.clock()
        with self._lock:
            self._stats["queries"] += 1
            if self._in_flight >= self.max_in_flight:
                self._stats["shed"] += 1
                return QueryResult(
                    status="rejected", roi=roi,
                    error=f"admission control: {self._in_flight} queries "
                          f"in flight >= budget {self.max_in_flight}",
                    elapsed_s=self.clock() - t0)
            self._in_flight += 1
        try:
            return self._query_admitted(roi, deadline_s, t0)
        finally:
            with self._lock:
                self._in_flight -= 1

    def _query_admitted(self, roi: ROI, deadline_s, t0) -> QueryResult:
        t_end = t0 + (self.deadline_s if deadline_s is None else deadline_s)
        ranges = roi_to_ranges(self.layout, roi)
        res = {"fetch_calls": 0, "retries": 0, "integrity_failures": 0,
               "cache_hits": 0, "cache_misses": 0, "error": None}
        got: dict[int, torch.Tensor] = {}
        missing: list[int] = []
        quarantined = 0
        for start, stop in ranges:
            # cache pass: verified hits; poisoned entries quarantine here
            miss: list[int] = []
            for b in range(start, stop):
                if self.clock() >= t_end:
                    res["error"] = "deadline exceeded"
                    miss = None
                    break
                hit = self._cache_get(b)
                if isinstance(hit, torch.Tensor):
                    res["cache_hits"] += 1
                    got[b] = hit
                    continue
                if hit == "quarantined":
                    quarantined += 1
                res["cache_misses"] += 1
                miss.append(b)
            if miss is None:  # deadline tripped mid-scan
                missing.extend(b for b in range(start, stop) if b not in got)
                continue
            # fetch pass: contiguous runs of misses, one storage read each
            for m0, m1 in merge_blocks_to_ranges(np.asarray(miss)):
                data = self._fetch_run(m0, m1, t_end, res)
                if data is None:
                    missing.extend(range(m0, m1))
                    continue
                for b in range(m0, m1):
                    blk = data[:, b - m0]
                    got[b] = blk
                    self._cache_put(b, blk)
        elapsed = self.clock() - t0
        with self._lock:
            for k in ("cache_hits", "cache_misses", "fetch_calls",
                      "retries", "integrity_failures"):
                self._stats[k] += res[k]
        missing_ranges = tuple(merge_blocks_to_ranges(np.asarray(missing)))
        if missing and not got:
            with self._lock:
                self._stats["errors"] += 1
            return QueryResult(
                status="error", roi=roi, payload=None,
                missing_ranges=missing_ranges, ranges=tuple(ranges),
                retries=res["retries"],
                integrity_failures=res["integrity_failures"],
                quarantined=quarantined, cache_hits=res["cache_hits"],
                cache_misses=res["cache_misses"],
                fetch_calls=res["fetch_calls"], elapsed_s=elapsed,
                error=res["error"] or "no blocks deliverable")
        payload = self._assemble(roi, ranges, got)
        status = "ok" if not missing else "degraded"
        if missing:
            with self._lock:
                self._stats["degraded"] += 1
        return QueryResult(
            status=status, roi=roi, payload=payload,
            missing_ranges=missing_ranges, ranges=tuple(ranges),
            retries=res["retries"],
            integrity_failures=res["integrity_failures"],
            quarantined=quarantined, cache_hits=res["cache_hits"],
            cache_misses=res["cache_misses"],
            fetch_calls=res["fetch_calls"], elapsed_s=elapsed,
            error=res["error"] if missing else None)

    def _assemble(self, roi: ROI, ranges, got: dict) -> torch.Tensor:
        """Delivered blocks → dense ROI box, written straight into the
        payload; undelivered blocks' footprints stay NaN (the degraded
        fill). C=1 payloads are plain 3-D boxes (the store convention)."""
        out = decode_blocks(got, self.layout, roi, ranges, self.store.dtype)
        return out if self.layout.channels > 1 else out[0]

    def query_batch(self, rois, *, deadline_s: "float | None" = None,
                    max_workers: "int | None" = None) -> list:
        """Concurrent batch of queries (order-preserving). Each query is
        independently admitted/deadlined; overload surfaces as typed
        ``rejected`` results, never an exception."""
        workers = max_workers or min(len(rois), self.max_in_flight + 2) or 1
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(
                lambda r: self.query(r, deadline_s=deadline_s), rois))

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats, cached_blocks=len(self._cache),
                        in_flight=self._in_flight)
