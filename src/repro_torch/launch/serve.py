"""Serving launcher: one front door for both serving paths, on the card
unless ``--device cpu``.

Default mode — batched greedy LM decode with a preallocated cache::

    python -m repro_torch.launch.serve --arch smollm-360m
    python -m repro_torch.launch.serve --arch smollm-360m --smoke --device cpu

``--stencil`` mode — the hardened ROI-query service over a curve-ordered
stencil block store (serve/service.py): advance a ResidentPipeline a few
steps on the device (the fused stencil kernel on the card), snapshot its
block store to the host, and drive a batched ROI query demo through the
fault matrix (failed and bit-flipped fetches with ``--faults``), checking
every delivered voxel against the dense cube and printing a per-request
outcome summary, ``SERVE_DONE`` and ``SERVE_LAUNCHES`` with the kernel
launches of the run as JSON::

    python -m repro_torch.launch.serve --stencil --M 256 --faults
    python -m repro_torch.launch.serve --stencil --M 16 --faults --device cpu

The torch counterpart of ``repro.launch.serve``: its options plus
``--device``. Weights are random, drawn from a ``torch.Generator`` seeded
with ``--seed``; prompts from ``numpy.random.default_rng(--seed)``.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="LM mode: model config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    # stencil ROI-service mode
    ap.add_argument("--stencil", action="store_true",
                    help="serve ROI queries over a stencil block store "
                         "instead of LM decode")
    ap.add_argument("--M", type=int, default=32)
    ap.add_argument("--T", type=int, default=8)
    ap.add_argument("--ordering", default="hilbert")
    ap.add_argument("--rule", default="gol")
    ap.add_argument("--bc", default="periodic")
    ap.add_argument("--steps", type=int, default=4,
                    help="pipeline steps before the snapshot is served")
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--deadline-ms", type=float, default=100.0)
    ap.add_argument("--cache-blocks", type=int, default=256)
    ap.add_argument("--max-in-flight", type=int, default=4)
    ap.add_argument("--faults", action="store_true",
                    help="inject the serving fault matrix (failed + "
                         "bit-flipped fetches, cache poison)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    return ap


def lm_main(args):
    """Serve ``args.batch`` random prompts; returns the (B, new) tokens."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.core.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.serve import greedy_decode

    if args.arch is None:
        raise SystemExit("LM mode needs --arch")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len), np.int32)).to(dev)
    t0 = time.perf_counter()
    out = greedy_decode(model, prompts, args.new_tokens,
                        args.prompt_len + args.new_tokens + 1)
    out = out.cpu()
    dt = time.perf_counter() - t0
    n = args.batch * args.new_tokens
    print(f"[serve] {cfg.name} on {dev}: {n} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s)")
    return out


def _demo_rois(M: int, T: int, n: int, seed: int):
    """Deterministic ROI mix, the JAX package's: aligned power-of-two
    boxes (the best-case contiguity suite) plus arbitrary unaligned boxes."""
    import numpy as np

    from repro_torch.serve import ROI

    rois = [ROI((0, 0, 0), (M // 2,) * 3),
            ROI((M // 2,) * 3, (M,) * 3),
            ROI((0, 0, 0), (M, M // 2, M // 2))]
    rng = np.random.default_rng(seed)
    while len(rois) < n:
        lo = rng.integers(0, M - T, 3)
        ext = rng.integers(T, M // 2 + 1, 3)
        hi = np.minimum(lo + ext, M)
        rois.append(ROI(tuple(int(v) for v in lo),
                        tuple(int(v) for v in hi)))
    return rois[:n]


def stencil_main(args):
    """Serve the ROI demo over a snapshot of a ResidentPipeline run on
    ``args.device``; returns ``(results, stats, launches)``. A payload
    that differs from the dense cube where it was delivered exits."""
    import json

    import torch

    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.faults import ServeFaultPlan, initial_state
    from repro_torch.serve import StencilQueryService, StoreLayout
    from repro_torch.stencil import ResidentPipeline

    dev = resolve_device(args.device)
    pipe = ResidentPipeline(M=args.M, T=args.T, rule=args.rule, bc=args.bc,
                            kind=args.ordering, device=dev)
    state0 = initial_state(args.rule, args.M, seed=args.seed)
    _build.reset_launches()
    cube = pipe.run(torch.from_numpy(state0).to(dev), args.steps)
    store = pipe.to_blocks(cube)
    launches = dict(_build.LAUNCHES)
    layout = StoreLayout.from_pipeline(pipe)
    print(f"[serve] stencil snapshot: rule={args.rule} M={args.M} "
          f"T={args.T} ordering={args.ordering} C={layout.channels} "
          f"({layout.nb} blocks) after {args.steps} steps on {dev}")

    svc = StencilQueryService(
        store=store, layout=layout, cache_blocks=args.cache_blocks,
        deadline_s=args.deadline_ms / 1e3, max_in_flight=args.max_in_flight)
    if args.faults:
        plan = ServeFaultPlan(fail_first=2, bitflip_first=1)
        svc.fetch = plan.wrap_fetch(svc.fetch)
        print("[serve] fault injection ON: first 2 fetches fail, "
              "next payload bit-flipped")

    rois = _demo_rois(args.M, args.T, args.queries, args.seed)
    t0 = time.perf_counter()
    results = svc.query_batch(rois)
    dt = time.perf_counter() - t0

    dense = cube.cpu()
    for i, (roi, r) in enumerate(zip(rois, results)):
        line = (f"[serve]  q{i:02d} {roi.lo}->{roi.hi} "
                f"status={r.status:9s} ranges={len(r.ranges):2d} "
                f"hits={r.cache_hits:3d} misses={r.cache_misses:3d} "
                f"retries={r.retries} deadline={r.elapsed_s * 1e3:6.1f}ms")
        if r.status in ("ok", "degraded") and r.payload is not None:
            sl = tuple(slice(l, h) for l, h in zip(roi.lo, roi.hi))
            want = dense[(Ellipsis,) + sl]
            served = ~torch.isnan(r.payload) if r.status == "degraded" \
                else torch.ones_like(r.payload, dtype=torch.bool)
            exact = torch.equal(r.payload[served], want[served])
            line += f" exact={exact} missing={list(r.missing_ranges)}"
            if not exact:
                raise SystemExit(f"payload mismatch on q{i}")
        print(line)

    by = {}
    for r in results:
        by[r.status] = by.get(r.status, 0) + 1
    s = svc.stats()
    print(f"[serve] {len(results)} queries in {dt * 1e3:.1f}ms: "
          + " ".join(f"{k}={v}" for k, v in sorted(by.items())))
    print(f"[serve] cache: {s['cache_hits']} hits / {s['cache_misses']} "
          f"misses ({s['cached_blocks']} resident), "
          f"fetches={s['fetch_calls']} retries={s['retries']} "
          f"integrity_failures={s['integrity_failures']} "
          f"quarantined={s['quarantined']} shed={s['shed']}")
    print("SERVE_DONE")
    print(f"SERVE_LAUNCHES {json.dumps(launches)}", flush=True)
    return results, s, launches


def main():
    args = build_parser().parse_args()
    if args.stencil:
        stencil_main(args)
    else:
        lm_main(args)


if __name__ == "__main__":
    main()
