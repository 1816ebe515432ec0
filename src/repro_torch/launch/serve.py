"""Serving launcher, LM mode: batched greedy decode with a preallocated
cache, on the card unless ``--device cpu``::

    python -m repro_torch.launch.serve --arch smollm-360m
    python -m repro_torch.launch.serve --arch smollm-360m --smoke --device cpu

The torch counterpart of ``repro.launch.serve``: its LM options plus
``--device``. Weights are random, drawn from a ``torch.Generator`` seeded
with ``--seed``; prompts from ``numpy.random.default_rng(--seed)``.
``--stencil`` (the ROI-query service) is not ported yet and raises; its
options come with it (ROADMAP.md queue 1, item 10).
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
    # the stencil ROI-service mode is not ported: --stencil only raises
    ap.add_argument("--stencil", action="store_true",
                    help="ROI-query service (not ported yet: raises)")
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


def main():
    args = build_parser().parse_args()
    if args.stencil:
        raise SystemExit("--stencil (the ROI-query service) is not ported to "
                         "the torch package yet: ROADMAP.md queue 1, item 10")
    lm_main(args)


if __name__ == "__main__":
    main()
