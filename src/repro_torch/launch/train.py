"""Training launcher, on the card unless ``--device cpu``::

    python -m repro_torch.launch.train --arch smollm-360m --steps 100 --smoke
    python -m repro_torch.launch.train --arch smollm-360m --smoke --steps 3 \\
        --batch 2 --seq 32 --device cpu --ckpt-dir /tmp/ck

The torch counterpart of ``repro.launch.train``: its options plus
``--device``, one process on one device. The enc-dec and VLM
architectures exit non-zero, as there: they train through
``Trainer(..., extra_batch=...)`` with their frames or patches.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    return ap


def main(args) -> None:
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model
    from repro_torch.train import OptConfig, Trainer, TrainerConfig, TrainConfig

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit(f"{args.arch}: use a family-specific driver for the "
                         "stubbed-frontend archs (examples/)")
    model = Model(cfg, device=args.device)
    print(f"[train] {cfg.name}: {model.n_params()/1e6:.1f}M params on "
          f"{model.device}")
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=10,
        train=TrainConfig(
            opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
            microbatches=args.microbatches))
    Trainer(model, pipe, tcfg).run(resume=args.resume)


if __name__ == "__main__":
    main(build_parser().parse_args())
