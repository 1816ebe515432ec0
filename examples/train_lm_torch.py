"""End-to-end training on the torch port: train a ~100M-class LM for a few
hundred steps.

The twin of ``examples/train_lm.py`` on ``repro_torch``, on the card
unless ``--device cpu``. Uses a width/depth-reduced smollm-family config
(llama arch: GQA + RoPE + SwiGLU) against the deterministic synthetic
pipeline, with the full production loop: AdamW + cosine schedule, f32
master weights, grad accumulation, async atomic checkpoints, restart
support.

Attention runs through the hand-written flash kernels
(``use_flash_kernel``): on the card, ``flash_attention_fwd`` and
``flash_attention_bwd``. ``--full`` trains the real 360M config at full
width in bf16 activations (their Hopper designs: each microbatch folds
4 sequences × 15 heads); the default reduced config runs f32
activations (their simple designs). On the CPU the kernels' plain
versions run.

Run: PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--resume] [--device cpu]
"""

import argparse
import dataclasses
import math
import os
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import TokenPipeline
from repro_torch.models import Model
from repro_torch.train import OptConfig, Trainer, TrainerConfig, TrainConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="train the real smollm-360m config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(get_config("smollm-360m"), use_flash_kernel=True)
    if not args.full:
        # ~25M-param reduction of the same family (CPU-friendly)
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=384, n_heads=6, n_kv_heads=2,
            head_dim=64, d_ff=1024, vocab=8192, activation_dtype="float32")
    model = Model(cfg, device=dev)
    print(f"[train_lm] {cfg.name}: {model.n_params()/1e6:.1f}M params")

    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=0)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 4, 50),
        ckpt_dir=args.ckpt_dir, log_every=10,
        train=TrainConfig(opt=OptConfig(lr=6e-4, warmup_steps=30,
                                        total_steps=args.steps),
                          microbatches=2))
    trainer = Trainer(model, pipe, tcfg)
    _, _, log = trainer.run(resume=args.resume)
    first = sum(m["loss"] for m in log[:10]) / max(len(log[:10]), 1)
    last = sum(m["loss"] for m in log[-10:]) / max(len(log[-10:]), 1)
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} over {len(log)} steps")
    losses = [m["loss"] for m in log]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss in {losses}")
    return {"steps": [m["step"] for m in log], "losses": losses,
            "step_ms": [1e3 * m["step_time"] for m in log],
            "first": first, "last": last, "n_params": model.n_params()}


if __name__ == "__main__":
    main()
