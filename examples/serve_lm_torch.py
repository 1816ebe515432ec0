"""Batched serving demo on the torch port: prefill + greedy decode over
concurrent requests.

The twin of ``examples/serve_lm.py`` on ``repro_torch``, on the card
unless ``--device cpu``. Builds the same reduced gemma3-family model
(sliding-window + global layers — the long-context serving case), loads
a batch of prompts, and decodes new tokens for all requests in lockstep
with a preallocated cache (the shape-stable regime a continuous-batching
server runs in).

``greedy_decode`` runs the prompt through teacher-forced decode steps,
as the JAX package does, and decode attention (``gqa_decode``) is plain
PyTorch there too, so this demo launches no hand-written kernel; the
prefill through the flash kernel is ``chip_smoke.py``'s. The weights
are drawn on the CPU from ``torch.Generator().manual_seed(0)`` and then
moved, so the card and the CPU serve the same model.

Run: PYTHONPATH=src python examples/serve_lm_torch.py [--new-tokens 32] [--device cpu]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import Model
from repro_torch.serve import greedy_decode


def reduced_config():
    return dataclasses.replace(
        get_config("gemma3-1b"), n_layers=6, d_model=256, n_heads=4,
        n_kv_heads=1, head_dim=64, d_ff=512, vocab=4096, sliding_window=32,
        global_every=3, activation_dtype="float32")


def seeded_model(cfg, dev) -> Model:
    """``cfg``'s model on ``dev`` with weights drawn on the CPU."""
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if dev.type == "cpu":
        return cpu
    model = Model(cfg, device=dev)
    with torch.no_grad():
        for p, q in zip(model.parameters(), cpu.parameters()):
            p.copy_(q)
    return model


def prompts_for(vocab: int, batch: int, prompt_len: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, (batch, prompt_len), np.int32)


def serve(model: Model, prompts: np.ndarray, new_tokens: int):
    """(tokens (B, new_tokens) on the CPU, seconds) of ``greedy_decode``."""
    dev = model.device
    max_len = prompts.shape[1] + new_tokens + 1
    t0 = time.perf_counter()
    out = greedy_decode(model, torch.from_numpy(prompts).to(dev), new_tokens,
                        max_len)
    out = out.cpu()
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config()
    model = seeded_model(cfg, dev)
    print(f"[serve_lm] {model.n_params()/1e6:.1f}M-param gemma3-family model, "
          f"{args.batch} concurrent requests")

    prompts = prompts_for(cfg.vocab, args.batch, args.prompt_len)
    out, dt = serve(model, prompts, args.new_tokens)
    total_new = args.batch * args.new_tokens
    print(f"[serve_lm] decoded {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s incl. prefill)")
    for b in range(min(args.batch, 2)):
        print(f"  req{b}: {out[b][:12].tolist()} ...")
    if not bool(torch.isfinite(out.float()).all()):
        raise RuntimeError("decoded tokens are not finite")
    if tuple(out.shape) != (args.batch, args.new_tokens):
        raise RuntimeError(f"decoded {tuple(out.shape)}, want "
                           f"{(args.batch, args.new_tokens)}")
    print("done.")
    return {"tokens": out, "seconds": dt, "tok_per_s": total_new / dt,
            "n_params": model.n_params()}


if __name__ == "__main__":
    main()
