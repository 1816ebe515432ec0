"""Serving: single-token decode step + a batched decode loop.

The torch counterpart of ``repro.serve.serve_step``. ``make_serve_step``
is one new token against a cache preallocated at ``max_len``;
``greedy_decode`` fills the cache by teacher-forced steps over the
prompts, then decodes greedily (static batch). The cache is written in
place at position ``cur`` (the JAX package's ``dynamic_update_slice``,
same numbers), so a step returns the cache it was given.
"""

from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.zoo import Model

__all__ = ["make_serve_step", "greedy_decode"]


def make_serve_step(model: Model):
    def serve_step(cache, batch):
        """batch: {tokens:(B,1) int32, cur: int} -> (next tokens (B,) int32,
        cache). Greedy; sampling is not ported yet (ROADMAP.md)."""
        logits, cache = model.decode(cache, batch)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        return nxt.to(torch.int32), cache

    return serve_step


@torch.no_grad()
def greedy_decode(model: Model, prompts: torch.Tensor, n_new: int,
                  max_len: int) -> torch.Tensor:
    """Prefill via teacher-forced steps, then greedy decode n_new tokens.

    prompts: (B, P) int32 on the model's device. Returns (B, n_new) int32.
    The f32 cache holds ``max_len`` positions (at least P + n_new - 1).
    """
    dev = resolve_device(model.device)
    B, P = prompts.shape
    if P + n_new - 1 > max_len:
        raise ValueError(f"max_len={max_len} < P + n_new - 1 = {P + n_new - 1}")
    prompts = prompts.to(dev)
    cache = model.init_cache(B, max_len, torch.float32)
    step = make_serve_step(model)
    tok = prompts[:, :1]
    out = []
    for t in range(P + n_new - 1):
        nxt, cache = step(cache, {"tokens": tok, "cur": t})
        if t + 1 < P:
            tok = prompts[:, t + 1:t + 2]
        else:
            tok = nxt[:, None]
            out.append(nxt)
    return torch.stack(out, dim=1)
