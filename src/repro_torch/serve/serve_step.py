"""Serving: single-token decode step + a batched decode loop.

The torch counterpart of ``repro.serve.serve_step``. ``make_serve_step``
is one new token against a cache preallocated at ``max_len``, greedy or
sampled at a temperature; ``greedy_decode`` fills the cache by
teacher-forced steps over the prompts, then decodes greedily (static
batch). The cache is written in place at position ``cur`` (the JAX
package's ``dynamic_update_slice``, same numbers), so a step returns the
cache it was given.

Sampling is the Gumbel-max form of the JAX package's
``jax.random.categorical``: the next token is ``argmax(logits /
temperature + g)`` with ``g`` standard Gumbel noise. ``g`` comes from an
explicit ``torch.Generator`` (JAX's random streams cannot be reproduced
in torch), or from the batch's ``"gumbel"`` tensor, through which noise
drawn elsewhere (e.g. by ``jax.random.gumbel`` with the same key the JAX
step is given) gives the same tokens.
"""

from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.zoo import Model

__all__ = ["make_serve_step", "greedy_decode", "gumbel_noise"]


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform in [tiny, 1)
    (f32) from ``generator``, which must live on ``device``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _vocab_whole(lg):
    """(B, V) logits with the vocab whole on every rank where they are a
    DTensor (a split or partial vocab replicated, a split batch kept):
    DTensor's argmax over a vocab split on two mesh dims breaks. A plain
    tensor passes through."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(lg, DTensor):
        return lg
    want = tuple(Replicate() if pl.is_partial() or pl.is_shard(lg.ndim - 1) else pl
                 for pl in lg.placements)
    return lg if want == tuple(lg.placements) else lg.redistribute(placements=want)


def make_serve_step(model: Model, *, sample: bool = False,
                    temperature: float = 1.0,
                    generator: torch.Generator | None = None):
    """A step ``(cache, batch) -> (next tokens (B,) int32, cache)``; batch:
    {tokens: (B,1) int32, cur: int, gumbel: (B, V) f32 (optional)}. Greedy
    unless ``sample``; sampling draws from ``generator`` where the batch
    brings no ``"gumbel"``, and raises if it has neither."""
    if sample and temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")

    def serve_step(cache, batch):
        logits, cache = model.decode(cache, batch)
        lg = _vocab_whole(logits[:, -1])
        if sample:
            g = batch.get("gumbel")
            if g is None:
                if generator is None:
                    raise ValueError("sampling needs a generator or a batch "
                                     "'gumbel' tensor")
                g = gumbel_noise(lg.shape, generator, lg.device)
            lg = lg / temperature + g.to(lg.device)
        nxt = torch.argmax(lg, dim=-1)
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
