"""Plain PyTorch reference of the FDTD wave leapfrog on a periodic cube.

The state is two fields u and v on an (M, M, M) row-major grid, stacked
(2, M, M, M) in float32. One timestep, with g the stencil radius and
n = (2g+1)³ - 1 neighbours:

    lap u = (sum of u over the n neighbours) - n·u
    v'    = v + kappa·lap u          (kappa = 2**-5)
    u'    = u + v'

The neighbour sum adds the (2g+1)³ - 1 shifted copies of u in dk, di, dj
order (the centre skipped), and n·u is taken off as power-of-two
multiples in descending order (16u, 8u, 2u for g = 1). Every product is
then an exact scaling and every sum is rounded once in a fixed order, so
any implementation that keeps this order without fused multiply-adds
gives the same bits. The neighbours wrap around each axis (periodic
boundary).

Imports nothing but torch. ``store_dtype`` rounds u and v to that type
after every step (the arithmetic stays in float32 after an exact
widening), the path a store of lower precision takes.
"""

from __future__ import annotations

import torch

KAPPA = 2.0 ** -5


def _wrap_pad(x: torch.Tensor, g: int) -> torch.Tensor:
    """(M, M, M) -> (M+2g)³, each axis extended by its other end."""
    M = x.shape[-1]
    idx = torch.arange(-g, M + g, device=x.device) % M
    for axis in range(3):
        x = x.index_select(axis, idx)
    return x


def wave_step(fields: torch.Tensor, g: int = 1) -> torch.Tensor:
    """One leapfrog timestep of (2, M, M, M) float32 fields."""
    u, v = fields[0], fields[1]
    M = u.shape[0]
    up = _wrap_pad(u, g)
    s = 2 * g + 1
    acc = torch.zeros_like(u)
    for dk in range(s):
        for di in range(s):
            for dj in range(s):
                if (dk, di, dj) == (g, g, g):
                    continue
                acc = acc + up[dk:dk + M, di:di + M, dj:dj + M]
    n = s ** 3 - 1
    lap = acc
    bit = 1 << (n.bit_length() - 1)
    rem = n
    while bit:
        if rem >= bit:
            lap = lap - float(bit) * u
            rem -= bit
        bit >>= 1
    v2 = v + KAPPA * lap
    u2 = u + v2
    return torch.stack([u2, v2])


def wave_run(fields: torch.Tensor, steps: int, g: int = 1,
             store_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``steps`` timesteps from ``fields`` (not modified); float32 out,
    the state rounded to ``store_dtype`` after every step."""
    x = fields.to(store_dtype).to(torch.float32)
    for _ in range(steps):
        x = wave_step(x, g).to(store_dtype).to(torch.float32)
    return x
