"""Public stencil operations around the kernels (repack path).

The torch counterparts of ``repro.kernels.ops.uniform_weights`` and
``gol3d_step``. The device decides the path: on CUDA the tap sum runs
through the ``stencil_sum_blocks`` kernel, on the CPU through its plain
version; the rule runs as torch elementwise code on both.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.boundary import PERIODIC
from repro_torch.core.layout import blockize_with_halo, device_constant, unblockize

from . import ref
from .stencil3d import stencil_sum_blocks

__all__ = ["gol3d_step", "uniform_weights"]


def _build_uniform_weights(g: int) -> np.ndarray:
    s = 2 * g + 1
    w = np.ones((s, s, s), dtype=np.float32)
    w[g, g, g] = 0.0
    return w


def uniform_weights(g: int, device="cuda") -> torch.Tensor:
    """All-ones stencil with a zero centre (neighbour count), as a cached
    device constant. Callers must not write to it."""
    return device_constant(("golw", g), lambda: _build_uniform_weights(g), device)


def gol3d_step(cube: torch.Tensor, *, g: int, T: int = 8,
               block_kind: str = "morton", bc=PERIODIC) -> torch.Tensor:
    """One gol3d update via the SFC-blocked repack pipeline:
    blockize_with_halo → tap-sum kernel → rule → unblockize. Equal to
    ref.gol3d_step_ref under the same ``bc``."""
    M = cube.shape[0]
    blocks = blockize_with_halo(cube, T, g, kind=block_kind, bc=bc)
    neigh = stencil_sum_blocks(blocks, uniform_weights(g, cube.device), g=g)
    centre = blocks[:, g:g + T, g:g + T, g:g + T]
    nxt = ref.gol_rule_ref(centre, neigh, g)
    return unblockize(nxt, M, kind=block_kind)
