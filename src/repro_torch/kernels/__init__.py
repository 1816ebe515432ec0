"""Stencil kernels (CUDA, csrc/) with their wrappers and plain versions."""

from .ops import gol3d_step, uniform_weights  # noqa: F401
from .rules import RULES, UpdateRule, apply_window_bc, get_rule  # noqa: F401
from .stencil3d import (  # noqa: F401
    LAUNCHES, SMEM_LIMIT_BYTES, fused_smem_bytes, reset_launches,
    stencil_step_fused, stencil_sum_blocks, stencil_sum_resident,
)
