"""Stencil application (gol3d) and its resident-store pipeline."""

from .gol3d import Gol3d, Gol3dConfig, stencil_block_kind  # noqa: F401
from .pipeline import ResidentPipeline  # noqa: F401
