"""Stencil application (gol3d), its resident-store and distributed
pipelines, the halo exchange and the mesh of shards."""

from .domain import (STENCIL_AXES, Decomposition3D, StencilMesh,  # noqa: F401
                     make_stencil_mesh)
from .gol3d import Gol3d, Gol3dConfig, stencil_block_kind  # noqa: F401
from .halo import (exchange_shell, make_distributed_step,  # noqa: F401
                   shard_state, shard_substeps, unshard_state)
from .pipeline import DistributedPipeline, ResidentPipeline  # noqa: F401
