"""Stencil application (gol3d), its resident-store and distributed
pipelines, the halo exchange, the mesh of shards and the checkpointed,
resumable runner; the modelled memory and exchange traffic beside them,
as ``repro.stencil`` exports it (its VMEM names are the shared-memory
ones here: ``SMEM_LIMIT_BYTES``, ``fused_smem_bytes``)."""

from .domain import (STENCIL_AXES, Decomposition3D, StencilMesh,  # noqa: F401
                     make_stencil_mesh)
from .gol3d import Gol3d, Gol3dConfig, stencil_block_kind  # noqa: F401
from .halo import (exchange_shell, make_distributed_step,  # noqa: F401
                   shard_boundary_flags, shard_state, shard_substeps,
                   surface_slab_scatter, unshard_state)
from .pipeline import (  # noqa: F401
    SMEM_LIMIT_BYTES, DistributedPipeline, ResidentPipeline,
    checkpoint_bytes_per_interval, checkpoint_traffic_fraction,
    distributed_bytes_per_step, exchange_bytes_per_step, exchange_face_items,
    exchange_items_per_exchange, fused_items_per_launch, fused_smem_bytes,
    repack_bytes_per_step, repack_items_per_step, resident_bytes_per_step,
    resident_unfused_bytes_per_step, resident_unfused_items_per_step,
)
from .runner import (CheckpointedRun, RunHealthError, RunHooks,  # noqa: F401
                     health_check)
