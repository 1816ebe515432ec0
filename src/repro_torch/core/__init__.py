"""Core: space-filling-curve orderings, boundaries, layouts and neighbour
tables — the torch package's own copies (it imports nothing of JAX)."""

from .boundary import (  # noqa: F401
    NEUMANN0, PERIODIC, BoundarySpec, MixedBoundary, as_boundary,
    axes_periodic, dirichlet, mixed, pad_cube,
)
from .device import resolve_device  # noqa: F401
from .layout import (  # noqa: F401
    apply_ordering, block_order, blockize, blockize_fields,
    blockize_with_halo, device_constant, store_spec, unblockize,
    unblockize_fields, undo_ordering,
)
from .neighbors import (  # noqa: F401
    FACE_COLS, OFFSETS_FACE, OFFSETS_FULL, SELF_COL, block_kind_of,
    boundary_face_table, boundary_face_table_device, extended_neighbor_table,
    extended_neighbor_table_device, neighbor_table, neighbor_table_device,
    ring_perms, shell_block_count, shell_block_index,
)
from .orderings import (  # noqa: F401
    COLUMN_MAJOR, HILBERT, MORTON, ROW_MAJOR, OrderingSpec, block_index_3d,
    ordering_from_name, path_to_rmo, rmo_to_path,
)
