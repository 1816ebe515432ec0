"""Production meshes and the Hilbert device order (the paper's placement
idea applied to the language model's mesh).

The torch counterpart of ``repro.launch.mesh``. ``make_production_mesh``
is a function: importing this module touches no process group. The
single-pod mesh is (16, 16) = 256 ranks ("data", "model"); the multi-pod
mesh is (2, 16, 16) = 512 ranks ("pod", "data", "model"), where "pod"
carries pure data parallelism so that only the gradient all-reduce
crosses pods.

Hilbert device order: the mesh's ranks are laid onto the physical torus
along a 3D Hilbert curve, so ranks adjacent in the minor mesh axis are
physically adjacent and blocks of 2^k consecutive ranks occupy compact
bricks of the torus. Where the objects given have torus ``coords`` (as
TPU devices do) those are read; ranks of a process group have none, and
their torus is synthesised in id order, as the JAX package does for its
placeholder devices.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.hilbert import hilbert_encode

__all__ = ["make_production_mesh", "hilbert_device_permutation",
           "MESH_AXES_SINGLE", "MESH_AXES_MULTI", "batch_axes"]

MESH_AXES_SINGLE = ("data", "model")
MESH_AXES_MULTI = ("pod", "data", "model")


def _torus_shape(n: int) -> tuple[int, int, int]:
    """A plausible 3D torus for n chips (power of two)."""
    dims = [1, 1, 1]
    i = 0
    while np.prod(dims) < n:
        dims[i % 3] *= 2
        i += 1
    return tuple(int(d) for d in sorted(dims))


def _device_coords(devices) -> np.ndarray:
    """(n, 3) physical coordinates: each object's ``coords`` where every
    one has them, else a torus synthesised in id order."""
    coords = []
    for d in devices:
        c = getattr(d, "coords", None)
        if c is None:
            coords = None
            break
        coords.append(tuple(c)[:3])
    if coords is not None:
        return np.asarray(coords, dtype=np.int64)
    n = len(devices)
    idx = np.arange(n)
    return np.stack(np.unravel_index(idx, _torus_shape(n)), axis=1).astype(np.int64)


def hilbert_device_permutation(devices) -> list:
    """``devices`` (ranks, or objects with ``coords``) reordered along the
    3D Hilbert curve through the torus: consecutive entries are torus
    neighbours, and any aligned block of 2^(3k) occupies a compact
    sub-brick."""
    coords = _device_coords(devices)
    side = 1 << int(np.ceil(np.log2(max(coords.max() + 1, 2))))
    m = int(np.log2(side))
    key = hilbert_encode([coords[:, 0].astype(np.uint64),
                          coords[:, 1].astype(np.uint64),
                          coords[:, 2].astype(np.uint64)], max(m, 2))
    order = np.argsort(key.astype(np.int64), kind="stable")
    return [devices[int(i)] for i in order]


def make_production_mesh(*, multi_pod: bool = False,
                         device_order: str = "hilbert",
                         device_type: str = "cuda"):
    """The dry-run target mesh over the initialised default process group:
    (16, 16) single pod or (2, 16, 16) two pods, its ranks in Hilbert
    order (``device_order="hilbert"``) or in id order. Raises when the
    group has fewer ranks than the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MESH_AXES_MULTI if multi_pod else MESH_AXES_SINGLE
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have}: initialise a process group of "
            f"{n} ranks (torch.distributed.init_process_group) first")
    ranks = list(range(n))
    if device_order == "hilbert":
        ranks = hilbert_device_permutation(ranks)
    return DeviceMesh(device_type, np.asarray(ranks, dtype=np.int64).reshape(shape),
                      mesh_dim_names=axes)


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
