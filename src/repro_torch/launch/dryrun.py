"""Sharding helpers of the multi-pod dry run.

The torch counterpart of the helpers in ``repro.launch.dryrun``:
``sanitize_specs`` and ``_batch_specs``. The dry run itself (lowering
every arch, shape and mesh without allocating) is not part of this
module yet. ``mesh`` is a ``DeviceMesh`` with named dims (only its
``mesh_dim_names`` and ``shape`` are read, as the JAX package reads only
``mesh.shape``).
"""

from __future__ import annotations

from repro_torch.models.params import Spec, leaf_paths, unflatten

__all__ = ["sanitize_specs"]


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def sanitize_specs(mesh, specs, abstracts):
    """Drop the sharding of any dim the mesh axis does not divide (vocab
    51865 over 16 ways, 5 kv heads over 16): the JAX package's baseline
    replicates such dims rather than pad them, and so does the port,
    although DTensor would take uneven shards. ``abstracts`` is a matching
    tree of anything with a ``shape`` (tensors, ParamDefs)."""
    shapes = {path: tuple(a.shape) for path, a in leaf_paths(abstracts)}

    def fix(spec, shape):
        parts = list(spec) + [None] * (len(shape) - len(spec))
        return Spec(*(axis if dim % _axis_size(mesh, axis) == 0 else None
                      for dim, axis in zip(shape, parts)))

    return unflatten({path: fix(spec, shapes[path])
                      for path, spec in leaf_paths(specs)})


def _batch_specs(specs_tree, baxes):
    """``Spec(baxes, None, ...)`` for every array input (anything with a
    ``shape``); scalars replicated."""
    def one(a):
        nd = len(a.shape)
        return Spec() if nd == 0 else Spec(baxes, *([None] * (nd - 1)))
    return unflatten({path: one(a) for path, a in leaf_paths(specs_tree)})
