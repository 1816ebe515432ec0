"""Parameter definition trees: shapes, logical axes, init.

The torch counterpart of ``repro.models.params``. Every parameter is
declared once as a ``ParamDef(shape, axes, scale)``; ``init_params``
materialises the tree from a ``torch.Generator`` and ``count_params``
counts it. The JAX package's random streams cannot be reproduced in
torch, so equal weights in both packages come from numpy
(``interop.lm_params_from_numpy``), not from a shared seed.

``partition_specs`` turns the defs' logical axes into a tree of
:class:`Spec` (one mesh-axis name, a tuple of names, or None per dim) by
``LOGICAL_RULES``, the JAX package's ``PartitionSpec`` tree as plain
tuples. ``placements`` turns a spec into the DTensor placements of a
``torch.distributed`` ``DeviceMesh`` with named dims: a tensor dim named
on a mesh dim is ``Shard(dim)`` there, every other mesh dim
``Replicate()``. ``constrain`` is the counterpart of
``with_sharding_constraint`` (a redistribute of a DTensor; a plain tensor
passes through), ``on_mesh`` the context under which the layer code mixes
DTensor parameters with the plain tensors it makes (positions, masks,
RoPE tables), which it treats as replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import contextlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["ParamDef", "LOGICAL_RULES", "Spec", "init_params", "count_params",
           "partition_specs", "placements", "constrain", "gathered", "on_mesh",
           "leaf_paths", "leaves", "unflatten", "tree_map", "tree_like"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]      # logical axis per dim
    scale: float = 0.02               # normal stddev; 0 -> zeros; 1.0 -> ones
    init: str = "normal"              # normal | zeros | ones | custom:<name>

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


LOGICAL_RULES: dict[str, Any] = {
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "inner": "model",
    "layers": None,
    "conv": "model",
}


def _entry(a):
    """A spec entry as JAX's ``PartitionSpec`` keeps it: a tuple of one
    axis is that axis, an empty one None."""
    if isinstance(a, (tuple, list)):
        a = tuple(a)
        return None if not a else a[0] if len(a) == 1 else a
    return a


class Spec(tuple):
    """A partition spec: per tensor dim, the mesh axis it is split over (a
    name), the axes (a tuple of names, the first major) or None
    (replicated). A tuple, so it equals the JAX package's
    ``PartitionSpec`` read as a tuple (which also keeps a tuple of one
    axis as the axis); missing trailing dims are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_entry(a) for a in axes))


def leaf_paths(tree, prefix=()):
    """(path, leaf) of a tree of nested dicts in sorted key order (the JAX
    package's flattening order); a path is a tuple of keys and a leaf is
    anything that is not a dict (a ParamDef, a tensor, an array)."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from leaf_paths(tree[k], prefix + (k,))


def leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`leaf_paths` order."""
    return [leaf for _, leaf in leaf_paths(tree)]


def unflatten(flat: dict[tuple, Any]) -> dict:
    """The tree of nested dicts whose leaves are ``flat``'s values, each at
    its path."""
    root: dict = {}
    for path, v in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return root


def tree_map(fn, tree) -> dict:
    """``tree`` with ``fn`` applied to each leaf."""
    return unflatten({path: fn(x) for path, x in leaf_paths(tree)})


def tree_like(tree, new_leaves) -> dict:
    """A tree shaped like ``tree`` whose leaves, in :func:`leaf_paths`
    order, are ``new_leaves``."""
    paths = [path for path, _ in leaf_paths(tree)]
    new_leaves = list(new_leaves)
    if len(new_leaves) != len(paths):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {len(paths)}")
    return unflatten(dict(zip(paths, new_leaves)))


def _custom_fill(t: torch.Tensor, name: str, generator: torch.Generator) -> None:
    """The mamba2 inits, equal in distribution to the JAX package's draws:
    ``a_log = log(A)`` with A uniform in [1, 16]; ``dt_bias`` the inverse
    softplus of dt, log-uniform in [1e-3, 1e-1]."""
    if name == "a_log":
        t.uniform_(1.0, 16.0, generator=generator).log_()
    elif name == "dt_bias":
        dt = t.uniform_(math.log(1e-3), math.log(1e-1), generator=generator).exp_()
        dt.add_(torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(name)


def _fill(t: torch.Tensor, d: ParamDef, generator: torch.Generator) -> None:
    """Draw ``d``'s initial value into ``t`` in place."""
    if d.init == "zeros" or d.scale == 0.0:
        t.zero_()
    elif d.init == "ones":
        t.fill_(1.0)
    elif d.init.startswith("custom:"):
        _custom_fill(t, d.init[len("custom:"):], generator)
    else:
        t.normal_(0.0, d.scale, generator=generator)


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device="cuda"):
    """Materialise a ParamDef tree into tensors on ``device``: normal
    draws of each leaf's scale from ``generator`` (which must live on
    ``device``), leaves in sorted path order."""
    flat = {}
    for path, d in leaf_paths(defs):
        t = torch.empty(d.shape, dtype=dtype, device=device)
        _fill(t, d, generator)
        flat[path] = t
    return unflatten(flat)


def partition_specs(defs, rules=None, extra_rules=None) -> dict:
    """The :class:`Spec` tree of a ParamDef tree: each logical axis mapped
    by ``rules`` (default :data:`LOGICAL_RULES`, updated by
    ``extra_rules``); an axis the rules do not name is replicated."""
    rules = dict(LOGICAL_RULES if rules is None else rules)
    if extra_rules:
        rules.update(extra_rules)
    return unflatten({path: Spec(*(rules.get(a) if a is not None else None
                                   for a in d.axes))
                      for path, d in leaf_paths(defs)})


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``
    with ``mesh_dim_names``): ``Shard(dim)`` on each mesh dim that
    ``spec`` names for tensor dim ``dim``, ``Replicate()`` on the others.
    A dim split over several mesh dims (``("pod", "data")``) is split
    pod-major, as JAX splits it: its axes must come in the mesh's order."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {names[i]} twice")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x, spec):
    """``x`` redistributed to ``spec``'s placements on its mesh where it is
    a DTensor (the JAX package's ``with_sharding_constraint``); a plain
    tensor, or ``spec=None``, passes through."""
    if spec is None or not isinstance(x, DTensor):
        return x
    want = placements(Spec(*spec), x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(placements=want)


def gathered(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank (each mesh dim
    that splits it replicated; a partial sum stays partial); a plain
    tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x if tuple(x.placements) == want else x.redistribute(placements=want)


def on_mesh(tree):
    """A context for work on ``tree``'s tensors: where a leaf is a DTensor,
    plain tensors mixed into DTensor operations count as replicated
    (``implicit_replication``); otherwise nothing."""
    if any(isinstance(x, DTensor) for x in leaves(tree)):
        return implicit_replication()
    return contextlib.nullcontext()


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in leaf_paths(defs))
