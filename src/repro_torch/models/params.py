"""Parameter definition trees: shapes, logical axes, init.

The torch counterpart of ``repro.models.params``. Every parameter is
declared once as a ``ParamDef(shape, axes, scale)``; ``init_params``
materialises the tree from a ``torch.Generator`` and ``count_params``
counts it. The JAX package's random streams cannot be reproduced in
torch, so equal weights in both packages come from numpy
(``interop.lm_params_from_numpy``), not from a shared seed.

``partition_specs`` and ``LOGICAL_RULES`` (the sharding of the tree over
a device mesh) wait for the sharding slice (ROADMAP queue 1, item 12.10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

__all__ = ["ParamDef", "init_params", "count_params", "leaf_paths", "leaves",
           "unflatten", "tree_map", "tree_like"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]      # logical axis per dim
    scale: float = 0.02               # normal stddev; 0 -> zeros; 1.0 -> ones
    init: str = "normal"              # normal | zeros | ones | custom:<name>

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


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


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in leaf_paths(defs))
