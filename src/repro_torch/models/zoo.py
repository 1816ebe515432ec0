"""Model zoo: a configuration and its weights as one ``nn.Module``.

The torch counterpart of ``repro.models.zoo.Model``. Its parameters are
the leaves of the ``ParamDef`` tree (``transformer.model_defs``), stacked
on the leading layers axis as in the JAX package and named by their
paths (``layers.wq``, ``embed``, ...), so a JAX parameter tree maps onto
it leaf for leaf (``interop.lm_params_from_numpy``). The weights live in
the module, so the methods take no ``params`` argument. The parameters do
not require gradients until the caller asks (``requires_grad_()``, as on
any module, which the trainer does); the serving methods run under
``torch.no_grad`` either way.

``specs`` and ``cache_specs`` are the JAX package's partition-spec trees
(``params.Spec``); :meth:`Model.shard` places the parameters on a
``DeviceMesh`` by such a tree, each one a DTensor parameter from then
on. The methods run on DTensor parameters under ``params.on_mesh``.

A model built on ``device="meta"`` holds shapes and dtypes and no data:
it can be sharded onto a mesh of torch's fake process group and run
``loss``, ``prefill`` and ``decode`` there, which is how the dry run
(``launch/dryrun.py``) counts a step without a card. :meth:`Model.abstract`
and :meth:`Model.abstract_cache` are the JAX package's abstract trees:
meta tensors in a dtype, nothing allocated.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.device import resolve_device

from . import transformer as tfm
from .config import ModelConfig
from .params import (_fill, count_params, init_params, leaf_paths, on_mesh,
                     partition_specs, placements, unflatten)

__all__ = ["Model", "active_params"]


def active_params(cfg: ModelConfig) -> int:
    """Active params per token (the JAX package's MoE discount) for 6ND
    model flops: of each routed expert weight (``moe/w1``, ``w2``, ``w3``),
    only top_k of n_routed experts count. From the defs alone, so it counts
    full-width models that are never allocated."""
    defs = tfm.model_defs(cfg)
    total = count_params(defs)
    if cfg.family != "moe":
        return total
    mo = cfg.moe
    inactive = 0
    for path, d in leaf_paths(defs):
        if len(path) >= 2 and path[-2] == "moe" and path[-1] in ("w1", "w2", "w3"):
            inactive += int(np.prod(d.shape)) * (mo.n_routed - mo.top_k) // mo.n_routed
    return total - inactive


def _abstract(defs, dtype) -> dict:
    return unflatten({path: torch.empty(d.shape, dtype=dtype, device="meta")
                      for path, d in leaf_paths(defs)})


class Model(nn.Module):
    """``cfg``'s parameters in ``cfg.param_dtype`` (zeros until
    :meth:`init` or a copy) on ``device`` — the card unless the caller asks
    for the CPU or for ``"meta"`` (no data)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = getattr(torch, cfg.param_dtype)
        for path, d in leaf_paths(tfm.model_defs(cfg)):
            node = self
            for name in path[:-1]:
                if not hasattr(node, name):
                    node.add_module(name, nn.Module())
                node = getattr(node, name)
            node.register_parameter(path[-1], nn.Parameter(
                torch.zeros(d.shape, dtype=dtype, device=self.device),
                requires_grad=False))

    # ---- parameters
    def defs(self):
        return tfm.model_defs(self.cfg)

    def params(self) -> dict:
        """The parameter tree as nested dicts of tensors (the JAX layout)."""
        root: dict = {}
        for name, p in self.named_parameters():
            *head, leaf = name.split(".")
            node = root
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = p
        return root

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on this model's
        device), leaves in sorted path order, each by its ParamDef."""
        tree = self.params()
        for path, d in leaf_paths(self.defs()):
            node = tree
            for k in path:
                node = node[k]
            _fill(node, d, generator)
        return self

    def abstract(self, dtype=torch.float32) -> dict:
        """The parameter tree as meta tensors in ``dtype`` (shapes and
        dtypes only, nothing allocated)."""
        return _abstract(self.defs(), dtype)

    def specs(self, extra_rules=None) -> dict:
        """The parameters' partition specs (``params.LOGICAL_RULES``)."""
        return partition_specs(self.defs(), extra_rules=extra_rules)

    @torch.no_grad()
    def shard(self, mesh, specs: dict) -> "Model":
        """Place every parameter on ``mesh`` by its spec in ``specs`` (a
        tree like :meth:`specs`, e.g. after ``launch.dryrun.
        sanitize_specs``): each becomes a DTensor ``nn.Parameter``
        holding its shard, with its ``requires_grad`` kept. Every rank of
        the mesh calls this with the same full values."""
        from torch.distributed.tensor import distribute_tensor

        tree = dict(leaf_paths(specs))
        for name, p in list(self.named_parameters()):
            path = tuple(name.split("."))
            node = self
            for k in path[:-1]:
                node = getattr(node, k)
            d = distribute_tensor(p.detach(), mesh, placements(tree[path], mesh))
            setattr(node, path[-1], nn.Parameter(d, requires_grad=p.requires_grad))
        return self

    def n_params(self) -> int:
        return count_params(self.defs())

    def n_active_params(self) -> int:
        return active_params(self.cfg)

    # ---- training
    def loss(self, batch: dict, remat: bool | str = True):
        """(ce + aux, (ce, aux)) of ``batch`` (``transformer.loss_fn``),
        differentiable in the parameters that require gradients. With
        DTensor parameters take the gradient under ``params.on_mesh``
        too (the backward mixes plain tensors in as the forward does)."""
        params = self.params()
        with on_mesh(params):
            return tfm.loss_fn(params, batch, self.cfg, remat)

    # ---- inference
    @torch.no_grad()
    def forward(self, batch: dict):
        """(logits f32 (B,S,V), aux) over the whole sequence."""
        params = self.params()
        with on_mesh(params):
            return tfm.forward(params, batch, self.cfg)

    @torch.no_grad()
    def prefill(self, batch: dict) -> torch.Tensor:
        """Last-position logits (B,V) — the inference prefill step."""
        params = self.params()
        with on_mesh(params):
            return tfm.prefill(params, batch, self.cfg)

    # ---- serving
    def cache_defs(self, batch: int, max_len: int):
        return tfm.cache_defs(self.cfg, batch, max_len)

    def abstract_cache(self, batch: int, max_len: int,
                       dtype=torch.bfloat16) -> dict:
        """The decode cache of ``max_len`` positions as meta tensors in
        ``dtype``."""
        return _abstract(self.cache_defs(batch, max_len), dtype)

    def cache_specs(self, batch: int, max_len: int, extra_rules=None) -> dict:
        """The decode cache's partition specs (``extra_rules`` names the
        cache's ``batch`` and ``seq`` axes)."""
        return partition_specs(self.cache_defs(batch, max_len),
                               extra_rules=extra_rules)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """A zero cache of ``max_len`` positions on this model's device."""
        return init_params(self.cache_defs(batch, max_len), None, dtype,
                           self.device)

    @torch.no_grad()
    def decode(self, cache: dict, batch: dict):
        """One-token decode: (logits (B,1,V), cache written in place)."""
        params = self.params()
        with on_mesh(params):
            return tfm.decode_step(params, cache, batch, self.cfg)
