"""Fine-grained MoE (DeepSeek style): shared + routed experts, top-k.

The torch counterpart of ``repro.models.moe``. Dispatch is the sort-based
fixed-capacity scheme: flatten each sequence's (token, k) assignments,
stable-sort them by expert, place each at its rank within the expert's
capacity-C buffer (an assignment past C is dropped), run one batched
GEMM per expert, and sum each token's expert outputs back weighted by the
renormalised router gate, in f32. All index math is row-local (per
sequence), batched over the rows with tensor ops.

On a device mesh (DTensor parameters and activations) the sharding
hints are read as the JAX package reads them: ``act_spec`` gathers the
sequence inside each batch shard before the router and pins the output
back to it; ``ep_axis`` pins the (B, E, C, ·) dispatch buffers to
batch × expert sharding, so the expert products run split over experts.
The row-local index work (routing's top-k, the sort dispatch, the
combine) runs on each rank's rows through ``local_map``; on plain
tensors the hints change nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .config import ModelConfig
from .layers import swiglu
from .params import Spec, constrain, placements

__all__ = ["moe_ffn", "route", "capacity", "dispatch_slots"]


def capacity(S: int, cfg: ModelConfig) -> int:
    """Per-row expert capacity C = ⌈S·K/E·cf⌉ (at least 1)."""
    moe = cfg.moe
    return max(int(math.ceil(S * moe.top_k / moe.n_routed * moe.capacity_factor)), 1)


def _pick(logits: torch.Tensor, K: int):
    """(probs, gate, ids) of router logits: softmax, top-k, the gate
    renormalised to sum 1."""
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, K, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, ids


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Router softmax over the experts in f32 (bf16 inputs are exact in
    f32: the JAX package's f32 accumulation) -> (probs (B,S,E), gate
    (B,S,K) renormalised to sum 1, ids (B,S,K))."""
    return _pick(x.float() @ p["router"].to(x.dtype).float(), cfg.moe.top_k)


def dispatch_slots(ids: torch.Tensor, E: int, C: int):
    """Each assignment's slot in its expert's buffer, row by row.

    ids: (B, S, K) expert ids. Returns ``(slot_e, slot_c, keep)``, each
    (B, S·K) in assignment order (token-major): the expert (E where the
    assignment is dropped), the rank within the expert's capacity (0 where
    dropped), and whether it is kept (rank < C). The rank is the
    assignment's place among those of the same expert after a stable sort
    by expert id (``argsort`` then ``searchsorted``), so earlier tokens win
    a full expert's places.
    """
    B = ids.shape[0]
    eid = ids.reshape(B, -1).long()
    n = eid.shape[1]
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = torch.gather(eid, 1, order)
    first = torch.searchsorted(eid_s, eid_s, side="left")
    rank_s = torch.arange(n, device=ids.device) - first
    rank = torch.empty_like(rank_s).scatter_(1, order, rank_s)
    keep = rank < C
    return (torch.where(keep, eid, E), torch.where(keep, rank, 0), keep)


def _row_local(fn, x, b_ax, n_in: int, outs):
    """``fn`` over each rank's rows where ``x`` is a DTensor: its ``n_in``
    inputs and its outputs split on dim 0 over the batch axes ``b_ax`` and
    replicated on the other mesh dims (``outs`` overrides an output's
    placements, e.g. a partial mean); on plain tensors ``fn`` itself."""
    if not isinstance(x, DTensor):
        return fn
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rows = placements(Spec(b_ax), mesh)
    return local_map(fn, out_placements=tuple(o or rows for o in outs),
                     in_placements=(rows,) * n_in, device_mesh=mesh,
                     redistribute_inputs=True)


def _batch_axes(x, cfg: ModelConfig):
    """``act_spec``'s batch axes where they divide x's batch, else None."""
    if cfg.act_spec is None or not isinstance(x, DTensor):
        return None
    b_ax = cfg.act_spec[0]
    names = x.device_mesh.mesh_dim_names
    axes = b_ax if isinstance(b_ax, (tuple, list)) else (b_ax,)
    ways = math.prod(x.device_mesh.size(names.index(a)) for a in axes if a)
    return b_ax if x.shape[0] % ways == 0 else None


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,D) -> (out (B,S,D), aux_loss scalar).

    p: router (D,E); w1,w3: (E,D,Fe); w2: (E,Fe,D);
       shared_{gate,up}: (D, n_shared·Fe); shared_down: (n_shared·Fe, D).

    Per-row capacity C = ⌈S·K/E·cf⌉; every expert's buffer is computed,
    full or not. The expert products take the activation dtype (bf16
    products are rounded once to bf16, where the JAX package keeps f32
    before the SiLU); the combine is summed in f32.
    """
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.n_routed, moe.top_k
    C = capacity(S, cfg)
    b_ax = _batch_axes(x, cfg)
    if cfg.act_spec is not None:
        # gather the sequence inside the shard: dispatch is row-local, so
        # only the batch sharding remains
        x = constrain(x, (b_ax, None, None))

    logits = x.float() @ p["router"].to(x.dtype).float()

    def pick(logits):
        probs, gate, ids = _pick(logits, K)
        # each expert's share of this rank's assignments (for the aux loss);
        # the one-hot by comparison: F.one_hot takes other ops on each
        # device (a value check on the CPU and the card, none on meta), and
        # the dry run's count must not depend on the device
        hot = ids.reshape(-1, K, 1).long() == torch.arange(E, device=ids.device)
        f = hot.float().mean(dim=(0, 1))
        return probs, gate, ids, f

    partial = None
    if isinstance(x, DTensor):
        from torch.distributed.tensor import Partial
        partial = tuple(Partial("avg") if pl.is_shard() else pl
                        for pl in placements(Spec(b_ax), x.device_mesh))
    probs, gate, ids, f = _row_local(pick, x, b_ax, 1,
                                     (None, None, None, partial))(logits)
    # the Switch-style load-balance loss, E · <f_e>·<p_e>
    aux = E * torch.sum(f * probs.reshape(-1, E).mean(dim=0)) * moe.aux_loss_coef

    def dispatch(x, ids):
        b = x.shape[0]
        slot_e, slot_c, keep = dispatch_slots(ids, E, C)
        rows = torch.arange(b, device=x.device)[:, None]
        flat = slot_e * C + slot_c                           # (b, S·K)
        tok = torch.arange(S, device=x.device).repeat_interleave(K)
        # dropped assignments land in the extra expert E, which is cut off
        buf = x.new_zeros((b, (E + 1) * C, D)).index_put(
            (rows.expand_as(flat), flat), x[:, tok])
        return buf.view(b, E + 1, C, D)[:, :E], flat, keep

    buf, flat, keep = _row_local(dispatch, x, b_ax, 2, (None,) * 3)(x, ids)

    def ep(t):
        """(B, E, ...) pinned to batch × expert sharding (the EP all-to-all);
        without it the expert products would run replicated."""
        if cfg.ep_axis is None:
            return t
        return constrain(t, (b_ax, cfg.ep_axis) + (None,) * (t.ndim - 2))

    adt = x.dtype
    buf = ep(buf)
    g = torch.einsum("becd,edf->becf", buf, p["w1"].to(adt))
    u = torch.einsum("becd,edf->becf", buf, p["w3"].to(adt))
    h = ep((F.silu(g.float()) * u.float()).to(adt))
    ye = ep(torch.einsum("becf,efd->becd", h, p["w2"].to(adt)))

    def combine(ye, gate, flat, keep):
        """Each token's K expert outputs, weighted by the gate (0 where
        dropped), summed in f32 in k order."""
        b = ye.shape[0]
        rows = torch.arange(b, device=ye.device)[:, None]
        vals = ye.reshape(b, E * C, D)[rows, torch.clamp(flat, max=E * C - 1)]
        w = (gate.reshape(b, -1) * keep.float())[..., None]
        return (vals.float() * w).reshape(b, S, K, D).sum(dim=2).to(adt)

    out = _row_local(combine, x, b_ax, 4, (None,))(ye, gate, flat, keep)
    shared = swiglu({"gate": p["shared_gate"], "up": p["shared_up"],
                     "down": p["shared_down"]}, x)
    out = out + shared
    if cfg.act_spec is not None:
        out = constrain(out, cfg.act_spec)
    return out, aux
