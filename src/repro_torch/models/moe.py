"""Fine-grained MoE (DeepSeek style): shared + routed experts, top-k.

The torch counterpart of ``repro.models.moe``. Dispatch is the sort-based
fixed-capacity scheme: flatten each sequence's (token, k) assignments,
stable-sort them by expert, place each at its rank within the expert's
capacity-C buffer (an assignment past C is dropped), run one batched
GEMM per expert, and sum each token's expert outputs back weighted by the
renormalised router gate, in f32. All index math is row-local (per
sequence), batched over the rows with tensor ops.

``act_spec`` and ``ep_axis`` are sharding hints of the JAX package (the
device mesh, ROADMAP.md queue 1, item 12.10); on one device they change
nothing, so they are not read here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import swiglu

__all__ = ["moe_ffn", "router_aux_loss", "route", "capacity", "dispatch_slots"]


def router_aux_loss(probs: torch.Tensor, ids: torch.Tensor, n_experts: int):
    """Switch-style load-balance loss: E · <f_e>·<p_e>."""
    f = F.one_hot(ids.long(), n_experts).float().mean(dim=(0, 1))
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def capacity(S: int, cfg: ModelConfig) -> int:
    """Per-row expert capacity C = ⌈S·K/E·cf⌉ (at least 1)."""
    moe = cfg.moe
    return max(int(math.ceil(S * moe.top_k / moe.n_routed * moe.capacity_factor)), 1)


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Router softmax over the experts in f32 (bf16 inputs are exact in
    f32: the JAX package's f32 accumulation) -> (probs (B,S,E), gate
    (B,S,K) renormalised to sum 1, ids (B,S,K))."""
    logits = x.float() @ p["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, ids


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

    probs, gate, ids = route(p, x, cfg)
    aux = router_aux_loss(probs.reshape(-1, E), ids.reshape(-1, K),
                          E) * moe.aux_loss_coef

    slot_e, slot_c, keep = dispatch_slots(ids, E, C)
    rows = torch.arange(B, device=x.device)[:, None]
    flat = slot_e * C + slot_c                               # (B, S·K)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)
    # dropped assignments land in the extra expert E, which is cut off
    buf = x.new_zeros((B, (E + 1) * C, D)).index_put(
        (rows.expand_as(flat), flat), x[:, tok])
    buf = buf.view(B, E + 1, C, D)[:, :E]

    adt = x.dtype
    g = torch.einsum("becd,edf->becf", buf, p["w1"].to(adt))
    u = torch.einsum("becd,edf->becf", buf, p["w3"].to(adt))
    h = (F.silu(g.float()) * u.float()).to(adt)
    ye = torch.einsum("becf,efd->becd", h, p["w2"].to(adt))

    # combine: each token's K expert outputs, weighted by the gate (0 where
    # dropped), summed in f32 in k order
    vals = ye.reshape(B, E * C, D)[rows, torch.clamp(flat, max=E * C - 1)]
    w = (gate.reshape(B, -1) * keep.float())[..., None]
    out = (vals.float() * w).reshape(B, S, K, D).sum(dim=2).to(adt)

    shared = swiglu({"gate": p["shared_gate"], "up": p["shared_up"],
                     "down": p["shared_down"]}, x)
    return out + shared, aux
