"""Sort-based capacity MoE with gather-only dispatch (the port of
``repro.models.moe``).

Dispatch:
  1. route: top-k over expert probabilities per token (``route``);
  2. per sequence (group), sort the (token, k) entries by expert id;
  3. an entry's rank within its expert segment (entry position − segment
     start) gives its capacity slot; entries with rank ≥ C drop (standard
     capacity semantics, C = S·k/E · capacity_factor);
  4. the expert input buffer (G, E, C, d) is built by gather
     (slot (e, c) ← sorted entry at segment_start[e] + c);
  5. the expert FFN is a batched einsum over the expert weights;
  6. combine is the inverse gather weighted by router probabilities.

The one-hot dispatch-tensor formulation (GShard/Switch) is O(T·E·C) memory;
this is O(T·k + E·C·d).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import gelu


def capacity(S: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert and group: the reference's float truncation."""
    C = max(8, int(S * top_k / n_experts * capacity_factor))
    return min(C, S * top_k)


def route(x, router, top_k: int):
    """x (B,S,d), router (d,E) -> (probs (B,S,E) f32, top_p (B,S,K) f32
    renormalised, top_e (B,S,K) int64).

    Ties go to the lower expert index, as ``lax.top_k`` breaks them: a
    stable descending sort, then the first K."""
    logits = (x @ router.to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[..., :top_k], idx[..., :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def moe_ffn(x, params, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, act: str = "swiglu"):
    """x (B, S, d) -> (B, S, d), aux load-balance loss (scalar f32).

    Groups are sequences (B groups).
    """
    B, S, d = x.shape
    E, K = n_experts, top_k
    T = S * K
    C = capacity(S, E, K, capacity_factor)
    dev = x.device

    probs, top_p, top_e = route(x, params["router"], K)

    # ---- flatten entries and sort by expert id (per group) ----
    e_flat = top_e.reshape(B, T)
    order = torch.argsort(e_flat, dim=1, stable=True)     # entry positions
    es = torch.gather(e_flat, 1, order)                   # sorted expert ids
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(es, experts, right=False)
    seg_end = torch.searchsorted(es, experts, right=True)
    rank_sorted = torch.arange(T, device=dev)[None, :] - torch.gather(
        seg_start, 1, es)                                 # rank of sorted entry

    # ---- build expert buffers by gather: slot (e, c) <- sorted entry ----
    slot_pos = seg_start[:, :, None] + torch.arange(C, device=dev)  # (B,E,C)
    slot_valid = slot_pos < seg_end[:, :, None]
    slot_entry = torch.gather(
        order, 1, slot_pos.clamp(0, T - 1).reshape(B, E * C)).reshape(B, E, C)
    slot_token = slot_entry // K                          # token index in seq
    xs = torch.gather(
        x, 1, slot_token.reshape(B, E * C)[..., None].expand(B, E * C, d)
    ).reshape(B, E, C, d)
    xs = torch.where(slot_valid[..., None], xs, 0.0)

    # ---- expert FFN (weights (E, d, f) / (E, f, d)) ----
    def _w(name):
        return params[name].to(x.dtype)

    if act == "swiglu":
        h = torch.einsum("becd,edf->becf", xs, _w("w1"))
        g = torch.einsum("becd,edf->becf", xs, _w("w3"))
        h = F.silu(h) * g
    else:
        h = gelu(torch.einsum("becd,edf->becf", xs, _w("w1")))
    ys = torch.einsum("becf,efd->becd", h, _w("w2"))

    # ---- combine: inverse gather back to (token, k) entries ----
    # entry -> its slot (e, c): c is the entry's rank (valid if < C)
    inv = torch.argsort(order, dim=1, stable=True)        # entry -> sorted pos
    rank_entry = torch.gather(rank_sorted, 1, inv)        # (B, T)
    keep = rank_entry < C
    flat_slot = e_flat * C + rank_entry.clamp(0, C - 1)
    y_entry = torch.gather(
        ys.reshape(B, E * C, d), 1, flat_slot[..., None].expand(B, T, d))
    w_entry = (top_p.reshape(B, T) * keep).to(x.dtype)
    y = (y_entry * w_entry[..., None]).reshape(B, S, K, d).sum(2)

    # ---- aux load-balance loss (Switch-style) ----
    me = probs.mean((0, 1))                               # (E,)
    ce = F.one_hot(top_e[..., 0], E).to(torch.float32).mean((0, 1))
    aux = E * torch.sum(me * ce)
    return y, aux
