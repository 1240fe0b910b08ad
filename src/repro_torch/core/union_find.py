"""Vectorized, deterministic union-find.

The paper (Algorithm 3) unions points inside a critical section using the
GPU's global atomics. This module keeps the reference's associative,
deterministic equivalent, so the port's labels and round counts equal it:

  * hooking is a scatter-min of target roots onto source roots
    (``scatter_reduce_(..., "amin", include_self=True)``) — all conflicting
    unions resolve to the minimum, independent of execution order;
  * path compression is full pointer jumping (``p = p[p]`` to fixpoint).

Pointers only ever decrease, so the parent forest is acyclic and
``pointer_jump`` terminates in O(log depth) sweeps; it is the port's one
path compression. The data-dependent loops are host-checked: one
device-to-host sync per iteration.
"""
from __future__ import annotations

import torch

from .. import trace

INT_MAX = 2**31 - 1

__all__ = [
    "init_parents",
    "pointer_jump",
    "hook_min",
    "union_edges",
    "connected_components",
]


def init_parents(n: int, device=None) -> torch.Tensor:
    """Each element starts as its own root."""
    return torch.arange(n, dtype=torch.int32, device=device)


def pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: iterate ``p = p[p]`` until fixpoint."""
    while True:
        trace.count("jump_steps")
        p2 = parent[parent.long()]
        trace.count("host_syncs")
        if torch.equal(p2, parent):
            return parent
        parent = p2


def hook_min(parent: torch.Tensor, src_root: torch.Tensor,
             tgt_root: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Hook each ``src_root`` onto ``min(current, tgt_root)`` (a new tensor).

    Invalid entries are routed to element n-1 with its own current parent
    as target, a no-op under ``min``.
    """
    if valid is not None:
        last = parent.shape[0] - 1
        src_root = torch.where(valid, src_root, last)
        tgt_root = torch.where(valid, tgt_root, parent[last])
    return parent.clone().scatter_reduce_(0, src_root.long(), tgt_root,
                                          "amin", include_self=True)


def union_edges(parent: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor | None = None,
                max_rounds: int = 64) -> torch.Tensor:
    """Union an explicit edge list ``(u, v)`` into ``parent``.

    Iterates hook + full compression until no root changes (at most
    ``max_rounds`` rounds). ``valid`` masks padded edges.
    """
    if valid is None:
        valid = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    u, v = u.long(), v.long()
    p = pointer_jump(parent)
    for _ in range(max_rounds):
        root = pointer_jump(p)
        ru, rv = root[u], root[v]
        p2 = hook_min(root, torch.maximum(ru, rv), torch.minimum(ru, rv),
                      valid=valid)
        p2 = pointer_jump(p2)
        changed = not torch.equal(p2, p)
        p = p2
        if not changed:
            break
    return p


def connected_components(n: int, u: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Component roots (min element per component) for an edge list."""
    parent = union_edges(init_parents(n, device=u.device), u, v, valid=valid)
    return pointer_jump(parent)
