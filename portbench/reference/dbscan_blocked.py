"""Plain reference of exact DBSCAN, in PyTorch operations only, for inputs
whose ε-pairs do not fit as int64 lists: every pass over the pairs runs a
block at a time.

It states the answer of ``dbscan.py``, worked out from the points alone:

  * counts[i]: the points j (i itself included) with d²(i, j) ≤ ε², where
    d² = ((dx·dx) + dy·dy) + dz·dz, d = p_i − p_j, each operation rounded
    on its own in float32, and ε² is ``float(eps) ** 2`` rounded once to
    float32;
  * core[i] = counts[i] ≥ minPts;
  * a core point's label is the smallest index of the core points joined
    to it by chains of core neighbours (its cluster);
  * a non-core point's label is the smallest label among its core
    neighbours, or −1 (noise) where it has none.

The neighbour search is ``dbscan.py``'s: a cell grid of side a little
above ε, every candidate in the same or an adjacent cell tested with the
d² above. The pairs are kept as blocks of int32 (src, dst) lists (n <
2^31), each from one block of at most ``block`` candidates; the counts,
the core–core hooking and the border attachment each walk the blocks, so
no pass holds more than a block's int64 indices. Clusters come from
hooking roots together along the core–core pairs (smaller root wins) and
full pointer jumping, as in ``dbscan.py``.

A copy, not an import of ``dbscan.py``: it imports nothing of the program
or of the rest of the benchmark, and runs on whatever device it is given.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

INT_MAX = 2**31 - 1


class Pairs(NamedTuple):
    """Every ordered pair (i, j) with d²(i, j) ≤ ε², self pairs included,
    as blocks: pair k of block b is (src[b][k], dst[b][k])."""
    counts: torch.Tensor   # (n,) int32
    src: list              # [(P_b,) int32]
    dst: list              # [(P_b,) int32]


class Answer(NamedTuple):
    counts: torch.Tensor   # (n,) int32
    core: torch.Tensor     # (n,) bool
    labels: torch.Tensor   # (n,) int32


def _dist2(q: torch.Tensor, c: torch.Tensor, dtype) -> torch.Tensor:
    """((dx·dx) + dy·dy) + dz·dz in ``dtype``, one rounding per operation
    (each line is its own PyTorch operation, so nothing is fused)."""
    acc = None
    for k in range(3):
        d = q[:, k].to(dtype) - c[:, k].to(dtype)
        sq = d * d
        acc = sq if acc is None else acc + sq
    return acc


def neighbour_pairs(points: np.ndarray, eps: float, dims: int, *,
                    device, dtype=torch.float32,
                    block: int = 1 << 24) -> Pairs:
    """All ε-neighbour pairs of ``points`` (n, 3) float32, in blocks of at
    most ``block`` pairs.

    ``dtype`` is the precision of d² and of the comparison with ε²;
    float32 is the configuration's, and a lower one makes the control.
    """
    pts = torch.as_tensor(np.ascontiguousarray(points, np.float32),
                          device=device)
    n = pts.shape[0]
    if n >= 2**31:
        raise ValueError(f"n = {n}: int32 pair lists need n < 2^31")
    eps2 = torch.tensor(float(np.float32(float(eps) ** 2)),
                        dtype=torch.float32, device=device).to(dtype)
    # cells of side a little above ε, in float64: a pair within ε differs
    # by at most one cell on every axis
    side = float(eps) * (1.0 + 2.0 ** -8)
    p64 = pts.double()
    cell = torch.floor((p64 - p64.min(dim=0).values) / side).long() + 1
    del p64
    cell[:, dims:] = 1
    span = cell.max(dim=0).values + 2
    key = (cell[:, 0] * span[1] + cell[:, 1]) * span[2] + cell[:, 2]
    del cell
    order = torch.argsort(key, stable=True)
    cells, occupancy = torch.unique_consecutive(key[order],
                                                return_counts=True)
    first = torch.cumsum(occupancy, 0) - occupancy

    counts = torch.zeros(n, dtype=torch.int64, device=device)
    src, dst = [], []
    offsets = [o for o in itertools.product((-1, 0, 1), repeat=3)
               if all(v == 0 for v in o[dims:])]
    for ox, oy, oz in offsets:
        nkey = key + (ox * span[1] + oy) * span[2] + oz
        pos = torch.searchsorted(cells, nkey).clamp(max=cells.numel() - 1)
        hit = cells[pos] == nkey
        start = torch.where(hit, first[pos], 0)
        length = torch.where(hit, occupancy[pos], 0)
        del nkey, pos, hit
        # queries in runs whose candidates total about ``block``
        ends = torch.cumsum(length, 0)
        q0 = 0
        while q0 < n:
            base = int(ends[q0 - 1]) if q0 else 0
            q1 = int(torch.searchsorted(ends, base + block, right=True))
            q1 = min(max(q1, q0 + 1), n)
            lens = length[q0:q1]
            total = int(lens.sum())
            if total:
                qi = torch.repeat_interleave(
                    torch.arange(q0, q1, device=device), lens)
                run0 = torch.repeat_interleave(
                    torch.cumsum(lens, 0) - lens, lens)
                k = torch.arange(total, device=device) - run0
                cj = order[start[qi] + k]
                near = _dist2(pts[qi], pts[cj], dtype) <= eps2
                qi, cj = qi[near], cj[near]
                counts += torch.bincount(qi, minlength=n)
                src.append(qi.to(torch.int32))
                dst.append(cj.to(torch.int32))
                del run0, k, near, qi, cj
            q0 = q1
    return Pairs(counts.to(torch.int32), src, dst)


def _compress(parent: torch.Tensor) -> torch.Tensor:
    while True:
        up = parent[parent]
        if torch.equal(up, parent):
            return parent
        parent = up


def components(n: int, pairs: Pairs, keep: torch.Tensor) -> torch.Tensor:
    """Root of each element under the pairs whose two ends are both in
    ``keep`` (n,) bool: the smallest element of its component."""
    parent = torch.arange(n, dtype=torch.int64, device=keep.device)
    while True:
        # a round reads the round's parent and scatters into a copy; with
        # no pair of two roots apart the copy is unchanged
        nxt = parent.clone()
        for s, d in zip(pairs.src, pairs.dst):
            both = keep[s] & keep[d]
            ru, rv = parent[s[both]], parent[d[both]]
            apart = ru != rv
            hi = torch.maximum(ru, rv)[apart]
            lo = torch.minimum(ru, rv)[apart]
            nxt.scatter_reduce_(0, hi, lo, "amin", include_self=True)
            del both, ru, rv, apart, hi, lo
        if torch.equal(nxt, parent):
            return parent
        parent = _compress(nxt)


def answer(pairs: Pairs, min_pts: int) -> Answer:
    """Core flags and labels at ``min_pts`` from the ε-neighbour pairs."""
    counts = pairs.counts
    n = counts.shape[0]
    core = counts >= min_pts
    root = components(n, pairs, core)
    labels = torch.where(core, root, INT_MAX)
    attach = torch.full((n,), INT_MAX, dtype=torch.int64,
                        device=counts.device)
    for s, d in zip(pairs.src, pairs.dst):
        border = ~core[s] & core[d]
        attach.scatter_reduce_(0, s[border].long(), labels[d[border]],
                               "amin", include_self=True)
        del border
    labels = torch.where(core, labels,
                         torch.where(attach != INT_MAX, attach, -1))
    return Answer(counts, core, labels.to(torch.int32))
