"""Plain reference of exact DBSCAN, in PyTorch operations only.

It states the answer the benchmark holds the program to, worked out from
the points alone:

  * counts[i]: the points j (i itself included) with d²(i, j) ≤ ε², where
    d² = ((dx·dx) + dy·dy) + dz·dz, d = p_i − p_j, each operation rounded
    on its own in float32, and ε² is ``float(eps) ** 2`` rounded once to
    float32;
  * core[i] = counts[i] ≥ minPts;
  * a core point's label is the smallest index of the core points joined
    to it by chains of core neighbours (its cluster);
  * a non-core point's label is the smallest label among its core
    neighbours, or −1 (noise) where it has none.

The neighbour search is a cell grid of side a little above ε: every pair
within ε lies in the same or adjacent cells, and every candidate is tested
with the d² above. Clusters come from hooking roots of the explicit
core–core edge list together (smaller root wins) and full pointer jumping.

It imports nothing of the program, and runs on whatever device it is
given, in blocks of candidate pairs so that it fits.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

INT_MAX = 2**31 - 1


class Pairs(NamedTuple):
    """Every ordered pair (i, j) with d²(i, j) ≤ ε², self pairs included."""
    counts: torch.Tensor   # (n,) int32
    src: torch.Tensor      # (P,) int64
    dst: torch.Tensor      # (P,) int64


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
    """All ε-neighbour pairs of ``points`` (n, 3) float32.

    ``dtype`` is the precision of d² and of the comparison with ε²;
    float32 is the configuration's, and a lower one makes the control.
    """
    pts = torch.as_tensor(np.ascontiguousarray(points, np.float32),
                          device=device)
    n = pts.shape[0]
    eps2 = torch.tensor(float(np.float32(float(eps) ** 2)),
                        dtype=torch.float32, device=device).to(dtype)
    # cells of side a little above ε, in float64: a pair within ε differs
    # by at most one cell on every axis
    side = float(eps) * (1.0 + 2.0 ** -8)
    p64 = pts.double()
    cell = torch.floor((p64 - p64.min(dim=0).values) / side).long() + 1
    cell[:, dims:] = 1
    span = cell.max(dim=0).values + 2
    key = (cell[:, 0] * span[1] + cell[:, 1]) * span[2] + cell[:, 2]
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
                src.append(qi)
                dst.append(cj)
            q0 = q1
    return Pairs(counts.to(torch.int32), torch.cat(src), torch.cat(dst))


def _compress(parent: torch.Tensor) -> torch.Tensor:
    while True:
        up = parent[parent]
        if torch.equal(up, parent):
            return parent
        parent = up


def components(n: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Root of each element under the edges (u, v): the smallest element
    of its component."""
    parent = torch.arange(n, dtype=torch.int64, device=u.device)
    while True:
        ru, rv = parent[u], parent[v]
        apart = ru != rv
        if not bool(apart.any()):
            return parent
        hi = torch.maximum(ru, rv)[apart]
        lo = torch.minimum(ru, rv)[apart]
        parent = parent.scatter_reduce(0, hi, lo, "amin", include_self=True)
        parent = _compress(parent)


def answer(pairs: Pairs, min_pts: int) -> Answer:
    """Core flags and labels at ``min_pts`` from the ε-neighbour pairs."""
    counts = pairs.counts
    n = counts.shape[0]
    core = counts >= min_pts
    cs, cd = core[pairs.src], core[pairs.dst]
    both = cs & cd
    root = components(n, pairs.src[both], pairs.dst[both])
    labels = torch.where(core, root, INT_MAX)
    border = ~cs & cd
    attach = torch.full((n,), INT_MAX, dtype=torch.int64,
                        device=counts.device)
    attach.scatter_reduce_(0, pairs.src[border], labels[pairs.dst[border]],
                           "amin", include_self=True)
    labels = torch.where(core, labels,
                         torch.where(attach != INT_MAX, attach, -1))
    return Answer(counts, core, labels.to(torch.int32))
