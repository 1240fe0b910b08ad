"""Sequential reference DBSCAN — faithful to the paper's Algorithm 1.

Pure numpy, O(n²); the correctness oracle for every accelerated path.
Border points are claimed by the first cluster that reaches them (seed-order
expansion), exactly like the original Ester et al. algorithm; tests compare
against accelerated outputs with ``labels.equivalent`` (border tie-breaks are
implementation-defined, DESIGN.md §7).

A copy of the JAX package's ``repro.baselines.brute``, which imports no JAX
either; the port keeps its own so that it imports nothing of that package.
"""
from __future__ import annotations

import numpy as np


def reference_dbscan(points, eps: float, min_pts: int):
    """Returns (labels (n,) int64 with −1 noise, core (n,) bool)."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    eps2 = float(eps) ** 2
    # Neighborhoods (self included — sklearn/minPts convention, DESIGN.md §7).
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    neigh = [np.where(d2[i] <= eps2)[0] for i in range(n)]
    core = np.array([len(nb) >= min_pts for nb in neigh])

    labels = np.full(n, -2, np.int64)  # -2 = UNASSIGNED, -1 = NOISE
    cid = 0
    for p in range(n):
        if labels[p] != -2:
            continue
        if not core[p]:
            labels[p] = -1
            continue
        labels[p] = cid
        stack = list(neigh[p])
        while stack:
            q = stack.pop()
            if labels[q] == -1:
                labels[q] = cid          # noise -> border
            if labels[q] != -2:
                continue
            labels[q] = cid
            if core[q]:
                stack.extend(neigh[q])
        cid += 1
    return labels, core


def reference_counts(points, eps: float):
    pts = np.asarray(points, np.float64)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return (d2 <= float(eps) ** 2).sum(1).astype(np.int32)
