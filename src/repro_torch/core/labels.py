"""Label post-processing + DBSCAN-equivalence checking.

DBSCAN's output is unique only up to (a) cluster renaming and (b) border-point
tie-breaks (a border point in ε-range of two clusters may legally join
either — the paper's critical section picks a race winner; we pick the min).
``equivalent`` checks the strongest property that *is* well-defined:
core-point partitions match exactly, noise matches exactly, and every border
point is assigned to some cluster that contains a core ε-neighbor of it.
"""
from __future__ import annotations

import numpy as np


def compact_labels(labels) -> np.ndarray:
    """Map raw root-id labels to 0..k−1 (noise stays −1). Host-side."""
    labels = np.asarray(labels)
    out = np.full_like(labels, -1)
    mask = labels >= 0
    uniq, inv = np.unique(labels[mask], return_inverse=True)
    out[mask] = inv
    return out


def cluster_sizes(labels) -> np.ndarray:
    labels = compact_labels(labels)
    if (labels >= 0).sum() == 0:
        return np.zeros(0, np.int64)
    return np.bincount(labels[labels >= 0])


def equivalent(labels_a, labels_b, core, points=None, eps=None) -> bool:
    """DBSCAN-equivalence of two labelings (see module docstring).

    If ``points``/``eps`` are given, border assignments are validated against
    geometry; otherwise border points are only required to agree on
    noise-vs-clustered status.
    """
    a = np.asarray(labels_a)
    b = np.asarray(labels_b)
    core = np.asarray(core)
    if a.shape != b.shape:
        return False
    # Noise must match exactly.
    if not np.array_equal(a == -1, b == -1):
        return False
    # Core partition must match exactly (same-cluster relation over cores).
    ca, cb = a[core], b[core]
    if ca.size:
        # canonical form: map each label to the first core index carrying it
        def canon(x):
            _, first = np.unique(x, return_index=True)
            m = {x[i]: i for i in first}
            return np.array([m[v] for v in x])
        if not np.array_equal(canon(ca), canon(cb)):
            return False
    # Border points: must join a cluster that contains a core ε-neighbor.
    if points is not None and eps is not None:
        pts = np.asarray(points)
        border = (~core) & (a != -1)
        core_idx = np.where(core)[0]
        for i in np.where(border)[0]:
            d2 = ((pts[core_idx] - pts[i]) ** 2).sum(axis=1)
            near = core_idx[d2 <= eps * eps + 1e-12]
            for lab in (a, b):
                if lab[i] not in set(lab[near]):
                    return False
    return True
