"""Stand-in for 3DRoad (the UCI 3D Road Network of North Jutland, 434,874
points, RT-DBSCAN §V-A): a random planar road graph wandered by noisy
walkers, long 1-D chains in 2D with z = 0.

A frozen copy of ``repro_torch.data.synth.roadnet2d`` (single-stream draws,
``structure_seed=None``); ``test_portbench_data.py`` holds the two equal.
"""
from __future__ import annotations

import numpy as np


def generate(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_nodes = max(16, n // 2000)
    nodes = rng.uniform(0.0, 10.0, (n_nodes, 2))
    pts = np.empty((n, 2), np.float32)
    i = 0
    while i < n:
        a, b = rng.integers(0, n_nodes, 2)
        seg = rng.integers(20, 200)
        seg = min(seg, n - i)
        t = np.linspace(0, 1, seg)[:, None]
        line = nodes[a] * (1 - t) + nodes[b] * t
        line += rng.normal(0, 0.004, line.shape)
        pts[i:i + seg] = line
        i += seg
    z = np.zeros((n, 1), np.float32)
    return np.concatenate([pts, z], axis=1)
