"""Stand-in for Porto (GPS points of the ECML/PKDD 2015 Porto taxi
trajectories, 1M+ points, RT-DBSCAN §V-A): 70% of the points in 12
Gaussian hubs of random width, 30% on routes between two hubs, z = 0.

A frozen copy of ``repro_torch.data.synth.taxi2d`` (single-stream draws,
``structure_seed=None``); ``test_portbench_data_taxi.py`` holds the two
equal.
"""
from __future__ import annotations

import numpy as np


def generate(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_hubs = 12
    hubs = rng.uniform(0.0, 8.0, (n_hubs, 2))
    n_blob = int(n * 0.7)
    which = rng.integers(0, n_hubs, n_blob)
    # the hub widths are drawn after the samples' offsets
    blob = hubs[which] + rng.normal(0, 0.15, (n_blob, 2)) * \
        rng.uniform(0.3, 1.0, (n_hubs,))[which][:, None]
    n_route = n - n_blob
    a = hubs[rng.integers(0, n_hubs, n_route)]
    b = hubs[rng.integers(0, n_hubs, n_route)]
    t = rng.uniform(0, 1, (n_route, 1))
    route = a * (1 - t) + b * t + rng.normal(0, 0.03, (n_route, 2))
    pts = np.concatenate([blob, route]).astype(np.float32)
    z = np.zeros((n, 1), np.float32)
    return np.concatenate([pts, z], axis=1)
