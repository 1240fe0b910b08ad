"""Stand-in for 3DIono (3-D ionosphere total-electron-content readings,
RT-DBSCAN §V-A): six layered sheets with smooth horizontal variation.

A frozen copy of ``repro_torch.data.synth.iono3d``;
``test_portbench_data.py`` holds the two equal.
"""
from __future__ import annotations

import numpy as np


def generate(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_layers = 6
    layer = rng.integers(0, n_layers, n)
    lat = rng.uniform(-60.0, 60.0, n)
    lon = rng.uniform(-180.0, 180.0, n) * 0.25
    tec = (layer * 12.0 + 4.0 * np.sin(lat / 17.0) + 2.5 * np.cos(lon / 23.0)
           + rng.normal(0, 0.8, n))
    return np.stack([lat, lon, tec], axis=1).astype(np.float32)
