"""Synthetic analogues of the paper's evaluation datasets (§V-A).

The container is offline, so we generate structurally-matched stand-ins:

  * ``roadnet2d``  ~ 3DRoad  (North Jutland road network, 435K 2D pts):
    a random planar graph wandered by noisy walkers — long 1-D chains,
    the worst case for diameter-bound algorithms.
  * ``taxi2d``     ~ Porto   (1M+ taxi GPS): dense urban blob mixture plus
    inter-blob route traffic.
  * ``highway``    ~ NGSIM   (11M+ vehicle locations on 3 highways): extreme
    global density along a few lanes; at the paper's tiny ε values the
    ε-neighborhoods are *empty* (0 clusters formed, §V-C).
  * ``iono3d``     ~ 3DIono  (1M+ 3D ionosphere readings): layered 3-D
    sheets with smooth horizontal variation.

All return float32 (n, 3) with z = 0 for 2D, exactly as the paper feeds
OptiX. Deterministic in (name, n, seed).

``structure_seed`` (optional, every generator) splits the RNG: the
dataset's *global structure* (taxi hubs, road-graph nodes, blob centers)
is drawn from ``structure_seed`` while the per-point samples come from
``seed``. Streaming consumers (``pipeline.point_stream``) use this to
draw many independent sample chunks from ONE world — without it, a
per-chunk seed would redraw the hubs/graph per chunk and the chunks would
not share a distribution (or match a corpus built from the same world).
``structure_n`` likewise pins the *size* of n-scaled structure (the road
graph's node count) to the stream total rather than the chunk length.
Default ``None`` for both reproduces the single-RNG draws bit-for-bit.
"""
from __future__ import annotations

import numpy as np


def _as3(points2d: np.ndarray) -> np.ndarray:
    z = np.zeros((len(points2d), 1), np.float32)
    return np.concatenate([points2d.astype(np.float32), z], axis=1)


def _split_rng(seed: int, structure_seed):
    """(structure rng, sample rng): one rng drawn through sequentially when
    no structure_seed is given (the historical layout), separate streams
    otherwise."""
    rng = np.random.default_rng(seed)
    rs = rng if structure_seed is None else np.random.default_rng(
        structure_seed)
    return rs, rng


def roadnet2d(n: int, seed: int = 0, structure_seed: int | None = None,
              structure_n: int | None = None) -> np.ndarray:
    rs, rng = _split_rng(seed, structure_seed)
    # the road graph scales with the dataset; streaming chunks pass the
    # STREAM total as structure_n so every chunk shares the corpus-sized
    # graph instead of a graph sized by the chunk
    n_nodes = max(16, (n if structure_n is None else structure_n) // 2000)
    nodes = rs.uniform(0.0, 10.0, (n_nodes, 2))
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
    return _as3(pts)


def taxi2d(n: int, seed: int = 0, structure_seed: int | None = None,
           structure_n: int | None = None) -> np.ndarray:
    rs, rng = _split_rng(seed, structure_seed)
    n_hubs = 12
    hubs = rs.uniform(0.0, 8.0, (n_hubs, 2))
    # the per-hub width ladder is structure too (it sets hub-local density,
    # which drives core/noise decisions) — but the historical single-RNG
    # layout draws it after the samples, so only reroute when split
    widths = rs.uniform(0.3, 1.0, (n_hubs,)) if structure_seed is not None \
        else None
    n_blob = int(n * 0.7)
    which = rng.integers(0, n_hubs, n_blob)
    if widths is None:
        widths_blob = rng.normal(0, 0.15, (n_blob, 2)) * \
            rng.uniform(0.3, 1.0, (n_hubs,))[which][:, None]
    else:
        widths_blob = rng.normal(0, 0.15, (n_blob, 2)) * \
            widths[which][:, None]
    blob = hubs[which] + widths_blob
    n_route = n - n_blob
    a = hubs[rng.integers(0, n_hubs, n_route)]
    b = hubs[rng.integers(0, n_hubs, n_route)]
    t = rng.uniform(0, 1, (n_route, 1))
    route = a * (1 - t) + b * t + rng.normal(0, 0.03, (n_route, 2))
    return _as3(np.concatenate([blob, route]))


def highway(n: int, seed: int = 0, structure_seed: int | None = None,
            structure_n: int | None = None) -> np.ndarray:
    # lanes are fixed geometry — no random global structure to share
    rng = np.random.default_rng(seed)
    n_lanes = 9
    lane = rng.integers(0, n_lanes, n)
    x = rng.uniform(0.0, 1000.0, n)          # along-highway position
    y = lane * 3.7 + rng.normal(0, 0.2, n)   # lane center ± jitter (meters)
    pts = np.stack([x, y], axis=1)
    return _as3(pts)


def iono3d(n: int, seed: int = 0, structure_seed: int | None = None,
           structure_n: int | None = None) -> np.ndarray:
    # layer sheets are fixed geometry — no random global structure
    rng = np.random.default_rng(seed)
    n_layers = 6
    layer = rng.integers(0, n_layers, n)
    lat = rng.uniform(-60.0, 60.0, n)
    lon = rng.uniform(-180.0, 180.0, n) * 0.25
    tec = (layer * 12.0 + 4.0 * np.sin(lat / 17.0) + 2.5 * np.cos(lon / 23.0)
           + rng.normal(0, 0.8, n))
    pts = np.stack([lat, lon, tec], axis=1).astype(np.float32)
    return pts


def skewed2d(n: int, seed: int = 0, structure_seed: int | None = None,
             structure_n: int | None = None) -> np.ndarray:
    """Pathologically skewed occupancy: ~30% of the points in one clump far
    denser than any ε of interest, the rest uniform over a wide domain.

    This is the regime where the capacity-padded hash grid degrades — the
    clump sets the global bucket capacity C_max, and every query then pays a
    27·C_max window (and the (H, C) table pays H·C_max slots) — while the
    cell-sorted CSR engine's per-tile slabs stay local (DESIGN.md §3).
    """
    rng = np.random.default_rng(seed)
    n_clump = int(n * 0.3)
    del structure_seed  # clump center is fixed — no random structure
    clump = np.array([5.0, 5.0]) + rng.normal(0, 1e-3, (n_clump, 2))
    rest = rng.uniform(0.0, 10.0, (n - n_clump, 2))
    return _as3(np.concatenate([clump, rest]))


DATASETS = {
    "roadnet2d": roadnet2d,
    "taxi2d": taxi2d,
    "highway": highway,
    "iono3d": iono3d,
    "skewed2d": skewed2d,
}


def load(name: str, n: int, seed: int = 0,
         structure_seed: int | None = None,
         structure_n: int | None = None) -> np.ndarray:
    return DATASETS[name](n, seed, structure_seed=structure_seed,
                          structure_n=structure_n)


def blobs(n: int, k: int = 5, dims: int = 2, seed: int = 0,
          noise_frac: float = 0.1, std: float = 0.05) -> np.ndarray:
    """Generic blob mixture for tests/examples."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 2.0, (k, dims))
    n_noise = int(n * noise_frac)
    n_blob = n - n_noise
    which = rng.integers(0, k, n_blob)
    pts = centers[which] + rng.normal(0, std, (n_blob, dims))
    noise = rng.uniform(-0.5, 2.5, (n_noise, dims))
    pts = np.concatenate([pts, noise]).astype(np.float32)
    if dims == 2:
        return _as3(pts)
    return pts
