"""FDBSCAN baseline (Prokopenko et al., arXiv:2103.05162).

BVH traversal + parallel union-find, no neighbor storage: the strongest
baseline in the paper. Runs on the LBVH *stack* engine
(``engine="bvh-stack"``: lockstep per-query traversal, "FDBSCAN without RT
cores"; the wavefront engine is RT-DBSCAN's own trick, so the baseline must
not use it). ``early_exit=True`` enables its early traversal termination
for stage-1 core counting: a query's traversal also stops at
``count ≥ minPts``.
"""
from __future__ import annotations

import torch

from ..core import bvh as bvh_mod
from ..core import engines
from ..core.dbscan import DBSCANResult, dbscan


def run(points, eps: float, min_pts: int, *, early_exit: bool = False,
        chunk: int = 2048, max_rounds: int = 64,
        device=None) -> DBSCANResult:
    """DBSCAN of ``points`` (n, 3) on the stack engine; ``device=None``
    means ``cuda``. ``chunk`` is the reference's per-vmap width, kept for
    its signature: the stack engine steps every query at once."""
    if not early_exit:
        return dbscan(points, eps, min_pts, engine="bvh-stack",
                      max_rounds=max_rounds, device=device)
    dev = engines.resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = points.shape[0]
    # Stage 1 with early termination; stage 2 must traverse fully (it needs
    # the true min core-neighbor root), exactly as in FDBSCAN.
    eng_early = bvh_mod.make_bvh_stack_engine(points, eps,
                                              early_stop=min_pts)
    counts, _ = eng_early.sweep(
        eng_early.state, torch.zeros(n, dtype=torch.bool, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev))
    eng = bvh_mod.make_bvh_stack_engine(points, eps)
    return dbscan(points, eps, min_pts, eng=eng, precomputed_counts=counts,
                  max_rounds=max_rounds)
