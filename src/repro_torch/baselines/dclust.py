"""CUDA-DClust+-style baseline (Poudel & Gowanlock 2021), simplified.

CUDA-DClust(+) grows clusters incrementally in parallel via chains over a
spatial index, merging colliding chains. The equivalent of chain growth
without union-find is *min-label wavefront propagation* over the grid
engine: every core point repeatedly adopts the minimum label among its core
ε-neighbors. Convergence takes O(core-graph diameter) sweeps — versus
RT-DBSCAN's O(log n) hooking rounds — which is exactly the algorithmic gap
this baseline is here to exhibit (and one reason DClust-style designs lose
on chain-shaped data like road networks). Each round is one sweep of the
grid engine (the ``csr_sweep`` kernel on the card) and one host read of
whether any label changed.
"""
from __future__ import annotations

import torch

from ..core import engines
from ..core import neighbors as nb
from ..core.dbscan import DBSCANResult

INT_MAX = nb.INT_MAX


def run(points, eps: float, min_pts: int, *, chunk: int = 2048,
        max_iters: int = 4096, device=None) -> DBSCANResult:
    """DBSCAN of ``points`` (n, 3) by min-label propagation over the grid
    engine on ``device`` (``None`` means ``cuda``)."""
    dev = engines.resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = points.shape[0]
    eng = nb.make_engine(points, eps, engine="grid", chunk=chunk, device=dev)
    counts, _ = eng.sweep(eng.state, torch.zeros(n, dtype=torch.bool,
                                                 device=dev),
                          torch.arange(n, dtype=torch.int32, device=dev))
    core = counts >= min_pts
    # labels double as the "root" payload for the sweep: min over core
    # neighbors of their current label == chain merge step.
    label = torch.arange(n, dtype=torch.int32, device=dev)
    iters = 0
    for _ in range(max_iters):
        _, m = eng.sweep(eng.state, core, label)
        new = torch.where(core, torch.minimum(label, m), label)
        changed = bool((new != label).any())
        label = new
        iters += 1
        if not changed:
            break
    _, m = eng.sweep(eng.state, core, label)
    labels = torch.where(core, label,
                         torch.where(m != INT_MAX, m, -1)).to(torch.int32)
    return DBSCANResult(labels=labels, core=core, counts=counts,
                        n_rounds=iters)
