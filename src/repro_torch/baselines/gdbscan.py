"""G-DBSCAN baseline (Andrade et al. 2013).

Materializes the ε-neighborhood graph, then finds clusters with BFS over
core-core edges. Memory is O(n²) (dense adjacency) — faithful to the paper's
finding that G-DBSCAN OOMs above ~100K points on a 6 GB GPU (§V-B1); we
raise the same way past ``max_n``, although the card could hold more: the
limit is the baseline's contract. BFS is realized as dense min-label
propagation (row-tiled), which performs the identical wavefront expansion.
Both are plain PyTorch on the points' device, as the reference computes
them in jnp outside any kernel; d² is ``kernels.ref._dist2``'s (separate
subtract, multiply and add per coordinate, ascending).
"""
from __future__ import annotations

import torch

from ..core import engines
from ..core.dbscan import DBSCANResult
from ..kernels import ref as kref

INT_MAX = kref.INT_MAX


class GDBSCANMemoryError(MemoryError):
    pass


def _adjacency(points, eps2: float, row_chunk: int) -> torch.Tensor:
    """(B, row_chunk, n) bool ε-adjacency of row chunks; rows past n are
    padding at +1e30 and hit nothing."""
    n = points.shape[0]
    n_pad = -(-n // row_chunk) * row_chunk
    q = kref.pad_to(points, n_pad, 0, 1e30)
    eps2_t = kref.eps2_tensor(eps2, points.device)
    return torch.stack([
        kref._dist2(q[s:s + row_chunk, None, :], points[None, :, :]) <= eps2_t
        for s in range(0, n_pad, row_chunk)])


def _label_round(adj, label, core, n: int):
    """Min label of each row's core neighbors (INT32_MAX when none)."""
    return torch.cat([
        torch.where(a & core[None, :], label[None, :], INT_MAX).amin(dim=1)
        for a in adj])[:n]


def run(points, eps: float, min_pts: int, *, max_n: int = 100_000,
        row_chunk: int = 1024, max_iters: int = 4096,
        device=None) -> DBSCANResult:
    """DBSCAN of ``points`` (n, 3) by dense adjacency and min-label
    propagation on ``device`` (``None`` means ``cuda``). Raises
    :class:`GDBSCANMemoryError` past ``max_n`` points."""
    dev = engines.resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = points.shape[0]
    if n > max_n:
        raise GDBSCANMemoryError(
            f"G-DBSCAN adjacency needs O(n²) memory; n={n} > max_n={max_n} "
            f"(mirrors the paper's >100K OOM, §V-B1)")
    adj = _adjacency(points, float(eps) ** 2, row_chunk)
    counts = adj.reshape(-1, n)[:n].sum(dim=1).to(torch.int32)
    core = counts >= min_pts

    label = torch.where(core, torch.arange(n, dtype=torch.int32, device=dev),
                        INT_MAX)
    iters = 0
    while iters < max_iters:
        m = _label_round(adj, label, core, n)
        new = torch.where(core, torch.minimum(label, m), label)
        iters += 1
        if not bool((new != label).any()):
            label = new
            break
        label = new
    # border attachment: min core-neighbor label
    m = _label_round(adj, label, core, n)
    labels = torch.where(core, label,
                         torch.where(m != INT_MAX, m, -1)).to(torch.int32)
    return DBSCANResult(labels=labels, core=core, counts=counts,
                        n_rounds=iters)
