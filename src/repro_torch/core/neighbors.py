"""Neighbor-search engines: the fused sweep primitive.

An *engine* answers the paper's fused sweep query:

    sweep(state, core, root) -> (counts, minroot)

    counts[i]  = |{ j : ‖p_i − p_j‖² ≤ ε² }|          (self included)
    minroot[i] = min{ root[j] : j ε-neighbor of i, core[j] }  (INT_MAX if none)

The port has one engine so far, ``grid``: the cell-sorted CSR ε-grid
(``grid.py``), whose inner loop is the ``csr_sweep`` kernel pair. Points are
reordered by Morton cell code and query tiles sweep contiguous candidate
slabs sized by actual local occupancy. Besides ``sweep`` it exposes
``sweep_sorted`` (payloads already in sorted layout, so the DBSCAN round
driver stays in sorted order across hooking rounds) and ``sweep_counts``
(stage 1 without the payload plane).
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..kernels import ops
from . import engines
from . import grid as grid_mod
from .engines import Engine, make_engine  # re-export (public API)  # noqa: F401

INT_MAX = ops.INT_MAX


def infer_dims(points_np: np.ndarray) -> int:
    """Data dimensionality: the column count, except for the paper's 3-col
    convention where 2D data rides in (n, 3) arrays with z = 0."""
    d = points_np.shape[1]
    if d != 3:
        return d
    return 2 if np.all(points_np[:, 2] == 0) else 3


@functools.lru_cache(maxsize=64)
def _csr_sweep_fns(spec: grid_mod.CSRGridSpec, eps2: float):
    """Sweeps of the cell-sorted CSR engine: the standard contract (original
    order / original root ids), the sorted-layout fast path, and the
    counts-only stage-1 sweep."""
    n = spec.n

    def _call(state: grid_mod.CSRGrid, croot_sorted):
        croot_pad = torch.full((spec.n_cand,), INT_MAX, dtype=torch.int32,
                               device=croot_sorted.device)
        croot_pad[:n] = croot_sorted
        counts_p, minroot_p = ops.csr_sweep(
            state.q_sorted, state.cands, croot_pad, state.starts, state.nblk,
            eps2, slab=spec.slab, block_q=spec.chunk, block_k=spec.block_k)
        return counts_p[:n], minroot_p[:n]

    def sweep(state: grid_mod.CSRGrid, core, root):
        order = state.order.long()
        croot_s = ops.fuse_core_root(core[order], root[order])
        counts_s, minroot_s = _call(state, croot_s)
        counts = torch.zeros((n,), dtype=torch.int32, device=order.device)
        counts[order] = counts_s
        minroot = torch.full((n,), INT_MAX, dtype=torch.int32,
                             device=order.device)
        minroot[order] = minroot_s
        return counts, minroot

    def sweep_sorted(state: grid_mod.CSRGrid, croot_sorted):
        return _call(state, croot_sorted)

    def sweep_counts(state: grid_mod.CSRGrid):
        counts_p = ops.csr_sweep_counts(
            state.q_sorted, state.cands, state.starts, state.nblk, eps2,
            slab=spec.slab, block_q=spec.chunk, block_k=spec.block_k)
        return counts_p[:n]

    return sweep, sweep_sorted, sweep_counts


def _build_csr(points, eps, *, dims=None, spec=None):
    eps2 = float(eps) ** 2   # in double, rounded once to f32 by the sweep
    pts_np = points.cpu().numpy()
    if dims is None:
        dims = infer_dims(pts_np)
    t0 = time.perf_counter()
    if spec is None:
        spec = grid_mod.plan_csr_grid(pts_np, float(eps), dims=dims,
                                      device=points.device)
    plan_s = time.perf_counter() - t0
    g = grid_mod.build_csr_grid(points, spec)
    if bool(g.overflow):
        raise ValueError(
            "CSR grid build overflowed the planned slab capacity "
            f"(slab={spec.slab}) — the spec was planned for different "
            "data; re-plan with plan_csr_grid on this dataset")
    fn, fn_sorted, fn_counts = _csr_sweep_fns(spec, eps2)
    return Engine("grid", g, fn, points.device, meta=spec,
                  sweep_sorted=fn_sorted, order=g.order,
                  timings={"plan_s": plan_s}, sweep_counts=fn_counts)


engines.register_engine(
    "grid", _build_csr,
    doc="cell-sorted CSR ε-grid; sorted-layout fast path (the default)",
    capabilities=("sweep_sorted", "sweep_counts"))
