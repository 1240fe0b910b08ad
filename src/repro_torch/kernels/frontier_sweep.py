"""Frontier-compacted CSR slab ε-sweep: the frontier round driver's inner
loop.

``csr_sweep`` restricted to an active-tile index vector: output slot ``i``
(rows ``[i·block_q, (i+1)·block_q)``) holds the min-root rows of query tile
``active[i]`` when ``i < n_active`` and INT32_MAX rows otherwise. Only the
min-root is computed (hooking discards counts). ``n_active`` is a (1,)
int32 tensor on the tensors' device: the kernel reads it there, so a
caller never syncs the host to learn it. Entries of ``active`` at or past
``n_active`` repeat the last live tile id (0 when none), the reference's
park contract (``core.grid.compact_tiles``).

Three parts, as in ``csr_sweep.py``: the CUDA kernel (``csrc/csr_sweep.cu``:
``csr_sweep``'s box pass, a cull pass with one block per slot that reads
``n_active`` and ``active[i]`` itself and keeps the runs of tile
``active[i]``'s slab that come within ε of its box, and the persistent
sweep of the kept runs into slot ``i``'s rows), its wrapper, and the plain
PyTorch version. :func:`kept_runs_plain` gives the runs the kernel keeps.
CPU tensors go to the plain version; CUDA tensors launch the kernel or
raise. Integer outputs of the two are bit-identical.
"""
from __future__ import annotations

import torch

from . import build
from . import csr_sweep as _csr
from .csr_sweep import (_check, _cuda_or_raise, _eps2_f32, _scratch,
                        _sweep_plain)
from .ref import INT_MAX

# Launches since the last reset_launches(); the plain version never counts.
LAUNCHES = {"frontier_sweep": 0}


def reset_launches() -> None:
    LAUNCHES["frontier_sweep"] = 0


def _check_frontier(queries, active, n_active, T):
    for name, x in (("active", active), ("n_active", n_active)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on "
                             f"{queries.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if active.shape != (T,):
        raise ValueError(f"active {tuple(active.shape)} != ({T},)")
    if n_active.shape != (1,):
        raise ValueError(f"n_active {tuple(n_active.shape)} != (1,)")


def frontier_sweep_plain(queries, cands_planar, croot, starts_blk, nblk,
                         active, n_active, eps2, *, max_blocks: int,
                         block_k: int = 512):
    """Plain PyTorch version of :func:`frontier_sweep` (any device): the
    slab sweep of tile ``active[i]`` in slot ``i`` for the live slots only,
    so its cost tracks the live count (which it reads on the host)."""
    T = starts_blk.shape[0]
    block_q = queries.shape[0] // T if T else 0
    na = min(max(int(n_active.reshape(-1)[0]), 0), T)
    minroot = torch.full((T * block_q,), INT_MAX, dtype=torch.int32,
                         device=queries.device)
    if na == 0:
        return minroot
    tiles = active[:na].long()
    q = queries.reshape(T, block_q, 3)[tiles].reshape(-1, 3)
    minroot[:na * block_q] = _sweep_plain(
        q, cands_planar, croot, starts_blk[tiles], nblk[tiles], eps2,
        max_blocks=max_blocks, block_k=block_k)[1]
    return minroot


def kept_runs_plain(queries, cands_planar, starts_blk, nblk, active,
                    n_active, eps2, *, max_blocks: int, block_k: int = 512):
    """(T, max_blocks · block_k / G) bool: the runs the kernel sweeps for
    slot ``i``, those of ``csr_sweep.kept_runs_plain`` for tile
    ``active[i]`` when ``i < n_active``, none for a parked slot."""
    T = starts_blk.shape[0]
    block_q = queries.shape[0] // T if T else 0
    na = min(max(int(n_active.reshape(-1)[0]), 0), T)
    kept = torch.zeros((T, max_blocks * (block_k // _csr.run_width(block_k))),
                       dtype=torch.bool, device=queries.device)
    if na == 0:
        return kept
    tiles = active[:na].long()
    kept[:na] = _csr.kept_runs_plain(
        queries.reshape(T, block_q, 3)[tiles].reshape(-1, 3), cands_planar,
        starts_blk[tiles], nblk[tiles], eps2, max_blocks=max_blocks,
        block_k=block_k)
    return kept


def frontier_sweep(queries, cands_planar, croot, starts_blk, nblk, active,
                   n_active, eps2, *, max_blocks: int, block_q: int = 256,
                   block_k: int = 512):
    """Min-root over per-tile slabs, restricted to the active tiles.

    queries      (T·block_q, 3) f32 — sorted query tiles
    cands_planar (3, nc) f32        — sorted candidates, +BIG padded
    croot        (nc,) int32        — root if core else INT32_MAX
    starts_blk   (T,) int32         — slab start per tile, in blocks
    nblk         (T,) int32         — live blocks per tile, ≤ max_blocks
    active       (T,) int32         — live tile ids compacted to the front,
                                      parked entries repeating the last
    n_active     (1,) int32         — live slot count, on the device
    eps2         float              — ε², rounded once to f32
    Returns minroot (T·block_q,) int32 in compacted slot order.
    """
    T = starts_blk.shape[0]
    _check(queries, cands_planar, croot, starts_blk, nblk,
           max_blocks=max_blocks, block_q=block_q, block_k=block_k)
    _check_frontier(queries, active, n_active, T)
    if queries.device.type == "cpu":
        return frontier_sweep_plain(queries, cands_planar, croot, starts_blk,
                                    nblk, active, n_active, eps2,
                                    max_blocks=max_blocks, block_k=block_k)
    _cuda_or_raise(queries, "frontier_sweep")
    # fresh each call: the cull pass sets it to INT32_MAX, then the sweep
    # folds into the live slots' rows
    minroot = torch.empty(queries.shape[0], dtype=torch.int32,
                          device=queries.device)
    if T == 0:
        return minroot
    # the list has room for every segment of every slot's slab; the kernel
    # counts the items on the device
    run, boxes, items, counters = _scratch(
        queries, cands_planar, starts_blk, max_blocks=max_blocks,
        block_k=block_k)
    build.launch("csr_sweep", "frontier_sweep_launch", "pppppppfiiiiiipppp",
                 "frontier_sweep", queries.device, queries, cands_planar,
                 croot, starts_blk, nblk, active, n_active, _eps2_f32(eps2),
                 T, block_q, cands_planar.shape[1], max_blocks, block_k, run,
                 minroot, boxes, items, counters)
    build.count(LAUNCHES, "frontier_sweep")
    return minroot
