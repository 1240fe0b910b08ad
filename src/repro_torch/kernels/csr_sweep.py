"""Cell-sorted CSR slab ε-sweep: the grid engine's inner loop.

Query tile ``t`` (rows ``[t·block_q, (t+1)·block_q)`` of the sorted query
array) sweeps the ``nblk[t]`` candidate blocks of ``block_k`` columns that
start at block ``starts_blk[t]`` of the planar ``(3, nc)`` sorted candidate
array. ``csr_sweep`` returns per-query counts of candidates with d² ≤ ε² and
the min of the fused payload ``croot`` over those hits (INT32_MAX when none);
``csr_sweep_counts`` returns the counts alone (stage 1 discards the payload).

Each function has three parts:
  * the CUDA kernel, ``csrc/csr_sweep.cu``: a box pass over runs of ``G``
    candidate columns, a cull pass that keeps the runs whose box comes
    within ε of the tile's box, and a persistent sweep of the kept runs;
  * its wrapper, which checks the inputs, allocates the outputs and the
    kernel's scratch (boxes, work list), launches on the current stream,
    raises on a launch error and counts the launch in ``LAUNCHES``;
  * the plain PyTorch version (``*_plain``), vectorised over tiles and
    looping over the block index ``j`` with a ``j < nblk[t]`` mask.

The kernel's skip has a plain version too (:func:`kept_runs_plain`, with
:func:`run_boxes_plain`, :func:`tile_boxes_plain` and
:func:`box_lower_bound`): the same f32 operations in the same order. Tests
and the smoke run use it; the sweep does not need it, since a skipped run
holds no hit (``csrc/csr_sweep.cu`` gives the argument).

Dispatch is by the tensors' device alone: CPU tensors go to the plain
version; CUDA tensors launch the kernel or raise. Integer outputs of the two
are bit-identical (the d² arithmetic is ``ref._dist2``'s).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import build
from .ref import INT_MAX, _dist2, eps2_tensor

# Launches of each kernel since the last reset_launches(); the plain
# versions never count.
LAUNCHES = {"csr_sweep": 0, "csr_sweep_counts": 0}

# G: the kernel boxes runs of gcd(block_k, RUN) candidate columns (128
# swept the full-size grids 1.7x faster than 512 on an H100: PERF.md).
# S: runs per work item, fixed by the kernel (kSegRuns, the width of its
# kept-run bitmask); the wrapper sizes the work list with it.
RUN = 128
SEG_RUNS = 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _eps2_f32(eps2: float) -> float:
    """ε² rounded once to f32 (callers pass ``float(eps) ** 2``)."""
    return float(np.float32(eps2))


def _check(queries, cands_planar, croot, starts_blk, nblk, *, max_blocks,
           block_q, block_k):
    T = starts_blk.shape[0]
    named = [("queries", queries, torch.float32),
             ("cands_planar", cands_planar, torch.float32),
             ("starts_blk", starts_blk, torch.int32),
             ("nblk", nblk, torch.int32)]
    if croot is not None:
        named.append(("croot", croot, torch.int32))
    for name, x, dtype in named:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on "
                             f"{queries.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nc = cands_planar.shape[1] if cands_planar.dim() == 2 else -1
    if queries.shape != (T * block_q, 3):
        raise ValueError(f"queries {tuple(queries.shape)} != "
                         f"({T} * {block_q}, 3)")
    if cands_planar.dim() != 2 or cands_planar.shape[0] != 3 \
            or nc % block_k != 0:
        raise ValueError(f"cands_planar {tuple(cands_planar.shape)} must be "
                         f"(3, nc) with nc a multiple of {block_k}")
    if croot is not None and croot.shape != (nc,):
        raise ValueError(f"croot {tuple(croot.shape)} != ({nc},)")
    if nblk.shape != (T,):
        raise ValueError(f"nblk {tuple(nblk.shape)} != ({T},)")
    if max_blocks * block_k > nc:
        raise ValueError(f"max_blocks * block_k = {max_blocks * block_k} "
                         f"exceeds nc = {nc}")
    if not 1 <= block_q <= 1024:
        raise ValueError(f"block_q = {block_q} outside [1, 1024]")
    if not 1 <= block_k * 16 <= 232_448:
        raise ValueError(f"block_k = {block_k}: stage needs {block_k * 16} "
                         "bytes of shared memory, over the 227 KB limit")


def _sweep_plain(queries, cands_planar, croot, starts_blk, nblk, eps2, *,
                 max_blocks, block_k, with_mind2=False):
    """counts and minroot of the slab sweep; with ``with_mind2`` also the
    min d² over the hits whose payload is not INT32_MAX (+inf when none),
    a min over the very d² values the hit test compared."""
    T = starts_blk.shape[0]
    dev = queries.device
    q = queries.reshape(T, -1, 3)
    eps2_t = eps2_tensor(eps2, dev)
    counts = torch.zeros(q.shape[:2], dtype=torch.int32, device=dev)
    minroot = torch.full(q.shape[:2], INT_MAX, dtype=torch.int32, device=dev)
    mind2 = torch.full(q.shape[:2], float("inf"), dtype=torch.float32,
                       device=dev)
    nb = torch.clamp(nblk, 0, max_blocks)
    n_steps = int(nb.max()) if T else 0   # steps past every tile's nblk hit nothing
    last = cands_planar.shape[1] - 1
    cols = torch.arange(block_k, device=dev)
    for j in range(n_steps):
        live = j < nb                                             # (T,)
        idx = ((starts_blk.to(torch.int64) + j) * block_k)[:, None] + cols
        idx = torch.where(live[:, None], idx, 0).clamp_(0, last)  # dead: any
        c = cands_planar[:, idx].permute(1, 2, 0)                 # (T, bk, 3)
        d2 = _dist2(q[:, :, None, :], c[:, None, :, :])           # (T, bq, bk)
        hit = (d2 <= eps2_t) & live[:, None, None]
        counts += hit.sum(dim=2, dtype=torch.int32)
        if croot is not None:
            r = torch.where(hit, croot[idx][:, None, :], INT_MAX)
            minroot = torch.minimum(minroot, r.amin(dim=2))
        if with_mind2:
            core_hit = hit & (croot[idx] != INT_MAX)[:, None, :]
            mind2 = torch.minimum(
                mind2, torch.where(core_hit, d2, float("inf")).amin(dim=2))
    if with_mind2:
        return counts.reshape(-1), minroot.reshape(-1), mind2.reshape(-1)
    return counts.reshape(-1), minroot.reshape(-1)


def csr_sweep_plain(queries, cands_planar, croot, starts_blk, nblk, eps2, *,
                    max_blocks: int, block_k: int = 512):
    """Plain PyTorch version of :func:`csr_sweep` (any device)."""
    return _sweep_plain(queries, cands_planar, croot, starts_blk, nblk, eps2,
                        max_blocks=max_blocks, block_k=block_k)


def csr_sweep_counts_plain(queries, cands_planar, starts_blk, nblk, eps2, *,
                           max_blocks: int, block_k: int = 512):
    """Plain PyTorch version of :func:`csr_sweep_counts` (any device)."""
    return _sweep_plain(queries, cands_planar, None, starts_blk, nblk, eps2,
                        max_blocks=max_blocks, block_k=block_k)[0]


def run_width(block_k: int) -> int:
    """G: columns per candidate box (it divides block_k)."""
    return math.gcd(block_k, RUN)


def _box(x):
    """(lo, hi) over dim -2 of ``x`` (..., n, 3), NaN dropped as fminf and
    fmaxf drop it: an all-NaN set gives (+inf, -inf)."""
    nan = torch.isnan(x)
    return (torch.where(nan, float("inf"), x).amin(dim=-2),
            torch.where(nan, float("-inf"), x).amax(dim=-2))


def run_boxes_plain(cands_planar, run: int):
    """Boxes (lo, hi), each (nc // run, 3), of the runs of ``run`` columns
    of the planar candidates."""
    return _box(cands_planar.T.reshape(-1, run, 3))


def tile_boxes_plain(queries, n_tiles: int):
    """Boxes (lo, hi), each (n_tiles, 3), of the query tiles."""
    return _box(queries.reshape(n_tiles, -1, 3))


def box_lower_bound(qlo, qhi, clo, chi):
    """The kernel's lb: per axis gap = max(0, qlo - chi, clo - qhi), then
    ((gx*gx) + gy*gy) + gz*gz, each f32 operation rounded on its own (the
    order of ``ref._dist2``); never above the d² of a pair of the boxes."""
    zero = torch.zeros((), dtype=torch.float32, device=qlo.device)
    gap = torch.fmax(torch.fmax(zero, qlo - chi), clo - qhi)
    acc = gap[..., 0] * gap[..., 0]
    acc = acc + gap[..., 1] * gap[..., 1]
    return acc + gap[..., 2] * gap[..., 2]


def kept_runs_plain(queries, cands_planar, starts_blk, nblk, eps2, *,
                    max_blocks: int, block_k: int = 512, run=None):
    """(T, max_blocks · block_k / G) bool: run ``j`` of tile ``t``'s slab
    (clamped as the kernel clamps it) is live and its box comes within ε
    of the tile's box (``lb <= eps2``), so the kernel sweeps it. ``run``
    (a divisor of block_k; default the kernel's G) counts what another G
    would keep."""
    T = starts_blk.shape[0]
    run = run_width(block_k) if run is None else run
    per = block_k // run
    clo, chi = run_boxes_plain(cands_planar, run)
    qlo, qhi = tile_boxes_plain(queries, T)
    sb = starts_blk.clamp(min=0)
    nb = torch.minimum(nblk.clamp(max=max_blocks),
                       cands_planar.shape[1] // block_k - sb).clamp(min=0)
    j = torch.arange(max_blocks * per, device=queries.device)
    live = j < (nb * per)[:, None]
    r = torch.where(live, sb[:, None].long() * per + j, 0)
    lb = box_lower_bound(qlo[:, None], qhi[:, None], clo[r], chi[r])
    return live & (lb <= eps2_tensor(eps2, queries.device))


def _scratch(queries, cands_planar, starts_blk, *, max_blocks, block_k):
    """The kernel's scratch: the run width, the run boxes (8 f32 a run),
    the work list (3 int32 an item, room for every segment of every slab)
    and its two counters."""
    run = run_width(block_k)
    cap = starts_blk.shape[0] * -(-(max_blocks * (block_k // run))
                                  // SEG_RUNS)
    dev = queries.device
    boxes = torch.empty(cands_planar.shape[1] // run * 8,
                        dtype=torch.float32, device=dev)
    items = torch.empty(max(cap, 1) * 3, dtype=torch.int32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    return run, boxes, items, counters


def _cuda_or_raise(x: torch.Tensor, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} takes CPU tensors (plain version) or "
                         f"CUDA tensors, not {x.device}")


def csr_sweep(queries, cands_planar, croot, starts_blk, nblk, eps2, *,
              max_blocks: int, block_q: int = 256, block_k: int = 512):
    """Fused count + min-payload slab sweep.

    queries      (T·block_q, 3) f32 — sorted query tiles
    cands_planar (3, nc) f32        — sorted candidates, nc a multiple of
                                      block_k, padded with +BIG
    croot        (nc,) int32        — root if core else INT32_MAX
    starts_blk   (T,) int32         — slab start per tile, in blocks
    nblk         (T,) int32         — live blocks per tile, ≤ max_blocks
    eps2         float              — ε², rounded once to f32
    Returns counts (T·block_q,) int32, minroot (T·block_q,) int32.
    """
    _check(queries, cands_planar, croot, starts_blk, nblk,
           max_blocks=max_blocks, block_q=block_q, block_k=block_k)
    if queries.device.type == "cpu":
        return csr_sweep_plain(queries, cands_planar, croot, starts_blk, nblk,
                               eps2, max_blocks=max_blocks, block_k=block_k)
    _cuda_or_raise(queries, "csr_sweep")
    # fresh outputs each call: the kernel's cull pass sets them to 0 and
    # INT32_MAX, then its sweep adds and mins into them
    counts = torch.empty(queries.shape[0], dtype=torch.int32,
                         device=queries.device)
    minroot = torch.empty_like(counts)
    if starts_blk.shape[0] == 0:
        return counts, minroot
    run, boxes, items, counters = _scratch(
        queries, cands_planar, starts_blk, max_blocks=max_blocks,
        block_k=block_k)
    build.launch("csr_sweep", "csr_sweep_launch", "pppppfiiiiiippppp",
                 "csr_sweep", queries.device, queries, cands_planar, croot,
                 starts_blk, nblk, _eps2_f32(eps2), starts_blk.shape[0],
                 block_q, cands_planar.shape[1], max_blocks, block_k, run,
                 counts, minroot, boxes, items, counters)
    build.count(LAUNCHES, "csr_sweep")
    return counts, minroot


def csr_sweep_counts(queries, cands_planar, starts_blk, nblk, eps2, *,
                     max_blocks: int, block_q: int = 256, block_k: int = 512):
    """Counts-only slab sweep (stage-1 core identification): the contract of
    :func:`csr_sweep` without ``croot`` and ``minroot``."""
    _check(queries, cands_planar, None, starts_blk, nblk,
           max_blocks=max_blocks, block_q=block_q, block_k=block_k)
    if queries.device.type == "cpu":
        return csr_sweep_counts_plain(queries, cands_planar, starts_blk, nblk,
                                      eps2, max_blocks=max_blocks,
                                      block_k=block_k)
    _cuda_or_raise(queries, "csr_sweep_counts")
    counts = torch.empty(queries.shape[0], dtype=torch.int32,
                         device=queries.device)
    if starts_blk.shape[0] == 0:
        return counts
    run, boxes, items, counters = _scratch(
        queries, cands_planar, starts_blk, max_blocks=max_blocks,
        block_k=block_k)
    build.launch("csr_sweep", "csr_sweep_counts_launch", "ppppfiiiiiipppp",
                 "csr_sweep_counts", queries.device, queries, cands_planar,
                 starts_blk, nblk, _eps2_f32(eps2), starts_blk.shape[0],
                 block_q, cands_planar.shape[1], max_blocks, block_k, run,
                 counts, boxes, items, counters)
    build.count(LAUNCHES, "csr_sweep_counts")
    return counts
