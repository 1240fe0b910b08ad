"""Cell-sorted CSR slab ε-sweep: the grid engine's inner loop.

Query tile ``t`` (rows ``[t·block_q, (t+1)·block_q)`` of the sorted query
array) sweeps the ``nblk[t]`` candidate blocks of ``block_k`` columns that
start at block ``starts_blk[t]`` of the planar ``(3, nc)`` sorted candidate
array. ``csr_sweep`` returns per-query counts of candidates with d² ≤ ε² and
the min of the fused payload ``croot`` over those hits (INT32_MAX when none);
``csr_sweep_counts`` returns the counts alone (stage 1 discards the payload).

Each function has three parts:
  * the CUDA kernel, ``csrc/csr_sweep.cu`` (one thread block per query tile);
  * its wrapper, which checks the inputs, allocates the outputs, launches on
    the current stream, raises on a launch error and counts the launch in
    ``LAUNCHES``;
  * the plain PyTorch version (``*_plain``), vectorised over tiles and
    looping over the block index ``j`` with a ``j < nblk[t]`` mask.

Dispatch is by the tensors' device alone: CPU tensors go to the plain
version; CUDA tensors launch the kernel or raise. Integer outputs of the two
are bit-identical (the d² arithmetic is ``ref._dist2``'s).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .ref import INT_MAX, _dist2, eps2_tensor

# Launches of each kernel since the last reset_launches(); the plain
# versions never count.
LAUNCHES = {"csr_sweep": 0, "csr_sweep_counts": 0}


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
                 max_blocks, block_k):
    T = starts_blk.shape[0]
    dev = queries.device
    q = queries.reshape(T, -1, 3)
    eps2_t = eps2_tensor(eps2, dev)
    counts = torch.zeros(q.shape[:2], dtype=torch.int32, device=dev)
    minroot = torch.full(q.shape[:2], INT_MAX, dtype=torch.int32, device=dev)
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
    counts = torch.empty(queries.shape[0], dtype=torch.int32,
                         device=queries.device)
    minroot = torch.empty_like(counts)
    if starts_blk.shape[0] == 0:
        return counts, minroot
    build.launch("csr_sweep", "csr_sweep_launch", "pppppfiiiiipp",
                 "csr_sweep", queries.device, queries, cands_planar, croot,
                 starts_blk, nblk, _eps2_f32(eps2), starts_blk.shape[0],
                 block_q, cands_planar.shape[1], max_blocks, block_k, counts,
                 minroot)
    LAUNCHES["csr_sweep"] += 1
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
    build.launch("csr_sweep", "csr_sweep_counts_launch", "ppppfiiiiip",
                 "csr_sweep_counts", queries.device, queries, cands_planar,
                 starts_blk, nblk, _eps2_f32(eps2), starts_blk.shape[0],
                 block_q, cands_planar.shape[1], max_blocks, block_k, counts)
    LAUNCHES["csr_sweep_counts"] += 1
    return counts
