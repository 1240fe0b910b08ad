"""Public wrappers for the slab-sweep kernels.

They keep the reference's signatures and conventions (``starts`` in
elements, a static ``slab`` capacity, padding with +BIG coordinates and an
INT32_MAX payload) and reduce them to the kernel contract: ``starts //
block_k``, ``max_blocks = slab // block_k``, f32 coordinates and int32
integers. There is no backend switch: the device of the tensors decides
(CPU → plain version, CUDA → kernel), in ``csr_sweep.py``.
"""
from __future__ import annotations

import torch

from . import csr_sweep as _csr
from .ref import INT_MAX

BIG = 1e30


def fuse_core_root(core, root):
    """Pre-fuse the core mask into the payload plane: root if core else MAX."""
    return torch.where(core, root, INT_MAX).to(torch.int32)


def _slab_args(queries, starts, nblk, *, slab, block_q, block_k):
    if slab % block_k or queries.shape[0] % block_q:
        raise ValueError(f"slab = {slab} must be a multiple of block_k = "
                         f"{block_k}, and the query rows {queries.shape[0]} "
                         f"of block_q = {block_q}")
    starts_blk = torch.div(starts, block_k, rounding_mode="floor") \
        .to(torch.int32)
    return (queries.to(torch.float32), starts_blk, nblk.to(torch.int32),
            slab // block_k)


def csr_sweep(queries, cands_planar, croot, starts, nblk, eps2, *,
              slab: int, block_q: int = 256, block_k: int = 512):
    """Cell-sorted CSR slab ε-sweep (grid engine inner loop).

    queries      (T·block_q, 3) — sorted query tiles
    cands_planar (3, nc)        — cell-sorted candidates, nc a multiple of
                 block_k, padded with +BIG
    croot        (nc,) int32    — root if core else INT32_MAX (sorted order)
    starts       (T,) int32     — per-tile slab start, in *elements*,
                 multiples of block_k, with starts + slab ≤ nc
    nblk         (T,) int32     — per-tile live block count (≤ slab/block_k)
    slab         per-tile slab capacity (elements, a multiple of block_k)

    Returns counts (T·block_q,) int32, minroot (T·block_q,) int32.
    """
    q, starts_blk, nblk, max_blocks = _slab_args(
        queries, starts, nblk, slab=slab, block_q=block_q, block_k=block_k)
    return _csr.csr_sweep(q, cands_planar, croot.to(torch.int32), starts_blk,
                          nblk, eps2, max_blocks=max_blocks, block_q=block_q,
                          block_k=block_k)


def csr_sweep_counts(queries, cands_planar, starts, nblk, eps2, *,
                     slab: int, block_q: int = 256, block_k: int = 512):
    """Counts-only CSR slab sweep (stage-1 core identification): no
    ``croot`` input, no ``minroot`` output; counts equal the full sweep's."""
    q, starts_blk, nblk, max_blocks = _slab_args(
        queries, starts, nblk, slab=slab, block_q=block_q, block_k=block_k)
    return _csr.csr_sweep_counts(q, cands_planar, starts_blk, nblk, eps2,
                                 max_blocks=max_blocks, block_q=block_q,
                                 block_k=block_k)
