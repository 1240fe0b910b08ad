"""Public wrappers for the sweep kernels.

They keep the reference's signatures and conventions (``starts`` in
elements, a static ``slab`` capacity, padding with +BIG coordinates and an
INT32_MAX payload, the core mask fused into the payload) and reduce them to
the kernel contracts: ``starts // block_k``, ``max_blocks = slab //
block_k``, padded shapes, f32 coordinates and int32 integers. There is no
backend switch: the device of the tensors decides (CPU → plain version,
CUDA → kernel), in the kernel modules.
"""
from __future__ import annotations

import torch

from . import cross_sweep as _cross
from . import csr_sweep as _csr
from . import frontier_sweep as _frontier
from . import gathered_sweep as _gathered
from . import pairwise_sweep as _pairwise
from .ref import INT_MAX

BIG = 1e30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to(x, n: int, dim: int, value):
    """``x`` padded with ``value`` along ``dim`` to length ``n``."""
    pad = n - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


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


def frontier_sweep(queries, cands_planar, croot, starts, nblk, active,
                   n_active, eps2, *, slab: int, block_q: int = 256,
                   block_k: int = 512):
    """Frontier-compacted CSR slab ε-sweep (stage-2 rounds).

    ``csr_sweep`` restricted to an active-tile index vector: slot ``i``
    sweeps tile ``active[i]`` when ``i < n_active`` and is parked
    (INT32_MAX rows) otherwise. ``active`` entries at or past ``n_active``
    repeat the last live id (or 0 when none). ``n_active`` may be a device
    tensor: it is never read on the host. Returns the *compacted* minroot
    (T·block_q,) int32; there is no counts output.
    """
    q, starts_blk, nblk, max_blocks = _slab_args(
        queries, starts, nblk, slab=slab, block_q=block_q, block_k=block_k)
    n_active = torch.as_tensor(n_active, dtype=torch.int32,
                               device=q.device).reshape(1)
    return _frontier.frontier_sweep(
        q, cands_planar, croot.to(torch.int32), starts_blk, nblk,
        active.to(torch.int32), n_active, eps2, max_blocks=max_blocks,
        block_q=block_q, block_k=block_k)


def cross_sweep(queries, cands_planar, croot, starts, nblk, eps2, *,
                slab: int, block_q: int = 256, block_k: int = 512):
    """Cross-corpus CSR slab ε-sweep (serving inner loop).

    The asymmetric sibling of :func:`csr_sweep`: fresh query points against
    a frozen corpus in cell-sorted layout. The payload holds cluster
    *labels* of core corpus points, so ``minroot`` is the DBSCAN-predict
    answer; ``mind2`` (min d² over the deciding core hits, +inf if none)
    rides along.

    queries      (T·block_q, 3) — Morton-sorted query tiles; +BIG padding
                 rows never hit
    cands_planar (3, nc)        — cell-sorted frozen corpus, nc a multiple
                 of block_k, padded with +BIG
    croot        (nc,) int32    — cluster label if core else INT32_MAX
    starts       (T,) int32     — per-tile slab start, in *elements*,
                 multiples of block_k, with starts + slab ≤ nc
    nblk         (T,) int32     — per-tile live block count (≤ slab/block_k)
    slab         per-tile slab capacity (elements, a multiple of block_k)

    Returns counts (T·block_q,) int32, minroot (T·block_q,) int32, mind2
    (T·block_q,) f32, bit-identical between the kernel and the plain
    version.
    """
    q, starts_blk, nblk, max_blocks = _slab_args(
        queries, starts, nblk, slab=slab, block_q=block_q, block_k=block_k)
    return _cross.cross_sweep(q, cands_planar,
                              croot.to(torch.int32).reshape(1, -1),
                              starts_blk, nblk, eps2, max_blocks=max_blocks,
                              block_q=block_q, block_k=block_k)


def pairwise_sweep_args(queries, cands, core, root, *, block_q: int = 256,
                        block_c: int = 512):
    """The kernel inputs of :func:`pairwise_sweep`: queries padded to a
    multiple of ``block_q`` and candidates (planar) to one of ``block_c``
    with +BIG coordinates, the fused payload with INT32_MAX."""
    nq_p = _round_up(max(queries.shape[0], 1), block_q)
    nc_p = _round_up(max(cands.shape[0], 1), block_c)
    q = pad_to(queries.to(torch.float32), nq_p, 0, BIG).contiguous()
    c = pad_to(cands.to(torch.float32), nc_p, 0, BIG).T.contiguous()
    croot = pad_to(fuse_core_root(core, root), nc_p, 0, INT_MAX)
    return q, c, croot.contiguous()


def pairwise_sweep(queries, cands, core, root, eps2, *, block_q: int = 256,
                   block_c: int = 512, chunk: int = 2048):
    """Brute ε-sweep. queries (nq, 3), cands (nc, 3), core/root (nc,).

    One kernel launch over the padded rows (:func:`pairwise_sweep_args`);
    ``chunk`` bounds the plain version's memory. Returns counts (nq,)
    int32, minroot (nq,) int32.
    """
    nq = queries.shape[0]
    counts, minroot = _pairwise.pairwise_sweep(
        *pairwise_sweep_args(queries, cands, core, root, block_q=block_q,
                             block_c=block_c),
        eps2, block_q=block_q, block_c=block_c, chunk=chunk)
    return counts[:nq], minroot[:nq]


def gathered_sweep_args(queries, cands, cand_valid, cand_core, cand_root,
                        *, block_b: int = 128, block_k: int = 512):
    """The kernel inputs of :func:`gathered_sweep`: invalid candidates
    become +BIG coordinates, ``valid & core`` is fused into the payload,
    rows pad to a multiple of ``block_b`` and windows to one of
    ``block_k``, and the window goes planar (3, b, k)."""
    b, k = cands.shape[0], cands.shape[1]
    b_p = _round_up(max(b, 1), block_b)
    k_p = _round_up(max(k, 1), block_k)
    cands = torch.where(cand_valid[..., None], cands.to(torch.float32), BIG)
    q = pad_to(queries.to(torch.float32), b_p, 0, BIG).contiguous()
    c = pad_to(pad_to(cands, k_p, 1, BIG), b_p, 0, BIG)
    croot = torch.where(cand_valid & cand_core, cand_root, INT_MAX) \
        .to(torch.int32)
    croot = pad_to(pad_to(croot, k_p, 1, INT_MAX), b_p, 0, INT_MAX)
    return q, c.permute(2, 0, 1).contiguous(), croot.contiguous()


def gathered_sweep(queries, cands, cand_valid, cand_core, cand_root, eps2, *,
                   block_b: int = 128, block_k: int = 512):
    """Pre-gathered window ε-sweep. queries (b, 3), cands (b, k, 3),
    masks and roots (b, k), padded and fused by
    :func:`gathered_sweep_args`. Returns counts (b,) int32, minroot (b,)
    int32.
    """
    b = cands.shape[0]
    counts, minroot = _gathered.gathered_sweep(
        *gathered_sweep_args(queries, cands, cand_valid, cand_core,
                             cand_root, block_b=block_b, block_k=block_k),
        eps2)
    return counts[:b], minroot[:b]
