"""Public wrappers for the sweep kernels, the Morton codes, the LBVH
build and the CSR layout's window bounds.

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

from . import bvh_sweep as _bvh
from . import cross_sweep as _cross
from . import csr_layout as _layout
from . import csr_sweep as _csr
from . import frontier_sweep as _frontier
from . import gathered_sweep as _gathered
from . import lbvh as _lbvh
from . import morton as _morton
from . import pairwise_sweep as _pairwise
from .ref import BIG, INT_MAX, pad_to  # noqa: F401  (re-exported)
from .ref import round_up as _round_up


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
                     slab: int, block_q: int = 256, block_k: int = 512,
                     with_work: bool = False):
    """Counts-only CSR slab sweep (stage-1 core identification): no
    ``croot`` input, no ``minroot`` output; counts equal the full sweep's.
    ``with_work``: also the sweep's (items, kept runs), as
    ``csr_sweep.csr_sweep_counts`` gives them."""
    q, starts_blk, nblk, max_blocks = _slab_args(
        queries, starts, nblk, slab=slab, block_q=block_q, block_k=block_k)
    return _csr.csr_sweep_counts(q, cands_planar, starts_blk, nblk, eps2,
                                 max_blocks=max_blocks, block_q=block_q,
                                 block_k=block_k, with_work=with_work)


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


# the kernel inputs of gathered_sweep from gathered windows
gathered_sweep_args = _gathered.window_args


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


def bvh_batch_sweep(queries, dlo, dhi, pt, croot, nmin, leaf, bound, eps2, *,
                    bf16_prune: bool = True, prune_payload: bool = False):
    """Batched wavefront BVH expand step (one breadth-first level of
    (query block, node) entries).

    queries (E, B, D) float, dlo/dhi/pt (E, D) float, croot/nmin/leaf (E,)
    int, bound (E, B) int — the semantics of
    ``kernels.bvh_sweep.bvh_batch_sweep``. The prune boxes arrive
    pre-dilated (and, when ``bf16_prune``, already outward-rounded to bf16
    values, in any float dtype: they widen to f32 exactly; bf16 boxes are
    passed on as bf16). Dead entries are encoded geometrically (box lo
    +BIG / hi −BIG, query −BIG, payload INT32_MAX, leaf 0), so there is no
    validity plane and no padding. Without ``prune_payload``, ``nmin`` and
    ``bound`` may be None.
    Returns hit (E, B) int32, minroot (E, B) int32, push (E,) int32.
    """
    f32 = [x.to(torch.float32).contiguous() for x in (queries, pt)]
    box = [(x if x.dtype == torch.bfloat16 else x.to(torch.float32))
           .contiguous() for x in (dlo, dhi)]
    i32 = [None if x is None else x.to(torch.int32).contiguous()
           for x in (croot, nmin, leaf, bound)]
    return _bvh.bvh_batch_sweep(f32[0], *box, f32[1], *i32, eps2,
                                bf16_prune=bf16_prune,
                                prune_payload=prune_payload)


def morton_encode(coords, *, dims: int = 3):
    """Morton codes from quantized int32 coords (n, 3) -> (n,) int32."""
    return _morton.morton_encode(coords.to(torch.int32).contiguous(),
                                 dims=dims)


def lbvh_keys(points, lo, hi, *, dims: int = 3):
    """Morton codes (n,) int32 of f32 points (n, D) quantized over the
    extent [lo, hi] (D,): the LBVH build's keys, in one kernel."""
    return _lbvh.lbvh_keys(points.to(torch.float32).contiguous(),
                           lo.to(torch.float32).contiguous(),
                           hi.to(torch.float32).contiguous(), dims=dims)


def lbvh_nodes(codes):
    """Karras's internal nodes of the sorted codes (n,): ``lbvh.Nodes``."""
    return _lbvh.lbvh_nodes(codes.to(torch.int32).contiguous())


def lbvh_refit(points, order, nodes):
    """The sorted points, int32 order and node boxes (``lbvh.Refit``) of
    ``points`` under the sort permutation ``order`` and ``nodes``."""
    return _lbvh.lbvh_refit(points.to(torch.float32).contiguous(),
                            order.to(torch.int64).contiguous(), nodes)


def lbvh_depth(left, right):
    """The depth of a Karras tree's deepest leaf, as a (1,) int32 tensor."""
    return _lbvh.lbvh_depth(left.to(torch.int32).contiguous(),
                            right.to(torch.int32).contiguous())


def window_bounds(sorted_codes, cells, *, dims: int, bits: int):
    """Per query cell (m, 3) int32: the [lo, hi) positions (m,) int32 of the
    code-sorted corpus (n,) int32 that cover its 9 (``dims == 2``) or 27
    window cells' occupied runs, (n, 0) where none is occupied."""
    return _layout.window_bounds(sorted_codes.to(torch.int32).contiguous(),
                                 cells.to(torch.int32).contiguous(), dims,
                                 bits)
