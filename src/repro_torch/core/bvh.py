"""LBVH — the bounding volume hierarchy of the RT-DBSCAN engines, in PyTorch.

The structural emulation of what the RT cores do in hardware: Morton codes
→ radix-sorted leaves → Karras (2012) binary radix tree → an AABB per
internal node → traversal with the paper's two-level test (ε-dilated AABB
prune, exact sphere refine — Algorithm 2 line 6).

Two traversal engines share the structure:

  * ``bvh`` — **wavefront** traversal: a level-synchronous frontier of
    (query block, node) entries, each carrying ``batch`` consecutive
    Morton-sorted queries, expanded and compacted level by level (on the
    card one launch of the fused ``bvh_level`` kernel a level).
    Payload-bounded early termination (``terminate=True``) skips any
    subtree whose min core-root payload cannot lower a block's running
    bounds, and the prune can run against outward-rounded bf16 boxes
    (``prune_dtype="bf16"``) with the exact f32 sphere refine untouched.
    It exposes ``sweep_sorted`` over the Morton-sorted leaves, which opts
    it into ``dbscan``'s sorted hooking loop, ``sweep_counts`` (exact
    stage-1 counting) and a ``sweep_frontier`` plan for the frontier round
    driver.
  * ``bvh-stack`` — per-query stack traversal in lockstep: every query
    steps until the slowest is done. The FDBSCAN baseline. It runs no
    kernel apart from those of its build (``lbvh_*``).

The one place where the port departs from the reference's loop structure
is ``wavefront_sweep``. The reference expands each level in fixed tiles of
``tile`` entries inside a device loop, and each tile reads the payload
bound as the tiles before it left it. The port expands a level's whole
live frontier at once: on the card in one launch of the fused
``bvh_level`` kernel, which reads the frontier and its live count on the
device and compacts its pushes there; on the CPU by the plain level loop,
in ``ops.bvh_batch_sweep`` calls of at most ``_LEVEL_ENTRIES`` entries
with one host read of the push count per call. Children are laid out in
the reference's order (per tile, its left children, then its right
children), so the compacted frontier and the overflow drop are the
reference's. An exact sweep (``bound=None``) does not depend on the
order: its counts, minroot, overflow flag and level histogram equal the
reference's. In a terminated sweep every push of a level is decided
against the bounds as they stood when the level started (both loops): a
bound read before the level's updates is only higher, so the pushed set
lies between the reference's and the exact traversal's: minroot is still
exactly ``min(exact, bound)`` and the calibrated capacity still fits, but
the partial counts and the histogram may differ from the reference's
(both are prune-order dependent there too, and ``dbscan`` reads neither:
stage 1 goes through the exact ``sweep_counts``).

Implementation notes (as in the reference):
  * duplicate Morton keys are disambiguated with the sorted index (Karras's
    key augmentation), so the common-prefix length δ grows strictly along
    any root → leaf path and tree depth never exceeds 64;
    ``max_leaf_depth`` computes the exact bound and the stack engine
    raises at build time if its stack could overflow;
  * internal-node AABBs are fitted bottom up on the card (the refit's
    plain version is the reference's range min/max table over the sorted
    points: every Karras node covers a contiguous leaf range).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import bvh_sweep as _bvhk
from ..kernels import lbvh as _lbvh
from ..kernels import ops
from ..kernels.ref import INT_MAX, _dist2, eps2_tensor
from . import engines
from . import grid as grid_mod

INT_MIN = -2**31
STACK = 96          # default stack capacity; the provable need is ≤ 65
MAX_LEVELS = 72     # BFS level bound: Karras depth ≤ 64, plus margin
_WAVE_TILE = 8192   # default frontier tile (the reference's expansion step)
# Frontier entries expanded per kernel call of the plain level loop, a
# multiple of the tile: caps the gathered tensors of one call (about
# 0.5-1 GB at batch 8).
_LEVEL_ENTRIES = 1 << 21
# Levels the fused loop launches past the last live count the host has
# read (a count of 0 ends the traversal; the levels after it are no-ops).
_LEVELS_AHEAD = 2
# Lockstep steps of the stack traversal between host checks for finished
# queries (which also drops them from the working set).
_STACK_CHECK = 16


class BVH(NamedTuple):
    pts_sorted: torch.Tensor  # (n, D) f32 leaf points in Morton order
    order: torch.Tensor       # (n,) int32 original index per leaf
    left: torch.Tensor        # (n-1,) int32 child node id (see encoding)
    right: torch.Tensor       # (n-1,) int32
    box_lo: torch.Tensor      # (n-1, D) f32 internal-node AABBs
    box_hi: torch.Tensor      # (n-1, D) f32
    first: torch.Tensor       # (n-1,) int32 leaf range covered by node …
    last: torch.Tensor        # (n-1,) int32 … [first, last], sorted ids


class BVHState(NamedTuple):
    bvh: BVH
    points: torch.Tensor      # (n, D) original order (queries)


# Node id encoding: internal nodes are 0..n-2; leaf i is (n-1) + i.


def build_bvh(points: torch.Tensor, *, dims: int = 3, lo=None,
              hi=None) -> BVH:
    """points (n, D) f32, n ≥ 2. ``lo``/``hi`` override the quantization
    extent (the distributed driver passes the real point extent so that
    its +BIG padding sentinels sort to the top Morton cell).

    For D > 3 the Morton order uses the first three coordinates only: the
    sort is a locality heuristic, and the boxes, payload ranges and sphere
    refine use all D coordinates.

    The reference's build, as kernels (``kernels/lbvh.py``; on the CPU
    their plain versions): the extent, the Morton keys, a stable sort of
    the keys, Karras's nodes, then the boxes bottom up."""
    dev = points.device
    f32 = torch.float32
    if lo is None or hi is None:
        amin, amax = torch.aminmax(points, dim=0)
    lo = amin if lo is None else torch.as_tensor(lo, dtype=f32, device=dev)
    hi = amax if hi is None else torch.as_tensor(hi, dtype=f32, device=dev)
    codes = ops.lbvh_keys(points, lo, hi, dims=min(dims, 3))
    # stable: equal codes keep their input order, as the reference's
    # argsort, and the sorted index then breaks the tie (Karras)
    codes, order = torch.sort(codes, stable=True)
    nodes = ops.lbvh_nodes(codes)
    fit = ops.lbvh_refit(points, order, nodes)
    return BVH(pts_sorted=fit.pts_sorted, order=fit.order, left=nodes.left,
               right=nodes.right, box_lo=fit.box_lo, box_hi=fit.box_hi,
               first=nodes.first, last=nodes.last)


def max_leaf_depth(left: torch.Tensor, right: torch.Tensor) -> int:
    """Exact tree depth (root = 0, result = deepest leaf's depth), by
    ``ops.lbvh_depth`` (one host read).

    δ-monotonicity bounds Karras depth by 64. The DFS stack the
    ``bvh-stack`` engine needs is at most ``max_leaf_depth + 1`` slots (one
    pending sibling per ancestor, plus the two children just pushed).
    """
    return int(ops.lbvh_depth(left, right)[0])


def bvh_from_arrays(d: dict, device) -> BVH:
    """A :class:`BVH` on ``device`` from numpy arrays of its fields (for
    example those of the reference's ``BVH``)."""
    floats = ("pts_sorted", "box_lo", "box_hi")
    return BVH(**{
        name: torch.as_tensor(np.array(d[name]),  # an owned, writable copy
                              dtype=torch.float32 if name in floats
                              else torch.int32, device=device)
        for name in BVH._fields})


# ---------------------------------------------------------------------------
# Wavefront traversal (engine="bvh")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WavefrontSpec:
    """Static plan for the wavefront engine (the reference's fields and
    defaults).

    ``capacity`` is the frontier entry count per level, calibrated at build
    time from the measured per-level peak of a payload-free probe traversal
    (kept in ``peak``): the exact traversal's frontier is a superset of
    every terminated sweep's over the same tree, so ``capacity =
    round_up(peak, tile)`` fits them all. Pushes beyond it are dropped and
    flag an overflow. ``tile`` orders each level's children (and, in the
    reference, is its expansion step). ``terminate`` opts the stage-2
    sweeps into payload-bounded early termination; ``prune_dtype`` ("bf16"
    | "f32") selects the AABB prune precision.
    """
    eps: float
    n: int                # leaf count (= query count for sweep_sorted)
    capacity: int         # frontier entry slots, multiple of tile
    tile: int             # frontier entries per tile
    max_levels: int       # BFS level bound (Karras depth ≤ 64)
    batch: int = 8        # queries per (query-block, node) entry
    terminate: bool = True       # payload-bounded early termination
    prune_dtype: str = "bf16"    # AABB prune precision ("bf16" | "f32")
    peak: int = 0         # measured per-level peak entries (telemetry)


def _bf16_directed(x: torch.Tensor, *, up: bool) -> torch.Tensor:
    """Round f32 ``x`` to bf16 toward +∞ (``up``) or −∞, exact when already
    representable: round to nearest, then step the bit pattern one ulp
    outward where that went the wrong way. Outward-rounded dilated boxes
    make the bf16 prune conservative: the kernel compares a round-to-nearest
    bf16 query against them, rounding is monotone and the box ends are
    bf16 values. Finite inputs only. torch has little uint16 arithmetic, so
    the 16 bits are stepped as int32."""
    b = x.to(torch.bfloat16)
    back = b.to(torch.float32)
    bits = b.view(torch.int16).to(torch.int32) & 0xFFFF
    mag_zero = (bits & 0x7FFF) == 0
    neg = (bits & 0x8000) != 0
    if up:
        need = back < x
        stepped = torch.where(mag_zero, 0x0001,
                              torch.where(neg, bits - 1, bits + 1))
    else:
        need = back > x
        stepped = torch.where(mag_zero, 0x8001,
                              torch.where(neg, bits + 1, bits - 1))
    stepped = torch.where(stepped >= 0x8000, stepped - 0x10000, stepped)
    return torch.where(need, stepped.to(torch.int16).view(torch.bfloat16), b)


def _node_boxes(bvh: BVH, eps):
    """ε-dilated f32 boxes over the combined node id space (2n−1, D):
    internal nodes 0..n−2 from the fitted AABBs, leaf (n−1)+i from its
    point."""
    eps_f = eps2_tensor(eps, bvh.pts_sorted.device)   # ε rounded to f32
    lo = torch.cat([bvh.box_lo, bvh.pts_sorted]) - eps_f
    hi = torch.cat([bvh.box_hi, bvh.pts_sorted]) + eps_f
    return lo, hi


def _node_prune_boxes(bvh: BVH, eps, prune_dtype: str):
    """The wavefront prune boxes: :func:`_node_boxes`, outward-rounded to
    bf16 and stored bf16 with ``prune_dtype="bf16"`` (half the per-level
    gather bytes; they widen back to f32 exactly)."""
    lo, hi = _node_boxes(bvh, eps)
    if prune_dtype == "bf16":
        return _bf16_directed(lo, up=False), _bf16_directed(hi, up=True)
    return lo, hi


def _node_payload_min(bvh: BVH, croot_sorted: torch.Tensor) -> torch.Tensor:
    """Min core-root payload per combined node (2n−1,): the early-
    termination bound. Internal nodes take the min over their contiguous
    leaf range; recomputed per sweep (the payload changes every round)."""
    internal = _lbvh.range_table_query(croot_sorted, bvh.first, bvh.last,
                                       torch.minimum)
    return torch.cat([internal, croot_sorted])


def _sweep_setup(bvh: BVH, queries, croot_leaf, *, eps, capacity, tile,
                 batch, prune_dtype, bound):
    """What both level loops read: the level inputs, the counts and
    min-root rows (``bound`` in payload mode, else INT32_MAX), the block
    count nb, the tile and the capacity C (a multiple of the tile)."""
    pts = bvh.pts_sorted
    dev = pts.device
    d = pts.shape[1]
    nb = -(-queries.shape[0] // batch)
    tile = min(tile, capacity)
    # Queries grouped into nb blocks of `batch`, plus a spare block nb
    # where dead lanes point: pad queries sit at −BIG (outside every
    # dilated box, ∞ distance), so they never hit or push; the boxes go to
    # the kernel as stored (bf16 with the bf16 prune) and widen there.
    qblocks = ops.pad_to(queries.to(torch.float32), (nb + 1) * batch, 0,
                         -grid_mod.BIG).reshape(nb + 1, batch, d)
    node_lo, node_hi = _node_prune_boxes(bvh, eps, prune_dtype)
    croot_leaf = croot_leaf.to(torch.int32)
    if bound is not None:
        node_min = _node_payload_min(bvh, croot_leaf)
        minroot = ops.pad_to(bound.to(torch.int32), (nb + 1) * batch, 0,
                             INT_MIN)
    else:
        node_min = None
        minroot = torch.full(((nb + 1) * batch,), INT_MAX, dtype=torch.int32,
                             device=dev)
    inputs = _bvhk.LevelInputs(
        left=bvh.left, right=bvh.right, node_lo=node_lo.contiguous(),
        node_hi=node_hi.contiguous(), pts=pts.to(torch.float32).contiguous(),
        croot_leaf=croot_leaf.contiguous(), node_min=node_min,
        qblocks=qblocks.contiguous())
    counts = torch.zeros((nb + 1, batch), dtype=torch.int32, device=dev)
    return (inputs, counts, minroot.reshape(nb + 1, batch), nb, tile,
            (capacity // tile) * tile)


def _plain_level(inputs, counts, minroot, fb, fn, eps2, *, nb, tile, C,
                 bf16_prune, prune_payload):
    """One level of the plain loop: every live entry (fb, fn) emits its two
    children through ``ops.bvh_batch_sweep``, ``_LEVEL_ENTRIES`` entries a
    call, leaf hits are scattered by block row, and the children that push
    are compacted in order. Pushes are decided against the bounds as they
    stood when the level started. Returns the next frontier, truncated to
    C entries, and whether it was truncated."""
    n = inputs.pts.shape[0]
    n_int = n - 1
    batch = counts.shape[1]
    step = max(tile, (_LEVEL_ENTRIES // tile) * tile)
    left, right = inputs.left.long(), inputs.right.long()
    bound = minroot.clone() if prune_payload else None
    next_b, next_n = [], []
    for s in range(0, fb.shape[0], step):
        sb, sn = fb[s:s + step], fn[s:s + step]
        nt = -(-sb.shape[0] // tile)
        # padding entries point at the spare block, whose queries at
        # −BIG lie outside every (finite) node box and hit no leaf
        sb = ops.pad_to(sb, nt * tile, 0, nb)
        sn = ops.pad_to(sn, nt * tile, 0, 0)
        # children in the reference's order: per tile of entries, their
        # left children, then their right children
        cb = sb.view(nt, 1, tile).expand(nt, 2, tile).reshape(-1)
        cn = torch.stack([left[sn].view(nt, tile),
                          right[sn].view(nt, tile)], dim=1).reshape(-1)
        is_leaf = cn >= n_int
        leaf_id = (cn - n_int).clamp(0, n - 1)
        nm, bnd = (inputs.node_min[cn], bound[cb]) if prune_payload \
            else (None, None)
        hit, mr, push = ops.bvh_batch_sweep(
            inputs.qblocks[cb], inputs.node_lo[cn], inputs.node_hi[cn],
            inputs.pts[leaf_id], inputs.croot_leaf[leaf_id], nm, is_leaf,
            bnd, eps2, bf16_prune=bf16_prune, prune_payload=prune_payload)
        counts.index_add_(0, cb, hit)
        minroot.scatter_reduce_(0, cb[:, None].expand(-1, batch), mr, "amin")
        keep = push.nonzero().squeeze(1)     # in order; one host sync
        next_b.append(cb[keep])
        next_n.append(cn[keep])
    fb, fn = torch.cat(next_b), torch.cat(next_n)
    return fb[:C], fn[:C], fb.shape[0] > C


def wavefront_sweep_plain(bvh: BVH, queries: torch.Tensor,
                          croot_leaf: torch.Tensor, *, eps: float,
                          eps2: float, capacity: int, tile: int = 8192,
                          batch: int = 8, prune_dtype: str = "bf16",
                          bound=None, max_levels: int = MAX_LEVELS,
                          stop_on_overflow: bool = False):
    """:func:`wavefront_sweep` by the plain level loop (:func:`_plain_level`,
    through ``ops.bvh_batch_sweep`` with the gathers and scatters around
    it and one host read of each level's push count): the CPU path, and
    on the card the per-entry kernel's path that the fused level is held
    to."""
    inputs, counts, minroot, nb, tile, C = _sweep_setup(
        bvh, queries, croot_leaf, eps=eps, capacity=capacity, tile=tile,
        batch=batch, prune_dtype=prune_dtype, bound=bound)
    nq = queries.shape[0]
    dev = counts.device
    nb_live = min(nb, C)
    fb = torch.arange(nb_live, dtype=torch.int64, device=dev)
    fn = torch.zeros(nb_live, dtype=torch.int64, device=dev)   # the root
    ovf = nb > C
    hist = []
    while fb.shape[0] and len(hist) < max_levels \
            and not (stop_on_overflow and ovf):
        hist.append(fb.shape[0])
        fb, fn, over = _plain_level(
            inputs, counts, minroot, fb, fn, eps2, nb=nb, tile=tile, C=C,
            bf16_prune=prune_dtype == "bf16", prune_payload=bound is not None)
        ovf = ovf or over
    hist_t = torch.full((max_levels,), -1, dtype=torch.int32, device=dev)
    hist_t[:len(hist)] = torch.tensor(hist, dtype=torch.int32, device=dev)
    return (counts[:nb].reshape(-1)[:nq], minroot[:nb].reshape(-1)[:nq],
            ovf, hist_t)


class _LevelCounts:
    """What the host knows of the live counts ``nlive`` that the level
    kernels write on the device: after each launch, an asynchronous copy
    of the count it wrote into pinned memory, read once it has landed.
    The host runs at most ``_LEVELS_AHEAD`` levels past the last count it
    has read, so it waits only for the count of a level launched earlier,
    never for the one it has just launched. ``waits`` counts those waits.
    On the CPU the counts are read as they are written."""

    def __init__(self, nlive: torch.Tensor):
        self.nlive, self.cuda = nlive, nlive.device.type == "cuda"
        self.host = torch.empty(nlive.shape, dtype=nlive.dtype,
                                pin_memory=self.cuda) if self.cuda else nlive
        self.pending = collections.deque()
        self.waits = 0

    def launched(self, level: int) -> None:
        k, ev = level + 1, None
        if self.cuda:
            self.host[k:k + 1].copy_(self.nlive[k:k + 1], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        self.pending.append((k, ev))

    def ended(self) -> bool:
        """True once a count read is 0: every later level is a no-op."""
        while self.pending:
            k, ev = self.pending[0]
            if ev is not None and not ev.query():
                if len(self.pending) < _LEVELS_AHEAD:
                    return False
                ev.synchronize()
                self.waits += 1
            self.pending.popleft()
            if int(self.host[k]) == 0:
                return True
        return False


def wavefront_sweep_fused(bvh: BVH, queries: torch.Tensor,
                          croot_leaf: torch.Tensor, *, eps: float,
                          eps2: float, capacity: int, tile: int = 8192,
                          batch: int = 8, prune_dtype: str = "bf16",
                          bound=None, max_levels: int = MAX_LEVELS,
                          stop_on_overflow: bool = False):
    """:func:`wavefront_sweep` by the fused level (``bvh_sweep.bvh_level``,
    one launch a level on the card): the frontier, its live count and the
    overflow flag stay on the device, and the one blocking read is the
    overflow flag at the end. On the CPU it runs the fused level's plain
    version."""
    inputs, counts, minroot, nb, tile, C = _sweep_setup(
        bvh, queries, croot_leaf, eps=eps, capacity=capacity, tile=tile,
        batch=batch, prune_dtype=prune_dtype, bound=bound)
    nq = queries.shape[0]
    payload = bound is not None
    state = _bvhk.new_level_state(counts, minroot, capacity=C,
                                  levels=max_levels, prune_payload=payload)
    _bvhk.check_level_arrays(inputs, state, prune_payload=payload)
    nb_live = min(nb, C)
    state.fb[0, :nb_live] = torch.arange(nb_live, dtype=torch.int32,
                                         device=counts.device)
    state.fn[0, :nb_live] = 0                                  # the root
    if nb > C:
        state.overflow.fill_(1)
    if not (stop_on_overflow and nb > C):
        state.nlive[:1].fill_(nb_live)     # a fill: no host copy to wait for
        counts_read = _LevelCounts(state.nlive)
        for level in range(max_levels):
            if counts_read.ended():
                break
            if payload:
                state.bound.copy_(minroot)
            _bvhk.bvh_level(inputs, state, level, eps2, tile=tile,
                            bf16_prune=prune_dtype == "bf16",
                            prune_payload=payload,
                            stop_on_overflow=stop_on_overflow)
            counts_read.launched(level)
    return (counts[:nb].reshape(-1)[:nq], minroot[:nb].reshape(-1)[:nq],
            bool(state.overflow[0]), state.hist)


def wavefront_sweep(bvh: BVH, queries: torch.Tensor,
                    croot_leaf: torch.Tensor, *, eps: float, eps2: float,
                    capacity: int, tile: int = 8192, batch: int = 8,
                    prune_dtype: str = "bf16", bound=None,
                    max_levels: int = MAX_LEVELS,
                    stop_on_overflow: bool = False):
    """Level-synchronous batched BVH traversal for all ``queries`` at once.

    A work queue of (query block, node) entries, each carrying ``batch``
    consecutive queries, is expanded level by level: every live entry
    emits its two children, leaf hits are accumulated by block row, and
    children with at least one useful column are compacted, in order,
    into the next frontier (at most ``capacity`` of them). On the card
    each level is one launch of the fused ``bvh_level`` kernel
    (:func:`wavefront_sweep_fused`); on the CPU the plain level loop runs
    (:func:`wavefront_sweep_plain`). The two give the same outputs. See
    the module docstring for how the level loop differs from the
    reference's.

    queries    (nq, D) f32 — consecutive queries share a frontier entry,
               so pass them in a locality-preserving order (the
               Morton-sorted leaves are the ideal blocking)
    croot_leaf (n,) int32  — per *leaf* payload: root if core else INT32_MAX
    bound      optional (nq,) int32 — payload-bounded early termination:
               each query's min-root accumulator starts at ``bound`` and a
               subtree is skipped for a column once its payload min cannot
               lower that accumulator, so the returned minroot is exactly
               ``min(exact minroot, bound)``; counts become partial. With
               ``bound=None`` counts and minroot are exact.

    Returns (counts (nq,) int32, minroot (nq,) int32, overflow (bool), hist
    (max_levels,) int32): ``hist[l]`` is the live entry count entering
    level ``l`` (−1 past the last level). ``overflow`` is True iff some
    level produced more than ``capacity`` pushes (those beyond are dropped,
    so results are then untrustworthy); ``stop_on_overflow`` ends the
    traversal at the first overflowing level (cheap calibration probes).
    """
    sweep = wavefront_sweep_plain if bvh.pts_sorted.device.type == "cpu" \
        else wavefront_sweep_fused
    return sweep(bvh, queries, croot_leaf, eps=eps, eps2=eps2,
                 capacity=capacity, tile=tile, batch=batch,
                 prune_dtype=prune_dtype, bound=bound, max_levels=max_levels,
                 stop_on_overflow=stop_on_overflow)


@functools.lru_cache(maxsize=64)
def _wave_fns(spec: WavefrontSpec):
    """(sweep, sweep_sorted, sweep_counts, probe, frontier) for one
    wavefront plan. The queries of the sorted-layout entry points are the
    Morton-sorted leaves themselves, so the engine's own order is both the
    sorted layout and the batching layout.

    Exactness contract (the reference's): ``sweep`` and ``sweep_counts``
    run non-terminated — counts and minroot exact. ``sweep_sorted``
    terminates (when the spec says so) with ``bound = croot_sorted``: its
    minroot is exactly ``min(exact, croot)``, which equals the exact value
    on every row the hooking rounds read (core rows: the self-hit already
    puts croot in the exact min) and on every row the border sweep reads
    (non-core rows: croot = INT32_MAX) — but its counts are partial, so
    stage 1 goes through ``sweep_counts`` (``dbscan`` prefers it)."""
    n = spec.n
    kw = dict(eps=spec.eps, eps2=spec.eps * spec.eps, capacity=spec.capacity,
              tile=spec.tile, batch=spec.batch, prune_dtype=spec.prune_dtype,
              max_levels=spec.max_levels)

    def _payload_free(state):
        return torch.full((n,), INT_MAX, dtype=torch.int32,
                          device=state.points.device)

    def sweep_sorted(state: BVHState, croot_sorted):
        bound = croot_sorted if spec.terminate else None
        counts, minroot, _, _ = wavefront_sweep(
            state.bvh, state.bvh.pts_sorted, croot_sorted, bound=bound, **kw)
        return counts, minroot

    def sweep_counts(state: BVHState, work=None):
        # the traversal keeps no candidate runs: ``work`` stays empty
        counts, _, _, _ = wavefront_sweep(
            state.bvh, state.bvh.pts_sorted, _payload_free(state), **kw)
        return counts

    def sweep(state: BVHState, core, root):
        order = state.bvh.order.long()
        croot_s = ops.fuse_core_root(core[order], root[order])
        counts_s, minroot_s, _, _ = wavefront_sweep(
            state.bvh, state.bvh.pts_sorted, croot_s, **kw)
        counts = torch.zeros_like(counts_s)
        minroot = torch.full_like(minroot_s, INT_MAX)
        counts[order] = counts_s
        minroot[order] = minroot_s
        return counts, minroot

    def probe(state: BVHState):
        _, _, ovf, hist = wavefront_sweep(
            state.bvh, state.bvh.pts_sorted, _payload_free(state),
            stop_on_overflow=True, **kw)
        return ovf, hist

    def fsweep(state: BVHState, croot_s, qroot_s, changed_s, pending):
        # Early termination is the frontier compaction here: a block whose
        # every query is non-core (bound = INT32_MIN) or already at the
        # tree-wide payload min dies at the root, so level 0 touches nb
        # entries and deeper levels only the live merge seam. ``pending``
        # passes through: the payload bound subsumes the changed-tile
        # bookkeeping the grid engine needs.
        bound = torch.where(qroot_s >= 0, croot_s, INT_MIN)
        _, m, _, _ = wavefront_sweep(
            state.bvh, state.bvh.pts_sorted, croot_s, bound=bound, **kw)
        m = torch.where(qroot_s >= 0, m, INT_MAX)
        nb = -(-n // spec.batch)
        live_col = (qroot_s >= 0) & (croot_s > croot_s.min())
        n_live = ops.pad_to(live_col, nb * spec.batch, 0, False) \
            .view(nb, spec.batch).any(dim=1).sum(dtype=torch.int32)
        return m, pending, n_live

    def fborder(state: BVHState, croot_s, core_s):
        # border attachment: only non-core rows read minroot, so core
        # columns park at bound = INT32_MIN and coreless subtrees (payload
        # min INT32_MAX) are never entered
        bound = torch.where(core_s, INT_MIN, INT_MAX).to(torch.int32)
        _, m, _, _ = wavefront_sweep(
            state.bvh, state.bvh.pts_sorted, croot_s, bound=bound, **kw)
        return torch.where(core_s, INT_MAX, m)

    frontier = engines.FrontierPlan(n_tiles=-(-n // spec.batch),
                                    sweep=fsweep, border=fborder)
    return sweep, sweep_sorted, sweep_counts, probe, frontier


def wavefront_levels(eng: engines.Engine) -> np.ndarray:
    """Per-level live frontier entry counts of ``eng``'s exact traversal,
    as a 1-D numpy array with one entry per executed level."""
    spec = eng.meta
    if not isinstance(spec, WavefrontSpec):
        raise ValueError("wavefront_levels needs an engine='bvh' Engine")
    _, hist = _wave_fns(spec)[3](eng.state)
    h = hist.cpu().numpy()
    return h[h >= 0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Calibrated WavefrontSpecs by (n, eps, dims, batch, prune_dtype) -> (data
# fingerprint, spec), as in the reference: a later build over the same data
# reuses the spec with no probe, and a same-shape build over other data
# starts its probes at the cached capacity. ``terminate`` is not in the
# key: it never changes the traversal's geometry.
_SPEC_CACHE: dict = {}
_PROBE_GROWTH = 4   # each probe that overflows grows the capacity 4x


def _data_fingerprint(points) -> tuple:
    """Exact identity of a point set (a content hash of its f32 bytes, so
    the reference's key): sweeps discard the overflow flag, so reusing a
    capacity on a collision would silently drop neighbors."""
    if isinstance(points, torch.Tensor):
        points = points.cpu().numpy()
    p = np.ascontiguousarray(np.asarray(points))
    return (p.shape, str(p.dtype), hashlib.sha1(p.tobytes()).hexdigest())


def _infer_dims(points: torch.Tensor) -> int:
    """``neighbors.infer_dims`` on the points' device, with one scalar
    read: the column count, except 2 for (n, 3) points whose z is all zero
    (−0.0 included; NaN is not zero)."""
    d = points.shape[1]
    if d != 3:
        return d
    return 2 if bool((points[:, 2] == 0).all()) else 3


def _tree(points: torch.Tensor, dims):
    """(LBVH, dims) of ``points`` on their device; n ≥ 2."""
    n = points.shape[0]
    if n < 2:
        raise ValueError("BVH engines need n >= 2 points")
    if dims is None:
        dims = _infer_dims(points)
    return build_bvh(points, dims=dims), dims


def make_bvh_engine(points: torch.Tensor, eps: float, *,
                    dims: int | None = None,
                    spec: WavefrontSpec | None = None, batch: int = 8,
                    terminate: bool = True,
                    prune_dtype: str = "bf16") -> engines.Engine:
    """Build the wavefront BVH engine (engine="bvh") over ``points`` (a
    tensor on the engine's device).

    Build = LBVH construction + frontier-capacity calibration: the capacity
    grows by ``_PROBE_GROWTH`` until one payload-free probe traversal fits,
    then is set from the probe's measured per-level peak. Calibrated specs
    are cached per (n, ε, dims, batch, prune_dtype) and data fingerprint.
    Pass a previous ``Engine.meta`` as ``spec`` to skip calibration (one
    certifying probe); the spec's own knobs then win over ``batch=`` /
    ``terminate=`` / ``prune_dtype=``. ``Engine.timings`` holds ``tree_s``
    (Morton codes, sort and tree) and ``calibrate_s`` (the probes).
    """
    n = points.shape[0]
    if prune_dtype not in ("bf16", "f32"):
        raise ValueError(f"unknown prune_dtype {prune_dtype!r}; "
                         "expected 'bf16' or 'f32'")
    t0 = time.perf_counter()
    bvh, dims = _tree(points, dims)
    engines.synchronize(points.device)
    t1 = time.perf_counter()
    state = BVHState(bvh=bvh, points=points)
    if spec is not None:
        if spec.n != n or spec.eps != float(eps):
            raise ValueError(
                f"reused WavefrontSpec was planned for n={spec.n}, "
                f"eps={spec.eps}; got n={n}, eps={float(eps)}")
        # sweeps discard the overflow flag, so a reused spec is certified
        # on this tree by one probe
        ovf, _ = _wave_fns(spec)[3](state)
        if ovf:
            raise ValueError(
                f"reused WavefrontSpec (capacity={spec.capacity}) "
                "overflows on this dataset — it was calibrated for "
                "different points; rebuild without spec=")
    else:
        nb = -(-n // batch)
        cache_key = (n, float(eps), dims, batch, prune_dtype)
        fp = _data_fingerprint(points)
        cached_fp, cached = _SPEC_CACHE.get(cache_key, (None, None))
        if cached is not None and cached_fp == fp:
            spec = dataclasses.replace(cached, terminate=terminate)
        else:
            tile = min(_WAVE_TILE, max(512, _round_up(nb, 512)))
            floor = max(_round_up(2 * nb, tile), 2 * tile)
            cap = max(floor, cached.capacity if cached else 0)
            cap_max = max(4 * nb * n, 1 << 20)
            while True:
                pspec = WavefrontSpec(eps=float(eps), n=n, capacity=cap,
                                      tile=tile, max_levels=MAX_LEVELS,
                                      batch=batch, terminate=terminate,
                                      prune_dtype=prune_dtype)
                ovf, hist = _wave_fns(pspec)[3](state)
                if not ovf:
                    break
                if cap >= cap_max:
                    raise RuntimeError(
                        f"wavefront frontier calibration diverged (capacity "
                        f"{cap} still overflows for n={n}, eps={eps}) — the "
                        "data/ε pair is denser than O(n²); use engine='brute'")
                cap = min(cap * _PROBE_GROWTH, _round_up(cap_max, tile))
            peak = int(hist.max())
            spec = dataclasses.replace(
                pspec, capacity=max(_round_up(peak, tile), tile), peak=peak)
            _SPEC_CACHE[cache_key] = (fp, spec)
    engines.synchronize(points.device)
    timings = {"tree_s": t1 - t0, "calibrate_s": time.perf_counter() - t1}
    sweep, sweep_sorted, sweep_counts, _, frontier = _wave_fns(spec)
    return engines.Engine(
        "bvh", state, sweep, points.device, meta=spec,
        sweep_sorted=sweep_sorted, order=bvh.order, timings=timings,
        sweep_counts=sweep_counts,
        sweep_frontier=frontier if spec.terminate else None)


# ---------------------------------------------------------------------------
# Per-query stack traversal (engine="bvh-stack", the FDBSCAN baseline)
# ---------------------------------------------------------------------------


def _stack_traverse(bvh: BVH, queries, croot_sorted, *, eps: float,
                    early_stop: int, stack: int):
    """counts and min core root of every query by a depth-first stack
    traversal, all queries in lockstep: one step pops each unfinished
    query's top node, refines it if it is a leaf, and pushes the children
    whose ε-dilated box holds the query, left then right (the reference's
    order). A query is done when its stack is empty or, with
    ``early_stop > 0``, once its count reaches ``early_stop``. Every
    ``_STACK_CHECK`` steps the host drops the finished queries from the
    working set; a finished query's state does not change in the steps
    before that."""
    dev = queries.device
    n = bvh.pts_sorted.shape[0]
    m = queries.shape[0]
    eps2 = eps2_tensor(float(eps) * float(eps), dev)
    node_lo, node_hi = _node_boxes(bvh, eps)
    kids = torch.stack([bvh.left, bvh.right], dim=1).long()   # (n-1, 2)
    counts = torch.zeros(m, dtype=torch.int32, device=dev)
    minroot = torch.full((m,), INT_MAX, dtype=torch.int32, device=dev)
    ids = torch.arange(m, device=dev)
    q = queries.to(torch.float32)
    # column `stack` takes the writes of children that are not pushed
    stk = torch.zeros((m, stack + 1), dtype=torch.int32, device=dev)  # root
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    mr = torch.full((m,), INT_MAX, dtype=torch.int32, device=dev)

    def going():
        go = sp > 0
        return go & (cnt < early_stop) if early_stop > 0 else go

    while ids.numel():
        for _ in range(_STACK_CHECK):
            go = going()
            node = stk.gather(1, (sp - 1).clamp(min=0)[:, None])[:, 0].long()
            sp = sp - go.long()
            inner = node < n - 1
            leaf_id = (node - (n - 1)).clamp(0, n - 1)
            hit = go & ~inner & (_dist2(q, bvh.pts_sorted[leaf_id]) <= eps2)
            cnt = cnt + hit.to(torch.int32)
            mr = torch.where(hit, torch.minimum(mr, croot_sorted[leaf_id]), mr)
            ci = kids[node.clamp(0, n - 2)]                      # (m, 2)
            overlap = ((q[:, None] >= node_lo[ci]) &
                       (q[:, None] <= node_hi[ci])).all(dim=2)
            push = overlap & (go & inner)[:, None]
            slots = torch.stack([sp, sp + push[:, 0].long()], dim=1)
            stk.scatter_(1, torch.where(push, slots, stack), ci.to(torch.int32))
            sp = sp + push.sum(dim=1)
        counts[ids] = cnt
        minroot[ids] = mr
        keep = going().nonzero().squeeze(1)        # one host sync
        ids, q, stk, sp, cnt, mr = (x[keep] for x in (ids, q, stk, sp, cnt,
                                                       mr))
    return counts, minroot


@functools.lru_cache(maxsize=64)
def _stack_sweep_fn(eps: float, early_stop: int, stack: int):
    """Lockstep stack traversal. ``early_stop > 0`` enables FDBSCAN's early
    traversal termination at ``count ≥ early_stop`` (stage-1 counting
    only: counts clip at exactly ``early_stop``). ``stack`` slots are
    guaranteed sufficient at build time (``max_leaf_depth`` check). The
    refine is ``ref._dist2``'s unfused ascending d². All queries step
    together."""

    def sweep(state: BVHState, core, root):
        bvh = state.bvh
        croot_sorted = ops.fuse_core_root(core, root)[bvh.order.long()]
        return _stack_traverse(bvh, state.points, croot_sorted, eps=eps,
                               early_stop=early_stop, stack=stack)

    return sweep


def make_bvh_stack_engine(points: torch.Tensor, eps: float, *,
                          dims: int | None = None, early_stop: int = 0,
                          stack: int = STACK) -> engines.Engine:
    """Build the per-query stack engine (engine="bvh-stack") over
    ``points`` (a tensor on the engine's device).

    Overflow safety: a DFS stack needs at most ``max_leaf_depth + 1``
    slots; the build measures the actual tree depth and raises if
    ``stack`` could overflow.
    """
    bvh, _ = _tree(points, dims)
    need = max_leaf_depth(bvh.left, bvh.right) + 1
    if need > stack:
        raise RuntimeError(
            f"BVH stack overflow: traversal of this tree can need {need} "
            f"stack slots but only {stack} are configured — neighbors would "
            "be dropped silently. Raise ``stack=`` or use the wavefront "
            "engine (engine='bvh'), which has no per-query stack.")
    state = BVHState(bvh=bvh, points=points)
    fn = _stack_sweep_fn(float(eps), early_stop, stack)
    return engines.Engine("bvh-stack", state, fn, points.device,
                          meta={"stack": stack, "depth": need - 1})


# Builders take only the keywords they honor (plus the standard surface
# make_engine always forwards): a misdirected engine-specific keyword such
# as make_engine(engine="bvh", early_stop=...) is a TypeError.


def _build_wavefront(points, eps, *, chunk=2048, dims=None, spec=None,
                     batch=8, terminate=True, prune_dtype="bf16"):
    return make_bvh_engine(points, eps, dims=dims, spec=spec, batch=batch,
                           terminate=terminate, prune_dtype=prune_dtype)


def _build_stack(points, eps, *, chunk=2048, dims=None, spec=None,
                 early_stop=0, stack=STACK):
    # every query steps at once, so the reference's per-vmap ``chunk`` has
    # nothing to tile
    return make_bvh_stack_engine(points, eps, dims=dims,
                                 early_stop=early_stop, stack=stack)


engines.register_engine(
    "bvh", _build_wavefront,
    doc="LBVH with batched wavefront (level-compacted work queue) "
        "traversal: query batching, payload-bounded early termination and "
        "a bf16 prune / f32 refine split (supports batch=, terminate=, "
        "prune_dtype=); sorted-layout fast path over the Morton-ordered "
        "leaves",
    capabilities=("sweep_sorted", "sweep_counts", "sweep_frontier"))
engines.register_engine(
    "bvh-stack", _build_stack,
    doc="LBVH with lockstep per-query stack traversal (FDBSCAN baseline; "
        "supports early_stop=, stack=)",
    capabilities=("early_stop",))
