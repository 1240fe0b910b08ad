"""Neighbor-search engines: the fused sweep primitive.

An *engine* answers the paper's fused sweep query:

    sweep(state, core, root) -> (counts, minroot)

    counts[i]  = |{ j : ‖p_i − p_j‖² ≤ ε² }|          (self included)
    minroot[i] = min{ root[j] : j ε-neighbor of i, core[j] }  (INT_MAX if none)

Engines (registered in ``engines``; one table, no ``if engine ==`` chains):

  * ``grid``      — cell-sorted CSR ε-grid (``grid.py``; ``csr_sweep``
    kernel pair): points reordered by Morton cell code, query tiles sweep
    contiguous candidate slabs sized by actual local occupancy. Besides
    ``sweep`` it exposes ``sweep_sorted`` (payloads already in sorted
    layout, so the DBSCAN round driver stays in sorted order across hooking
    rounds), ``sweep_counts`` (stage 1 without the payload plane) and
    ``sweep_frontier`` (the ``frontier_sweep`` kernel re-sweeps only the
    tiles that can still produce a union). The default.
  * ``grid-hash`` — capacity-padded spatial-hash ε-grid (``hash_sweep``
    kernel): each query sweeps the occupied slots of the buckets of its
    9/27 adjacent cells, read from the (H, C) table in one launch (the
    plain version gathers the padded windows per ``chunk`` of queries:
    O(n · 27 · C) work).
  * ``brute``     — all-pairs sweep (``pairwise_sweep`` kernel), one launch
    per sweep. O(n²) work.

The BVH engines (``bvh``, ``bvh-stack``) register from ``bvh.py``.

Every engine also backs ``find_neighbors`` (neighbor *lists*) through its
``neighbors`` capability; those lists are plain tensor code. The ``grid``
engine alone answers cross-corpus queries (``query``, the ``cross_sweep``
kernel) against its frozen layout: the serving tier's ``assign`` and
ingest.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..kernels import csr_sweep as _csr
from ..kernels import gathered_sweep as _gathered
from ..kernels import ops
from ..kernels.ref import _dist2, eps2_tensor
from . import engines
from . import grid as grid_mod
from .engines import Engine, make_engine  # re-export (public API)  # noqa: F401

INT_MAX = ops.INT_MAX

# Bound on every overflow → double-the-slab-and-retry loop (serving assign
# and ingest): a slab doubles at most this many times before the caller
# raises a CapacityError naming the final capacity. log2(n_cand / slab)
# doublings always suffice; the cap makes a pathological query
# distribution (or a fault-injected overflow flag) end in a diagnosable
# error rather than an unbounded retry loop.
MAX_SLAB_REGROW = 8


class GridState(NamedTuple):
    grid: grid_mod.Grid
    buckets: torch.Tensor            # (n, OFF) int32
    cell_valid: torch.Tensor         # (n, OFF) bool
    points: torch.Tensor             # (n, 3) f32 (original order)
    occupancy: torch.Tensor          # (H,) int32 per bucket: valid prefix


def infer_dims(points_np: np.ndarray) -> int:
    """Data dimensionality: the column count, except for the paper's 3-col
    convention where 2D data rides in (n, 3) arrays with z = 0."""
    d = points_np.shape[1]
    if d != 3:
        return d
    return 2 if np.all(points_np[:, 2] == 0) else 3


def _topk_neighbor_ids(hit, cand_idx, k_max: int):
    """Shared tail of every neighbor-list body: ascending ids of the hits,
    -1 padded to ``k_max`` columns, plus exact per-row counts."""
    key = torch.where(hit, cand_idx, INT_MAX).to(torch.int32)
    if key.shape[1] < k_max:
        key = ops.pad_to(key, k_max, 1, INT_MAX)
    key = torch.sort(key, dim=1).values[:, :k_max]
    cnt = hit.sum(dim=1, dtype=torch.int32)
    return torch.where(key == INT_MAX, -1, key).to(torch.int32), cnt


def hash_window_chunks(state: GridState, core, root, chunk: int):
    """Per chunk of ``chunk`` queries: the ``ops.gathered_sweep`` inputs of
    its windows of 9/27 buckets (queries, candidates, validity, core,
    root), padded to whole chunks (``gathered_sweep.hash_windows``)."""
    g = state.grid
    return _gathered.hash_windows(state.points, state.buckets,
                                  state.cell_valid, g.points, g.index,
                                  core, root, chunk)


@functools.lru_cache(maxsize=64)
def _grid_sweep_fn(eps2: float, chunk: int):
    """The grid-hash sweep: ``hash_sweep`` over the bucket table (its plain
    version, on the CPU, sweeps each chunk's gathered windows)."""

    def sweep(state: GridState, core, root):
        g = state.grid
        return _gathered.hash_sweep(
            state.points.to(torch.float32), g.order, state.buckets,
            state.cell_valid, g.points, g.index, state.occupancy,
            core.to(torch.bool), root.to(torch.int32), eps2, chunk=chunk)

    return sweep


@functools.lru_cache(maxsize=64)
def _grid_hash_neighbors_fn(eps2: float, chunk: int):
    """Neighbor lists from the hash grid's gathered candidate windows (the
    sweep's windows, with every point core and its own index as root)."""

    def neighbors(state: GridState, k_max: int):
        n = state.points.shape[0]
        dev = state.points.device
        e2 = eps2_tensor(eps2, dev)
        out = [_topk_neighbor_ids((_dist2(q[:, None, :], cand) <= e2) & val,
                                  idx, k_max)
               for q, cand, val, _, idx in hash_window_chunks(
                   state, torch.ones((n,), dtype=torch.bool, device=dev),
                   torch.arange(n, dtype=torch.int32, device=dev), chunk)]
        return (torch.cat([i for i, _ in out])[:n],
                torch.cat([c for _, c in out])[:n])

    return neighbors


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

    def sweep_counts(state: grid_mod.CSRGrid, work=None):
        got = ops.csr_sweep_counts(
            state.q_sorted, state.cands, state.starts, state.nblk, eps2,
            slab=spec.slab, block_q=spec.chunk, block_k=spec.block_k,
            with_work=work is not None)
        if work is None:
            return got[:n]
        counts_p, swept = got
        # a kept run is G candidate columns, each swept by a tile's rows
        work["kept_runs"] = swept[1]
        work["pairs_per_run"] = _csr.run_width(spec.block_k) * spec.chunk
        return counts_p[:n]

    return sweep, sweep_sorted, sweep_counts


@functools.lru_cache(maxsize=64)
def _csr_frontier_fns(spec: grid_mod.CSRGridSpec, eps2: float):
    """The ``sweep_frontier`` capability of the CSR engine.

    Tile liveness is the intersection of two independently hook-safe tests:

      * **pending** (dirty blocks): some candidate in the tile's slab
        changed payload since the tile was last swept — a sticky flag, so
        a tile parked by the seam test keeps remembering the change;
      * **live seam**: the slab's min core root is below some core query's
        root in the tile — the only configuration that can produce a
        *new* union (otherwise every hook target equals the query's own
        root and the scatter-min is a no-op).

    Parked tiles return INT32_MAX min-root rows; their hook step is then
    ``parent[root] min= root`` — exactly the no-op the full sweep would
    have produced — so the union-find trajectory (every label and the round
    count) is bit-identical to the full re-sweep drivers. Nothing here
    syncs the host: the live count stays a device scalar.
    """
    n, bk, chunk = spec.n, spec.block_k, spec.chunk
    T = spec.n_tiles
    max_blocks = spec.slab // bk

    def _pad_payload(croot_sorted):
        croot_pad = torch.full((spec.n_cand,), INT_MAX, dtype=torch.int32,
                               device=croot_sorted.device)
        croot_pad[:n] = croot_sorted
        return croot_pad

    def _tile_rows(x, fill):
        return ops.pad_to(x, T * chunk, 0, fill).reshape(T, chunk)

    def _compacted_to_sorted(minroot_c, active, n_live):
        # slot i's rows belong to tile active[i]; dead slots and rows past
        # n go to one spare slot (index n), cut off at the end
        dev = minroot_c.device
        live = torch.arange(T, device=dev) < n_live
        dst = active.long()[:, None] * chunk + torch.arange(chunk, device=dev)
        dst = torch.where(live[:, None] & (dst < n), dst, n)
        out = torch.full((n + 1,), INT_MAX, dtype=torch.int32, device=dev)
        out[dst.reshape(-1)] = minroot_c
        return out[:n]

    def _frontier_call(state, croot_pad, live):
        active, n_live = grid_mod.compact_tiles(live)
        minroot_c = ops.frontier_sweep(
            state.q_sorted, state.cands, croot_pad, state.starts, state.nblk,
            active, n_live, eps2, slab=spec.slab, block_q=chunk, block_k=bk)
        return _compacted_to_sorted(minroot_c, active, n_live), n_live

    def sweep(state: grid_mod.CSRGrid, croot_s, qroot_s, changed_s, pending):
        pending = pending | grid_mod.slab_touched(
            changed_s, state.starts, state.nblk, n, block_k=bk)
        croot_pad = _pad_payload(croot_s)
        slab_min = grid_mod.slab_payload_min(
            croot_pad, state.starts, state.nblk, block_k=bk,
            max_blocks=max_blocks)
        qmax = _tile_rows(qroot_s, -1).amax(dim=1)
        live = pending & (slab_min < qmax)
        m, n_live = _frontier_call(state, croot_pad, live)
        return m, pending & ~live, n_live

    def border(state: grid_mod.CSRGrid, croot_s, core_s):
        # minroot is consumed only by non-core queries, and only slabs with
        # a core candidate can produce one != INT32_MAX
        croot_pad = _pad_payload(croot_s)
        slab_min = grid_mod.slab_payload_min(
            croot_pad, state.starts, state.nblk, block_k=bk,
            max_blocks=max_blocks)
        has_noncore = _tile_rows(~core_s, False).any(dim=1)
        live = has_noncore & (slab_min < INT_MAX)
        return _frontier_call(state, croot_pad, live)[0]

    return engines.FrontierPlan(n_tiles=T, sweep=sweep, border=border)


@functools.lru_cache(maxsize=64)
def _csr_cross_query_fn(spec: grid_mod.CSRGridSpec, eps2: float, slab: int,
                        block_q: int):
    """Cross-corpus query over a frozen CSR layout: the function behind the
    ``query`` capability and the serving tier's ``assign``.

    Quantizes fresh queries with the *corpus* plan, sorts them stably by
    Morton code so tiles share window cells, bisects each query's 9/27
    window cells against the corpus's sorted codes, reduces them to
    per-tile slabs, and runs the ``cross_sweep`` kernel; results go back to
    request order. ``q`` is a padded batch (a bucket of ``block_q``-row
    tiles) and ``nq`` its live count: padded rows sort to the end, and
    their lanes drop out of the tile windows. Returns counts, minroot,
    mind2 (each (Qp,)) and ``overflow``, a () bool tensor: a tile's window
    outgrew ``slab`` (the caller regrows).
    """
    n_cand = spec.n_cand
    eff_slab = min(slab, n_cand)  # slab == n_cand covers any window

    def query(codes, cands, croot_sorted, q, nq: int):
        Qp = q.shape[0]
        n = codes.shape[0]
        dev = q.device
        valid = torch.arange(Qp, device=dev) < nq
        qcells, qcodes = grid_mod.cell_codes(q, spec.side, spec.origin,
                                             spec.dims, spec.bits)
        # stable sort by code, padding keyed to the end of the batch
        qorder = torch.argsort(torch.where(valid, qcodes, INT_MAX),
                               stable=True)
        valid_s = valid[qorder]
        lo, hi = grid_mod._csr_window_bounds(codes, qcells[qorder],
                                             spec.dims, spec.bits)
        # dead lanes drop out of the tile min/max (the tile_slabs contract)
        lo = torch.where(valid_s, lo, n)
        hi = torch.where(valid_s, hi, 0)
        starts, nblk, overflow = grid_mod.tile_slabs(
            lo, hi, Qp, n_tiles=Qp // block_q, chunk=block_q,
            block_k=spec.block_k, slab=eff_slab, n_cand=n_cand)
        counts_s, minroot_s, mind2_s = ops.cross_sweep(
            q[qorder], cands, croot_sorted, starts, nblk, eps2,
            slab=eff_slab, block_q=block_q, block_k=spec.block_k)
        counts = torch.zeros((Qp,), dtype=torch.int32, device=dev)
        counts[qorder] = counts_s
        minroot = torch.full((Qp,), INT_MAX, dtype=torch.int32, device=dev)
        minroot[qorder] = minroot_s
        mind2 = torch.full((Qp,), float("inf"), dtype=torch.float32,
                           device=dev)
        mind2[qorder] = mind2_s
        return counts, minroot, mind2, overflow

    return query


@functools.lru_cache(maxsize=64)
def _csr_neighbors_fn(spec: grid_mod.CSRGridSpec, eps2: float):
    """Neighbor lists from the CSR engine's per-tile contiguous slabs."""
    n, slab, bk, chunk = spec.n, spec.slab, spec.block_k, spec.chunk

    def neighbors(state: grid_mod.CSRGrid, k_max: int):
        dev = state.order.device
        order = state.order.long()
        e2 = eps2_tensor(eps2, dev)
        # original id per sorted position; slab pads (≥ n) can never hit
        orig = torch.full((spec.n_cand,), INT_MAX, dtype=torch.int32,
                          device=dev)
        orig[:n] = state.order
        live_blk = torch.arange(slab, device=dev)
        q = state.q_sorted.reshape(-1, chunk, 3)
        idx_s, cnt_s = [], []
        for t, (st, nb) in enumerate(zip(state.starts.tolist(),
                                         state.nblk.tolist())):
            c = state.cands[:, st:st + slab].T
            d2 = _dist2(q[t][:, None, :], c[None, :, :])
            live = live_blk < nb * bk
            i, k = _topk_neighbor_ids((d2 <= e2) & live[None, :],
                                      orig[None, st:st + slab], k_max)
            idx_s.append(i)
            cnt_s.append(k)
        idx = torch.full((n, k_max), -1, dtype=torch.int32, device=dev)
        idx[order] = torch.cat(idx_s)[:n]
        cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
        cnt[order] = torch.cat(cnt_s)[:n]
        return idx, cnt

    return neighbors


@functools.lru_cache(maxsize=64)
def _brute_sweep_fn(eps2: float, chunk: int):

    def sweep(points, core, root):
        return ops.pairwise_sweep(points, points, core, root, eps2,
                                  chunk=chunk)

    return sweep


@functools.lru_cache(maxsize=64)
def _brute_neighbors_fn(eps2: float, chunk: int):

    def neighbors(points, k_max: int):
        n = points.shape[0]
        e2 = eps2_tensor(eps2, points.device)
        cand_idx = torch.arange(n, dtype=torch.int32,
                                device=points.device)[None, :]
        idx, cnt = [], []
        for s in range(0, n, chunk):
            d2 = _dist2(points[s:s + chunk, None, :], points[None, :, :])
            i, c = _topk_neighbor_ids(d2 <= e2, cand_idx, k_max)
            idx.append(i)
            cnt.append(c)
        return torch.cat(idx), torch.cat(cnt)

    return neighbors


# --- registry builders (one per engine; the only dispatch table) -----------


def _build_brute(points, eps, *, chunk=2048, dims=None, spec=None):
    eps2 = float(eps) ** 2
    return Engine("brute", points, _brute_sweep_fn(eps2, chunk),
                  points.device, neighbors=_brute_neighbors_fn(eps2, chunk))


def _build_csr(points, eps, *, chunk=2048, dims=None, spec=None):
    eps2 = float(eps) ** 2   # in double, rounded once to f32 by the sweep
    if spec is None:
        timings: dict = {}
        spec, g = grid_mod.plan_and_build_csr_grid(points, float(eps),
                                                   dims=dims, timings=timings)
    else:
        timings = {"plan_s": 0.0}    # a reused plan: nothing planned
        g = grid_mod.build_csr_grid(points, spec)
    with trace.span("build.check"):
        trace.count("host_syncs")
        overflow = bool(g.overflow)
    if overflow:
        raise ValueError(
            "CSR grid build overflowed the planned slab capacity "
            f"(slab={spec.slab}) — the spec was planned for different "
            "data; re-plan with plan_csr_grid on this dataset")
    fn, fn_sorted, fn_counts = _csr_sweep_fns(spec, eps2)

    def query(state, q, nq, croot_sorted, *, slab=None, block_q=256):
        """Cross-corpus queries against this engine's frozen layout: q
        (Qp, 3) padded queries (Qp a multiple of block_q), nq the live
        count, croot_sorted (n_cand,) payload in sorted layout."""
        fn_q = _csr_cross_query_fn(spec, eps2,
                                   spec.slab if slab is None else slab,
                                   block_q)
        return fn_q(state.codes, state.cands, croot_sorted, q, nq)

    return Engine("grid", g, fn, points.device, meta=spec,
                  sweep_sorted=fn_sorted, order=g.order,
                  timings=timings, sweep_counts=fn_counts,
                  neighbors=_csr_neighbors_fn(spec, eps2), query=query,
                  sweep_frontier=_csr_frontier_fns(spec, eps2))


def _build_grid_hash(points, eps, *, chunk=2048, dims=None, spec=None):
    eps2 = float(eps) ** 2
    pts_np = points.cpu().numpy()
    if dims is None:
        dims = infer_dims(pts_np)
    timings: dict = {}
    with trace.timed(timings, "plan_s"):
        if spec is None:
            spec = grid_mod.plan_grid(pts_np, float(eps), dims=dims)
    g = grid_mod.build_grid(points, spec)
    buckets, cell_valid = grid_mod.neighbor_buckets(points, spec)
    state = GridState(grid=g, buckets=buckets, cell_valid=cell_valid,
                      points=points,
                      occupancy=g.valid.sum(dim=1, dtype=torch.int32))
    return Engine("grid-hash", state, _grid_sweep_fn(eps2, chunk),
                  points.device, meta=spec, timings=timings,
                  neighbors=_grid_hash_neighbors_fn(eps2, chunk))


engines.register_engine(
    "brute", _build_brute,
    doc="all-pairs sweep (exact, O(n²) compute)",
    capabilities=("neighbors",))
engines.register_engine(
    "grid", _build_csr,
    doc="cell-sorted CSR ε-grid; sorted-layout fast path (the default)",
    capabilities=("neighbors", "sweep_sorted", "query", "sweep_counts",
                  "sweep_frontier"))
engines.register_engine(
    "grid-hash", _build_grid_hash,
    doc="capacity-padded spatial-hash ε-grid (comparison baseline)",
    capabilities=("neighbors",))


def find_neighbors(points, eps: float, k_max: int, *, engine: str = "grid",
                   chunk: int = 2048, device=None):
    """Fixed-radius neighbor *lists* (library op).

    Dispatches through the engine registry: any engine advertising the
    ``neighbors`` capability works (``grid``, ``grid-hash``, ``brute``).
    Returns (idx (n, k_max) int32 padded with -1, counts (n,) int32) on
    ``device`` (``None`` means ``cuda``). Neighbor indices are ascending;
    self is included. Lists past ``k_max`` are truncated (counts stay
    exact).
    """
    entry = engines.get_engine_spec(engine)
    if "neighbors" not in entry.capabilities:
        raise ValueError(
            f"engine {engine!r} does not provide the neighbor-list "
            "capability; use engine='grid', 'grid-hash' or 'brute'")
    eng = make_engine(points, eps, engine=engine, chunk=chunk, device=device)
    return eng.neighbors(eng.state, k_max=k_max)
