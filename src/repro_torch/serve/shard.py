"""Morton-range corpus shards: one clustered snapshot split into
per-device serveable pieces (DESIGN.md §15).

The CSR corpus is already Morton-sorted, so range partitioning is a
*split*, not a rebuild: shard ``j`` is a contiguous run of sorted
positions, cut at count-balanced quantiles and then **snapped forward to
the end of the enclosing code run** so one cell code never spans two
shards. That snap is the routing exactness precondition: a query's
ε-dilated window cell is either empty in the global corpus or its whole
occupied run lies inside exactly one shard, so occupancy bisection
against the global sorted codes names the shard directly (§15.2).
Snapping can collapse adjacent cuts (e.g. an all-duplicates corpus has
one code), in which case the effective shard count is smaller than
requested — never zero-point shards.

**Why shards are split from a global clustering instead of clustered
independently:** DBSCAN labels are a global connectivity property — core
status needs neighbor counts across the boundary and clusters span it.
Each shard therefore carries the *global* clustering's outputs sliced to
its rows (core flags, ε-counts) but re-labeled with **shard-local dense
ids**: the s-th smallest global cluster label present in the shard maps
to local id s. ``np.unique`` builds that table ascending, so the remap
is *monotone* — the ``cross_sweep`` scatter-min over shard-local payload
ids, mapped back through the table and min-merged across shards, picks
the same element a global scatter-min would, which is what makes the
router's gather bit-identical to the single-snapshot answer (§15.3).

Each shard gets its *own* :class:`~repro_torch.core.grid.CSRGridSpec`
planned from its local extent/occupancy (a dense shard's slab no longer
sizes a sparse shard's sweep), built on the snapshot's device; routing,
by contrast, always quantizes with the **tier plan** — the global
snapshot's side/origin/bits — because ownership is defined over tier
codes. Routing is numpy on the host, with the cells and codes computed by
the same functions as the grid's (on CPU tensors).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..core import grid as grid_mod
from ..kernels import ref as kref
from .snapshot import ClusterSnapshot

INT_MAX = np.iinfo(np.int32).max


def target_tag(shard_id: int, replica: int | None = 0) -> str:
    """Canonical name of one serving target — ``shard-00j/rK`` (or the
    shard-scoped ``shard-00j`` when ``replica`` is None) — shared by
    health reports, fault-site tags, and error messages so a chaos test
    can address the exact copy it means to kill."""
    sid = f"shard-{shard_id:03d}"
    return sid if replica is None else f"{sid}/r{replica}"


def _window_offsets(dims: int) -> np.ndarray:
    rng = (-1, 0, 1)
    return np.asarray(
        [(dx, dy, dz) for dx in rng for dy in rng
         for dz in (rng if dims == 3 else (0,))], np.int32)


@dataclasses.dataclass(frozen=True)
class ShardPart:
    """One shard of a split snapshot (module docstring).

    ``snapshot`` is a fully self-contained :class:`ClusterSnapshot` —
    same fields, same ``assign``/ingest machinery — except its ``labels``
    / ``croot_sorted`` payload plane carries shard-local dense ids;
    ``label_table`` maps them back to the global label space.
    """
    shard_id: int
    snapshot: ClusterSnapshot
    label_table: np.ndarray   # (n_local_clusters,) int32, ascending global
    #                           labels; local id s -> label_table[s]
    code_lo: int              # owned tier-code range [code_lo, code_hi)
    code_hi: int
    orig_index: np.ndarray    # (n_j,) int64: shard row -> global corpus row

    @property
    def n(self) -> int:
        return self.snapshot.n

    @property
    def probe_point(self) -> np.ndarray:
        """(1, 3) f32 heartbeat query: the shard's own first corpus point.
        Probing with a point the shard *owns* keeps the window non-empty
        (a real slab walk, not a trivially-empty one) and the 1-point
        batch pads to the scheduler's smallest bucket, which warmup has
        already run (§16.1)."""
        return self.snapshot.points[:1].cpu().numpy().astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """Routing structure: tier quantization + snapped cuts (§15.2).

    Owns no shard data — only the global sorted code array and the cut
    positions/codes. Both routing questions reduce to ``searchsorted``:

    * **ingest** (``owner_of``): a point's tier code against the inner
      cut codes — cut ranges partition the whole code space, so every
      point has exactly one owning shard;
    * **query** (``window_shards``): each of the query's 9/27 ε-dilated
      window cell codes against the global sorted codes — an *occupied*
      run lies wholly inside one shard (cuts are snapped to code
      boundaries), and only shards owning occupied window runs can hold
      an ε-neighbor, so the routed set is exact, typically 1–2 shards.

    ``window_shards`` answers as the reference's does, with less host
    work: it computes the windows of each distinct query cell once, and
    bisects the window codes against the distinct occupied codes (one
    per run, with the run's start) instead of twice against every corpus
    code (at iono3d 1,000,000, about 47,000 occupied cells, the 884,736
    window codes of 32,768 queries took two bisections of about 260 ms
    each on the host CPU of an H100 machine; ``tools/tier_split.py``).
    """
    side: float
    origin: tuple
    dims: int
    bits: int
    codes: np.ndarray       # (n,) int64 global Morton-sorted tier codes
    pos_cuts: np.ndarray    # (K+1,) int64 cut positions in sorted order
    cut_codes: np.ndarray   # (K+1,) int64: shard j owns [cut[j], cut[j+1])

    @property
    def n_shards(self) -> int:
        return len(self.pos_cuts) - 1

    def _cell_codes(self, points_np: np.ndarray) -> tuple:
        """(cells, int64 codes) of host points under the tier's plan."""
        pts = torch.as_tensor(np.asarray(points_np, np.float32))
        cells, codes = grid_mod.cell_codes(pts, self.side, self.origin,
                                           self.dims, self.bits)
        return cells.numpy(), codes.numpy().astype(np.int64)

    def _codes_of(self, cells_np: np.ndarray) -> np.ndarray:
        codes = kref.morton_encode_ref(torch.as_tensor(cells_np),
                                       dims=self.dims)
        return codes.numpy().astype(np.int64)

    @functools.cached_property
    def _runs(self) -> tuple:
        """(the distinct codes of the sorted corpus, ascending; the sorted
        position where each one's run starts)."""
        return np.unique(self.codes, return_index=True)

    def owner_of(self, points_np) -> np.ndarray:
        """(m,) int32 owning shard per point — the ingest route."""
        _, codes = self._cell_codes(points_np)
        return np.searchsorted(self.cut_codes[1:-1], codes,
                               side="right").astype(np.int32)

    def window_shards(self, points_np) -> np.ndarray:
        """(m, K) bool: shard j may hold an ε-neighbor of point i.

        Mirrors ``grid._csr_window_bounds``'s cell enumeration exactly
        (±1 per axis around the clipped tier cell, neighbors clipped to
        the engine's cap): every corpus point within ε of a query sits
        in one of these window cells — tier side ≥ ε, the same argument
        that makes the engine's window sweep exact — so a shard outside
        this mask cannot contribute a count, a minroot, or a mind2.
        """
        cells, codes = self._cell_codes(points_np)
        # a cell's code names it (the clipped cells fit the code's bits):
        # the windows of each distinct query cell, once
        _, first, inv = np.unique(codes, return_index=True,
                                  return_inverse=True)
        cells = cells[first]
        m = len(cells)
        offs = _window_offsets(self.dims)
        cap = (1 << self.bits) - 2
        nbc = np.clip(cells[None, :, :] + offs[:, None, :], 0, cap)
        if self.dims == 2:
            nbc[:, :, 2] = 0
        codes = self._codes_of(nbc.reshape(-1, 3)).reshape(len(offs), m)
        # occupied iff the code is one of the corpus's; its run starts at
        # the reference's left bisection of the sorted codes
        runs, run_start = self._runs
        i = np.minimum(np.searchsorted(runs, codes), len(runs) - 1)
        occ = runs[i] == codes
        left = run_start[i]
        # an occupied run never straddles a cut: its start position names
        # the one shard holding it
        sid = np.searchsorted(self.pos_cuts, left, side="right") - 1
        mask = np.zeros((m, self.n_shards), bool)
        oi, oj = np.nonzero(occ)
        mask[oj, sid[oi, oj]] = True
        return mask[inv.reshape(-1)]


def _build_part(shard_id: int, pts: np.ndarray, labels_global: np.ndarray,
                core: np.ndarray, counts: np.ndarray, rows: np.ndarray,
                code_lo: int, code_hi: int, tier_spec, eps: float,
                min_pts: int, engine: str, device) -> ShardPart:
    # shard-local dense labels: ascending table -> monotone remap (the
    # §15.3 merge invariant; module docstring)
    table = np.unique(labels_global[labels_global >= 0]).astype(np.int32)
    local = np.where(labels_global >= 0,
                     np.searchsorted(table, labels_global),
                     -1).astype(np.int32)
    pts_dev = torch.as_tensor(pts, dtype=torch.float32, device=device)
    spec_j, g = grid_mod.plan_and_build_csr_grid(
        pts_dev, eps, dims=tier_spec.dims, chunk=tier_spec.chunk,
        block_k=tier_spec.block_k)
    if bool(g.overflow):
        raise AssertionError(
            f"shard {shard_id} CSR build overflowed its planned slab — "
            "plan/build disagree on quantization")
    local_dev = torch.as_tensor(local, device=device)
    core_dev = torch.as_tensor(core, device=device)
    order = g.order.long()
    croot_sorted = torch.full((spec_j.n_cand,), INT_MAX, dtype=torch.int32,
                              device=device)
    croot_sorted[:spec_j.n] = torch.where(core_dev[order], local_dev[order],
                                          INT_MAX)
    snap = ClusterSnapshot(
        points=pts_dev, labels=local_dev, core=core_dev,
        counts=torch.as_tensor(counts, device=device), order=g.order,
        cands=g.cands, codes=g.codes, croot_sorted=croot_sorted, spec=spec_j,
        engine=engine, eps=float(eps), min_pts=int(min_pts))
    return ShardPart(shard_id=shard_id, snapshot=snap, label_table=table,
                     code_lo=int(code_lo), code_hi=int(code_hi),
                     orig_index=rows)


def split_snapshot(snapshot: ClusterSnapshot,
                   n_shards: int) -> Tuple[ShardMap, list]:
    """Split a (globally clustered) snapshot into Morton-range shards, each
    built on the snapshot's device.

    Returns ``(shard_map, [ShardPart, ...])``. Cuts are count-balanced
    quantiles of the sorted corpus, snapped forward to code-run
    boundaries; collapsed cuts are dropped, so ``len(parts)`` may be
    smaller than ``n_shards`` (and is never zero — every part holds at
    least one point). Shard rows keep ascending global-corpus order, so
    tier compaction can reassemble the canonical corpus order exactly.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    spec = snapshot.spec
    codes = snapshot.codes.cpu().numpy().astype(np.int64)
    order = snapshot.order.cpu().numpy().astype(np.int64)
    n = len(codes)
    k_req = min(max(1, int(n_shards)), n)
    pos_cuts = [0]
    for j in range(1, k_req):
        p = (j * n) // k_req
        # snap forward past the run of the code at the quantile position
        p = int(np.searchsorted(codes, codes[min(p, n - 1)], side="right"))
        if pos_cuts[-1] < p < n:
            pos_cuts.append(p)
    pos_cuts.append(n)
    pos_cuts = np.asarray(pos_cuts, np.int64)
    K = len(pos_cuts) - 1
    cut_codes = np.empty(K + 1, np.int64)
    cut_codes[0] = 0
    for j in range(1, K):
        cut_codes[j] = codes[pos_cuts[j]]
    cut_codes[K] = np.iinfo(np.int64).max

    labels_g = snapshot.labels.cpu().numpy()
    core_g = snapshot.core.cpu().numpy()
    counts_g = snapshot.counts.cpu().numpy()
    pts_g = snapshot.points.cpu().numpy()
    parts = []
    for j in range(K):
        rows = np.sort(order[pos_cuts[j]:pos_cuts[j + 1]])
        parts.append(_build_part(
            j, pts_g[rows], labels_g[rows], core_g[rows], counts_g[rows],
            rows, int(cut_codes[j]), int(cut_codes[j + 1]), spec,
            float(snapshot.eps), int(snapshot.min_pts), snapshot.engine,
            snapshot.device))
    smap = ShardMap(side=spec.side, origin=tuple(spec.origin),
                    dims=spec.dims, bits=spec.bits, codes=codes,
                    pos_cuts=pos_cuts, cut_codes=cut_codes)
    return smap, parts
