"""RT-DBSCAN (Algorithm 3) on PyTorch.

Two stages over one fused sweep primitive:

  Stage 1 — core identification: one sweep counts ε-neighbors per point;
            ``core = counts ≥ minPts`` (self included, sklearn convention).
  Stage 2 — cluster formation: nothing was stored (the paper's memory-light
            contract), so each hooking round *re-sweeps* and unions
            deterministically:
              root   = find-with-compression (pointer jumping)
              m_i    = min root over core ε-neighbors of i   (the sweep)
              hook   parent[root_i] min= m_i   for core i    (scatter-min)
            Rounds converge in O(log n) (Shiloach–Vishkin).
  Border — one final sweep attaches each non-core point to the *minimum*
            core-neighbor root; no core neighbor ⇒ noise (−1).

Round drivers: ``hook_loop="device"`` (the default) runs the hooking rounds
in *sorted layout* for engines advertising ``sweep_sorted`` (payloads stay
sorted across rounds; original-order labels are reconstructed once at the
end). ``hook_loop="frontier"`` further re-sweeps only the live tiles of
each round for engines advertising ``sweep_frontier`` (bit-identical labels
and round count; the cost of rounds 2..k tracks the merge frontier).
``hook_loop="host"`` runs the generic per-round loop over the original
order, as do the other two for engines without the capability they need.
All run one loop, :func:`hook_rounds`, with their own sweep, as do
serving's ingest and each distributed rank: one host check per round,
capped at ``max_rounds``; labels and round counts equal the JAX
reference's.

Labels are component-min core indices; ``labels.compact_labels`` maps them
to 0..k−1 for reporting.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from . import neighbors as nb
from .union_find import hook_min, pointer_jump

INT_MAX = nb.INT_MAX


class DBSCANResult(NamedTuple):
    labels: torch.Tensor     # (n,) int32: cluster root id, or -1 for noise
    core: torch.Tensor       # (n,) bool
    counts: torch.Tensor     # (n,) int32 ε-neighbor counts (incl. self)
    n_rounds: int            # stage-2 hooking rounds executed
    frontier_tiles: torch.Tensor | None = None  # (max_rounds,) int32 live
    #   tiles swept per hooking round (frontier driver only; -1 past
    #   n_rounds)
    timings: dict | None = None  # host seconds of stage1_s, stage2_s and
    #   border_s, each ended by a device synchronize; and one count,
    #   stage1_kept_pairs: the pairs stage 1's sweep tested (kept runs x
    #   run width x query tile rows, padding rows included), where the
    #   engine's sweep_counts counts them


def _hook_step(root, m, core):
    """One stage-2 hooking step (of :func:`hook_rounds`): hook each core
    root onto the min core-neighbor root and recompress."""
    tgt = torch.minimum(m, root)             # m includes own root for core pts
    p2 = hook_min(root, root, tgt, valid=core)
    p2 = pointer_jump(p2)
    trace.count("host_syncs")
    return p2, not torch.equal(p2, root)


def hook_rounds(core, sweep_min, max_rounds: int):
    """Stage 2's rounds from the identity forest, each in a
    ``stage2.round`` span: jump to the roots, ``sweep_min(root)`` (each
    point's min core-neighbor root), :func:`_hook_step` (looked up when the
    loop runs, so a patch of it reaches every caller), until a round
    changes nothing or ``max_rounds``. Returns (roots, rounds run)."""
    parent = torch.arange(core.shape[0], dtype=torch.int32,
                          device=core.device)
    n_rounds, changed = 0, True
    while changed and n_rounds < max_rounds:
        with trace.span("stage2.round", round=n_rounds):
            root = pointer_jump(parent)
            parent, changed = _hook_step(root, sweep_min(root), core)
        n_rounds += 1
    return pointer_jump(parent), n_rounds


def _stage1_fn(sweep, state, n: int, device):
    zeros = torch.zeros((n,), dtype=torch.bool, device=device)
    iota = torch.arange(n, dtype=torch.int32, device=device)
    counts, _ = sweep(state, zeros, iota)
    return counts


def _scatter_sorted(values_s, order, n: int, fill):
    """Original-order tensor from a sorted-layout one: out[order] = values."""
    out = torch.full((n,), fill, dtype=values_s.dtype, device=values_s.device)
    out[order.long()] = values_s
    return out


def _sorted_stage1_fn(sweep_sorted, state, order):
    n = order.shape[0]
    croot = torch.full((n,), INT_MAX, dtype=torch.int32, device=order.device)
    counts_s, _ = sweep_sorted(state, croot)
    return _scatter_sorted(counts_s, order, n, 0)


def _counts_stage1_fn(sweep_counts, state, order, work=None):
    """Stage 1 through the counts-only sweep (no payload plane at all);
    ``work`` (a dict) receives what the sweep counts of its work."""
    return _scatter_sorted(sweep_counts(state, work=work), order,
                           order.shape[0], 0)


def _sorted_driver_fn(sweep_sorted, max_rounds: int, state, order, core,
                      timings: dict):
    """Sorted-layout stage 2 + border attachment for engines advertising
    ``sweep_sorted``.

    The union-find runs over *sorted* point ids, so the sweep payloads never
    leave sorted layout across rounds. Original label ids (component-min
    original core index) are reconstructed once at the end via a
    segment-min over ``order``.
    """
    dev = order.device
    n = order.shape[0]
    with trace.timed(timings, "stage2_s", dev):
        core_s = core[order.long()]
        root, n_rounds = hook_rounds(
            core_s,
            lambda root: sweep_sorted(
                state, torch.where(core_s, root, INT_MAX))[1],
            max_rounds)

    with trace.timed(timings, "border_s", dev):
        core_label = _label_ids(root, core_s, order)
        croot = torch.where(core_s, core_label, INT_MAX)
        _, m = sweep_sorted(state, croot)         # border attachment sweep
        labels_s = torch.where(core_s, core_label,
                               torch.where(m != INT_MAX, m, -1)
                               ).to(torch.int32)
        labels = _scatter_sorted(labels_s, order, n, -1)
    return labels, n_rounds


def _label_ids(root, core_s, order):
    """Brute-identical label ids from a sorted-space forest: min *original*
    index over the core members of each component."""
    n = order.shape[0]
    comp_min = torch.full((n,), INT_MAX, dtype=torch.int32,
                          device=order.device)
    comp_min.scatter_reduce_(0, root.long(),
                             torch.where(core_s, order, INT_MAX), "amin",
                             include_self=True)
    return comp_min[root.long()]


def _frontier_driver_fn(frontier, max_rounds: int, state, order, core,
                        timings: dict):
    """Frontier-compacted stage 2 + border for engines advertising
    ``sweep_frontier``.

    Same fixpoint as the sorted driver, but each round re-sweeps only the
    tiles that can still produce a *new* union — pending (payload changed
    in the slab since the tile's last sweep) ∧ live seam (slab min core
    root below some core query's root). Parked tiles yield INT32_MAX
    min-roots, whose hook is the no-op the full sweep would have produced,
    so labels and round count are bit-identical to the sorted driver. The
    pending flags, the previous payload and the per-round live-tile
    histogram stay on the device; the host checks ``changed`` once a round.
    """
    dev = order.device
    n = order.shape[0]
    with trace.timed(timings, "stage2_s", dev):
        core_s = core[order.long()]
        prev_croot = torch.full((n,), -1, dtype=torch.int32, device=dev)
        pending = torch.ones((frontier.n_tiles,), dtype=torch.bool,
                             device=dev)
        hist = torch.full((max_rounds,), -1, dtype=torch.int32, device=dev)
        r = 0

        def sweep_min(root):
            nonlocal prev_croot, pending, r
            croot = torch.where(core_s, root, INT_MAX)
            qroot = torch.where(core_s, root, -1)
            m, pending, n_live = frontier.sweep(
                state, croot, qroot, croot != prev_croot, pending)
            hist[r] = n_live
            prev_croot, r = croot, r + 1
            return m

        root, n_rounds = hook_rounds(core_s, sweep_min, max_rounds)

    with trace.timed(timings, "border_s", dev):
        core_label = _label_ids(root, core_s, order)
        # the border sweep also skips tiles whose minroot nobody reads
        m = frontier.border(state, torch.where(core_s, core_label, INT_MAX),
                            core_s)
        labels_s = torch.where(core_s, core_label,
                               torch.where(m != INT_MAX, m, -1)
                               ).to(torch.int32)
        labels = _scatter_sorted(labels_s, order, n, -1)
    return labels, n_rounds, hist


def dbscan(points, eps: float, min_pts: int, *, engine: str = "grid",
           chunk: int = 2048, max_rounds: int = 64, precomputed_counts=None,
           eng: nb.Engine | None = None, hook_loop: str = "device",
           device=None) -> DBSCANResult:
    """Cluster ``points`` (n, 3) — 2D data carries z = 0, as in the paper.

    ``device=None`` means ``cuda`` (raising when there is no card); pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    ``precomputed_counts`` implements the paper's §VI-B re-run use case:
    saved stage-1 counts let a minPts re-run skip core identification.
    ``eng`` reuses a built engine (then its device is used) across runs of
    the same dataset. ``chunk`` tiles the brute and grid-hash sweeps; the
    CSR engine's tile size is part of its plan. ``hook_loop`` selects the
    stage-2 round driver: ``"device"`` (default, sorted layout),
    ``"frontier"`` (live tiles only; engines without ``sweep_frontier``
    fall back to the driver ``"device"`` would take) or ``"host"``
    (generic loop).
    """
    if hook_loop not in ("device", "host", "frontier"):
        raise ValueError(f"unknown hook_loop {hook_loop!r}")
    if eng is None:
        eng = nb.make_engine(points, eps, engine=engine, chunk=chunk,
                             device=device)
    with trace.span("dbscan", hook_loop=hook_loop):
        return _stages(eng, len(points), min_pts, max_rounds,
                       precomputed_counts, hook_loop)


def _stages(eng: nb.Engine, n: int, min_pts: int, max_rounds: int,
            precomputed_counts, hook_loop: str) -> DBSCANResult:
    """Stage 1, stage 2 and the border on a built engine."""
    dev = eng.device
    timings: dict = {}
    work: dict = {}

    with trace.timed(timings, "stage1_s", dev):
        sorted_path = eng.sweep_sorted is not None and \
            hook_loop in ("device", "frontier")
        if precomputed_counts is not None:
            counts = trace.to_device(precomputed_counts, dev, torch.int32)
        elif sorted_path and eng.sweep_counts is not None:
            counts = _counts_stage1_fn(eng.sweep_counts, eng.state,
                                       eng.order, work)
        elif sorted_path:
            counts = _sorted_stage1_fn(eng.sweep_sorted, eng.state,
                                       eng.order)
        else:
            counts = _stage1_fn(eng.sweep, eng.state, n, dev)
        core = counts >= min_pts
    if work:
        # read once stage 1 has ended, so stage1_s holds no read
        timings["stage1_kept_pairs"] = \
            int(trace.to_host(work["kept_runs"])) * work["pairs_per_run"]

    if sorted_path and hook_loop == "frontier" \
            and eng.sweep_frontier is not None:
        labels, n_rounds, hist = _frontier_driver_fn(
            eng.sweep_frontier, max_rounds, eng.state, eng.order, core,
            timings)
        return DBSCANResult(labels=labels, core=core, counts=counts,
                            n_rounds=n_rounds, frontier_tiles=hist,
                            timings=timings)
    if sorted_path:
        labels, n_rounds = _sorted_driver_fn(
            eng.sweep_sorted, max_rounds, eng.state, eng.order, core,
            timings)
        return DBSCANResult(labels=labels, core=core, counts=counts,
                            n_rounds=n_rounds, timings=timings)

    # Generic stage 2: the rounds over the original order.
    with trace.timed(timings, "stage2_s", dev):
        root, n_rounds = hook_rounds(
            core, lambda root: eng.sweep(eng.state, core, root)[1],
            max_rounds)

    # Border attachment + final labels.
    with trace.timed(timings, "border_s", dev):
        _, m = eng.sweep(eng.state, core, root)
        labels = torch.where(core, root,
                             torch.where(m != INT_MAX, m, -1)
                             ).to(torch.int32)
    return DBSCANResult(labels=labels, core=core, counts=counts,
                        n_rounds=n_rounds, timings=timings)
