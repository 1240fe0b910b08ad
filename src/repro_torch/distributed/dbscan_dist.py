"""Distributed DBSCAN over D ranks, in PyTorch.

The reference runs one SPMD program under ``shard_map``; the port runs the
same program on every rank of a group (``distributed/comm.py``): D threads
on one device (:class:`~.comm.ThreadGroup`) or one process a rank over
``torch.distributed`` (:class:`~.comm.ProcessGroup`). Its steps, names and
arithmetic are the reference's:

  1. **Quantile slabs**: a global histogram (``psum``) over the widest
     coordinate picks D−1 cuts, so that each rank owns about n/D points.
  2. **Redistribution**: a fixed-capacity ``all_to_all`` packs each point's
     (x, y, z, global id + 1) to its slab's owner.
  3. **ε-halo exchange**: owned points within ε of a slab face go to that
     neighbour by ``ppermute``.
  4. **Local sweep**: the fused (counts, min-core-root) query over owned ∪
     halo candidates, through a local engine of the registry
     (``engines.get_local_engine``): ``grid`` (a per-slab hash grid,
     ``hash_sweep``), ``csr`` (cell-sorted slabs, ``csr_sweep``), ``bvh``
     (the wavefront LBVH, ``lbvh_*`` and ``bvh_level``) or ``brute``
     (``pairwise_sweep``). On a card each runs its kernels; on the CPU
     their plain versions.
  5. **Local union-find**: hooking and pointer jumping on the local graph.
  6. **Cross-rank label rounds**: halo labels are exchanged again and each
     local component takes the min label of its members.
  7. Labels return to the input order by global id (a ``psum``).

Capacities are config; an overflow anywhere raises a flag that every rank
sees (``psum``), and :func:`dbscan_distributed` doubles them and restarts.
The flag is read once every buffer is built, so an attempt that overflowed
stops there (the reference runs it to the end and discards its answer).

Global ids ride the all_to_all as f32 (``gid + 1``), exactly as the
reference does: exact for n < 2^24 points.

The ``grid`` engine counts each candidate once. The reference's
``make_grid_sweep`` counts a candidate again for every window offset whose
cell hashes to a bucket already in the window (it masks such buckets out
of ``minroot`` only), so its counts can exceed the true ones; the port's
equal ``_sweep_local``'s, as every other engine's do (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from ..core import engines
from ..core.dbscan import DBSCANResult
from ..core.engines import synchronize
from ..kernels import ref as _kref
from .comm import ThreadGroup

INT_MAX = 2 ** 31 - 1
BIG = 1e30
# the payload's global ids ride as f32 (id + 1): exact below 2^24
MAX_POINTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class DistConfig:
    send_factor: float = 4.0     # per-(src,dst) capacity = factor · n/D²
    halo_factor: float = 0.5     # halo capacity = factor · n/D
    hist_bins: int = 512
    max_label_rounds: int = 32
    query_chunk: int = 1024
    local_uf_rounds: int = 32
    # local sweep engine, resolved through the engine registry
    # (``engines.register_local_engine``): "csr" = cell-sorted CSR slabs,
    # "grid" = per-slab hash grid, "bvh" = wavefront LBVH traversal,
    # "brute" = all pairs
    local_engine: str = "grid"
    grid_capacity: int = 32      # points per hash bucket (regrows on overflow)
    grid_occupancy: int = 8      # target points per bucket → table size
    csr_chunk: int = 256         # CSR queries per sweep tile
    csr_block: int = 512         # CSR slab granularity (elements)
    csr_slab: int = 4096         # CSR per-tile slab capacity (regrows on
    #                              overflow, capped by the candidate count)
    bvh_frontier_factor: float = 8.0  # wavefront queue = factor · n_cand
    #                              entries (regrows on overflow)


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def _real_extent(cand_pts, real):
    """(lo, hi) (3,) f32 of the real rows; 0 on an axis without one."""
    inf = float("inf")
    lo = torch.where(real[:, None], cand_pts, inf).amin(dim=0)
    hi = torch.where(real[:, None], cand_pts, -inf).amax(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    return lo, hi


def _fused(croot):
    """The kernels' (core, root) payload of a fused ``croot`` plane."""
    croot = croot.to(torch.int32)
    return croot != INT_MAX, croot


def make_grid_sweep(cand_pts, eps: float, n_cand: int, cfg: DistConfig):
    """Per-slab hash-grid sweep: a (H, C) table built once over the
    candidates, answering fused (counts, minroot) queries with
    ``hash_sweep`` (each occupied slot of each valid bucket of a query's
    window once).

    Returns (sweep(queries, croot) -> (counts, minroot), overflow), where
    ``queries`` is a prefix of ``cand_pts`` (all of it, or the owned rows):
    the kernel visits them in the table's bucket-major order, kept to the
    prefix. Padded candidates (coords BIG) move to far cells of their own,
    2·ε apart beyond the real extent, so they never alias a real cell; any
    capacity overflow (with hash collisions with far cells) raises the
    regrow flag. Padded queries carry a −BIG sentinel, as the ``bvh``
    engine's do, so that they hit nothing: not even the +BIG fill of the
    plain version's padded windows (the reference's +BIG padding queries
    count the empty slots of their windows; the driver never reads a
    padding row).
    """
    from ..core import grid as grid_mod
    from ..kernels import gathered_sweep as _gathered

    dev = cand_pts.device
    table = 1 << max(6, math.ceil(math.log2(max(
        n_cand / cfg.grid_occupancy, 1.0))))
    spec = grid_mod.GridSpec(side=eps, origin=(0.0, 0.0, 0.0),
                             table_size=table, capacity=cfg.grid_capacity,
                             dims=3)
    real = cand_pts[:, 0] < 1e29
    # every padded point gets its OWN far cell (2·side apart), strictly
    # beyond the real data's extent so pad cells can never alias real cells
    real_max = torch.where(real, cand_pts[:, 0], -float("inf")).amax()
    far = torch.where(torch.isfinite(real_max), real_max, 0.0) + 16.0 * eps
    idx = torch.arange(n_cand, dtype=torch.float32, device=dev)
    pad_x = far + 2.0 * eps * idx
    zero = torch.zeros_like(pad_x)
    pts_c = torch.where(real[:, None], cand_pts,
                        torch.stack([pad_x, zero, zero], dim=1))
    grid = grid_mod.build_grid(pts_c, spec)
    placed_real = (grid.valid & (grid.points[..., 0] < far)).sum()
    overflow = placed_real < real.sum()
    occupancy = grid.valid.sum(dim=1, dtype=torch.int32)
    eps2 = eps * eps
    orders = {n_cand: grid.order}

    def visiting_order(nq: int):
        if nq not in orders:
            keep = torch.argsort((grid.order >= nq).to(torch.int8),
                                 stable=True)[:nq]
            orders[nq] = grid.order[keep].contiguous()
        return orders[nq]

    def sweep(queries, croot):
        queries = torch.where(queries[:, :1] < 1e29, queries,
                              -BIG).contiguous()
        buckets, cell_valid = grid_mod.neighbor_buckets(queries, spec)
        core, root = _fused(croot)
        return _gathered.hash_sweep(
            queries, visiting_order(queries.shape[0]), buckets,
            cell_valid, grid.points, grid.index, occupancy, core, root, eps2,
            chunk=cfg.query_chunk)

    return sweep, overflow


def make_csr_sweep(cand_pts, eps: float, n_cand: int, cfg: DistConfig):
    """Per-slab cell-sorted CSR sweep: sort the candidates by Morton cell
    code once, then answer fused (counts, minroot) queries for *all*
    candidates against per-tile contiguous slabs through ``csr_sweep``.

    The slab capacity is config (``cfg.csr_slab``), with an overflow flag
    that triggers the driver's regrow-and-restart. The plan's cell side
    and origin stay f32 tensors on the device, as in the reference (no
    host read). Padded candidates (coords BIG) sort to a reserved top
    Morton cell that no real query window can reach.

    Returns (sweep(croot) -> (counts, minroot) over all local candidate
    indices, overflow).
    """
    from ..core import grid as grid_mod
    from ..kernels import ops

    dev = cand_pts.device
    bits = 10
    eps2 = eps * eps
    real = cand_pts[:, 0] < 1e29
    lo3, hi3 = _real_extent(cand_pts, real)
    max_cells = (1 << bits) - 2
    # side grows past ε only when the extent saturates the Morton bit budget
    side = torch.maximum(torch.tensor(eps, dtype=torch.float32, device=dev),
                         (hi3 - lo3).amax() / (max_cells - 1) * (1 + 1e-5))
    cells = grid_mod.csr_cells(cand_pts, side, lo3, 3, bits)
    cells = torch.where(real[:, None], cells, (1 << bits) - 1)  # pads → top
    codes = _kref.morton_encode_ref(cells, dims=3)
    order = torch.argsort(codes, stable=True).to(torch.int32)
    ol = order.long()
    spts = cand_pts[ol]
    lo, hi = grid_mod._csr_window_bounds(codes[ol], cells[ol], 3, bits)
    # padded queries demand nothing (lo = n / hi = 0 drop out of the tile
    # min/max)
    real_s = real[ol]
    lo = torch.where(real_s, lo, n_cand)
    hi = torch.where(real_s, hi, 0)

    chunk, bk = cfg.csr_chunk, cfg.csr_block
    slab = min(-(-cfg.csr_slab // bk) * bk, -(-n_cand // bk) * bk)
    T = -(-n_cand // chunk)
    n_csr = max(-(-n_cand // bk) * bk, slab)
    start, nblk, overflow = grid_mod.tile_slabs(
        lo, hi, n_cand, n_tiles=T, chunk=chunk, block_k=bk, slab=slab,
        n_cand=n_csr)
    pad_q = torch.clamp(torch.arange(T * chunk, device=dev), max=n_cand - 1)
    q_sorted = spts[pad_q].contiguous()
    cands = _full((n_csr, 3), BIG, torch.float32, dev)
    cands[:n_cand] = spts
    cands_planar = cands.T.contiguous()

    def sweep(croot):
        croot_pad = _full((n_csr,), INT_MAX, torch.int32, dev)
        croot_pad[:n_cand] = croot[ol]
        counts_p, m_p = ops.csr_sweep(
            q_sorted, cands_planar, croot_pad, start, nblk,
            eps2, slab=slab, block_q=chunk, block_k=bk)
        counts = torch.zeros((n_cand,), dtype=torch.int32, device=dev)
        counts[ol] = counts_p[:n_cand]
        m = _full((n_cand,), INT_MAX, torch.int32, dev)
        m[ol] = m_p[:n_cand]
        return counts, m

    return sweep, overflow


def make_bvh_wave_sweep(cand_pts, eps: float, n_cand: int, cfg: DistConfig):
    """Per-slab wavefront LBVH sweep: build the Karras tree over the
    candidates once (over the *real* extent, so padded candidates quantize
    to the top Morton cell), then answer fused (counts, minroot) queries
    for all candidates by level-synchronous frontier traversal.

    The frontier capacity is config (``cfg.bvh_frontier_factor`` ·
    ``n_cand``) with an overflow flag: one payload-free probe at build time
    certifies every later sweep. Padded queries carry a −BIG sentinel, so
    they fall out of the frontier at the first level.

    Returns (sweep(croot) -> (counts, minroot) over all local candidate
    indices, overflow).
    """
    from ..core import bvh as bvh_mod

    dev = cand_pts.device
    real = cand_pts[:, 0] < 1e29
    lo3, hi3 = _real_extent(cand_pts, real)
    bvh = bvh_mod.build_bvh(cand_pts, dims=3, lo=lo3, hi=hi3)
    capacity = -(-int(cfg.bvh_frontier_factor * n_cand) // 512) * 512
    queries = torch.where(real[:, None], cand_pts, -BIG).contiguous()
    kw = dict(eps=float(eps), eps2=float(eps) ** 2, capacity=capacity)
    _, _, overflow, _ = bvh_mod.wavefront_sweep(
        bvh, queries, _full((n_cand,), INT_MAX, torch.int32, dev),
        stop_on_overflow=True, **kw)

    def sweep(croot):
        counts, m, _, _ = bvh_mod.wavefront_sweep(
            bvh, queries, croot[bvh.order.long()].contiguous(), **kw)
        return counts, m

    return sweep, torch.tensor(bool(overflow), device=dev)


# --- local-engine registry builders: each returns (sweep_all, sweep_own,
# overflow) where ``sweep_all(croot)`` answers the fused query for every
# local candidate and ``sweep_own`` for the owned prefix only. ---


def _local_brute(cand_pts, eps, n_cand, p_own, cfg):
    from ..kernels import ops
    eps2 = eps * eps

    def sweep(queries, croot):
        core, root = _fused(croot)
        return ops.pairwise_sweep(queries, cand_pts, core, root, eps2,
                                  chunk=cfg.query_chunk)

    return (lambda croot: sweep(cand_pts, croot),
            lambda croot: sweep(cand_pts[:p_own], croot),
            torch.tensor(False, device=cand_pts.device))


def _owned_prefix(sweep_all, overflow, p_own):
    """(sweep_all, sweep_own, overflow) of an engine that always sweeps
    every candidate: the owned rows are the first ``p_own`` of its
    answer."""
    def sweep_own(croot):
        counts, m = sweep_all(croot)
        return counts[:p_own], m[:p_own]

    return sweep_all, sweep_own, overflow


def _local_csr(cand_pts, eps, n_cand, p_own, cfg):
    return _owned_prefix(*make_csr_sweep(cand_pts, eps, n_cand, cfg), p_own)


def _local_grid(cand_pts, eps, n_cand, p_own, cfg):
    gsweep, overflow = make_grid_sweep(cand_pts, eps, n_cand, cfg)
    return (lambda croot: gsweep(cand_pts, croot),
            lambda croot: gsweep(cand_pts[:p_own], croot), overflow)


def _local_bvh(cand_pts, eps, n_cand, p_own, cfg):
    return _owned_prefix(*make_bvh_wave_sweep(cand_pts, eps, n_cand, cfg),
                         p_own)


engines.register_local_engine("brute", _local_brute)
engines.register_local_engine("csr", _local_csr)
engines.register_local_engine("grid", _local_grid)
engines.register_local_engine("bvh", _local_bvh)


def _compress(parent):
    """Pointer jumping to the fixed point (one host read a jump)."""
    p = parent
    while True:
        p2 = p[p.long()]
        if torch.equal(p2, p):
            return p2
        p = p2


def _local_components(sweep_all, core, n_local, rounds):
    """Local-index union-find over the rank's points (owned ∪ halo).

    Returns (root (n_local,) int32, rounds run)."""
    parent = torch.arange(n_local, dtype=torch.int32, device=core.device)
    it = 0
    changed = True
    while changed and it < rounds:
        root = _compress(parent)
        croot = torch.where(core, root, INT_MAX)
        _, m = sweep_all(croot)
        tgt = torch.minimum(torch.where(core, m, root), root)
        p2 = root.scatter_reduce(0, root.long(), tgt, "amin",
                                 include_self=True)
        p2 = _compress(p2)
        changed = not torch.equal(p2, root)
        parent = p2
        it += 1
    return _compress(parent), it


def _pack_by_dest(values, dest, n_dest: int, cap: int):
    """values (n, w), dest (n,) -> (n_dest, cap, w) padded buffer +
    overflow.

    Padding rows carry coords=BIG and payload id 0 (invalid); rows past a
    destination's capacity land in a spare slot that is cut off, so they
    can never clobber a valid slot."""
    n, w = values.shape
    dev = values.device
    order = torch.argsort(dest, stable=True)
    ds = dest[order]
    start = torch.searchsorted(ds, torch.arange(n_dest, dtype=ds.dtype,
                                                device=dev))
    rank = torch.arange(n, device=dev) - start[ds.long()]
    fill = torch.tensor([BIG] * (w - 1) + [0.0], dtype=values.dtype,
                        device=dev)
    buf = fill.expand(n_dest * cap + 1, w).clone()
    ok = rank < cap
    buf[torch.where(ok, ds.long() * cap + rank, n_dest * cap)] = \
        values[order]
    return buf[:n_dest * cap].reshape(n_dest, cap, w), torch.any(~ok)


def _first_k(pred, k: int):
    """(order, valid): the first ``k`` positions where ``pred`` holds, in
    order, then the rest (``valid`` False). The driver computes it once per
    slab face and reuses it for every exchange across that face, where the
    reference sorts again each time."""
    key = torch.where(pred, torch.arange(pred.shape[0], dtype=torch.int32,
                                         device=pred.device), INT_MAX)
    order = torch.argsort(key, stable=True)[:k]
    return order, key[order] != INT_MAX


def _select_rows(values, sel):
    """The rows ``sel`` picks; invalid rows get coords=BIG and payload id 0
    (so downstream validity checks see them as empty)."""
    order, valid = sel
    fill = torch.tensor([BIG, BIG, BIG, 0.0], dtype=values.dtype,
                        device=values.device)
    return torch.where(valid[:, None], values[order], fill)


def _select_first_k(values, pred, k: int):
    """First-k rows of ``values`` where pred (:func:`_select_rows`)."""
    return _select_rows(values, _first_k(pred, k))


def _select_core_flags(core, sel):
    order, valid = sel
    return core[order] & valid


def _select_labels(label, sel):
    order, valid = sel
    return torch.where(valid, label[order], INT_MAX)


def _slab_cuts(comm, pts_local, n: int, D: int, hist_bins: int):
    """Step 1: (widest axis (0-d), cuts (D-1,) f32, the points' coordinate
    on it), in the reference's f32 arithmetic."""
    lo = comm.pmin(pts_local.amin(dim=0))
    hi = comm.pmax(pts_local.amax(dim=0))
    widest = torch.argmax(hi - lo)
    c = pts_local.index_select(1, widest.reshape(1))[:, 0]
    clo = lo[widest]
    chi = torch.maximum(hi[widest], clo + 1e-6)
    b = hist_bins
    bin_of = torch.clamp(((c - clo) / (chi - clo) * b).to(torch.int32),
                         0, b - 1)
    hist = torch.bincount(bin_of.long(), minlength=b).to(torch.int32)
    hist = comm.psum(hist)
    cum = torch.cumsum(hist, 0, dtype=torch.int32)
    targets = (torch.arange(1, D, dtype=torch.float32,
                            device=pts_local.device) / D) * n
    cut_bins = torch.searchsorted(cum.to(torch.float32), targets)
    cuts = clo + (cut_bins.to(torch.float32) + 1) / b * (chi - clo)
    return widest, cuts, c


class _Steps:
    """Host seconds of each step of one rank, each ended by a device
    synchronize."""

    def __init__(self, device):
        self.device, self.t = device, time.perf_counter()
        self.s = {}

    def __call__(self, name: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


def _rank_dbscan(comm, points, n: int, eps: float, min_pts: int,
                 cfg: DistConfig):
    """The reference's ``impl`` on one rank. ``points`` is the whole (n, 3)
    input on the host; the rank takes its n/D rows. Returns (labels (n,),
    core (n,), overflow, label rounds, steps) with labels and core on the
    rank's device."""
    D = comm.axis_size()
    dev = comm.device
    n_local = n // D
    cap_send = max(8, int(cfg.send_factor * n / (D * D)))
    p_own = D * cap_send
    cap_halo = max(8, int(cfg.halo_factor * n / D))
    r = comm.axis_index()
    sent0 = dict(comm.sent)
    steps = _Steps(dev)
    pts_local = points[r * n_local:(r + 1) * n_local].to(dev)
    gidx = r * n_local + torch.arange(n_local, dtype=torch.int32, device=dev)
    f32 = torch.float32

    # ---- 1. quantile slab boundaries over the widest coordinate ----
    widest, cuts, c = _slab_cuts(comm, pts_local, n, D, cfg.hist_bins)
    steps("cuts")

    # ---- 2. fixed-capacity all_to_all redistribution ----
    dest = torch.searchsorted(cuts, c).to(torch.int32)
    payload = torch.cat([pts_local, gidx[:, None].to(f32) + 1.0], dim=1)
    send, ovf1 = _pack_by_dest(payload, dest, D, cap_send)
    owned = comm.all_to_all(send.reshape(D * cap_send, 4)).reshape(p_own, 4)
    own_valid = owned[:, 3] > 0
    own_pts = torch.where(own_valid[:, None], owned[:, :3], BIG)
    own_gidx = (owned[:, 3] - 1.0).to(torch.int32)
    steps("all_to_all")

    # ---- 3. ε-halo exchange with slab neighbours ----
    my_lo = cuts[r - 1] if r > 0 else torch.tensor(-BIG, dtype=f32,
                                                   device=dev)
    my_hi = cuts[r] if r < D - 1 else torch.tensor(BIG, dtype=f32,
                                                   device=dev)
    oc = own_pts.index_select(1, widest.reshape(1))[:, 0]
    near_lo = own_valid & (oc <= my_lo + eps)
    near_hi = own_valid & (oc >= my_hi - eps)
    sel_lo, sel_hi = _first_k(near_lo, cap_halo), _first_k(near_hi, cap_halo)
    send_l = _select_rows(owned, sel_lo)
    send_r = _select_rows(owned, sel_hi)
    ovf2 = (near_lo.sum() > cap_halo) | (near_hi.sum() > cap_halo)
    # from the left neighbour its right face, from the right its left face
    halo = torch.cat([comm.ppermute(send_r, 1), comm.ppermute(send_l, -1)])
    halo_valid = halo[:, 3] > 0
    halo_pts = torch.where(halo_valid[:, None], halo[:, :3], BIG)
    cand_pts = torch.cat([own_pts, halo_pts]).contiguous()
    n_cand = cand_pts.shape[0]
    steps("halo")

    build_local = engines.get_local_engine(cfg.local_engine)
    sweep_all, sweep_own, ovf3 = build_local(cand_pts, eps, n_cand, p_own,
                                             cfg)
    # every capacity is known here: an attempt that overflowed stops on
    # every rank (the reference runs it to the end, then discards it)
    overflow = bool(comm.psum((ovf1 | ovf2 | ovf3).to(torch.int32)) > 0)
    steps("local_build")
    if overflow:
        return None, None, True, 0, steps.s

    # ---- 4. stage 1: core identification (fused sweep) ----
    counts, _ = sweep_own(_full((n_cand,), INT_MAX, torch.int32, dev))
    core_own = own_valid & (counts >= min_pts)
    # halo core flags come from their owners through the same permutes
    core_l = _select_core_flags(core_own, sel_lo)
    core_r = _select_core_flags(core_own, sel_hi)
    halo_core = torch.cat([comm.ppermute(core_r, 1),
                           comm.ppermute(core_l, -1)])
    core_all = torch.cat([core_own, halo_core & halo_valid])
    steps("stage1")

    # ---- 5. local components over owned ∪ halo ----
    root_local, local_rounds = _local_components(
        sweep_all, core_all, n_cand, cfg.local_uf_rounds)
    root_l = root_local.long()
    steps("components")

    def halo_labels(label):
        lab_l = _select_labels(label, sel_lo)
        lab_r = _select_labels(label, sel_hi)
        return torch.cat([label, comm.ppermute(lab_r, 1),
                          comm.ppermute(lab_l, -1)])

    # ---- 6. cross-rank label rounds ----
    label = torch.where(core_own, own_gidx, INT_MAX)
    rounds = 0
    changed = True
    while changed and rounds < cfg.max_label_rounds:
        all_lab = torch.where(core_all, halo_labels(label), INT_MAX)
        seg_min = _full((n_cand,), INT_MAX, torch.int32, dev).scatter_reduce(
            0, root_l, all_lab, "amin", include_self=True)
        new = torch.where(core_all, seg_min[root_l], INT_MAX)[:p_own]
        changed = bool(comm.psum(torch.any(new != label).to(torch.int32))
                       > 0)
        label = new
        rounds += 1
    steps("label_rounds")

    # ---- border attachment: min core-neighbour label ----
    croot = torch.where(core_all, halo_labels(label), INT_MAX)
    _, m = sweep_own(croot)
    final = torch.where(core_own, label, torch.where(m != INT_MAX, m, -1))
    final = torch.where(own_valid, final, -1).to(torch.int32)
    steps("border")

    # ---- 7. return to the input order (each global slot is written by
    # exactly one rank, -1 ↦ 0 elsewhere: the psum selects the owner) ----
    slot = torch.where(own_valid, own_gidx, n).long()
    out_lab = _full((n + 1,), -1, torch.int32, dev)
    out_lab[slot] = final
    out_core = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    out_core[slot] = core_own.to(torch.int32)
    out_lab = out_lab[:n]
    out_lab = comm.psum(torch.where(out_lab == -1, 0, out_lab + 1)) - 1
    out_core = comm.psum(out_core[:n]) > 0
    steps("return")
    steps.s["local_rounds"] = local_rounds
    steps.s["sent"] = {k: v - sent0.get(k, 0) for k, v in comm.sent.items()}
    return out_lab, out_core, False, rounds, steps.s


def make_distributed_dbscan(group, n: int, eps: float, min_pts: int,
                            cfg: DistConfig = DistConfig()):
    """The distributed DBSCAN for fixed (n, ε, minPts, group).

    Returns fn(points (n, 3) host f32) -> (labels (n,) int32, core (n,)
    bool, overflow, label rounds, per-rank steps), labels and core on the
    group's device (rank 0's; every rank holds the same)."""
    D = group.size
    if n % D:
        raise ValueError(f"n = {n} must be divisible by the group's {D} "
                         "ranks")
    if n >= MAX_POINTS:
        raise ValueError(f"n = {n}: global ids ride as f32, exact only "
                         f"below {MAX_POINTS}")

    def fn(points):
        outs = group.run(_rank_dbscan, points, n, float(eps), int(min_pts),
                         cfg)
        labels, core, overflow, rounds, _ = outs[0]
        return labels, core, overflow, rounds, [o[4] for o in outs]

    return fn


def dbscan_distributed(points, eps: float, min_pts: int, group=None,
                       cfg: DistConfig = DistConfig(),
                       max_regrows: int = 3, *, device=None):
    """Distributed DBSCAN of ``points`` (n, 3), n divisible by the group's
    size D, on ``group`` (a :class:`~.comm.ThreadGroup` or this process's
    :class:`~.comm.ProcessGroup`; ``None`` means one rank on ``device``,
    ``None`` meaning ``cuda``: it raises without a card).

    On capacity overflow the buffers are regrown (×2) and the run
    restarts, as in the reference. Returns ``DBSCANResult`` with ``counts``
    zeros (counts stay on the ranks) and ``timings``: rank 0's host
    seconds per step (``cuts``, ``all_to_all``, ``halo``, ``local_build``,
    ``stage1``, ``components``, ``label_rounds``, ``border``, ``return``)
    of the last attempt, its ``local_rounds``, the bytes each rank put into
    each collective (``sent``, summed over the ranks), ``regrows``, and
    the host seconds of every attempt (``attempts_s``, the overflowed ones
    first).
    """
    if group is None:
        group = ThreadGroup(1, device=device)
    elif device is not None and torch.device(device) != group.device:
        raise ValueError(f"device {device} is not the group's "
                         f"{group.device}")
    points = torch.as_tensor(points, dtype=torch.float32).cpu()
    n = points.shape[0]
    attempts = []
    for regrows in range(max_regrows + 1):
        fn = make_distributed_dbscan(group, n, eps, min_pts, cfg)
        t0 = time.perf_counter()
        labels, core, overflow, rounds, steps = fn(points)
        attempts.append(time.perf_counter() - t0)
        if not overflow:
            sent = {}
            for s in steps:
                for k, v in s["sent"].items():
                    sent[k] = sent.get(k, 0) + v
            timings = dict(steps[0], sent=sent, regrows=regrows,
                           attempts_s=attempts)
            return DBSCANResult(
                labels=labels, core=core,
                counts=torch.zeros((n,), dtype=torch.int32,
                                   device=labels.device),
                n_rounds=int(rounds), timings=timings)
        cfg = dataclasses.replace(
            cfg, send_factor=cfg.send_factor * 2,
            halo_factor=cfg.halo_factor * 2,
            grid_capacity=cfg.grid_capacity * 2,
            csr_slab=cfg.csr_slab * 2,
            bvh_frontier_factor=cfg.bvh_frontier_factor * 2)
    raise RuntimeError(
        "distributed DBSCAN capacity overflow after regrows — data too "
        "skewed for the configured budget")
