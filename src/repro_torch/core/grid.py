"""The ε-grids of the grid and grid-hash engines.

**Cell-sorted CSR layout** (engine ``grid``). Points are reordered by the
Morton code of their ε-cell, so that every query tile's candidates form one
contiguous slab of the sorted array, sized by the tile's actual local
occupancy: O(n) memory and O(n · window) work. ``plan_csr_grid`` (host)
runs the same sort-by-cell pass the build runs and measures the worst
per-tile slab extent, which fixes the static slab capacity;
``build_csr_grid`` (device) sorts and derives per-tile slabs.
``slab_payload_min``, ``slab_touched`` and ``compact_tiles`` serve the
frontier round driver's live-tile test.

**Capacity-padded spatial hash** (engine ``grid-hash``). Points are binned
by a hash of their ε-cell into an (H, C) table; a query's candidates are
the buckets of its 9/27 adjacent cells. ``plan_grid`` (host) fixes H and
the bucket capacity C = max occupancy, so ``build_grid`` can never drop a
point; ``neighbor_buckets`` gives each point its window's bucket ids.
Aliased far-away cells are removed by the exact d² test of the sweep.

``spec_from_fields`` and ``grid_from_arrays`` rebuild a plan and a built
grid of either kind from plain fields and numpy arrays, e.g. those of the
JAX reference.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ref as _kref
from .engines import resolve_device

BIG = 1e30
INT32_MAX = np.iinfo(np.int32).max
_F32_BELOW_2_31 = 2.0 ** 31 - 128      # the largest f32 below 2^31
# Teschner et al.'s spatial-hash primes
_HASH_K = (73856093, 19349663, 83492791)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static plan of the spatial-hash grid for one (dataset, ε)
    (hashable)."""
    side: float           # cell side (≥ ε)
    origin: tuple         # (3,) domain min, for quantization precision
    table_size: int       # H, power of two
    capacity: int         # C, max points per bucket (measured at plan time)
    dims: int             # 2 or 3 (z ignored for 2D)

    @property
    def n_offsets(self) -> int:
        return 9 if self.dims == 2 else 27


class Grid(NamedTuple):
    """Device-side spatial-hash grid buffers."""
    points: torch.Tensor  # (H, C, 3) f32, padded with +BIG
    index: torch.Tensor   # (H, C) int32 original point index, -1 padding
    valid: torch.Tensor   # (H, C) bool
    order: torch.Tensor   # (n,) int32 sort order (bucket-major)
    bucket: torch.Tensor  # (n,) int32 bucket id per original point


def _hash_cells(cx, cy, cz, table_size: int) -> torch.Tensor:
    """The reference's spatial hash, with its uint32 wraparound: computed
    in int64, where each uint32 cell times a prime stays below 2^59 and the
    low bits kept by ``& (H - 1)`` (H ≤ 2^32) are those of the wrapped
    product."""
    h = ((cx.to(torch.int64) & _U32) * _HASH_K[0]
         ^ (cy.to(torch.int64) & _U32) * _HASH_K[1]
         ^ (cz.to(torch.int64) & _U32) * _HASH_K[2])
    return (h & (table_size - 1)).to(torch.int32)


def _saturate_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 as XLA converts: values beyond the int32 range saturate
    to its ends (a plain cast sends +huge to INT32_MIN on the CPU). The
    clamp stops at the largest f32 below 2^31, and everything from 2^31 up
    maps to INT32_MAX."""
    c = torch.clamp(x, -2.0 ** 31, _F32_BELOW_2_31).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, INT32_MAX, c)


def _quantize(points: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Integer cell coordinates (n, 3); z is 0 for 2D. Both constants are
    rounded once to f32, as in the reference. A coordinate far outside the
    domain (a +1e30 padding row) saturates, as the reference's cast
    does."""
    inv = torch.tensor(1.0 / spec.side, dtype=points.dtype,
                       device=points.device)
    org = torch.tensor(spec.origin, dtype=points.dtype, device=points.device)
    c = _saturate_int32(torch.floor((points - org) * inv))
    if spec.dims == 2:
        c[:, 2] = 0
    return c


def plan_grid(points_np: np.ndarray, eps: float, *, dims: int = 3,
              target_occupancy: float = 8.0, capacity_round: int = 8,
              max_table_size: int = 1 << 22) -> GridSpec:
    """Host-side planning pass: fixes H and C so the build is exact (one
    O(n) pass on the CPU: quantize, hash, bincount)."""
    n = len(points_np)
    origin = tuple(float(v) for v in points_np.min(axis=0))
    table_size = 1 << max(6, math.ceil(math.log2(max(n / target_occupancy,
                                                     1.0))))
    table_size = min(table_size, max_table_size)
    spec = GridSpec(side=float(eps), origin=origin, table_size=table_size,
                    capacity=0, dims=dims)
    c = _quantize(torch.as_tensor(np.asarray(points_np, np.float32)), spec)
    h = _hash_cells(c[:, 0], c[:, 1], c[:, 2], table_size)
    occ = torch.bincount(h.long(), minlength=table_size)
    cap = int(occ.max()) if n else 1
    cap = max(capacity_round, ((cap + capacity_round - 1) // capacity_round)
              * capacity_round)
    if table_size * cap > 64 * max(n, 1):
        warnings.warn(
            f"plan_grid: skewed occupancy — max bucket holds {int(occ.max())}"
            f" of {n} points, so the (H, C) table is ({table_size}, {cap}) = "
            f"{table_size * cap} slots ({table_size * cap / max(n, 1):.1f}x "
            f"the point count) and every query sweeps "
            f"{9 if dims == 2 else 27} x {cap} candidates; the cell-sorted "
            "CSR engine (engine='grid') avoids this blow-up",
            RuntimeWarning, stacklevel=2)
    return dataclasses.replace(spec, capacity=cap)


def build_grid(points: torch.Tensor, spec: GridSpec) -> Grid:
    """Sort-based spatial-hash build on the points' device. A point whose
    bucket rank reaches the capacity (a plan from other data) is dropped,
    as in the reference; it lands in a spare slot that is cut off."""
    n = points.shape[0]
    dev = points.device
    H, C = spec.table_size, spec.capacity
    c = _quantize(points, spec)
    bucket = _hash_cells(c[:, 0], c[:, 1], c[:, 2], H)
    order = torch.argsort(bucket, stable=True).to(torch.int32)
    bsorted = bucket[order.long()]
    start = torch.searchsorted(bsorted, torch.arange(H, dtype=torch.int32,
                                                     device=dev),
                               out_int32=True)
    rank = torch.arange(n, dtype=torch.int32, device=dev) \
        - start[bsorted.long()]
    slot = torch.where(rank < C, bsorted.long() * C + rank, H * C)
    gpoints = torch.full((H * C + 1, 3), BIG, dtype=torch.float32, device=dev)
    gindex = torch.full((H * C + 1,), -1, dtype=torch.int32, device=dev)
    gvalid = torch.zeros((H * C + 1,), dtype=torch.bool, device=dev)
    gpoints[slot] = points[order.long()].to(torch.float32)
    gindex[slot] = order
    gvalid[slot] = True
    return Grid(points=gpoints[:H * C].reshape(H, C, 3),
                index=gindex[:H * C].reshape(H, C),
                valid=gvalid[:H * C].reshape(H, C), order=order,
                bucket=bucket)


def neighbor_buckets(points: torch.Tensor, spec: GridSpec) -> tuple:
    """Per-point candidate window: bucket ids of the 9/27 adjacent cells.

    Returns (buckets (n, OFF) int32, cell_valid (n, OFF) bool); a bucket id
    repeated within a row (hash aliasing of distinct offsets) is valid only
    at its first slot, so no candidate counts twice.
    """
    c = _quantize(points, spec)
    rng = (-1, 0, 1)
    offs = torch.tensor([(dx, dy, dz) for dx in rng for dy in rng
                         for dz in (rng if spec.dims == 3 else (0,))],
                        dtype=torch.int32, device=points.device)
    cells = c[:, None, :] + offs[None, :, :]
    b = _hash_cells(cells[..., 0], cells[..., 1], cells[..., 2],
                    spec.table_size)
    # a slot is a duplicate iff an earlier slot of its row (in stable sort
    # order) holds the same bucket
    sidx = torch.argsort(b, dim=1, stable=True)
    srt = torch.gather(b, 1, sidx)
    dup_sorted = torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool),
                            srt[:, 1:] == srt[:, :-1]], dim=1)
    dup = torch.empty_like(dup_sorted).scatter_(1, sidx, dup_sorted)
    return b, ~dup


@dataclasses.dataclass(frozen=True)
class CSRGridSpec:
    """Static plan for the cell-sorted CSR engine (hashable).

    ``side`` may exceed ε when the extent saturates the Morton bit budget
    (coarser cells keep the ±1 window exact since side ≥ ε). The top cell
    index per axis is reserved for padding, so padded candidates can never
    enter a real query's window.
    """
    side: float           # cell side (≥ ε)
    origin: tuple         # (3,) domain min
    dims: int             # 2 or 3
    bits: int             # Morton bits per axis (15 for 2D, 10 for 3D)
    chunk: int            # queries per sweep tile
    block_k: int          # candidate block granularity (slab quantum)
    n: int                # real point count
    n_tiles: int          # T = ceil(n / chunk)
    slab: int             # per-tile slab capacity (elements, mult. block_k)
    n_cand: int           # padded sorted-candidate length (mult. block_k)


class CSRGrid(NamedTuple):
    """Device-side CSR grid buffers. All layouts are *sorted*: position s
    holds the point with the s-th smallest Morton cell code."""
    order: torch.Tensor     # (n,) int32: sorted position -> original index
    q_sorted: torch.Tensor  # (T*chunk, 3) f32 sorted queries, edge-padded
    cands: torch.Tensor     # (3, n_cand) f32 planar sorted candidates, +BIG
    starts: torch.Tensor    # (T,) int32 slab starts (elements, mult. block_k)
    nblk: torch.Tensor      # (T,) int32 live blocks per tile slab
    overflow: torch.Tensor  # () bool: a tile's window outgrew the slab
    codes: torch.Tensor     # (n,) int32 sorted Morton cell codes


def csr_cells(points: torch.Tensor, side, origin, dims: int,
              bits: int) -> torch.Tensor:
    """Quantized cell coords, clipped to the real-cell range
    [0, 2^bits - 3]. The two top indices stay free: 2^bits - 2 for clipped
    window neighbors, 2^bits - 1 reserved for padding sentinels.

    ``side`` and ``origin`` are a Python float and tuple (the single-device
    plan: 1 / side rounded once from f64 to f32, as the reference does with
    a Python float), or f32 tensors on the points' device (the distributed
    engine, whose plan lives on the device: 1 / side is then an f32
    division, as in the reference, with no host read)."""
    if isinstance(side, torch.Tensor):
        inv = 1.0 / side
        org = origin
    else:
        inv = torch.tensor(1.0 / side, dtype=points.dtype,
                           device=points.device)
        org = torch.tensor(origin, dtype=points.dtype, device=points.device)
    # clamped before the cast: a coordinate far outside the domain (a
    # serving query, a +BIG padding row) saturates instead of overflowing
    # int32, as the reference's saturating cast does
    c = torch.clamp(torch.floor((points - org) * inv), 0,
                    (1 << bits) - 3).to(torch.int32)
    if dims == 2:
        c[:, 2] = 0
    return c


def _csr_window_bounds(sorted_codes, cells, dims: int, bits: int):
    """Per query cell: [lo, hi) positions in the code-sorted corpus covering
    the occupied runs of all 9/27 window cells. Empty window cells are
    excluded (their insertion point would needlessly widen the slab)."""
    n = sorted_codes.shape[0]
    m = cells.shape[0]
    dev = cells.device
    rng = (-1, 0, 1)
    offs = [(dx, dy, dz) for dx in rng for dy in rng
            for dz in (rng if dims == 3 else (0,))]
    lo = torch.full((m,), n, dtype=torch.int32, device=dev)
    hi = torch.zeros((m,), dtype=torch.int32, device=dev)
    cell_cap = (1 << bits) - 2
    for off in offs:
        nb = torch.clamp(cells + torch.tensor(off, dtype=torch.int32,
                                              device=dev), 0, cell_cap)
        if dims == 2:
            nb[:, 2] = 0
        code = _kref.morton_encode_ref(nb, dims=dims)
        left = torch.searchsorted(sorted_codes, code, out_int32=True)
        right = torch.searchsorted(sorted_codes, code, out_int32=True,
                                   right=True)
        occupied = right > left
        lo = torch.minimum(lo, torch.where(occupied, left, n))
        hi = torch.maximum(hi, torch.where(occupied, right, 0))
    return lo, hi


def _csr_layout(points, side: float, origin: tuple, dims: int, bits: int):
    """Shared sort-by-cell pass: identical arithmetic runs at plan time and
    build time, so the plan's slab capacity is valid for the build. The
    sort is stable, as ``jnp.argsort`` is: ties in the Morton code keep
    their input order."""
    cells = csr_cells(points, side, origin, dims, bits)
    codes = _kref.morton_encode_ref(cells, dims=dims)
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]
    lo, hi = _csr_window_bounds(sorted_codes, cells[order], dims, bits)
    return order.to(torch.int32), points[order], lo, hi, sorted_codes


def _edge_pad_index(n: int, length: int, device) -> torch.Tensor:
    """Rows ``0 .. length-1`` with those past ``n`` repeating row n-1."""
    return torch.clamp(torch.arange(length, device=device), max=max(n - 1, 0))


def tile_slabs(lo, hi, n: int, *, n_tiles: int, chunk: int, block_k: int,
               slab: int, n_cand: int):
    """Reduce per-query window bounds to per-tile slab (start, nblk).

    Queries beyond ``n`` are edge-repeated. ``overflow`` fires when a
    tile's window outgrows the static ``slab`` capacity.
    """
    bk = block_k
    pad_idx = _edge_pad_index(n, n_tiles * chunk, lo.device)
    lo_t = lo[pad_idx].reshape(n_tiles, chunk).amin(dim=1)
    hi_t = hi[pad_idx].reshape(n_tiles, chunk).amax(dim=1)
    start = torch.clamp(torch.div(lo_t, bk, rounding_mode="floor") * bk, 0,
                        n_cand - slab)
    need = hi_t - start
    overflow = torch.any(need > slab)
    nblk = torch.clamp(torch.div(need + bk - 1, bk, rounding_mode="floor"), 0,
                       slab // bk)
    return start.to(torch.int32), nblk.to(torch.int32), overflow


def slab_payload_min(payload, starts, nblk, *, block_k: int,
                     max_blocks: int):
    """Per-tile min of ``payload`` over the tile's live slab blocks.

    payload (n_cand,) int32 — sorted-layout plane (INT32_MAX padding);
    returns (T,) int32. A block-granular min, then one (T, max_blocks)
    gather masked by ``j < nblk``: a few passes over the payload plane, far
    below one sweep.
    """
    nb_tot = payload.shape[0] // block_k
    blk_min = payload.reshape(nb_tot, block_k).amin(dim=1)
    starts_blk = torch.div(starts, block_k, rounding_mode="floor")
    j = torch.arange(max_blocks, device=payload.device)
    idx = torch.clamp(starts_blk[:, None].long() + j, 0, nb_tot - 1)
    vals = torch.where(j < nblk[:, None], blk_min[idx], INT32_MAX)
    return vals.amin(dim=1).to(torch.int32)


def slab_touched(flags, starts, nblk, n: int, *, block_k: int):
    """Per-tile "any flagged point in my slab" — the dirty-block test.

    flags (n,) bool in sorted layout; returns (T,) bool. One prefix sum
    over the point plane, then a two-gather range count per tile's
    contiguous slab ``[starts, starts + nblk·block_k)``.
    """
    cum = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                 device=flags.device),
                     torch.cumsum(flags.to(torch.int32), 0,
                                  dtype=torch.int32)])
    lo = torch.clamp(starts, 0, n).long()
    hi = torch.clamp(starts + nblk * block_k, 0, n).long()
    return cum[hi] > cum[lo]


def compact_tiles(live):
    """Compact live tile ids to the front: (active (T,) int32, n_live ()
    int32), both on ``live``'s device and computed there without a host
    sync.

    Entries at positions >= n_live repeat the last live id (0 when none),
    the park contract of ``kernels/frontier_sweep.py``. Dead tiles scatter
    to one spare slot past the end, which is cut off.
    """
    T = live.shape[0]
    idx = torch.arange(T, dtype=torch.int32, device=live.device)
    n_live = live.sum(dtype=torch.int32)
    pos = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    active = torch.zeros((T + 1,), dtype=torch.int32, device=live.device)
    active[torch.where(live, pos, T).long()] = idx
    active = active[:T]
    park = active[torch.clamp(n_live - 1, 0, max(T - 1, 0)).reshape(1)
                  .long()]
    return torch.where(idx < n_live, active, park), n_live


def plan_csr_grid(points_np: np.ndarray, eps: float, *, dims: int = 3,
                  chunk: int = 256, block_k: int = 512,
                  margin_blocks: int = 1, device=None) -> CSRGridSpec:
    """Host-side planning pass for the CSR engine.

    Runs the same sort-by-cell layout the build runs (on ``device``,
    ``None`` meaning ``cuda``) and measures the worst per-tile slab extent,
    so the sweep shapes are static yet sized by *actual* occupancy.
    ``side`` grows beyond ε only when the extent exceeds the Morton bit
    budget.
    """
    n = len(points_np)
    if n < 1:
        raise ValueError("plan_csr_grid needs at least one point")
    pts = np.asarray(points_np, np.float32)
    origin = tuple(float(v) for v in pts.min(axis=0))
    bits = 15 if dims == 2 else 10
    ext = float((pts.max(axis=0) - pts.min(axis=0))[:dims].max())
    side = float(eps)
    max_cells = (1 << bits) - 2
    if math.floor(ext / side) + 1 > max_cells:
        side = ext / (max_cells - 1) * (1 + 1e-5)
    dev = resolve_device(device)
    _, _, lo, hi, _ = _csr_layout(torch.as_tensor(pts, device=dev), side,
                                  origin, dims, bits)
    lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
    T = max(1, -(-n // chunk))
    pad_idx = np.minimum(np.arange(T * chunk), n - 1)
    lo_t = lo[pad_idx].reshape(T, chunk).min(axis=1)
    hi_t = hi[pad_idx].reshape(T, chunk).max(axis=1)
    need = int((hi_t - (lo_t // block_k) * block_k).max())
    slab = -(-max(need, 1) // block_k) * block_k + margin_blocks * block_k
    n_cand = max(-(-n // block_k) * block_k, slab)
    return CSRGridSpec(side=side, origin=origin, dims=dims, bits=bits,
                       chunk=chunk, block_k=block_k, n=n, n_tiles=T,
                       slab=slab, n_cand=n_cand)


def build_csr_grid(points: torch.Tensor, spec: CSRGridSpec) -> CSRGrid:
    """CSR build on the points' device: sort by cell code, derive per-tile
    slabs.

    The ``overflow`` flag guards the plan/build parity contract (it fires
    only if the build's quantization disagrees with the plan beyond the slab
    margin — callers should check it once per build).
    """
    n = points.shape[0]
    order, spoints, lo, hi, codes = _csr_layout(points, spec.side,
                                                spec.origin, spec.dims,
                                                spec.bits)
    starts, nblk, overflow = tile_slabs(
        lo, hi, n, n_tiles=spec.n_tiles, chunk=spec.chunk,
        block_k=spec.block_k, slab=spec.slab, n_cand=spec.n_cand)
    q_sorted = spoints[_edge_pad_index(n, spec.n_tiles * spec.chunk,
                                       points.device)].contiguous()
    cands = torch.full((3, spec.n_cand), BIG, dtype=torch.float32,
                       device=points.device)
    cands[:, :n] = spoints.T
    return CSRGrid(order=order, q_sorted=q_sorted, cands=cands,
                   starts=starts, nblk=nblk, overflow=overflow, codes=codes)


def spec_from_fields(d: dict, kind=CSRGridSpec):
    """A plan of ``kind`` (``CSRGridSpec``, ``GridSpec`` or
    ``bvh.WavefrontSpec``) from a plain dict of its fields (for example
    ``dataclasses.asdict`` of the reference's spec)."""
    kw = {f.name: d[f.name] for f in dataclasses.fields(kind)}
    if "origin" in kw:
        kw["origin"] = tuple(float(v) for v in kw["origin"])
    return kind(**kw)


_FLOAT_FIELDS = ("q_sorted", "cands", "points")
_BOOL_FIELDS = ("overflow", "valid")


def grid_from_arrays(d: dict, device, kind=CSRGrid):
    """A built grid of ``kind`` (``CSRGrid`` or ``Grid``) on ``device`` from
    numpy arrays of its fields (for example those of the reference's
    ``CSRGrid`` or ``Grid``)."""
    def dtype(name):
        return (torch.float32 if name in _FLOAT_FIELDS else
                torch.bool if name in _BOOL_FIELDS else torch.int32)
    return kind(**{
        name: torch.as_tensor(np.array(d[name]),  # an owned, writable copy
                              dtype=dtype(name), device=device)
        for name in kind._fields})
