"""Cell-sorted CSR layout of the grid engine.

Points are reordered by the Morton code of their ε-cell, so that every query
tile's candidates form one contiguous slab of the sorted array, sized by the
tile's actual local occupancy: O(n) memory and O(n · window) work.

``plan_csr_grid`` (host) runs the same sort-by-cell pass the build runs and
measures the worst per-tile slab extent, which fixes the static slab
capacity; ``build_csr_grid`` (device) sorts and derives per-tile slabs.
``spec_from_fields`` and ``grid_from_arrays`` rebuild a plan and a built
grid from plain fields and numpy arrays, e.g. those of the JAX reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ref as _kref
from .engines import resolve_device

BIG = 1e30
INT32_MAX = np.iinfo(np.int32).max


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


def csr_cells(points: torch.Tensor, side: float, origin: tuple, dims: int,
              bits: int) -> torch.Tensor:
    """Quantized cell coords, clipped to the real-cell range
    [0, 2^bits - 3]. The two top indices stay free: 2^bits - 2 for clipped
    window neighbors, 2^bits - 1 reserved for padding sentinels."""
    # both constants rounded once to the points' f32, as the reference does
    inv = torch.tensor(1.0 / side, dtype=points.dtype, device=points.device)
    org = torch.tensor(origin, dtype=points.dtype, device=points.device)
    c = torch.floor((points - org) * inv).to(torch.int32)
    c = torch.clamp(c, 0, (1 << bits) - 3)
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


def spec_from_fields(d: dict) -> CSRGridSpec:
    """A ``CSRGridSpec`` from a plain dict of its fields (for example
    ``dataclasses.asdict`` of the reference's spec)."""
    kw = {f.name: d[f.name] for f in dataclasses.fields(CSRGridSpec)}
    kw["origin"] = tuple(float(v) for v in kw["origin"])
    return CSRGridSpec(**kw)


def grid_from_arrays(d: dict, device) -> CSRGrid:
    """A ``CSRGrid`` on ``device`` from numpy arrays of a built grid's
    fields (for example those of the reference's ``CSRGrid``)."""
    dtypes = {"q_sorted": torch.float32, "cands": torch.float32,
              "overflow": torch.bool}
    return CSRGrid(**{
        name: torch.as_tensor(np.array(d[name]),  # an owned, writable copy
                              dtype=dtypes.get(name, torch.int32),
                              device=device)
        for name in CSRGrid._fields})
