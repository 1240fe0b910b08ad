"""The window bounds of the grid engine's cell-sorted CSR layout.

``window_bounds(sorted_codes, cells, dims, bits)``: per query cell, the
``[lo, hi)`` positions in the code-sorted corpus that cover the occupied
runs of its 9 (2-D) or 27 (3-D) window cells. Window cells are clamped to
``[0, 2^bits - 2]`` (so a padding row at ``2^bits - 1`` clamps like any
other), and empty ones are left out; a window with no occupied cell gives
``(n, 0)``. The layout (``core/grid.py`` ``_csr_layout``), the serving
tier's cross query (``core/neighbors.py``) and the distributed driver's
CSR engine (``distributed/dbscan_dist.py``) all take their bounds here.

Three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/csr_layout.cu``, ``window_bounds_kernel<dims>``: one thread a
query row, the window's bisections in registers), its wrapper, and the
plain PyTorch version (:func:`window_bounds_plain`, the reference's loop
over the offsets: a Morton code and two ``searchsorted`` calls an offset).
CPU tensors go to the plain version; CUDA tensors launch the kernel or
raise. The outputs of the two are bit-identical.

While ``repro_torch.trace`` records, each launch adds one to the
``window_bounds_launches`` counter.
"""
from __future__ import annotations

import torch

from .. import trace
from . import build
from .csr_sweep import _cuda_or_raise
from .ref import morton_encode_ref

# Launches since the last reset_launches(); the plain version never counts.
LAUNCHES = {"window_bounds": 0}


def reset_launches() -> None:
    LAUNCHES["window_bounds"] = 0


def window_bounds_plain(sorted_codes, cells, dims: int, bits: int):
    """Plain PyTorch version of :func:`window_bounds` (any device)."""
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
        code = morton_encode_ref(nb, dims=dims)
        left = torch.searchsorted(sorted_codes, code, out_int32=True)
        right = torch.searchsorted(sorted_codes, code, out_int32=True,
                                   right=True)
        occupied = right > left
        lo = torch.minimum(lo, torch.where(occupied, left, n))
        hi = torch.maximum(hi, torch.where(occupied, right, 0))
    return lo, hi


def window_bounds(sorted_codes, cells, dims: int, bits: int):
    """sorted_codes (n,) int32 ascending, cells (m, 3) int32 → lo, hi (m,)
    int32. ``dims`` is 2 (z not read) or 3; ``bits`` the Morton bits of an
    axis (15 or 10)."""
    if cells.device.type == "cpu":
        return window_bounds_plain(sorted_codes, cells, dims, bits)
    _cuda_or_raise(cells, "window_bounds")
    if sorted_codes.dtype != torch.int32 or cells.dtype != torch.int32:
        raise TypeError(f"sorted_codes and cells must be torch.int32, got "
                        f"{sorted_codes.dtype} and {cells.dtype}")
    if sorted_codes.dim() != 1 or cells.dim() != 2 or cells.shape[1] != 3:
        raise ValueError(f"sorted_codes {tuple(sorted_codes.shape)} and "
                         f"cells {tuple(cells.shape)} must be (n,) and (m, 3)")
    if not (sorted_codes.is_contiguous() and cells.is_contiguous()):
        raise ValueError("sorted_codes and cells must be contiguous")
    if dims not in (2, 3):
        raise ValueError(f"dims must be 2 or 3, got {dims}")
    if sorted_codes.shape[0] >= 1 << 30:
        # a bisection step reaches twice n in int32
        raise ValueError(f"window_bounds takes fewer than 2^30 corpus codes, "
                         f"got {sorted_codes.shape[0]}")
    if sorted_codes.device != cells.device:
        raise ValueError(f"sorted_codes is on {sorted_codes.device}, not "
                         f"{cells.device}")
    m = cells.shape[0]
    lo = torch.empty(m, dtype=torch.int32, device=cells.device)
    hi = torch.empty_like(lo)
    if m == 0:
        return lo, hi
    build.launch("csr_layout", "window_bounds_launch", "pipiiipp",
                 "window_bounds", cells.device, sorted_codes,
                 sorted_codes.shape[0], cells, m, dims, bits, lo, hi)
    build.count(LAUNCHES, "window_bounds")
    trace.count("window_bounds_launches")
    return lo, hi
