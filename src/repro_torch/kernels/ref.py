"""Plain tensor code the main path shares with the kernels.

``_dist2`` is the one d² every slab sweep (kernel and plain version) must
reproduce bit for bit: f32, one coordinate at a time in ascending order,
``acc = acc + d * d`` with every operation rounded on its own — never an
FMA (``addcmul`` or a contracted multiply-add rounds once and flips hits
at d² = ε²). ``morton_encode_ref`` is the Morton code of the grid build;
as in the reference path it is plain tensor code, not a kernel.
``pad_to`` pads the kernels' inputs (with ``BIG`` coordinates and an
INT32_MAX payload, by the wrappers' conventions).
"""
from __future__ import annotations

import numpy as np
import torch

INT_MAX = 2**31 - 1
BIG = 1e30


def round_up(x: int, m: int) -> int:
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


def eps2_tensor(eps2: float, device) -> torch.Tensor:
    """ε² rounded once to f32, as a 0-dim tensor on ``device``: the plain
    versions compare d² with it (a comparison with a Python float is not
    promised to round ε² the same way)."""
    # a fill on the device: no host-to-device copy to wait for
    return torch.full((), float(np.float32(eps2)), dtype=torch.float32,
                      device=device)


def _dist2(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance, (..., D) vs (..., D), broadcast-safe.

    Math is always f32 regardless of storage dtype, accumulated in
    ascending coordinate order with separate subtract, multiply and add.
    """
    shape = torch.broadcast_shapes(q.shape[:-1], c.shape[:-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=q.device)
    for k in range(q.shape[-1]):
        d = q[..., k].to(torch.float32) - c[..., k].to(torch.float32)
        acc = acc + d * d
    return acc


def morton_encode_ref(coords: torch.Tensor, dims: int = 3) -> torch.Tensor:
    """30-bit Morton (Z-order) code from quantized integer coords.

    coords (n, 3) int32: 10 bits per axis for 3D, 15 bits per axis for 2D
    (the z column is ignored when dims == 2). Returns (n,) int32.
    """
    def expand3(x):  # 10 -> 30 bits, 2-bit gaps
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    def expand2(x):  # 15 -> 30 bits, 1-bit gaps
        x = x & 0x7FFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    coords = coords.to(torch.int32)
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    if dims == 2:
        return (expand2(x) | (expand2(y) << 1)).to(torch.int32)
    return (expand3(x) | (expand3(y) << 1) | (expand3(z) << 2)).to(torch.int32)
