"""Morton (Z-order) codes of quantized coordinates: the LBVH build's sort
key.

``coords`` (n, 3) int32 → (n,) int32 30-bit codes: 15 bits of x and y
interleaved when ``dims == 2`` (z ignored), else 10 bits of each of x, y
and z. Each coordinate is masked to its bit width first, as in the
reference.

Three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/bvh_sweep.cu``, ``morton_encode_kernel``: one thread per point),
its wrapper, and the plain PyTorch version (``ref.morton_encode_ref``, the
bit chains written as tensor operations). CPU tensors go to the plain
version; CUDA tensors launch the kernel or raise. The two are
bit-identical.
"""
from __future__ import annotations

import torch

from . import build
from .csr_sweep import _cuda_or_raise
from .ref import morton_encode_ref

# Launches since the last reset_launches(); the plain version never counts.
LAUNCHES = {"morton_encode": 0}


def reset_launches() -> None:
    LAUNCHES["morton_encode"] = 0


def morton_encode_plain(coords, dims: int = 3):
    """Plain PyTorch version of :func:`morton_encode` (any device)."""
    return morton_encode_ref(coords, dims=dims)


def morton_encode(coords, *, dims: int = 3):
    """coords (n, 3) int32, contiguous → (n,) int32 Morton codes."""
    if coords.dtype != torch.int32:
        raise TypeError(f"coords must be torch.int32, got {coords.dtype}")
    if coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords {tuple(coords.shape)} must be (n, 3)")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    if coords.device.type == "cpu":
        return morton_encode_plain(coords, dims=dims)
    _cuda_or_raise(coords, "morton_encode")
    n = coords.shape[0]
    codes = torch.empty(n, dtype=torch.int32, device=coords.device)
    if n == 0:
        return codes
    build.launch("bvh_sweep", "morton_encode_launch", "piip", "morton_encode",
                 coords.device, coords, n, dims, codes)
    build.count(LAUNCHES, "morton_encode")
    return codes
