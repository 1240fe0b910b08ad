"""Pre-gathered window ε-sweep: the grid-hash engine's inner loop.

Query row ``r`` of ``queries`` (b, 3) sweeps its own window of ``k``
candidates: row ``r`` of each plane of the planar ``(3, b, k)`` candidate
array, with the fused payload ``croot`` (b, k) = root if the candidate is
valid and core, else INT32_MAX. Invalid and padded candidates carry +BIG
coordinates, so they never count. Returns per row the count of window
candidates with d² ≤ ε² and the min ``croot`` over those hits (INT32_MAX
when none).

Three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/gathered_sweep.cu``: one warp per query row, 16-byte loads
coalesced along ``k``), its wrapper, and the plain PyTorch version. CPU
tensors go to the plain version; CUDA tensors launch the kernel or raise.
Integer outputs of the two are bit-identical.
"""
from __future__ import annotations

import torch

from . import build
from .csr_sweep import _cuda_or_raise, _eps2_f32
from .ref import INT_MAX, _dist2, eps2_tensor

# Launches since the last reset_launches(); the plain version never counts.
LAUNCHES = {"gathered_sweep": 0}


def reset_launches() -> None:
    LAUNCHES["gathered_sweep"] = 0


def _check(queries, cands_planar, croot):
    for name, x, dtype in (("queries", queries, torch.float32),
                           ("cands_planar", cands_planar, torch.float32),
                           ("croot", croot, torch.int32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on "
                             f"{queries.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b = queries.shape[0]
    if queries.dim() != 2 or queries.shape[1] != 3:
        raise ValueError(f"queries {tuple(queries.shape)} must be (b, 3)")
    if cands_planar.dim() != 3 or cands_planar.shape[:2] != (3, b) \
            or cands_planar.shape[2] % 4:
        raise ValueError(f"cands_planar {tuple(cands_planar.shape)} must be "
                         f"(3, {b}, k) with k a multiple of 4")
    if croot.shape != cands_planar.shape[1:]:
        raise ValueError(f"croot {tuple(croot.shape)} != "
                         f"{tuple(cands_planar.shape[1:])}")
    if queries.device.type == "cuda" and any(
            x.data_ptr() % 16 for x in (cands_planar, croot)):
        raise ValueError("cands_planar and croot must be 16-byte aligned")


def gathered_sweep_plain(queries, cands_planar, croot, eps2):
    """Plain PyTorch version of :func:`gathered_sweep` (any device)."""
    eps2_t = eps2_tensor(eps2, queries.device)
    hit = _dist2(queries[:, None, :], cands_planar.permute(1, 2, 0)) <= eps2_t
    counts = hit.sum(dim=1, dtype=torch.int32)
    if croot.shape[1] == 0:
        return counts, torch.full_like(counts, INT_MAX)
    return counts, torch.where(hit, croot, INT_MAX).amin(dim=1)


def gathered_sweep(queries, cands_planar, croot, eps2):
    """Fused filter + min-payload over per-query candidate windows.

    queries      (b, 3) f32       — padded rows may hold +BIG
    cands_planar (3, b, k) f32    — per-row windows, k a multiple of 4,
                                    invalid and padded candidates +BIG
    croot        (b, k) int32     — root if valid and core, else INT32_MAX
    eps2         float            — ε², rounded once to f32
    Returns counts (b,) int32, minroot (b,) int32.
    """
    _check(queries, cands_planar, croot)
    if queries.device.type == "cpu":
        return gathered_sweep_plain(queries, cands_planar, croot, eps2)
    _cuda_or_raise(queries, "gathered_sweep")
    b, k = croot.shape
    counts = torch.empty(b, dtype=torch.int32, device=queries.device)
    minroot = torch.empty_like(counts)
    if b == 0:
        return counts, minroot
    build.launch("gathered_sweep", "gathered_sweep_launch", "pppfiipp",
                 "gathered_sweep", queries.device, queries, cands_planar,
                 croot, _eps2_f32(eps2), b, k, counts, minroot)
    LAUNCHES["gathered_sweep"] += 1
    return counts, minroot
