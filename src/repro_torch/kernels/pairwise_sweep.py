"""Tiled brute-force ε-sweep: the brute engine's inner loop.

Every query row of ``queries`` (nq, 3) against every candidate of the
planar ``(3, nc)`` array: per query the count of candidates with d² ≤ ε²
and the min of the fused payload ``croot`` (root if core else INT32_MAX)
over those hits, INT32_MAX when none. Padded candidates carry +BIG
coordinates and an INT32_MAX payload, so they never count.

Three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/csr_sweep.cu``, ``pairwise_sweep_kernel``: the slab-walk body over
every candidate block, one thread block per ``block_q`` queries), its
wrapper, and the plain PyTorch version, which walks query chunks of
``chunk`` rows and candidate blocks of ``block_c`` columns so that its
memory stays bounded. CPU tensors go to the plain version; CUDA tensors
launch the kernel or raise. Integer outputs of the two are bit-identical.
"""
from __future__ import annotations

import torch

from . import build
from .csr_sweep import _cuda_or_raise, _eps2_f32
from .ref import INT_MAX, _dist2, eps2_tensor

# Launches since the last reset_launches(); the plain version never counts.
LAUNCHES = {"pairwise_sweep": 0}

# candidate columns per step of the plain version
_PLAIN_COLS = 16384


def reset_launches() -> None:
    LAUNCHES["pairwise_sweep"] = 0


def _check(queries, cands_planar, croot, *, block_q, block_c):
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
    if queries.dim() != 2 or queries.shape[1] != 3 \
            or queries.shape[0] % block_q:
        raise ValueError(f"queries {tuple(queries.shape)} must be (nq, 3) "
                         f"with nq a multiple of {block_q}")
    if cands_planar.dim() != 2 or cands_planar.shape[0] != 3 \
            or cands_planar.shape[1] % block_c:
        raise ValueError(f"cands_planar {tuple(cands_planar.shape)} must be "
                         f"(3, nc) with nc a multiple of {block_c}")
    if croot.shape != (cands_planar.shape[1],):
        raise ValueError(f"croot {tuple(croot.shape)} != "
                         f"({cands_planar.shape[1]},)")
    if not 1 <= block_q <= 1024:
        raise ValueError(f"block_q = {block_q} outside [1, 1024]")
    if not 1 <= block_c * 16 <= 232_448:
        raise ValueError(f"block_c = {block_c}: stage needs {block_c * 16} "
                         "bytes of shared memory, over the 227 KB limit")


def pairwise_sweep_plain(queries, cands_planar, croot, eps2, *,
                         chunk: int = 2048):
    """Plain PyTorch version of :func:`pairwise_sweep` (any device)."""
    dev = queries.device
    nq, nc = queries.shape[0], cands_planar.shape[1]
    eps2_t = eps2_tensor(eps2, dev)
    counts = torch.zeros((nq,), dtype=torch.int32, device=dev)
    minroot = torch.full((nq,), INT_MAX, dtype=torch.int32, device=dev)
    for s in range(0, nq, chunk):
        q = queries[s:s + chunk, None, :]
        for c0 in range(0, nc, _PLAIN_COLS):
            c = cands_planar[:, c0:c0 + _PLAIN_COLS].T[None]
            hit = _dist2(q, c) <= eps2_t
            counts[s:s + chunk] += hit.sum(dim=1, dtype=torch.int32)
            r = torch.where(hit, croot[None, c0:c0 + _PLAIN_COLS], INT_MAX)
            minroot[s:s + chunk] = torch.minimum(minroot[s:s + chunk],
                                                 r.amin(dim=1))
    return counts, minroot


def pairwise_sweep(queries, cands_planar, croot, eps2, *, block_q: int = 256,
                   block_c: int = 512, chunk: int = 2048):
    """Brute ε-sweep with the fused min-payload.

    queries      (nq, 3) f32  — nq a multiple of block_q, padded with +BIG
    cands_planar (3, nc) f32  — nc a multiple of block_c, padded with +BIG
    croot        (nc,) int32  — root if core else INT32_MAX (padding MAX)
    eps2         float        — ε², rounded once to f32
    chunk        query rows per step of the plain version (its memory)
    Returns counts (nq,) int32, minroot (nq,) int32.
    """
    _check(queries, cands_planar, croot, block_q=block_q, block_c=block_c)
    if queries.device.type == "cpu":
        return pairwise_sweep_plain(queries, cands_planar, croot, eps2,
                                    chunk=chunk)
    _cuda_or_raise(queries, "pairwise_sweep")
    counts = torch.empty(queries.shape[0], dtype=torch.int32,
                         device=queries.device)
    minroot = torch.empty_like(counts)
    if queries.shape[0] == 0:
        return counts, minroot
    build.launch("csr_sweep", "pairwise_sweep_launch", "pppfiiiipp",
                 "pairwise_sweep", queries.device, queries, cands_planar,
                 croot, _eps2_f32(eps2), queries.shape[0], block_q,
                 cands_planar.shape[1], block_c, counts, minroot)
    LAUNCHES["pairwise_sweep"] += 1
    return counts, minroot
