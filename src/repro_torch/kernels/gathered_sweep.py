"""The grid-hash engine's ε-sweeps.

``gathered_sweep`` (the reference's kernel contract): query row ``r`` of
``queries`` (b, 3) sweeps its own window of ``k`` candidates, row ``r`` of
each plane of the planar ``(3, b, k)`` candidate array, with the fused
payload ``croot`` (b, k) = root if the candidate is valid and core, else
INT32_MAX. Invalid and padded candidates carry +BIG coordinates, so they
never count. Returns per row the count of window candidates with d² ≤ ε²
and the min ``croot`` over those hits (INT32_MAX when none).

``hash_sweep`` (the engine's sweep): every query sweeps the occupied slots
of the buckets of its 9/27-cell window straight from the (H, C) bucket
table, in one launch. Its plain version is the chunked path the engine ran
before: gather each chunk's windows padded to 9/27 × C slots
(:func:`hash_windows`), then ``gathered_sweep_plain``.

Each has three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/gathered_sweep.cu``), its wrapper, and the plain PyTorch version.
CPU tensors go to the plain version; CUDA tensors launch the kernel or
raise. Integer outputs of the two are bit-identical.
"""
from __future__ import annotations

import torch

from . import build
from .csr_sweep import _cuda_or_raise, _eps2_f32
from .ref import BIG, INT_MAX, _dist2, eps2_tensor, pad_to, round_up

# Launches since the last reset_launches(); the plain versions never count.
LAUNCHES = {"gathered_sweep": 0, "hash_sweep": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def window_args(queries, cands, cand_valid, cand_core, cand_root, *,
                block_b: int = 128, block_k: int = 512):
    """The inputs of :func:`gathered_sweep` from gathered windows (queries
    (b, 3), cands (b, k, 3), masks and roots (b, k)): invalid candidates
    become +BIG coordinates, ``valid & core`` is fused into the payload,
    rows pad to a multiple of ``block_b`` and windows to one of
    ``block_k``, and the window goes planar (3, b, k)."""
    b, k = cands.shape[0], cands.shape[1]
    b_p = round_up(max(b, 1), block_b)
    k_p = round_up(max(k, 1), block_k)
    cands = torch.where(cand_valid[..., None], cands.to(torch.float32), BIG)
    q = pad_to(queries.to(torch.float32), b_p, 0, BIG).contiguous()
    c = pad_to(pad_to(cands, k_p, 1, BIG), b_p, 0, BIG)
    croot = torch.where(cand_valid & cand_core, cand_root, INT_MAX) \
        .to(torch.int32)
    croot = pad_to(pad_to(croot, k_p, 1, INT_MAX), b_p, 0, INT_MAX)
    return q, c.permute(2, 0, 1).contiguous(), croot.contiguous()


def hash_windows(queries, buckets, cell_valid, gpoints, gindex, core, root,
                 chunk: int):
    """Per chunk of ``chunk`` queries (the last padded with +BIG queries,
    bucket 0, invalid cells): the queries and their windows of 9/27
    buckets × C slots, as (queries, candidates, validity, core, root).
    A slot is valid when it holds a point (``gindex >= 0``; padding slots
    hold -1) and its cell is valid: this makes no use of the bucket
    occupancy that :func:`hash_sweep` relies on. Gathering per chunk
    bounds the window buffer to ``chunk`` × 27 × C slots."""
    n, n_off = buckets.shape
    width = gpoints.shape[1] * n_off
    gvalid = gindex >= 0
    gidx = gindex.long().clamp(min=0)           # padding slots: any point
    gcore = gvalid & core[gidx]
    groot = root[gidx]
    n_pad = round_up(n, chunk)
    q = pad_to(queries, n_pad, 0, BIG)
    bkt = pad_to(buckets, n_pad, 0, 0)
    cv = pad_to(cell_valid, n_pad, 0, False)
    for s in range(0, n_pad, chunk):
        bb = bkt[s:s + chunk].long()
        yield (q[s:s + chunk], gpoints[bb].reshape(chunk, width, 3),
               (gvalid[bb] & cv[s:s + chunk, :, None]).reshape(chunk, width),
               gcore[bb].reshape(chunk, width),
               groot[bb].reshape(chunk, width))


def _check_hash(queries, order, buckets, cell_valid, gpoints, gindex,
                occupancy, core, root):
    n = queries.shape[0]
    named = (("queries", queries, torch.float32, (n, 3)),
             ("order", order, torch.int32, (n,)),
             ("buckets", buckets, torch.int32, (n, None)),
             ("cell_valid", cell_valid, torch.bool, tuple(buckets.shape)),
             ("gpoints", gpoints, torch.float32, (None, None, 3)),
             ("gindex", gindex, torch.int32, tuple(gpoints.shape[:2])),
             ("occupancy", occupancy, torch.int32, tuple(gpoints.shape[:1])),
             ("core", core, torch.bool, (None,)),
             ("root", root, torch.int32, tuple(core.shape)))
    for name, x, dtype, shape in named:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on "
                             f"{queries.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dim() != len(shape) or any(
                want is not None and got != want
                for got, want in zip(x.shape, shape)):
            raise ValueError(f"{name} {tuple(x.shape)} must be {shape} "
                             "(None: any)")


def sweep_windows(sweep, queries, order, buckets, cell_valid, gpoints,
                  gindex, occupancy, core, root, eps2, *, chunk: int = 2048):
    """``sweep`` (:func:`gathered_sweep` or :func:`gathered_sweep_plain`)
    over the padded windows of :func:`hash_windows`, chunk by chunk: the
    grid-hash sweep as the engine ran it before :func:`hash_sweep` (the
    inputs are hash_sweep's; ``order`` and ``occupancy`` are not used)."""
    n = queries.shape[0]
    out = [sweep(*window_args(*w), eps2)
           for w in hash_windows(queries, buckets, cell_valid, gpoints,
                                 gindex, core, root, chunk)]
    return (torch.cat([c[:chunk] for c, _ in out])[:n],
            torch.cat([m[:chunk] for _, m in out])[:n])


def hash_sweep_plain(queries, order, buckets, cell_valid, gpoints, gindex,
                     occupancy, core, root, eps2, *, chunk: int = 2048):
    """Plain PyTorch version of :func:`hash_sweep` (any device): the padded
    windows through :func:`gathered_sweep_plain` (:func:`sweep_windows`).
    ``order`` only sets the kernel's visiting order; slot validity comes
    from ``gindex``, not from ``occupancy``, so the kernel's prefix
    assumption is held to an independent reading of the table."""
    return sweep_windows(gathered_sweep_plain, queries, order, buckets,
                         cell_valid, gpoints, gindex, occupancy, core, root,
                         eps2, chunk=chunk)


def hash_sweep(queries, order, buckets, cell_valid, gpoints, gindex,
               occupancy, core, root, eps2, *, chunk: int = 2048):
    """The grid-hash sweep over the (H, C) bucket table.

    queries    (n, 3) f32     — the queries, finite
    order      (n,) int32     — the visiting order (``Grid.order``: bucket-
                                major, so a warp's queries share windows)
    buckets    (n, OFF) int32 — the buckets of each query's 9/27 cells
    cell_valid (n, OFF) bool  — False on a repeated bucket (hash aliasing)
    gpoints    (H, C, 3) f32  — the table; bucket h's points at slots
                                0 .. occupancy[h] - 1
    gindex     (H, C) int32   — the point id of each slot
    occupancy  (H,) int32     — points per bucket
    core       (m,) bool, root (m,) int32 — the payload, by point id
                                (the ids in ``gindex``)
    eps2       float          — ε², rounded once to f32
    chunk      queries per chunk of the plain version's window gather
    Returns counts (n,) int32 and minroot (n,) int32 (min root of the core
    hits, INT32_MAX when none), row i for query i.
    """
    _check_hash(queries, order, buckets, cell_valid, gpoints, gindex,
                occupancy, core, root)
    if queries.device.type == "cpu":
        return hash_sweep_plain(queries, order, buckets, cell_valid, gpoints,
                                gindex, occupancy, core, root, eps2,
                                chunk=chunk)
    _cuda_or_raise(queries, "hash_sweep")
    n = queries.shape[0]
    counts = torch.empty(n, dtype=torch.int32, device=queries.device)
    minroot = torch.empty_like(counts)
    if n == 0:
        return counts, minroot
    build.launch("gathered_sweep", "hash_sweep_launch", "pppppppppfiiipp",
                 "hash_sweep", queries.device, queries, order, buckets,
                 cell_valid, gpoints, gindex, occupancy, core, root,
                 _eps2_f32(eps2), n, buckets.shape[1], gpoints.shape[1],
                 counts, minroot)
    LAUNCHES["hash_sweep"] += 1
    return counts, minroot
