"""One level of the batched wavefront BVH traversal: the ``bvh`` engine's
inner loop.

The traversal (``core/bvh.py``, ``wavefront_sweep``) keeps a frontier of
(query block, node) entries and expands every live entry into its two
children each level. This function takes the E children of a level, each
carrying B queries, through the two-phase test:

  * **prune** — a column (entry, query) is ``inside`` when every coordinate
    of the query lies in the pre-dilated box ``[dlo, dhi]``; with
    ``bf16_prune`` the query is rounded to the nearest bf16 first (the
    boxes are then outward-rounded bf16 values, so the prune admits a
    superset of the f32 prune);
  * **refine** — ``hit`` = leaf and the exact f32 d² ≤ ε² (``ref._dist2``'s
    arithmetic), whatever the prune dtype; ``minroot`` = ``croot`` if hit,
    else INT32_MAX;
  * **push** — an internal child with at least one useful column: inside,
    and in payload mode (``prune_payload``) ``nmin < bound`` — its subtree's
    min payload can still lower the column's running bound.

Three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/bvh_sweep.cu``, ``bvh_batch_sweep_kernel``: one thread per entry),
its wrapper, and the plain PyTorch version. CPU tensors go to the plain
version; CUDA tensors launch the kernel or raise. All three outputs of the
two are bit-identical.
"""
from __future__ import annotations

import torch

from . import build
from .csr_sweep import _cuda_or_raise, _eps2_f32
from .ref import INT_MAX, _dist2, eps2_tensor

# Launches since the last reset_launches(); the plain version never counts.
LAUNCHES = {"bvh_batch_sweep": 0}

MAX_DIMS = 8     # the kernel's template range of D


def reset_launches() -> None:
    LAUNCHES["bvh_batch_sweep"] = 0


_BOX_DTYPES = (torch.float32, torch.bfloat16)


def _check(queries, dlo, dhi, pt, croot, nmin, leaf, bound, prune_payload):
    if prune_payload and (nmin is None or bound is None):
        raise ValueError("prune_payload needs nmin and bound")
    named = (("queries", queries, torch.float32), ("dlo", dlo, _BOX_DTYPES),
             ("dhi", dhi, dlo.dtype), ("pt", pt, torch.float32),
             ("croot", croot, torch.int32), ("nmin", nmin, torch.int32),
             ("leaf", leaf, torch.int32), ("bound", bound, torch.int32))
    for name, x, dtype in named:
        if x is None:
            continue
        if x.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on "
                             f"{queries.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.dim() != 3:
        raise ValueError(f"queries {tuple(queries.shape)} must be (E, B, D)")
    e, b, d = queries.shape
    for name, x, shape in (("dlo", dlo, (e, d)), ("dhi", dhi, (e, d)),
                           ("pt", pt, (e, d)), ("croot", croot, (e,)),
                           ("nmin", nmin, (e,)), ("leaf", leaf, (e,)),
                           ("bound", bound, (e, b))):
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
    if not 1 <= d <= MAX_DIMS or b < 1:
        raise ValueError(f"queries {tuple(queries.shape)}: need B >= 1 and "
                         f"1 <= D <= {MAX_DIMS}")
    if e >= 2**31:
        raise ValueError(f"{e} entries: over the kernel's int32 count")


def bvh_batch_sweep_plain(queries, dlo, dhi, pt, croot, nmin, leaf, bound,
                          eps2, *, bf16_prune: bool = True,
                          prune_payload: bool = False):
    """Plain PyTorch version of :func:`bvh_batch_sweep` (any device)."""
    qp = queries.to(torch.bfloat16).to(torch.float32) if bf16_prune \
        else queries
    lo, hi = dlo.to(torch.float32), dhi.to(torch.float32)
    inside = ((qp >= lo[:, None, :]) & (qp <= hi[:, None, :])).all(dim=-1)
    lf = (leaf != 0)[:, None]
    hit = lf & (_dist2(queries, pt[:, None, :])
                <= eps2_tensor(eps2, queries.device))
    minroot = torch.where(hit, croot[:, None], INT_MAX).to(torch.int32)
    useful = inside & (nmin[:, None] < bound) if prune_payload else inside
    push = ~lf[:, 0] & useful.any(dim=1)
    return hit.to(torch.int32), minroot, push.to(torch.int32)


def bvh_batch_sweep(queries, dlo, dhi, pt, croot, nmin, leaf, bound, eps2,
                    *, bf16_prune: bool = True, prune_payload: bool = False):
    """Batched prune/refine over one level of (query block, node) entries.

    queries (E, B, D) f32  — B queries per entry; dead entries at −BIG
    dlo/dhi (E, D) f32 or bf16 — pre-dilated prune box (bf16 values when
                             ``bf16_prune``), widened to f32 in the
                             kernel; dead entries +BIG / −BIG
    pt      (E, D) f32     — leaf point (internal entries: don't-care)
    croot   (E,) int32     — leaf payload: root if core else INT32_MAX
    nmin    (E,) int32     — subtree min payload (payload mode only:
                             None otherwise, and so is ``bound``)
    leaf    (E,) int32     — 1 iff the child is a leaf
    bound   (E, B) int32   — per-column running min-root bound
    eps2    float          — ε², rounded once to f32
    Dead entries need only one of their two encodings: box +BIG / −BIG,
    or queries at −BIG (outside every finite box, d² overflows to ∞).
    All contiguous. Returns hit (E, B) int32 ∈ {0, 1}, minroot (E, B)
    int32, push (E,) int32 ∈ {0, 1}.
    """
    _check(queries, dlo, dhi, pt, croot, nmin, leaf, bound, prune_payload)
    kw = dict(bf16_prune=bf16_prune, prune_payload=prune_payload)
    if queries.device.type == "cpu":
        return bvh_batch_sweep_plain(queries, dlo, dhi, pt, croot, nmin, leaf,
                                     bound, eps2, **kw)
    _cuda_or_raise(queries, "bvh_batch_sweep")
    e, b, d = queries.shape
    hit = torch.empty((e, b), dtype=torch.int32, device=queries.device)
    minroot = torch.empty_like(hit)
    push = torch.empty(e, dtype=torch.int32, device=queries.device)
    if e == 0:
        return hit, minroot, push
    build.launch("bvh_sweep", "bvh_batch_sweep_launch", "ppppppppfiiiiiippp",
                 "bvh_batch_sweep", queries.device, queries, dlo, dhi, pt,
                 croot, nmin, leaf, bound, _eps2_f32(eps2), e, b, d,
                 int(dlo.dtype == torch.bfloat16), int(bf16_prune),
                 int(prune_payload), hit, minroot, push)
    LAUNCHES["bvh_batch_sweep"] += 1
    return hit, minroot, push
