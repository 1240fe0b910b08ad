"""Cross-corpus CSR slab ε-sweep: the serving tier's inner loop.

Every other slab sweep is a self-join (n points against themselves).
Serving asks the asymmetric question: fresh query points against a frozen
corpus whose cell-sorted layout was built once at snapshot time. Query tile
``t`` (rows ``[t·block_q, (t+1)·block_q)`` of the Morton-sorted queries)
sweeps the ``nblk[t]`` corpus blocks of ``block_k`` columns that start at
block ``starts_blk[t]`` of the planar ``(3, nc)`` corpus. The payload
``croot`` (``(1, nc)``, the reference kernel's layout) holds the cluster
label of core corpus points and INT32_MAX elsewhere. Per query:

  * ``counts``  — corpus points with d² ≤ ε² (queries are not corpus
    members, so there is no self term);
  * ``minroot`` — min ``croot`` over those hits, INT32_MAX when none: the
    DBSCAN-predict answer;
  * ``mind2``   — min d² over the hits whose ``croot`` is not INT32_MAX,
    +inf when none: the distance to the deciding core point.

Three parts, as in ``csr_sweep.py``: the CUDA kernel (``csrc/csr_sweep.cu``:
``csr_sweep``'s box pass, cull pass and persistent sweep of the runs that
come within ε of the query tile's box, with a third output that the sweep
folds as ``atomicMin`` on the bits of d², exact for the non-negative,
non-NaN d² of a hit), its wrapper, and the plain PyTorch version. The
runs the kernel keeps are ``csr_sweep.kept_runs_plain`` of the same
inputs. CPU tensors go to the plain version; CUDA tensors launch the kernel
or raise. All three outputs of the two are bit-identical, the float one
included: both take the min over the very d² values the hit test compared,
and a skipped run holds no hit.
"""
from __future__ import annotations

import torch

from .. import trace
from . import build
from .csr_sweep import (_check, _cuda_or_raise, _eps2_f32, _scratch,
                        _sweep_plain, kept_runs_plain, record_work,
                        run_width, work_plain)

# Launches since the last reset_launches(); the plain version never counts.
LAUNCHES = {"cross_sweep": 0}


def reset_launches() -> None:
    LAUNCHES["cross_sweep"] = 0


def _payload(croot, cands_planar) -> torch.Tensor:
    """The (1, nc) payload as the (nc,) plane the slab checks expect."""
    nc = cands_planar.shape[1] if cands_planar.dim() == 2 else -1
    if croot.shape != (1, nc):
        raise ValueError(f"croot {tuple(croot.shape)} != (1, {nc})")
    return croot.reshape(-1)


def cross_sweep_plain(queries, cands_planar, croot, starts_blk, nblk, eps2,
                      *, max_blocks: int, block_k: int = 512):
    """Plain PyTorch version of :func:`cross_sweep` (any device)."""
    return _sweep_plain(queries, cands_planar,
                        _payload(croot, cands_planar), starts_blk, nblk,
                        eps2, max_blocks=max_blocks, block_k=block_k,
                        with_mind2=True)


def cross_sweep(queries, cands_planar, croot, starts_blk, nblk, eps2, *,
                max_blocks: int, block_q: int = 256, block_k: int = 512):
    """Cross-corpus count, min core label and min core d² over per-tile
    slabs.

    queries      (T·block_q, 3) f32 — Morton-sorted query tiles (fresh
                                      points), +BIG padding rows
    cands_planar (3, nc) f32        — cell-sorted frozen corpus, nc a
                                      multiple of block_k, +BIG padded
    croot        (1, nc) int32      — cluster label if core else INT32_MAX
    starts_blk   (T,) int32         — slab start per tile, in blocks
    nblk         (T,) int32         — live blocks per tile, ≤ max_blocks
    eps2         float              — ε², rounded once to f32
    Returns counts (T·block_q,) int32, minroot (T·block_q,) int32,
    mind2 (T·block_q,) f32.
    """
    plane = _payload(croot, cands_planar)
    _check(queries, cands_planar, plane, starts_blk, nblk,
           max_blocks=max_blocks, block_q=block_q, block_k=block_k)
    if queries.device.type == "cpu":
        if trace.is_recording():
            record_work(work_plain(kept_runs_plain(
                queries, cands_planar, starts_blk, nblk, eps2,
                max_blocks=max_blocks, block_k=block_k)),
                run_width(block_k), block_q)
        return cross_sweep_plain(queries, cands_planar, croot, starts_blk,
                                 nblk, eps2, max_blocks=max_blocks,
                                 block_k=block_k)
    _cuda_or_raise(queries, "cross_sweep")
    # fresh outputs each call: the kernel's cull pass sets them to 0,
    # INT32_MAX and +inf, then its sweep adds and mins into them
    counts = torch.empty(queries.shape[0], dtype=torch.int32,
                         device=queries.device)
    minroot = torch.empty_like(counts)
    mind2 = torch.empty(queries.shape[0], dtype=torch.float32,
                        device=queries.device)
    if starts_blk.shape[0] == 0:
        return counts, minroot, mind2
    run, boxes, items, counters = _scratch(
        queries, cands_planar, starts_blk, max_blocks=max_blocks,
        block_k=block_k)
    build.launch("csr_sweep", "cross_sweep_launch", "pppppfiiiiiipppppp",
                 "cross_sweep", queries.device, queries, cands_planar, plane,
                 starts_blk, nblk, _eps2_f32(eps2), starts_blk.shape[0],
                 block_q, cands_planar.shape[1], max_blocks, block_k, run,
                 counts, minroot, mind2, boxes, items, counters)
    build.count(LAUNCHES, "cross_sweep")
    record_work(counters[0::2], run, block_q)
    return counts, minroot, mind2
