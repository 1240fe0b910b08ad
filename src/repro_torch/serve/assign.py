"""Online DBSCAN-predict against a frozen snapshot.

``assign`` answers the serving question: for a batch of *new* points,
which cluster of the frozen corpus does each belong to? Semantics are the
standard DBSCAN predict rule, made deterministic the same way the batch
path is: a query joins the cluster of its minimum-label ε-reachable core
point; with no core point in range it is noise (−1). Border/noise corpus
points never attract queries (they don't define reachability), which is
why the snapshot's payload plane carries ``label if core else INT32_MAX``.

One call: validate (NaN/Inf/shape/dtype are rejected *before*
quantization), bucket-pad (scheduler), quantize with the corpus plan,
Morton-sort, bisect window bounds against the frozen sorted codes, and run
the ``cross_sweep`` kernel over per-tile slabs on the snapshot's device.
The per-tile slab capacity starts at the corpus plan's and regrows
(double and retry) when a query tile's window outgrows it; the grown value
sticks for the snapshot's plan so steady-state serving never regrows
twice. The regrow loop is bounded (``max_regrow``, default
``MAX_SLAB_REGROW``): exhaustion raises a
:class:`~repro_torch.serve.resilience.CapacityError` naming the final slab
capacity, and every retry is counted in the scheduler's telemetry.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import neighbors as nb
from ..core.engines import synchronize
from . import faults
from .resilience import next_slab, validate_points
from .scheduler import BucketScheduler
from .snapshot import ClusterSnapshot

INT_MAX = np.iinfo(np.int32).max


class AssignResult(NamedTuple):
    labels: np.ndarray   # (nq,) int32: joined cluster label, or -1 noise
    counts: np.ndarray   # (nq,) int32: ε-neighbors in the corpus
    dist: np.ndarray     # (nq,) f32: distance to the nearest deciding core
    #                      point (+inf for noise) — attachment confidence
    bucket: int          # padded batch size served (telemetry)
    seconds: float       # wall-clock of the device work for this call
    staleness: int = 0   # delta points ingested but not visible to this
    #                      answer (the delta watermark; 0 = fully fresh)
    degraded: bool = False  # True when the serving session is running on
    #                      a circuit-broken (failing/stalled) compaction —
    #                      staleness is no longer bounded by the policy
    partial: bool = False   # sharded tier only: at least one routed shard
    #                      contributed nothing (quarantined / leg
    #                      exhausted). Its neighbors are MISSING, never
    #                      invented: the min/sum merge makes counts a
    #                      lower bound and labels/dist upper bounds of
    #                      the full answer
    shards: dict | None = None  # sharded tier only: shard_id →
    #                      router.LegStatus (serving replica, per-shard
    #                      staleness/degraded, retries/failovers/hedged,
    #                      missing flag) for every shard the query batch
    #                      routed to


def assign(snapshot: ClusterSnapshot, queries, *,
           scheduler: BucketScheduler | None = None,
           block_q: int = 256,
           max_regrow: int = nb.MAX_SLAB_REGROW) -> AssignResult:
    """Label ``queries`` (nq, 3) against the frozen ``snapshot``, on the
    snapshot's device.

    Pass a shared ``scheduler`` from a serving loop to get bucketed shapes
    and latency/program-key telemetry across calls; without one an
    ephemeral scheduler still buckets.
    """
    sched = scheduler or BucketScheduler(min_bucket=block_q)
    q_np = validate_points(queries, name="queries")
    q_pad, nq = sched.pad(q_np)
    if q_pad.shape[0] % block_q:
        raise ValueError(
            f"bucket {q_pad.shape[0]} not a multiple of block_q={block_q}; "
            "set the scheduler's min_bucket to a multiple of block_q")
    spec = snapshot.spec
    eps2 = float(snapshot.eps) ** 2
    dev = snapshot.device
    q_dev = torch.as_tensor(q_pad, device=dev)

    slab = snapshot.slab
    t0 = time.perf_counter()

    def program_key(s):
        # the full identity of one cross-query program: plan + shape
        # bucket + slab + tile + device — a scheduler shared across
        # snapshots must not conflate them
        return (spec, q_pad.shape[0], s, block_q, dev)

    for attempt in range(max_regrow + 1):
        fn = nb._csr_cross_query_fn(spec, eps2, slab, block_q)
        counts, minroot, mind2, overflow = fn(
            snapshot.codes, snapshot.cands, snapshot.croot_sorted, q_dev, nq)
        synchronize(dev)
        if not bool(overflow) and not faults.fire("serve.assign.overflow"):
            break
        sched.note_trace(program_key(slab))  # the overflowed attempt ran
        sched.note_regrow()
        slab = next_slab(slab, spec.n_cand, attempt=attempt,
                         max_regrow=max_regrow, what="cross-query")
        snapshot.note_slab(slab)
    seconds = time.perf_counter() - t0
    sched.note_call(program_key(slab), seconds)

    counts = counts[:nq].cpu().numpy()
    minroot = minroot[:nq].cpu().numpy()
    mind2 = mind2[:nq].cpu().numpy()
    labels = np.where(minroot != INT_MAX, minroot, -1).astype(np.int32)
    return AssignResult(labels=labels, counts=counts,
                        dist=np.sqrt(mind2, dtype=np.float32),
                        bucket=q_pad.shape[0], seconds=seconds)
