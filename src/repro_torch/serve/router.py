"""Scatter-gather serving tier over Morton-range shards (DESIGN.md §15),
with each shard an isolated failure domain behind the router (§16).

:class:`ShardedTier` is the multi-device form of :class:`ServeSession`:
one :class:`~repro_torch.serve.shard.ShardMap` routes every request to
the shards it can touch, per-shard ``ClusterSnapshot``s (placed
round-robin on the host's cards via ``distributed.shard_devices``) answer in
shard-local label space, and the gather remaps + min-merges back to the
global answer — bit-identical to the single-snapshot path (§15.3).

**Query path.** ``assign`` computes each query's ε-dilated tier window,
bisects the window cell codes against the global sorted codes, and
scatters the batch's sub-sets to the 1–2 shards owning occupied runs
(`ShardMap.window_shards`). Each shard runs the same bucketed
``cross_sweep`` program ``assign`` always ran — one shared
:class:`BucketScheduler` fronts all shards (and their replicas) as the
load balancer, and because program keys carry the shard's plan, its
``recompiles`` count (distinct program keys) stays honest across the
tier. The gather is three
monotone merges: counts **sum**, minroot **min** (after the shard-local
→ global label-table remap, which is monotone because the table is
ascending), mind2 **min** (IEEE sqrt is monotone, so min-of-dist equals
dist-of-min bit-for-bit).

**Failure domains (§16).** Every scatter leg consults a
:class:`~repro_torch.serve.health.HealthRegistry` keyed by ``(shard,
replica)``: the round-robin turn-holder among *live* replicas serves;
retryable :class:`ServeError`s are absorbed by jittered exponential
backoff honoring ``retry_after``; a failing target is abandoned and the
leg **fails over** down the replica ring; a *suspect* turn-holder is
optionally **hedged** — the leg is duplicated to a second live replica
and the first result wins, the loser's work discarded (replicas share
the shard's buffers, so both compute identical bits: the hedge buys
latency, never a different answer). A ``faults.Kill`` inside a leg is
the *target's* death, not the router's — it quarantines the target
immediately instead of propagating. When a whole leg exhausts its ring,
the gather goes **partial**: the merged result carries ``partial=True``
and per-shard :class:`LegStatus` rows, and the min/sum merge contract
makes the degradation direction provable — a missing shard can only
*lose* neighbors (counts are a lower bound, labels/dist upper bounds),
never invent them (§16.3). Quarantined shards re-materialize from their
checkpoint namespace (:meth:`recover_shard`, backgrounded when
``auto_recover``), re-certified by active probes before serving again.

**Ingest path.** Deltas split by Morton ownership (`ShardMap.owner_of`)
into per-shard ``ServeSession`` buffers — per-shard WAL offsets,
per-shard checkpoint namespaces, per-shard online labeling. Only the
primary owns the write path (replicas are read copies), so ingest never
fails over: a dying owner quarantines the shard and the chunk sheds as
*retryable* — it never reached the ack log, orphan pieces on sibling
shards are dropped by the next rebuild, and the client's idempotent
retry after recovery is absorbed piece-wise by each session's dedup
window. Compaction is *triggered* per shard (a full or due buffer) but
*executed* at tier scope: cluster labels are a global connectivity
property (a boundary point's core status needs neighbors from both
sides), so the tier rebuilds from the canonical corpus + the
arrival-ordered chunk log — exactly the concatenation order the single
``ServeSession`` compacts — then re-splits and hands every session its
new shard through :meth:`ServeSession.adopt_snapshot`. One
regrowing/failing rebuild trips the *shared* circuit breaker (the
rebuild is tier-global, a different failure domain than any one shard):
every shard keeps serving its last published snapshot, answers carry
``degraded``/``staleness``, and overflowing ingests shed with the
owning shard named in the error (DESIGN.md §15.4).

**Replication.** ``replicate(shard_id)`` adds read replicas of a hot
shard; the router round-robins ``assign`` traffic across them, skipping
quarantined copies (a down replica never stalls the slot's turn).
Replicas share the shard's plan, so they add zero new program keys (and
on multi-card hosts each replica is copied onto its own slot).

**Threads.** A hedged leg runs two ``assign`` calls at once on a thread
pool, so two host threads launch ``cross_sweep`` onto one card's current
stream; the kernels' first build and their launch counters are guarded
by a lock in ``kernels/build.py``.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import time
from collections import Counter, OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import distributed as dist
from . import faults
from .assign import AssignResult, assign
from .health import DOWN, HEALTHY, SUSPECT, HealthRegistry
from .ingest import IngestResult, ServeSession, _digest
from .resilience import (AdmissionError, AdmissionQueue, Backoff,
                         CircuitBreaker, CompactionError, ServeError,
                         ValidationError, validate_points, CLOSED)
from .scheduler import BucketScheduler
from .shard import ShardMap, split_snapshot, target_tag
from .snapshot import ClusterSnapshot, build_snapshot
from .wal import WriteAheadLog

INT64_MAX = np.iinfo(np.int64).max


class LegStatus(NamedTuple):
    """Outcome of one assign scatter leg — the per-shard row in
    ``AssignResult.shards`` (§16.3)."""
    state: str           # health state of the serving target after the leg
    replica: int         # replica that answered; -1 = none (missing)
    staleness: int       # this shard's ingested-but-unfolded delta points
    degraded: bool       # shard serving under deferred compaction / missing
    missing: bool = False  # leg exhausted: the shard contributed NOTHING
    #                        (its neighbors are lost from the merge, never
    #                        invented — see AssignResult.partial)
    retries: int = 0     # retryable errors absorbed by backoff
    failovers: int = 0   # targets abandoned before the answer
    hedged: bool = False  # a duplicate leg was issued to a second replica


class ShardedTier:
    """Morton-range shards behind a scatter-gather router (module
    docstring; DESIGN.md §15–16). Build one with :meth:`build`, or from
    an existing global snapshot with :meth:`from_snapshot`.

    Router knobs: ``n_shards`` (requested; the effective count can be
    smaller when code-run snapping collapses cuts), ``block_q`` /
    ``scheduler`` (shared bucket ladder + telemetry), ``max_delta_frac``
    / ``delta_capacity`` (per-shard ingest buffer policy),
    ``ckpt_root``/``wal_root`` (durable mode: per-shard checkpoint
    namespaces ``shard-00j`` + per-shard WAL directories), ``devices``
    (placement override for :func:`distributed.shard_devices`; by default
    every visible card when the snapshot is on one, else the snapshot's
    own device).

    Failure-domain knobs (§16): ``health`` (per-target registry; bring
    your own for an injectable clock), ``hedge`` (duplicate a suspect
    turn-holder's leg to a second replica), ``leg_retries`` + ``backoff``
    (retryable-error budget per target and its jittered delay ladder),
    ``allow_partial`` (exhausted legs degrade to a partial gather instead
    of raising), ``auto_recover`` (quarantined shards re-materialize in
    the background), ``sleep`` (injectable for deterministic backoff
    tests).
    """

    def __init__(self, shard_map: ShardMap, parts: list, *, corpus,
                 eps: float, min_pts: int, n_shards: int,
                 engine: str = "grid",
                 block_q: int = 256,
                 scheduler: Optional[BucketScheduler] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 admission: Optional[AdmissionQueue] = None,
                 max_delta_frac: float = 0.25,
                 delta_capacity: int = 1 << 14,
                 dedup_window: int = 1024,
                 ckpt_root: Optional[str] = None,
                 wal_root: Optional[str] = None,
                 durability: str = "fsync", keep: int = 3,
                 devices=None,
                 health: Optional[HealthRegistry] = None,
                 hedge: bool = True,
                 leg_retries: int = 2,
                 backoff: Optional[Backoff] = None,
                 allow_partial: bool = True,
                 auto_recover: bool = True,
                 sleep=time.sleep):
        self.eps = float(eps)
        self.min_pts = int(min_pts)
        self.engine = engine
        self.block_q = block_q
        self.n_shards_requested = int(n_shards)
        self.max_delta_frac = max_delta_frac
        self.delta_capacity = delta_capacity
        self.dedup_window = dedup_window
        self.ckpt_root = ckpt_root
        self.wal_root = wal_root
        self.durability = durability
        self.keep = keep
        self.scheduler = scheduler or BucketScheduler(min_bucket=block_q)
        self.breaker = breaker or CircuitBreaker()
        self.admission = admission or AdmissionQueue()
        self.health = health or HealthRegistry()
        self.hedge = hedge
        self.leg_retries = int(leg_retries)
        self.backoff = backoff or Backoff()
        self.allow_partial = allow_partial
        self.auto_recover = auto_recover
        self._sleep = sleep
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._recovering: set = set()
        self._recovery_futures: dict = {}
        # the device every global build (compaction) runs on: the
        # snapshot's; shards are placed from there
        self.device = parts[0].snapshot.device
        if devices is None and self.device.type != "cuda":
            devices = [self.device]
        self._devices = dist.shard_devices(
            max(len(parts), 1), devices)
        self._multi_device = len(set(self._devices)) > 1
        # canonical state: the corpus in original order plus the arrival-
        # ordered log of fully-acked chunks — together they ARE the
        # single-session concatenation order, which is what makes tier
        # compaction bit-identical to the single-snapshot path (§15.4)
        self._corpus = np.asarray(corpus, np.float32)
        self._chunks: list = []
        self._dedup: OrderedDict = OrderedDict()
        self.n_compactions = 0
        self._compaction_deferred = False
        self._routing = False  # reentrancy guard: no compaction while a
        #                        chunk is mid-scatter (§15.4)
        self._replica_counts: dict = {}
        self._extra_replicas: dict = {}
        self._rr: Counter = Counter()
        self.replica_served: Counter = Counter()
        self.map = shard_map
        self.parts: list = []
        self.sessions: list = []
        self._adopt(shard_map, list(parts))

    # --- construction -------------------------------------------------------

    @classmethod
    def build(cls, points, eps: float, min_pts: int, *, n_shards: int,
              engine: str = "grid", device=None,
              **knobs) -> "ShardedTier":
        """Cluster ``points`` globally on ``device`` (``None`` means
        ``cuda``), split by Morton range, bring up one session per
        shard."""
        snap = build_snapshot(points, eps, min_pts, engine=engine,
                              device=device)
        return cls.from_snapshot(snap, n_shards=n_shards, **knobs)

    @classmethod
    def from_snapshot(cls, snapshot: ClusterSnapshot, *, n_shards: int,
                      **knobs) -> "ShardedTier":
        """Split an existing global snapshot (shards are built on its
        device) and bring up one session per shard."""
        smap, parts = split_snapshot(snapshot, n_shards)
        return cls(smap, parts, corpus=snapshot.points.cpu().numpy(),
                   eps=snapshot.eps, min_pts=snapshot.min_pts,
                   n_shards=n_shards, engine=snapshot.engine, **knobs)

    def _slot(self, shard_id: int, replica: int = 0) -> torch.device:
        """The device of a shard (or one of its replicas)."""
        if not self._multi_device:
            return self.device
        devs = self._devices
        return devs[(shard_id + replica * len(self.parts)) % len(devs)]

    def _place(self, shard_id: int, snapshot: ClusterSnapshot,
               replica: int = 0) -> ClusterSnapshot:
        """Pin a shard (or one of its replicas) to its device slot.
        Single-device hosts skip the copy — placement is then identity
        and replicas share the shard's buffers."""
        if not self._multi_device:
            return snapshot
        return snapshot.to(self._slot(shard_id, replica))

    def _make_session(self, shard_id: int,
                      snapshot: ClusterSnapshot) -> ServeSession:
        sid = target_tag(shard_id, None)
        wal = None
        if self.wal_root is not None:
            wal = WriteAheadLog(os.path.join(self.wal_root, sid),
                                durability=self.durability)
        return ServeSession(
            snapshot,
            # the session never self-decides compaction policy — the tier
            # owns the due-check and the rebuild (on_compact delegate)
            max_delta_frac=float("inf"),
            delta_capacity=self.delta_capacity,
            scheduler=self.scheduler,
            block_q=self.block_q, ckpt_dir=self.ckpt_root,
            breaker=self.breaker, admission=AdmissionQueue(),
            dedup_window=self.dedup_window, wal=wal, keep=self.keep,
            session_id=sid, ckpt_namespace=sid,
            on_compact=lambda _j=shard_id: self._compact_for(_j))

    def _adopt(self, smap: ShardMap, parts: list) -> None:
        """Swap in a re-split tier (initial bring-up and every
        compaction): existing sessions adopt their new shard in place
        (keeping WAL/checkpoint/dedup continuity), extra sessions are
        retired, missing ones created, replicas re-materialized at their
        configured counts."""
        self.map = smap
        for sess in self.sessions[len(parts):]:
            if sess.wal is not None:
                sess.wal.close()
        new_sessions = []
        for j, part in enumerate(parts):
            snap = self._place(j, part.snapshot)
            if j < len(self.sessions):
                sess = self.sessions[j]
                sess.adopt_snapshot(snap)
            else:
                sess = self._make_session(j, snap)
            new_sessions.append(sess)
        self.sessions = new_sessions
        self.parts = list(parts)
        self._extra_replicas = {
            j: [self._place(j, parts[j].snapshot, replica=r + 1)
                for r in range(self._replica_counts.get(j, 0))]
            for j in range(len(parts))}

    # --- shape / status ------------------------------------------------------

    @property
    def n_shards(self) -> int:
        """Effective shard count (≤ requested — cut snapping)."""
        return len(self.parts)

    @property
    def n(self) -> int:
        return len(self._corpus) + sum(len(c) for c in self._chunks)

    @property
    def n_delta(self) -> int:
        return sum(s.n_delta for s in self.sessions)

    def _n_replicas(self, shard_id: int) -> int:
        return 1 + len(self._extra_replicas.get(shard_id, []))

    def _replica_snapshots(self, shard_id: int) -> list:
        return ([self.sessions[shard_id].snapshot]
                + self._extra_replicas.get(shard_id, []))

    @property
    def quarantined(self) -> list:
        """Shard ids with no live serving copy (every target down)."""
        return [j for j in range(len(self.parts))
                if self.health.quarantined(j, self._n_replicas(j))]

    @property
    def degraded(self) -> bool:
        return (self._compaction_deferred
                or self.breaker.state != CLOSED
                or any(s._compaction_deferred for s in self.sessions)
                or bool(self.quarantined))

    # --- replication / load balancing ---------------------------------------

    def replicate(self, shard_id: int, copies: int = 1) -> int:
        """Add ``copies`` read replicas of a hot shard; returns the new
        replica count (serving copies = count + 1). Replicas follow
        compactions automatically."""
        if not 0 <= shard_id < len(self.parts):
            raise ValueError(f"no shard {shard_id} (have {len(self.parts)})")
        cur = self._replica_counts.get(shard_id, 0)
        self._replica_counts[shard_id] = cur + int(copies)
        reps = self._extra_replicas.setdefault(shard_id, [])
        for r in range(cur, cur + int(copies)):
            reps.append(self._place(shard_id,
                                    self.parts[shard_id].snapshot,
                                    replica=r + 1))
        return self._replica_counts[shard_id]

    # --- queries ------------------------------------------------------------

    def warmup(self, max_nq: int = 1024) -> None:
        """Run every shard's (and replica's) bucket ladder once, so a
        variable request stream meets no new program key (and any slab
        regrow happens here, not on live traffic). Queries are corpus
        points of the shard itself — live windows, realistic slabs."""
        for j, part in enumerate(self.parts):
            p0 = part.snapshot.points[:1].cpu().numpy()
            for b in self.scheduler.buckets_upto(max_nq):
                q = np.tile(p0, (b, 1))
                for snap in self._replica_snapshots(j):
                    assign(snap, q, scheduler=self.scheduler,
                           block_q=self.block_q)

    def assign(self, queries) -> AssignResult:
        """Scatter-gather DBSCAN-predict (module docstring). With every
        routed shard serving, the merged answer is bit-identical to
        single-snapshot ``assign`` on the unsplit corpus — the §15.3
        invariant the parity suite gates. With a shard quarantined and
        ``allow_partial`` on, the answer is the §16.3 *restriction*:
        exactly the full merge minus the missing shard's contribution."""
        q_np = validate_points(queries, name="queries")
        ticket = self.admission.admit(len(q_np))
        t0 = time.perf_counter()
        try:
            return self._assign_admitted(q_np)
        finally:
            self.admission.finish(ticket, time.perf_counter() - t0)

    def _assign_admitted(self, q_np: np.ndarray) -> AssignResult:
        t0 = time.perf_counter()
        mask = self.map.window_shards(q_np)
        self.scheduler.note_route(mask.sum(axis=1))
        nq = len(q_np)
        counts = np.zeros(nq, np.int32)
        merged = np.full(nq, INT64_MAX, np.int64)
        dist_m = np.full(nq, np.inf, np.float32)
        bucket = 0
        staleness = 0
        partial = False
        shard_status: dict = {}
        for j in range(len(self.parts)):
            idx = np.nonzero(mask[:, j])[0]
            if idx.size == 0:
                continue
            r, status = self._assign_leg(j, q_np[idx])
            shard_status[int(j)] = status
            staleness += status.staleness
            if r is None:
                # exhausted leg: the gather goes PARTIAL. The merge
                # direction is provable from the min/sum contract — this
                # shard's contribution could only have raised counts and
                # lowered labels/dist, so the partial answer loses its
                # neighbors, never invents any (§16.3)
                partial = True
                continue
            bucket += r.bucket
            table = self.parts[j].label_table.astype(np.int64)
            if table.size:
                glab = np.where(r.labels >= 0,
                                table[np.clip(r.labels, 0, None)],
                                INT64_MAX)
            else:
                glab = np.full(idx.size, INT64_MAX, np.int64)
            merged[idx] = np.minimum(merged[idx], glab)
            counts[idx] += r.counts
            dist_m[idx] = np.minimum(dist_m[idx], r.dist)
        if partial:
            self.scheduler.note_partial()
        labels = np.where(merged != INT64_MAX, merged, -1).astype(np.int32)
        return AssignResult(
            labels=labels, counts=counts, dist=dist_m, bucket=bucket,
            seconds=time.perf_counter() - t0, staleness=staleness,
            degraded=self.degraded or partial, partial=partial,
            shards=shard_status)

    def _leg_status(self, j: int, *, replica: int, missing: bool,
                    retries: int, failovers: int,
                    hedged: bool) -> LegStatus:
        return LegStatus(
            state=(DOWN if missing
                   else self.health.state((j, replica))),
            replica=replica,
            staleness=int(self.sessions[j].n_delta),
            degraded=bool(self.sessions[j]._compaction_deferred or missing),
            missing=missing, retries=retries, failovers=failovers,
            hedged=hedged)

    def _assign_leg(self, j: int, q_sub: np.ndarray) -> tuple:
        """One scatter leg behind the health registry (§16.2): serve the
        round-robin turn-holder among live replicas, hedge a suspect
        turn-holder to a second live copy (first result wins), absorb
        retryable errors with jittered backoff, and fail over down the
        ring. Exhaustion returns ``(None, status)`` — the partial-gather
        path — or re-raises the last error when ``allow_partial`` is
        off."""
        remaining = self.health.candidates(j, self._n_replicas(j),
                                           start=self._rr[j])
        self._rr[j] += 1
        retries = failovers = 0
        hedged = False
        last_err = None
        while remaining:
            rep = remaining.pop(0)
            if (self.hedge and remaining
                    and self.health.state((j, rep)) == SUSPECT):
                alt = next((r2 for r2 in remaining
                            if self.health.state((j, r2)) == HEALTHY),
                           remaining[0])
                remaining.remove(alt)
                hedged = True
                r, winner, n_retry, err = self._hedged_pair(j, rep, alt,
                                                            q_sub)
                retries += n_retry
                if err is not None:
                    last_err = err
                if r is not None:
                    self.replica_served[(j, winner)] += 1
                    return r, self._leg_status(
                        j, replica=winner, missing=False, retries=retries,
                        failovers=failovers, hedged=True)
                failovers += 2
                self.scheduler.note_failover()
                continue
            r, n_retry, err = self._try_target(j, rep, q_sub)
            retries += n_retry
            if err is not None:
                last_err = err
            if r is not None:
                self.replica_served[(j, rep)] += 1
                return r, self._leg_status(
                    j, replica=rep, missing=False, retries=retries,
                    failovers=failovers, hedged=hedged)
            failovers += 1
            self.scheduler.note_failover()
        # ring exhausted (or empty: the whole shard is quarantined)
        self._maybe_schedule_recovery(j)
        if not self.allow_partial:
            self._reraise(last_err, j)
        return None, self._leg_status(j, replica=-1, missing=True,
                                      retries=retries, failovers=failovers,
                                      hedged=hedged)

    def _try_target(self, j: int, rep: int, q_sub: np.ndarray) -> tuple:
        """Bounded serve attempt(s) against one target; returns
        ``(result | None, retries_used, last_error)``. A ``faults.Kill``
        here is the *target's* death, not the router's — the failure-
        domain boundary — so it is absorbed: the target quarantines
        immediately and the leg fails over. Any other exception escaping
        the shard's program is likewise confined to its domain (recorded
        as a target failure, leg fails over) — only the single-session
        path lets it propagate."""
        key = (j, rep)
        tag = target_tag(j, rep)
        snaps = self._replica_snapshots(j)
        err = None
        for attempt in range(self.leg_retries + 1):
            t0 = time.perf_counter()
            try:
                faults.fire("serve.shard.assign", tag)
                r = assign(snaps[rep], q_sub, scheduler=self.scheduler,
                           block_q=self.block_q)
            except faults.Kill:
                self.health.force_down(key)
                return None, attempt, AdmissionError(
                    f"{tag} died serving an assign leg; quarantined for "
                    "re-materialization",
                    retry_after=self._recover_hint(),
                    session_id=target_tag(j, None))
            except ServeError as e:
                err = e
                self.health.record_failure(key)
                if e.retryable and attempt < self.leg_retries:
                    self.scheduler.note_leg_retry()
                    self._sleep(self.backoff.delay(attempt, e.retry_after))
                    continue
                return None, attempt, e
            except Exception as e:
                err = e
                self.health.record_failure(key)
                return None, attempt, e
            self.health.record_success(key, time.perf_counter() - t0)
            return r, attempt, None
        return None, self.leg_retries, err

    def _hedged_pair(self, j: int, rep: int, alt: int,
                     q_sub: np.ndarray) -> tuple:
        """§16.2 hedge: run the suspect turn-holder and a second live
        replica concurrently; the first successful result wins and the
        loser's work is discarded. Replicas share the shard's buffers,
        so both compute the same bits — the race is about latency and
        availability, never the answer. A loser still in flight keeps
        running on the pool and lands its health signal when it
        finishes."""
        self.scheduler.note_hedge()
        ex = self._executor()
        futs = {ex.submit(self._try_target, j, r, q_sub): r
                for r in (rep, alt)}
        result, winner, err, retries = None, -1, None, 0
        pending = set(futs)
        while pending and result is None:
            done, pending = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
            for f in done:
                r, n_retry, e = f.result()
                retries += n_retry
                if e is not None:
                    err = e
                if r is not None and result is None:
                    result, winner = r, futs[f]
        return result, winner, retries, err

    def _reraise(self, err, j: int):
        """Re-raise a leg's terminal error at tier scope, naming the
        shard and PRESERVING ``retry_after`` — the backoff hint the
        underlying session computed must survive the router's wrapping
        (clients price their retry on it)."""
        sid = target_tag(j, None)
        if err is None:
            raise AdmissionError(
                f"{sid}: no live replica (quarantined); retry after "
                "re-materialization", retry_after=self._recover_hint(),
                session_id=sid)
        if isinstance(err, ServeError):
            details = dict(err.details)
            details["session_id"] = sid
            raise type(err)(f"{sid}: {err}", retry_after=err.retry_after,
                            **details) from err
        raise err

    def _recover_hint(self) -> float:
        """``retry_after`` for requests shed on a quarantined shard: with
        background recovery running the wait is one re-materialize, not
        a full breaker window."""
        return 0.05 if self.auto_recover else self.health.recover_after_s

    def _executor(self) -> cf.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=max(4, 2 * max(len(self.parts), 1)),
                thread_name_prefix="shard-tier")
        return self._pool

    # --- health: probes, quarantine, recovery -------------------------------

    def probe(self, shard_id: int, replica: int = 0) -> bool:
        """Active heartbeat (§16.1): a 1-point ``assign`` of the shard's
        own first corpus point against the target's snapshot, bounded by
        the registry's ``probe_deadline_s`` — a stalled target *fails*
        its probe even when it eventually answers, because to a latency
        SLO slow is down. The 1-point batch pads to the smallest bucket
        warmup already ran, so probes add no program key. The outcome
        lands in the health registry with ``probe=True``."""
        j, rep = int(shard_id), int(replica)
        key = (j, rep)
        tag = target_tag(j, rep)
        snaps = self._replica_snapshots(j)
        if not 0 <= rep < len(snaps):
            raise ValueError(f"no replica {rep} of shard {j}")
        self.scheduler.note_probe()
        q = self.parts[j].probe_point
        t0 = time.perf_counter()
        try:
            faults.fire("serve.shard.probe", tag)
            assign(snaps[rep], q, scheduler=self.scheduler,
                   block_q=self.block_q)
        except faults.Kill:
            self.health.record_failure(key, probe=True)
            self.health.force_down(key)
            return False
        except Exception:
            self.health.record_failure(
                key, probe=True, latency_s=time.perf_counter() - t0)
            return False
        dt = time.perf_counter() - t0
        if dt > self.health.probe_deadline_s:
            self.health.record_failure(key, probe=True, latency_s=dt)
            return False
        self.health.record_success(key, dt, probe=True)
        return True

    def probe_all(self) -> dict:
        """Heartbeat every serving target; ``{target_tag: ok}``."""
        return {target_tag(j, r): self.probe(j, r)
                for j in range(len(self.parts))
                for r in range(self._n_replicas(j))}

    def _maybe_schedule_recovery(self, j: int) -> None:
        if (self.auto_recover and j not in self._recovering
                and self.health.quarantined(j, self._n_replicas(j))):
            self._recovering.add(j)
            self._recovery_futures[j] = self._executor().submit(
                self._recover_bg, j)

    def _recover_bg(self, j: int) -> bool:
        try:
            return self.recover_shard(j)
        except BaseException:
            return False
        finally:
            self._recovering.discard(j)

    def join_recovery(self, timeout: Optional[float] = None) -> bool:
        """Block until in-flight background re-materializations finish;
        True when none remain pending and all of them succeeded."""
        futs = dict(self._recovery_futures)
        if not futs:
            return True
        done, pending = cf.wait(set(futs.values()), timeout=timeout)
        if pending:
            return False
        self._recovery_futures.clear()
        return all(f.result() for f in done)

    def recover_shard(self, shard_id: int) -> bool:
        """Re-materialize one quarantined shard (§16.4).

        Durable tiers rebuild the shard's session from its own
        checkpoint namespace + WAL (:meth:`ServeSession.recover` —
        newest intact snapshot, delta replayed past the watermark);
        non-durable tiers re-place the tier's in-memory part (the dead
        shard's unfolded delta died with it, but every *acked* chunk
        lives in the tier's canonical log and returns at the next
        compaction). Replicas re-materialize from the recovered
        snapshot, then every target must pass an active probe before
        the shard leaves quarantine; a failed re-materialize leaves it
        quarantined for the next attempt. Synchronous — the
        ``auto_recover`` background path wraps it.
        """
        j = int(shard_id)
        sid = target_tag(j, None)
        n_reps = 1 + self._replica_counts.get(j, 0)
        keys = [(j, r) for r in range(n_reps)]
        for k in keys:
            self.health.begin_recovery(k)
        try:
            faults.fire("serve.shard.rematerialize", sid)
            old = self.sessions[j]
            if self.wal_root is not None and self.ckpt_root is not None:
                if old.wal is not None:
                    try:
                        old.wal.close()
                    except Exception:
                        pass
                self.sessions[j] = ServeSession.recover(
                    self.ckpt_root, os.path.join(self.wal_root, sid),
                    durability=self.durability, device=self._slot(j),
                    max_delta_frac=float("inf"),
                    delta_capacity=self.delta_capacity,
                    scheduler=self.scheduler,
                    block_q=self.block_q, breaker=self.breaker,
                    admission=AdmissionQueue(),
                    dedup_window=self.dedup_window, keep=self.keep,
                    session_id=sid, ckpt_namespace=sid,
                    on_compact=lambda _j=j: self._compact_for(_j))
            else:
                self.sessions[j] = self._make_session(
                    j, self._place(j, self.parts[j].snapshot))
            self._extra_replicas[j] = [
                self._place(j, self.sessions[j].snapshot, replica=r + 1)
                for r in range(self._replica_counts.get(j, 0))]
        except BaseException:
            # Kill included: death *during* re-materialize leaves the
            # shard quarantined for the next attempt (§16.4)
            for k in keys:
                self.health.end_recovery(k, ok=False)
            return False
        for k in keys:
            self.health.end_recovery(k, ok=True)
        # certify: every target answers a live heartbeat before the
        # shard is trusted with traffic again
        ok = True
        for r in range(n_reps):
            ok &= self.probe(j, r)
        return bool(ok)

    def health_report(self) -> dict:
        """Operator view (§16): per-target health rows (state,
        consecutive failures, last leg/probe latency, served count) next
        to the tier's routing/serving telemetry — the README ops table's
        one-call dashboard."""
        targets = {}
        for j in range(len(self.parts)):
            for r in range(self._n_replicas(j)):
                t = self.health.target((j, r))
                targets[target_tag(j, r)] = {
                    "state": self.health.state((j, r)),
                    "consecutive_failures": t.consecutive_failures,
                    "failures": t.n_failures,
                    "successes": t.n_successes,
                    "probes": t.n_probes,
                    "last_latency_s": t.last_latency_s,
                    "last_probe_s": t.last_probe_s,
                    "last_probe_ok": t.last_probe_ok,
                    "served": int(self.replica_served.get((j, r), 0)),
                }
        sch = self.scheduler
        p50, p99 = sch.latency_percentiles()
        return {
            "targets": targets,
            "quarantined": [target_tag(q, None) for q in self.quarantined],
            "recovering": sorted(target_tag(q, None)
                                 for q in self._recovering),
            "scheduler": {
                "calls": sch.calls, "recompiles": sch.recompiles,
                "regrows": sch.regrows, "failovers": sch.failovers,
                "hedges": sch.hedges, "leg_retries": sch.leg_retries,
                "probes": sch.probes, "partials": sch.partials,
                "p50_s": p50, "p99_s": p99,
            },
        }

    # --- ingest -------------------------------------------------------------

    def ingest(self, chunk, *,
               request_id: Optional[str] = None) -> IngestResult:
        """Route a chunk to its owning shards and label it online.

        Atomicity posture (§15.4): deterministic failures (validation,
        capacity, a quarantined owner) are pre-flighted before any shard
        is touched; a mid-scatter label failure or owner death leaves
        earlier pieces in their shard buffers but the chunk *unacked* —
        those orphans never reach the canonical log, so the next tier
        compaction (rebuilding from corpus + acked chunks only) sheds
        them, and an idempotent retry under the same ``request_id`` is
        absorbed piece-wise by each session's dedup window. Online
        labels of fresh (corpus-free) clusters are deterministic and
        collision-free across shards:
        ``tier.n + shard_id + n_shards * local_index``.
        """
        chunk = validate_points(chunk, name="chunk")
        ticket = self.admission.admit(len(chunk))
        t0 = time.perf_counter()
        try:
            return self._ingest_admitted(chunk, request_id)
        finally:
            self.admission.finish(ticket, time.perf_counter() - t0)

    def _ingest_admitted(self, chunk: np.ndarray,
                         request_id: Optional[str]) -> IngestResult:
        if request_id is not None and self.dedup_window > 0:
            hit = self._dedup.get(request_id)
            if hit is not None:
                digest, result = hit
                if digest != _digest(chunk):
                    raise ValidationError(
                        f"request_id {request_id!r} replayed with a "
                        "different payload — at-least-once delivery must "
                        "not mutate the request", request_id=request_id)
                return result._replace(deduped=True)
        owner = self.map.owner_of(chunk)
        need = np.bincount(owner, minlength=len(self.parts))
        if np.any(need > self.delta_capacity):
            j = int(np.argmax(need))
            raise ValidationError(
                f"chunk routes {int(need[j])} points to shard {j}, over "
                f"delta_capacity={self.delta_capacity}; split it or raise "
                "the capacity")
        down = sorted({int(j) for j in np.unique(owner)
                       if self.health.quarantined(int(j),
                                                  self._n_replicas(int(j)))})
        if down:
            # writes have one owner: a quarantined owner sheds the whole
            # chunk *before* any scatter (no partial state to orphan)
            for j in down:
                self._maybe_schedule_recovery(j)
            sids = ", ".join(target_tag(j, None) for j in down)
            raise AdmissionError(
                f"tier: owning shard(s) {sids} quarantined "
                "(re-materializing); chunk shed before any scatter — "
                "retry idempotently after recovery",
                retry_after=self._recover_hint(), session_id=sids)
        over = [j for j in range(len(self.parts))
                if self.sessions[j].n_delta + need[j] > self.delta_capacity]
        if over:
            # fold the tier first; shed the whole chunk (no partial state)
            # when the breaker is holding compaction
            if not self._compact_maybe():
                sids = ", ".join(target_tag(j, None) for j in over)
                raise AdmissionError(
                    f"tier: delta buffer(s) full on {sids} and compaction "
                    "is circuit-broken; retry after the breaker's next "
                    "probe window",
                    retry_after=max(self.breaker.retry_after(), 0.001),
                    n_delta=self.n_delta, session_id=sids)
            owner = self.map.owner_of(chunk)  # re-split moved the cuts
        labels = np.full(len(chunk), -1, np.int64)
        degraded = False
        self._routing = True
        try:
            for j in np.unique(owner):
                idx = np.nonzero(owner == j)[0]
                rid = (f"{request_id}/{target_tag(int(j), None)}"
                       if request_id is not None else None)
                res = self._ingest_leg(int(j), chunk[idx], rid)
                labels[idx] = self._remap_online(int(j), res.labels)
                degraded |= res.degraded
        finally:
            self._routing = False
        # the chunk is fully applied: it enters the canonical log (ack)
        self._chunks.append(np.array(chunk, np.float32, copy=True))
        compacted = False
        if self._compaction_due() and self._compact_maybe():
            compacted = True
        result = IngestResult(
            labels=labels.astype(np.int32), compacted=compacted,
            n_delta=self.n_delta, degraded=degraded or self.degraded)
        if request_id is not None and self.dedup_window > 0:
            self._dedup[request_id] = (_digest(chunk), result)
            while len(self._dedup) > self.dedup_window:
                self._dedup.popitem(last=False)
        return result

    def _ingest_leg(self, j: int, piece: np.ndarray,
                    rid: Optional[str]) -> IngestResult:
        """One ingest scatter leg (§16.2). Only the shard's *primary*
        owns the write path (replicas are read copies), so ingest never
        fails over — a dying owner quarantines the shard and the chunk
        sheds as *retryable*: it never reached the ack log, orphan
        pieces already landed on sibling shards are dropped by the next
        rebuild, and the client's idempotent retry after recovery is
        absorbed by the dedup window. Retryable session errors go
        through the same jittered backoff as assign legs; terminal ones
        re-raise at tier scope with ``retry_after`` preserved."""
        key = (j, 0)
        tag = target_tag(j, 0)
        err = None
        for attempt in range(self.leg_retries + 1):
            t0 = time.perf_counter()
            try:
                faults.fire("serve.shard.ingest", tag)
                res = self.sessions[j].ingest(piece, request_id=rid)
            except faults.Kill:
                self.health.force_down(key)
                self._maybe_schedule_recovery(j)
                raise AdmissionError(
                    f"{tag} died mid-ingest; the chunk is UNACKED (orphan "
                    "pieces on sibling shards shed at the next rebuild) — "
                    "retry idempotently after recovery",
                    retry_after=self._recover_hint(),
                    session_id=target_tag(j, None)) from None
            except ServeError as e:
                err = e
                self.health.record_failure(key)
                if e.retryable and attempt < self.leg_retries:
                    self.scheduler.note_leg_retry()
                    self._sleep(self.backoff.delay(attempt, e.retry_after))
                    continue
                self._reraise(e, j)
            self.health.record_success(key, time.perf_counter() - t0)
            return res
        self._reraise(err, j)

    def _remap_online(self, shard_id: int,
                      local_labels: np.ndarray) -> np.ndarray:
        """Shard-local online labels -> tier label space. Corpus-anchored
        ids go through the shard's table; fresh-cluster ids (≥ the shard
        corpus size) map to ``tier.n + shard_id + n_shards * local`` —
        deterministic, and distinct shards produce distinct residues so
        fresh clusters can never collide across shards."""
        lab = np.asarray(local_labels).astype(np.int64)
        n_shard = self.sessions[shard_id].snapshot.n
        table = self.parts[shard_id].label_table.astype(np.int64)
        fresh = lab >= n_shard
        anchored = (lab >= 0) & ~fresh
        out = np.full_like(lab, -1)
        if table.size:
            out[anchored] = table[np.clip(lab[anchored], 0, table.size - 1)]
        out[fresh] = (self.n_baseline + shard_id
                      + len(self.parts) * (lab[fresh] - n_shard))
        return out

    @property
    def n_baseline(self) -> int:
        """Corpus size at the last compaction — the base for fresh online
        cluster ids (mirrors the single session's ``n_corpus + idx``)."""
        return len(self._corpus)

    # --- compaction ---------------------------------------------------------

    def _compaction_due(self) -> bool:
        return any(
            s.n_delta >= self.delta_capacity
            or s.n_delta >= self.max_delta_frac * s.snapshot.n
            for s in self.sessions)

    def _compact_for(self, shard_id: int) -> bool:
        """`on_compact` delegate: a shard's full buffer asks the *tier*
        to fold (labels are global — §15.4). Deferred while a chunk is
        mid-scatter or the breaker is open."""
        return self._compact_maybe()

    def _compact_maybe(self) -> bool:
        if self._routing or not self.breaker.allow():
            self._compaction_deferred = True
            return False
        try:
            self.compact(_gated=False)
            return True
        except CompactionError:
            return False

    def compact(self, *, force: bool = False,
                _gated: bool = True) -> None:
        """Tier-global compaction (§15.4): rebuild one global snapshot
        from the canonical corpus + the arrival-ordered acked-chunk log
        (exactly the single session's concatenation order — labels stay
        bit-identical to the unsharded path), re-split by Morton range,
        and hand every session its new shard. Per shard, the swap runs
        through :meth:`ServeSession.adopt_snapshot`: namespaced atomic
        checkpoint publish, WAL watermark, keep-K + WAL GC. Failures trip
        the shared breaker; every shard keeps serving its last published
        snapshot (degraded/staleness-flagged) instead of stalling."""
        if _gated and not force and not self.breaker.allow():
            raise CompactionError(
                "tier compaction circuit breaker is open "
                f"(state={self.breaker.state}); force=True to probe now",
                retry_after=self.breaker.retry_after())
        try:
            faults.fire("serve.compact")  # same chaos site as the single
            #   session: fault suites drive the tier identically
            pts = (np.concatenate([self._corpus] + self._chunks)
                   if self._chunks else self._corpus)
            snap = build_snapshot(pts, self.eps, self.min_pts,
                                  engine=self.engine, device=self.device)
            smap, parts = split_snapshot(snap, self.n_shards_requested)
        except Exception as e:
            self.breaker.record_failure()
            self._compaction_deferred = True
            raise CompactionError(
                f"tier compaction rebuild failed ({type(e).__name__}: "
                f"{e}); all shards keep serving their last published "
                "snapshots", retry_after=self.breaker.retry_after()) from e
        self.breaker.record_success()
        self._corpus = np.asarray(pts, np.float32)
        self._chunks = []
        self._adopt(smap, parts)
        self.n_compactions += 1
        self._compaction_deferred = False

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        for sess in self.sessions:
            if sess.wal is not None:
                sess.wal.close()
