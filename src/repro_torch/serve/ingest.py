"""Streaming ingest: a bounded delta buffer over a frozen snapshot.

The snapshot is immutable (that is what makes it cheap to query and safe
to publish); new points land in a small *delta* buffer and are labeled
online on the snapshot's device at every ingest:

  1. **cross-sweep** of the delta against the frozen corpus (the same
     ``cross_sweep`` slab walk ``assign`` uses), giving both corpus
     neighbor counts and the corpus-cluster anchor per delta point,
  2. **self-sweep** of the delta (``pairwise_sweep`` all-pairs — the delta
     is bounded, so O(d²) beats building a structure per chunk),
  3. **union-find hooking** over the delta (``core.dbscan.hook_rounds``,
     the loop the batch drivers run, one ``pairwise_sweep`` per round, the
     host checking ``changed`` once a round): delta cores merge among
     themselves, components adopt their minimum corpus anchor label,
     anchor-free components open fresh clusters labeled
     ``n_corpus + min delta index`` (deterministic).

Online labels are exact DBSCAN over (frozen corpus ∪ delta) *except* that
corpus points keep their snapshot labels — a delta point can promote a
corpus border point to core or bridge two corpus clusters, and the frozen
half won't reflect that until **compaction**: once the delta exceeds a
configured fraction of the corpus (or its capacity), the session
re-clusters the concatenated dataset from scratch through the ordinary
batch path and freezes a new snapshot. Compaction is parity-tested: its
labels are bit-identical to ``dbscan()`` on the concatenation, so the
serving path never drifts from the batch semantics for more than one
delta window.

**The resilience envelope.** Compaction runs behind a
:class:`~repro_torch.serve.resilience.CircuitBreaker`: a failed or stalled
rebuild never unpublishes anything (the snapshot swap is the *last* step,
and on-disk publication rides the checkpoint layer's atomic rename), and
once the breaker trips, due-compactions are deferred instead of retried
on the hot path — ``assign`` keeps answering from the last published
snapshot with ``staleness`` (the delta watermark) and ``degraded`` riding
on every answer. Ingest is **idempotent**: chunks may carry a
client-supplied ``request_id``; a bounded dedup window makes replays
(crash-retry, at-least-once upstream) byte-level no-ops that return the
recorded result. Both ingest and assign sit behind a bounded
:class:`~repro_torch.serve.resilience.AdmissionQueue` that sheds load
explicitly (reject + ``retry_after``) on depth/age thresholds.

**Durability.** With a :class:`~repro_torch.serve.wal.WriteAheadLog`
attached, every chunk is logged before it is applied (log → apply → ack),
compactions stamp watermarks, and :meth:`ServeSession.recover` replays the
log suffix past the newest intact snapshot. The WAL and the snapshots are
byte-compatible with the JAX reference's (``repro.serve``), so either
package recovers the other's.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import neighbors as nb
from ..core.dbscan import hook_rounds
from ..distributed import checkpoint as ckpt
from ..kernels import ops
from . import faults
from .assign import AssignResult, assign
from .resilience import (AdmissionQueue, CapacityError, CircuitBreaker,
                         CompactionError, AdmissionError, ServeError,
                         ValidationError, next_slab, validate_points, CLOSED)
from .scheduler import BIG, BucketScheduler
from .snapshot import (ClusterSnapshot, build_snapshot, load_snapshot,
                       published_wal_offsets, save_snapshot)
from .wal import WriteAheadLog

INT_MAX = nb.INT_MAX


class IngestResult(NamedTuple):
    labels: np.ndarray   # (chunk,) int32 online labels of the new points
    compacted: bool      # this ingest crossed the compaction threshold
    n_delta: int         # delta points outstanding after this ingest
    deduped: bool = False    # replayed request_id: recorded result, no-op
    degraded: bool = False   # a due compaction was deferred/failed (the
    #                          breaker is holding it); staleness grows


class RecoveryReport(NamedTuple):
    """What :meth:`ServeSession.recover` did."""
    baseline_step: int       # checkpoint step the recovery loaded
    baseline_offset: int     # that snapshot's WAL watermark (replay start)
    replayed_chunks: int     # ingest records applied past the watermark
    replayed_points: int
    skipped_aborted: int     # ABORT-neutralized records (in-process fails)
    skipped_duplicates: int  # byte-duplicated frames (same seq) skipped
    truncated_bytes: int     # torn tail dropped by the WAL open scan
    compactions: int         # compactions the replay itself triggered


def _scatter_min(idx, values, size: int):
    """``out[idx] min= values`` over an INT32_MAX-filled (size,) int32."""
    out = torch.full((size,), INT_MAX, dtype=torch.int32,
                     device=values.device)
    return out.scatter_reduce_(0, idx.long(), values.to(torch.int32), "amin",
                               include_self=True)


@functools.lru_cache(maxsize=32)
def _delta_label_fn(spec, eps2: float, min_pts: int, n_corpus: int,
                    slab: int, block_q: int, max_rounds: int = 64):
    """Labels of the whole (padded) delta buffer: one cross query against
    the corpus, then ``pairwise_sweep`` self-joins of the delta with
    host-checked hooking rounds in between."""
    cross = nb._csr_cross_query_fn(spec, eps2, slab, block_q)

    def label(codes, cands, croot_sorted, dpts, d: int):
        D = dpts.shape[0]
        iota = torch.arange(D, dtype=torch.int32, device=dpts.device)
        valid = iota < d
        # corpus side: neighbor counts + per-point cluster anchor
        counts_x, anchor, _, overflow = cross(codes, cands, croot_sorted,
                                              dpts, d)
        # delta side: self-join counts (padded rows sit at +BIG; their
        # mutual zero-distance hits are confined to invalid lanes)
        zeros = torch.zeros((D,), dtype=torch.bool, device=dpts.device)
        counts_s, _ = ops.pairwise_sweep(dpts, dpts, zeros, iota, eps2)
        counts = counts_x + counts_s            # self included via self-join
        core_d = valid & (counts >= min_pts)

        # hook delta cores into components (the batch drivers' rounds)
        root, _ = hook_rounds(
            core_d,
            lambda root: ops.pairwise_sweep(dpts, dpts, core_d, root,
                                            eps2)[1],
            max_rounds)

        # per component: min corpus anchor over core members, else a fresh
        # deterministic cluster id (n_corpus + min delta index of a core)
        anchor_comp = _scatter_min(root, torch.where(core_d, anchor, INT_MAX),
                                   D)[root.long()]
        comp_min = _scatter_min(root, torch.where(core_d, iota, INT_MAX),
                                D)[root.long()]
        label_core = torch.where(anchor_comp != INT_MAX, anchor_comp,
                                 comp_min + n_corpus)
        # border attachment: min over (delta core neighbors' final labels,
        # corpus core neighbors' labels); neither in range -> noise
        _, m2 = ops.pairwise_sweep(dpts, dpts, core_d, label_core, eps2)
        border = torch.minimum(m2, anchor)
        labels = torch.where(core_d, label_core,
                             torch.where(border != INT_MAX, border, -1))
        return (torch.where(valid, labels, -1).to(torch.int32), counts,
                core_d, overflow)

    return label


def _digest(chunk: np.ndarray) -> bytes:
    """Byte-level identity of a chunk — what makes a replayed request_id
    with *different* payload a detectable client bug, not a silent skip."""
    return hashlib.sha256(np.ascontiguousarray(chunk).tobytes()).digest()


@dataclasses.dataclass
class ServeSession:
    """Stateful serving wrapper: frozen snapshot + delta buffer + buckets
    + the resilience envelope (module docstring; DESIGN.md §10, §12).
    Its tensors live on the snapshot's device, and so does every
    compaction it builds.

    Policy knobs:

    * ``max_delta_frac`` — compaction policy: the delta may grow to this
      fraction of the corpus before a full re-cluster folds it in
      (bounded staleness of the frozen half). ``delta_capacity``
      hard-bounds delta memory regardless of corpus size.
    * ``ckpt_dir`` (optional) republishes each compacted snapshot through
      the atomic checkpoint machinery with a bumped step.
    * ``breaker`` — circuit breaker on compaction/rebuild (default:
      3 consecutive failures open it for 30 s). While it is open, due
      compactions are deferred (``IngestResult.degraded``), ``assign``
      keeps serving the last published snapshot, and an ingest that would
      overflow ``delta_capacity`` is shed with ``AdmissionError``
      (``retry_after`` = the breaker's next-probe time) instead of
      growing without bound.
    * ``admission`` — bounded admission queue for queue-based load
      leveling; ``assign``/``ingest`` submit through it, and the
      burst-mode :meth:`submit`/:meth:`pump` pair exposes the queue
      directly (age-based shedding happens at pump time).
    * ``dedup_window`` — how many recent ``request_id`` results are
      retained to absorb at-least-once replays (0 disables).
    * ``wal`` — a :class:`~repro.serve.wal.WriteAheadLog` makes ingest
      *durable*: every chunk is logged (and synced per the log's
      ``durability``) **before** it is applied, so an acknowledged
      ingest survives process death — :meth:`recover` replays the log
      suffix past the newest intact snapshot's watermark. Requires
      ``ckpt_dir`` (the log replays *onto* a published baseline); if the
      checkpoint dir is empty, the construction publishes the session's
      starting snapshot as step 0 so recovery is possible from the very
      first ingest. ``keep`` bounds the retained snapshot versions
      (watermark-pinned steps are never GC'd — DESIGN.md §14.3).
    * ``session_id`` — names this session in shed/error messages; with
      several sessions in one process (the sharded tier runs one per
      shard) an ``AdmissionError`` must say *which* buffer is full.
    * ``ckpt_namespace`` — scopes this session's checkpoint steps (and
      their keep-K GC + watermark pins) to a subdirectory of
      ``ckpt_dir``; the sharded tier publishes shard ``j`` under
      ``shard-00j`` so shards can never GC each other (DESIGN.md §15).
    * ``on_compact`` — compaction delegate: when set, a due/overflowing
      delta calls it instead of compacting locally (it returns True when
      the owner compacted, False when deferred). The sharded tier owns
      compaction because cluster labels are a *global* connectivity
      property — a shard cannot re-cluster alone (DESIGN.md §15.4); the
      tier folds every shard's delta in canonical order and hands each
      session its new shard via :meth:`adopt_snapshot`.
    """
    snapshot: ClusterSnapshot
    max_delta_frac: float = 0.25
    delta_capacity: int = 1 << 14
    scheduler: BucketScheduler | None = None
    block_q: int = 256
    ckpt_dir: str | None = None
    breaker: CircuitBreaker | None = None
    admission: AdmissionQueue | None = None
    dedup_window: int = 1024
    wal: WriteAheadLog | None = None
    keep: int = 3
    session_id: str | None = None
    ckpt_namespace: str | None = None
    on_compact: Optional[callable] = None

    def __post_init__(self):
        if self.scheduler is None:
            self.scheduler = BucketScheduler(min_bucket=self.block_q)
        if self.scheduler.min_bucket % self.block_q:
            raise ValueError(
                f"scheduler min_bucket={self.scheduler.min_bucket} must be "
                f"a multiple of block_q={self.block_q} (every bucket in the "
                "power-of-two ladder is then a whole number of query tiles)")
        if self.breaker is None:
            self.breaker = CircuitBreaker()
        if self.admission is None:
            self.admission = AdmissionQueue()
        self._delta = np.zeros((0, 3), np.float32)
        self._step = 0
        self.n_compactions = 0
        self._compaction_deferred = False
        self._dedup: OrderedDict = OrderedDict()  # request_id -> (digest,
        #                                           IngestResult)
        self._pending: list = []  # burst mode: (ticket, queries) FIFO
        self._replaying = False   # recover(): records come FROM the log
        self._wal_applied = 0     # global log offset: every record below
        #                           it is reflected in (snapshot + delta)
        self.last_recovery: RecoveryReport | None = None
        if self.wal is not None:
            if self.ckpt_dir is None:
                raise ValueError(
                    "a WAL-durable session requires ckpt_dir: recovery "
                    "replays the log on top of a *published* snapshot "
                    "baseline, so compactions must be able to publish")
            self._wal_applied = self.wal.position
            last = ckpt.latest_step(self.ckpt_dir,
                                    namespace=self.ckpt_namespace)
            if last is None:
                # publish the starting corpus as the recovery baseline —
                # without it the first crash would have a log but nothing
                # to replay it onto
                save_snapshot(self.snapshot, self.ckpt_dir, step=0,
                              keep=self.keep, wal_offset=self._wal_applied,
                              namespace=self.ckpt_namespace)
                self.wal.append_watermark(0, self._wal_applied)
                self._wal_applied = self.wal.position
            else:
                self._step = last

    def _sid(self) -> str:
        """Human-readable session identity for shed/error messages."""
        return self.session_id if self.session_id is not None else "default"

    # --- health ------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        """True while the session serves on a circuit-broken compaction:
        the frozen half's staleness is no longer bounded by
        ``max_delta_frac`` — answers still come from the last *published*
        snapshot, flagged per-answer."""
        return self._compaction_deferred or self.breaker.state != CLOSED

    # --- queries -----------------------------------------------------------

    def assign(self, queries) -> AssignResult:
        """DBSCAN-predict against the frozen snapshot (delta points become
        visible to queries at the next compaction). Every answer carries
        ``staleness`` (the delta watermark — how many ingested points this
        answer cannot see) and ``degraded`` (breaker holding compaction).
        Raises ``AdmissionError`` when the admission queue is full."""
        q_np = validate_points(queries, name="queries")
        ticket = self.admission.admit(len(q_np))
        t0 = time.perf_counter()
        try:
            return self._assign_admitted(q_np)
        finally:
            self.admission.finish(ticket, time.perf_counter() - t0)

    def _assign_admitted(self, q_np: np.ndarray) -> AssignResult:
        try:
            r = assign(self.snapshot, q_np, scheduler=self.scheduler,
                       block_q=self.block_q)
        except CapacityError:
            # a structurally-exhausted regrow is a rebuild-path failure:
            # count it toward the breaker so a corrupt layout trips it
            self.breaker.record_failure()
            raise
        return r._replace(staleness=self.n_delta, degraded=self.degraded)

    # --- burst mode: explicit queue ----------------------------------------

    def submit(self, queries, *, now: float | None = None) -> int:
        """Enqueue one assign request (queue-based load leveling). Returns
        a ticket id; raises ``AdmissionError`` (with ``retry_after``) when
        the queue is at ``max_depth`` — the explicit shed that replaces a
        melting p99."""
        q_np = validate_points(queries, name="queries")
        ticket = self.admission.submit(len(q_np), now=now)
        self._pending.append((ticket, q_np))
        return ticket.id

    def pump(self, *, now: float | None = None) -> list:
        """Drain the queue oldest-first: serve every ticket still within
        ``max_age_s``, shed the rest (they are *dropped* — the client
        already timed out; serving them would burn device time on dead
        answers). Returns [(ticket_id, AssignResult | AdmissionError)]."""
        out = []
        by_id = {t.id: q for t, q in self._pending}
        self._pending.clear()
        while True:
            t = self.admission.take(now=now)
            if t is None:
                break
            q_np = by_id.pop(t.id)
            t0 = time.perf_counter()
            try:
                r = self._assign_admitted(q_np)
            except ServeError as e:
                r = e  # per-ticket failure must not abort the drain
            finally:
                self.admission.finish(t, time.perf_counter() - t0)
            out.append((t.id, r))
        for tid in by_id:  # age-shed at take(): report explicitly
            out.append((tid, AdmissionError(
                "request waited past max_age_s and was shed at pump",
                retry_after=self.admission.service_estimate_s())))
        return out

    # --- ingest ------------------------------------------------------------

    @property
    def n_delta(self) -> int:
        return len(self._delta)

    def _compaction_due(self) -> bool:
        return (self.n_delta >= self.delta_capacity
                or self.n_delta >= self.max_delta_frac * self.snapshot.n)

    def ingest(self, chunk, *, request_id: Optional[str] = None,
               _wal_end: Optional[int] = None) -> IngestResult:
        """Append ``chunk`` (m, 3) and label it online (module docstring).

        Returns the chunk's labels; earlier delta points may silently
        re-label as later arrivals densify their neighborhoods — readers
        that care should re-``assign``.

        ``request_id`` (optional) makes the call idempotent: a replay of
        an id inside the dedup window returns the recorded result without
        touching the delta (``deduped=True``); the same id with a
        *different* payload raises ``ValidationError``.

        With a ``wal`` attached the contract is **log → apply → ack**
        (DESIGN.md §14.1): the chunk's frame is appended (and synced per
        the log's ``durability``) before any state changes, so a result
        you receive is durable. A failed *apply* (label program raised)
        rolls the delta back and neutralizes the frame with an ABORT
        record; a *crash* mid-apply leaves the frame live and recovery
        applies it in full. ``_wal_end`` is the replay path's internal
        cursor — the record is already on disk, so replay must not
        re-append it (that is what makes replay a byte-level no-op).
        """
        chunk = validate_points(chunk, name="chunk")
        if request_id is not None and self.dedup_window > 0 \
                and not self._replaying:
            # replay skips the *check* (a WAL record exists only for
            # chunks that passed it originally) but still repopulates the
            # window below, so post-recovery client retries stay no-ops
            hit = self._dedup.get(request_id)
            if hit is not None:
                digest, result = hit
                if digest != _digest(chunk):
                    raise ValidationError(
                        f"request_id {request_id!r} replayed with a "
                        "different payload — at-least-once delivery must "
                        "not mutate the request", request_id=request_id)
                return result._replace(deduped=True)
        if len(chunk) > self.delta_capacity:
            raise ValidationError(
                f"chunk of {len(chunk)} exceeds delta_capacity="
                f"{self.delta_capacity}; split it or raise the capacity")
        if self.n_delta + len(chunk) > self.delta_capacity:
            # the buffer is hard-bounded: fold it first, or shed the chunk
            # when the breaker is holding compaction (retry once it probes)
            if not self._try_compact():
                # price the hint from both holds: the breaker's next probe
                # window AND one measured service time (a deferred-by-the-
                # tier compaction leaves the breaker closed, but retrying
                # faster than the queue drains is still pointless) — the
                # router re-raise preserves this value verbatim (§16.2)
                raise AdmissionError(
                    f"session {self._sid()!r}: delta buffer full "
                    f"({self.n_delta}/{self.delta_capacity}) and compaction "
                    "is circuit-broken; retry after the breaker's next "
                    "probe window",
                    retry_after=max(self.breaker.retry_after(),
                                    self.admission.service_estimate_s(),
                                    0.001),
                    n_delta=self.n_delta, session_id=self.session_id)
        wal_rec = None
        if self.wal is not None and not self._replaying:
            # LOG: durable before applied — only then may the ack happen
            wal_rec = self.wal.append_ingest(chunk, request_id=request_id)
        d0 = self.n_delta
        self._delta = np.concatenate([self._delta, chunk])
        d1 = self.n_delta
        if wal_rec is not None:
            self._wal_applied = wal_rec.end
        elif _wal_end is not None:
            self._wal_applied = _wal_end
        compacted = False
        try:
            if self._compaction_due() and self._try_compact():
                compacted = True
                n_old = self.snapshot.n - d1
                labels = self.snapshot.labels[
                    n_old + d0:n_old + d1].cpu().numpy()
                result = IngestResult(labels=labels.astype(np.int32),
                                      compacted=True, n_delta=0)
            else:
                faults.fire("serve.ingest.label")  # chaos: mid-ingest crash
                labels = self._label_delta()[d0:d1]
                result = IngestResult(labels=labels, compacted=False,
                                      n_delta=d1, degraded=self.degraded)
        except faults.Kill:
            raise  # simulated process death: no in-process cleanup runs —
            #        the logged-but-unacked frame replays in full
        except BaseException:
            if not compacted:
                # crash-retry contract: a failed ingest leaves no trace, so
                # the client's replay is a fresh attempt, not a double —
                # the WAL frame is neutralized rather than rewritten
                self._delta = self._delta[:d0]
                if wal_rec is not None:
                    self._wal_applied = self.wal.append_abort(wal_rec.seq).end
            raise
        if request_id is not None and self.dedup_window > 0:
            self._dedup[request_id] = (_digest(chunk), result)
            while len(self._dedup) > self.dedup_window:
                self._dedup.popitem(last=False)
        return result

    def _label_delta(self) -> np.ndarray:
        d = self.n_delta
        D = self.scheduler.bucket(d)
        dpts = np.full((D, 3), BIG, np.float32)
        dpts[:d] = self._delta
        spec = self.snapshot.spec
        eps2 = float(self.snapshot.eps) ** 2
        slab = self.snapshot.slab  # shared with assign: a grown slab
        #                            sticks, no per-ingest re-regrow
        dpts = torch.as_tensor(dpts, device=self.snapshot.device)
        for attempt in range(nb.MAX_SLAB_REGROW + 1):
            fn = _delta_label_fn(spec, eps2, int(self.snapshot.min_pts),
                                 self.snapshot.n, slab, self.block_q)
            labels, _, _, overflow = fn(
                self.snapshot.codes, self.snapshot.cands,
                self.snapshot.croot_sorted, dpts, d)
            if not bool(overflow) \
                    and not faults.fire("serve.ingest.overflow"):
                break
            self.scheduler.note_regrow()
            slab = next_slab(slab, spec.n_cand, attempt=attempt,
                             max_regrow=nb.MAX_SLAB_REGROW,
                             what="delta cross-sweep")
            self.snapshot.note_slab(slab)
        return labels[:d].cpu().numpy()

    # --- compaction --------------------------------------------------------

    def _try_compact(self) -> bool:
        """Breaker-gated compaction for the hot path: False when deferred
        (breaker open) or failed (failure recorded, old snapshot live).
        With an ``on_compact`` delegate the decision belongs to the owner
        (the sharded tier) — it compacts tier-wide or defers."""
        if self.on_compact is not None:
            ok = bool(self.on_compact())
            self._compaction_deferred = not ok
            return ok
        if not self.breaker.allow():
            self._compaction_deferred = True
            return False
        try:
            self.compact(_gated=False)
            return True
        except CompactionError:
            return False

    def compact(self, *, force: bool = False,
                _gated: bool = True) -> ClusterSnapshot:
        """Fold the delta into a fresh snapshot via the ordinary batch path
        (bit-identical to ``dbscan`` on the concatenated points — the
        parity contract ingest's bounded staleness is measured against).
        The re-cluster runs under the frontier round driver (DESIGN.md
        §11, via ``build_snapshot``): compaction is the serving path's
        recurring full-cluster cost, and on a mostly-converged corpus the
        frontier collapses its stage-2 rounds to the merge seams.

        The rebuild is guarded by the session's circuit breaker: with the
        breaker open this raises ``CompactionError`` immediately (pass
        ``force=True`` for an operator-driven recovery attempt); a failed
        rebuild records a breaker failure and leaves the previously
        published snapshot fully live — the in-memory swap is the last
        step, and on-disk publication is the checkpoint layer's atomic
        rename, so a crashed compaction never leaves a half-visible
        corpus.

        With a ``wal`` attached, a successful publish stamps the change
        log's watermark (DESIGN.md §14.3): the new snapshot's meta embeds
        the applied log offset it folds (crash-consistent — it rides the
        atomic rename), a WATERMARK record lands in the WAL for GC
        bookkeeping, keep-K checkpoint GC pins every step a live
        watermark still references, and WAL segments wholly below the
        oldest of the newest keep-K snapshots' offsets are unlinked.
        Death between publish and watermark-append
        (``serve.compact.watermark`` site) is safe: recovery reads the
        offset from the snapshot meta.
        """
        if self.on_compact is not None:
            raise ServeError(
                f"session {self._sid()!r} compacts at tier scope (its "
                "labels are a slice of a global clustering) — call the "
                "owning tier's compact() instead")
        if _gated and not force and not self.breaker.allow():
            raise CompactionError(
                "compaction circuit breaker is open "
                f"(state={self.breaker.state}); force=True to probe now",
                retry_after=self.breaker.retry_after())
        # captured before the rebuild: every logged record reflected in
        # (snapshot + delta) right now is what the new snapshot will hold
        wm_offset = self._wal_applied if self.wal is not None else None
        try:
            faults.fire("serve.compact")  # chaos: stall (delay) / failure
            pts = np.concatenate([self.snapshot.points.cpu().numpy(),
                                  self._delta])
            new_snapshot = build_snapshot(
                pts, self.snapshot.eps, self.snapshot.min_pts,
                engine=self.snapshot.engine, device=self.snapshot.device)
        except Exception as e:
            self.breaker.record_failure()
            self._compaction_deferred = True
            raise CompactionError(
                f"compaction rebuild failed ({type(e).__name__}: {e}); "
                "last published snapshot remains live",
                retry_after=self.breaker.retry_after()) from e
        # success: atomic swap, then atomic publish
        self.breaker.record_success()
        self._adopt(new_snapshot, wm_offset)
        return self.snapshot

    def adopt_snapshot(self, new_snapshot: ClusterSnapshot) -> None:
        """Swap in an externally rebuilt snapshot (the sharded tier's
        global compaction path, DESIGN.md §15.4): the delta is cleared,
        the step bumps, and the publish/watermark tail runs exactly as a
        local compaction's — atomic checkpoint rename under this
        session's namespace, WAL watermark, keep-K + WAL GC. The caller
        guarantees ``new_snapshot`` reflects this session's whole delta
        (plus whatever else the tier folded)."""
        wm_offset = self._wal_applied if self.wal is not None else None
        self._adopt(new_snapshot, wm_offset)

    def _adopt(self, new_snapshot: ClusterSnapshot,
               wm_offset: int | None) -> None:
        self.snapshot = new_snapshot
        self._delta = np.zeros((0, 3), np.float32)
        self.n_compactions += 1
        self._step += 1
        self._compaction_deferred = False
        if self.ckpt_dir is not None:
            pin = ({s for s, _ in self.wal.live_watermarks()}
                   if self.wal is not None else ())
            save_snapshot(self.snapshot, self.ckpt_dir, step=self._step,
                          keep=self.keep, wal_offset=wm_offset, pin=pin,
                          namespace=self.ckpt_namespace)
        if self.wal is not None:
            faults.fire("serve.compact.watermark")  # chaos: die between
            #   the atomic publish and the WAL's watermark record
            self._wal_applied = self.wal.append_watermark(
                self._step, wm_offset).end
            self._wal_gc()

    # --- durability / recovery ----------------------------------------------

    def _wal_gc(self) -> None:
        """Unlink WAL segments below the oldest watermark of the *newest*
        ``keep`` snapshots on disk — the steps keep-K itself retains, so
        every keep-K baseline always has its whole replay suffix in the
        log. Older watermark-pinned stragglers deliberately do NOT enter
        the bound (that would ratchet: a live watermark pins its step,
        the pinned step's offset would hold the bound down, which keeps
        its watermark live forever). Their pins are transient segment-
        granularity slop — the watermark record unlinks with its segment
        and the next publish's keep-K GC reclaims the step; a fallback
        that deep is refused by :meth:`recover`'s coverage check rather
        than silently replayed short (DESIGN.md §14.3)."""
        offsets = published_wal_offsets(self.ckpt_dir,
                                        namespace=self.ckpt_namespace)
        if offsets:
            newest = sorted(offsets)[-max(self.keep, 1):]
            self.wal.gc(min(offsets[s] for s in newest))

    @classmethod
    def recover(cls, ckpt_dir: str, wal_dir: str, *,
                durability: str = "fsync", segment_bytes: int = 4 << 20,
                device=None, **session_kw) -> "ServeSession":
        """Crash-consistent restart (DESIGN.md §14.4): load the newest
        *intact* snapshot (the hardened loader walks keep-K versions past
        damage), open the WAL (which truncates a torn tail), and replay
        every ingest record past the snapshot's watermark through the
        ordinary idempotent ingest path.

        The invariant this reconstructs: the recovered state contains the
        baseline corpus plus every *acknowledged* chunk; a chunk whose
        frame was logged but whose ack never happened (crash mid-apply)
        is applied in full; an ABORT-neutralized or byte-duplicated frame
        is skipped. Nothing is ever partially applied — a frame either
        fails its CRC (dropped with the tail) or decodes to the whole
        chunk. Replay writes no new frames, so recovering twice from the
        same disk state is a byte-level no-op on the log and yields an
        identical session.

        ``session_kw`` forwards policy knobs (``max_delta_frac``,
        ``breaker`` …) to the rebuilt session; pass the same values the
        crashed session used so replay-triggered compactions fire at the
        same thresholds. The :class:`RecoveryReport` lands on
        ``session.last_recovery``. The snapshot loads onto ``device``
        (``None`` means ``cuda``); snapshots and WALs written by the JAX
        reference recover here as well.
        """
        namespace = session_kw.get("ckpt_namespace")
        snap, meta = load_snapshot(ckpt_dir, with_meta=True,
                                   namespace=namespace, device=device)
        base_step = int(meta["step"])
        base_off = int(meta.get("wal_offset", 0))
        wal = WriteAheadLog(wal_dir, durability=durability,
                            segment_bytes=segment_bytes)
        if base_off < wal.oldest_offset:
            # the loader fell back past every step whose suffix the WAL
            # still holds: replaying from here would silently drop the
            # acked records GC'd away — refuse loudly instead
            raise ServeError(
                f"cannot recover from snapshot step {base_step}: its "
                f"replay suffix starts at log offset {base_off} but the "
                f"WAL is garbage-collected below {wal.oldest_offset}; "
                "the acked records in between exist only in newer "
                "snapshots (all damaged or deleted)")
        sess = cls(snap, wal=wal, ckpt_dir=ckpt_dir, **session_kw)
        # publishes must never collide with an existing (possibly damaged)
        # newer step: an idempotent save would silently keep the damaged
        # one, so number past everything on disk
        sess._step = max(base_step,
                         ckpt.latest_step(ckpt_dir, namespace=namespace)
                         or 0)
        sess._wal_applied = base_off
        records = list(wal.records(base_off))  # materialize: a replay-
        #   triggered compaction may GC segments while we iterate
        aborted = {r.aborted_seq for r in records if r.kind == "abort"}
        seen: set = set()
        n_chunks = n_pts = n_dup = n_abort = 0
        comp0 = sess.n_compactions
        for r in records:
            if r.kind != "ingest":
                continue
            if r.seq in seen:
                n_dup += 1  # duplicated tail frame: already applied —
                continue    # replaying it again is the no-op contract
            seen.add(r.seq)
            if r.seq in aborted:
                n_abort += 1
                continue
            sess._replaying = True
            try:
                sess.ingest(r.chunk, request_id=r.request_id,
                            _wal_end=r.end)
            finally:
                sess._replaying = False
            n_chunks += 1
            n_pts += len(r.chunk)
        # trailing non-ingest records (aborts, watermarks) are no-ops:
        # advance the applied cursor over them
        sess._wal_applied = max(sess._wal_applied, wal.position)
        sess.last_recovery = RecoveryReport(
            baseline_step=base_step, baseline_offset=base_off,
            replayed_chunks=n_chunks, replayed_points=n_pts,
            skipped_aborted=n_abort, skipped_duplicates=n_dup,
            truncated_bytes=wal.truncated_bytes,
            compactions=sess.n_compactions - comp0)
        return sess
