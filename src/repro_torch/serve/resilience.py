"""Resilience primitives for the serving tier (DESIGN.md §12).

The serving path (§10) answers predict/ingest from one frozen snapshot;
this module is its production envelope — the four patterns the sharded
tier will inherit shard-by-shard:

  * a structured **error taxonomy** (:class:`ServeError` and subclasses)
    so callers can branch on ``code``/``retryable`` instead of parsing
    messages, with ``retry_after`` carried on sheddable errors;
  * **input validation** (:func:`validate_points`): NaN/Inf coordinates,
    wrong dims, wrong rank, and non-real dtypes are rejected *before*
    quantization — a NaN survives ``int32`` casting as an arbitrary cell
    code, so it would otherwise silently poison the Morton sort;
  * a **circuit breaker** (:class:`CircuitBreaker`): the classic
    closed → open → half-open machine guarding compaction/rebuild, so a
    persistently failing rebuild stops being retried on the hot path and
    the session keeps serving the last published snapshot;
  * **queue-based load leveling** (:class:`AdmissionQueue`): a bounded
    admission queue in front of the shape-bucket scheduler with depth and
    age thresholds that shed load *explicitly* (``AdmissionError`` with a
    ``retry_after`` estimate) instead of letting p99 melt.

Everything takes an injectable ``clock`` so tests drive time
deterministically; nothing here touches a device.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np


# --- error taxonomy ---------------------------------------------------------


class ServeError(Exception):
    """Base of the serving failure taxonomy (DESIGN.md §12.1).

    ``code`` is a stable machine-readable tag, ``retryable`` says whether
    the *same* request can succeed later, and ``retry_after`` (seconds,
    optional) is the server's backoff hint on shed/deferred work.
    """
    code = "serve_error"
    retryable = False

    def __init__(self, message: str, *, retry_after: float | None = None,
                 **details):
        super().__init__(message)
        self.retry_after = retry_after
        self.details = details


class ValidationError(ServeError, ValueError):
    """Malformed request payload (never retryable as-is). Subclasses
    ``ValueError`` so pre-envelope callers catching that still work."""
    code = "invalid_input"
    retryable = False


class AdmissionError(ServeError):
    """Load shed: the admission queue is beyond its depth/age thresholds
    (or a required compaction is circuit-broken). Retry after backoff."""
    code = "admission_shed"
    retryable = True


class CapacityError(ServeError):
    """A slab regrow loop hit its retry cap or the structural ceiling;
    the message names the final slab capacity reached."""
    code = "capacity_exhausted"
    retryable = False


class CompactionError(ServeError):
    """A compaction/rebuild failed; the previously published snapshot is
    still live (the swap never happened)."""
    code = "compaction_failed"
    retryable = True


class SnapshotFormatError(ServeError):
    """A snapshot is intact but written by a newer format than this build
    supports — deliberately NOT part of the corruption-fallback set."""
    code = "snapshot_format"
    retryable = False


# --- input validation -------------------------------------------------------


def validate_points(points, *, name: str = "points",
                    cols: int = 3) -> np.ndarray:
    """Validate a request's point payload; return it as (m, cols) float32.

    Rejections (all :class:`ValidationError`, pre-quantization): non-real
    dtypes (complex/object/str/bool), wrong rank, wrong column count, and
    non-finite coordinates — the first offending row index is named so a
    client can drop/fix the poisoned record and retry the rest.
    """
    arr = np.asarray(points)
    if arr.dtype == object or arr.dtype.kind not in "fiu":
        raise ValidationError(
            f"{name} dtype {arr.dtype} is not a real numeric type; "
            "expected float32-compatible coordinates", dtype=str(arr.dtype))
    if arr.ndim != 2 or arr.shape[1] != cols:
        raise ValidationError(
            f"{name} must be (m, {cols}), got {arr.shape}",
            shape=tuple(arr.shape))
    arr = arr.astype(np.float32, copy=False)
    finite = np.isfinite(arr).all(axis=1)
    if not finite.all():
        bad = int(np.argmin(finite))
        raise ValidationError(
            f"{name}[{bad}] has non-finite coordinates "
            f"({arr[bad].tolist()}); NaN/Inf would corrupt the Morton "
            "quantization — drop or fix the record",
            row=bad, n_bad=int((~finite).sum()))
    return arr


# --- bounded slab regrow ----------------------------------------------------


def next_slab(slab: int, n_cand: int, *, attempt: int, max_regrow: int,
              what: str) -> int:
    """One step of the overflow → double-slab-and-retrace policy, bounded.

    Raises :class:`CapacityError` naming the final slab capacity when the
    retry cap is exhausted or the slab already covers every candidate
    (``n_cand`` — at which point overflow is structural, not sizing).
    """
    if slab >= n_cand or attempt >= max_regrow:
        raise CapacityError(
            f"{what} slab overflow persists at slab={slab} after "
            f"{attempt} regrow(s) (cap {max_regrow}, n_cand={n_cand}) — "
            "pathological query distribution or corrupt snapshot layout",
            slab=slab, n_cand=n_cand, attempts=attempt)
    return min(slab * 2, n_cand)


# --- retry backoff ----------------------------------------------------------


@dataclasses.dataclass
class Backoff:
    """Jittered exponential backoff for retryable scatter legs (§16.2).

    ``delay(attempt, retry_after)`` is the exponential ladder
    ``base_s · 2^attempt`` (capped at ``cap_s``) stretched by up to
    ``jitter``× of itself, then floored at the server's ``retry_after``
    hint — the hint is a *promise* ("nothing will change sooner"), so
    retrying under it only burns a retry budget on a guaranteed
    rejection. Jitter de-synchronizes concurrent legs retrying against
    the same shard; it comes from a seeded injectable RNG so tests and
    replays stay deterministic.
    """
    base_s: float = 0.05
    cap_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def delay(self, attempt: int, retry_after: float | None = None) -> float:
        d = min(self.base_s * (2.0 ** max(attempt, 0)), self.cap_s)
        d *= 1.0 + self.jitter * float(self._rng.random())
        if retry_after:
            d = max(d, float(retry_after))
        return d


# --- circuit breaker --------------------------------------------------------


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


@dataclasses.dataclass
class CircuitBreaker:
    """Closed → open → half-open breaker (DESIGN.md §12.2).

    ``record_failure`` past ``failure_threshold`` consecutive failures
    opens the circuit; :meth:`allow` then vetoes the guarded operation
    until ``reset_after_s`` has elapsed, at which point exactly one probe
    is allowed (half-open): its success closes the circuit, its failure
    re-opens it for another full timeout. ``clock`` is injectable so
    tests advance time without sleeping.
    """
    failure_threshold: int = 3
    reset_after_s: float = 30.0
    clock: callable = time.monotonic

    def __post_init__(self):
        self._failures = 0          # consecutive
        self._opened_at: Optional[float] = None
        self._probing = False
        self.n_trips = 0            # telemetry: closed->open transitions
        self.n_failures = 0         # telemetry: total failures recorded

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return CLOSED
        if self.clock() - self._opened_at >= self.reset_after_s:
            return HALF_OPEN
        return OPEN

    def allow(self) -> bool:
        """May the guarded operation run now? Half-open admits one probe."""
        s = self.state
        if s == CLOSED:
            return True
        if s == HALF_OPEN and not self._probing:
            self._probing = True
            return True
        return False

    def record_success(self) -> None:
        self._failures = 0
        self._opened_at = None
        self._probing = False

    def record_failure(self) -> None:
        self.n_failures += 1
        self._failures += 1
        self._probing = False
        if self._opened_at is not None:
            # a failed half-open probe re-opens for a fresh timeout
            self._opened_at = self.clock()
        elif self._failures >= self.failure_threshold:
            self.n_trips += 1
            self._opened_at = self.clock()

    def retry_after(self) -> float:
        """Seconds until the next half-open probe (0 when not open)."""
        if self._opened_at is None:
            return 0.0
        return max(0.0, self.reset_after_s
                   - (self.clock() - self._opened_at))


# --- admission queue (queue-based load leveling) ----------------------------


@dataclasses.dataclass
class Ticket:
    id: int
    size: int
    arrived: float


@dataclasses.dataclass
class AdmissionQueue:
    """Bounded admission in front of the bucket scheduler (DESIGN.md §12.3).

    Two explicit shed thresholds instead of a melting p99:

      * **depth** — at most ``max_depth`` requests waiting + in flight;
        request ``max_depth + 1`` is rejected at :meth:`submit` with a
        ``retry_after`` estimated from the backlog and the EWMA service
        time (the client's backoff hint);
      * **age** — a request that has waited longer than ``max_age_s`` by
        the time the worker gets to it is shed at :meth:`take` (serving
        it would burn device time on an answer the client has already
        timed out on — the load-leveling argument).

    The queue is passive (no threads): a serving loop calls ``submit`` on
    arrival and ``take``/``finish`` around each served batch, and the
    same calls drive the EWMA that prices ``retry_after``.
    """
    max_depth: int = 64
    max_age_s: float = 2.0
    clock: callable = time.monotonic
    ewma_alpha: float = 0.2

    def __post_init__(self):
        self._waiting: collections.deque = collections.deque()
        self._inflight = 0
        self._next_id = 0
        self._ewma_s: Optional[float] = None
        self.admitted = 0
        self.served = 0
        self.shed_depth = 0   # rejected at submit (queue full)
        self.shed_age = 0     # dropped at take (waited past max_age_s)

    @property
    def depth(self) -> int:
        return len(self._waiting) + self._inflight

    def service_estimate_s(self) -> float:
        return self._ewma_s if self._ewma_s is not None else 0.05

    # -- arrival side --

    def _admit_or_shed(self, size: int, now: float) -> Ticket:
        if self.depth >= self.max_depth:
            self.shed_depth += 1
            raise AdmissionError(
                f"admission queue full (depth={self.depth} ≥ "
                f"max_depth={self.max_depth}); retry after backoff",
                retry_after=max(self.depth, 1) * self.service_estimate_s(),
                depth=self.depth)
        t = Ticket(id=self._next_id, size=size, arrived=now)
        self._next_id += 1
        self.admitted += 1
        return t

    def submit(self, size: int = 1, *, now: float | None = None) -> Ticket:
        """Queue one request of ``size`` points for a later :meth:`take`,
        or shed it explicitly (burst/async arrival side)."""
        now = self.clock() if now is None else now
        t = self._admit_or_shed(size, now)
        self._waiting.append(t)
        return t

    def admit(self, size: int = 1, *, now: float | None = None) -> Ticket:
        """Admit one request straight to in-flight (the synchronous serve
        path: caller runs it now and pairs with :meth:`finish`)."""
        now = self.clock() if now is None else now
        t = self._admit_or_shed(size, now)
        self._inflight += 1
        return t

    # -- worker side --

    def take(self, *, now: float | None = None) -> Optional[Ticket]:
        """Pop the oldest request still worth serving; age-shed the rest.

        Returns None when nothing is waiting. The caller must pair every
        returned ticket with :meth:`finish`.
        """
        now = self.clock() if now is None else now
        while self._waiting:
            t = self._waiting.popleft()
            if now - t.arrived > self.max_age_s:
                self.shed_age += 1
                continue
            self._inflight += 1
            return t
        return None

    def finish(self, ticket: Ticket, seconds: float) -> None:
        self._inflight -= 1
        self.served += 1
        if self._ewma_s is None:
            self._ewma_s = seconds
        else:
            self._ewma_s += self.ewma_alpha * (seconds - self._ewma_s)

    # -- telemetry --

    @property
    def shed(self) -> int:
        return self.shed_depth + self.shed_age

    def shed_rate(self) -> float:
        total = self.admitted + self.shed_depth
        return (self.shed / total) if total else 0.0
