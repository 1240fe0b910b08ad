"""Per-target health for the sharded tier (DESIGN.md §16).

A router that scatters with no health model fails the whole query on
one unhealthy shard, even though the tier holds replicas. This module
gives the router a *failure-domain* view — one
:class:`TargetHealth` per serving target ``(shard_id, replica)``, driven
by two signal classes:

  * **passive** — every scatter leg reports success/error/latency for
    the target it hit (:meth:`HealthRegistry.record_success` /
    :meth:`~HealthRegistry.record_failure`), feeding a *per-target*
    :class:`~repro_torch.serve.resilience.CircuitBreaker` instead of the one
    shared breaker §12 used for compaction (which stays — it guards the
    tier-global rebuild, a different failure domain);
  * **active** — ``ShardedTier.probe`` runs a 1-point ``assign`` against
    the shard's own snapshot, deadline-bounded, and reports the outcome
    here (``probe=True`` so heartbeat telemetry is separable from
    traffic).

The state machine per target is derived, not stored — it reads straight
off the target's breaker plus its consecutive-failure count, so passive
traffic and active probes drive the same transitions:

    healthy ──failure──▶ suspect ──(down_after consecutive)──▶ down
       ▲                    │                                   │
       └──────success───────┘            recover_after_s elapsed│
       ▲                                 (breaker half-open) or │
       │                                 re-materialize started ▼
       └─────────────probe/leg success────────────────────── recovering

``down`` targets are **quarantined**: :meth:`candidates` never returns
them, so the round-robin turn passes straight to the next live replica
instead of stalling the slot. ``recovering`` (half-open) targets keep
their turn in the rotation — that is the breaker's single-probe
admission generalized to a replica set — while ``suspect`` turn-holders
are the router's hedging trigger. The ``clock`` is injectable (shared
with every per-target breaker) so tests drive the whole lifecycle
without sleeping.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from .resilience import HALF_OPEN, OPEN, CircuitBreaker

HEALTHY, SUSPECT, DOWN, RECOVERING = ("healthy", "suspect", "down",
                                      "recovering")


@dataclasses.dataclass
class TargetHealth:
    """Signal accumulator for one ``(shard_id, replica)`` serving target.

    ``breaker`` is the target's own circuit breaker: ``down_after``
    consecutive failures open it (= quarantine), ``recover_after_s``
    later it half-opens (= recovering, one probe admitted). The probe
    fields keep the *heartbeat* history separate from traffic latency so
    ``health_report`` can show both.
    """
    key: tuple
    breaker: CircuitBreaker
    consecutive_failures: int = 0
    n_successes: int = 0
    n_failures: int = 0
    n_probes: int = 0
    last_latency_s: Optional[float] = None   # last successful leg
    last_probe_s: Optional[float] = None     # last completed probe
    last_probe_ok: Optional[bool] = None
    recovering: bool = False                 # re-materialize in flight


@dataclasses.dataclass
class HealthRegistry:
    """Health registry for every serving target behind one router.

    Knobs: ``down_after`` (consecutive failures before quarantine — the
    per-target breaker's threshold), ``recover_after_s`` (quarantine
    timeout before a target half-opens into ``recovering``),
    ``probe_deadline_s`` (a heartbeat slower than this *fails* even if it
    returns — a stalled shard is as dead as a crashed one to a latency
    SLO), ``clock`` (injectable, shared with the per-target breakers).
    """
    down_after: int = 3
    recover_after_s: float = 30.0
    probe_deadline_s: float = 1.0
    clock: callable = time.monotonic

    def __post_init__(self):
        self._targets: dict = {}

    # --- target accounting --------------------------------------------------

    def target(self, key) -> TargetHealth:
        """The accumulator for ``key = (shard_id, replica)``, created
        healthy on first sight (an unseen target has no strikes)."""
        key = (int(key[0]), int(key[1]))
        t = self._targets.get(key)
        if t is None:
            t = TargetHealth(key=key, breaker=CircuitBreaker(
                failure_threshold=self.down_after,
                reset_after_s=self.recover_after_s, clock=self.clock))
            self._targets[key] = t
        return t

    def state(self, key) -> str:
        """Derived state (module docstring diagram)."""
        t = self.target(key)
        if t.recovering:
            return RECOVERING
        s = t.breaker.state
        if s == OPEN:
            return DOWN
        if s == HALF_OPEN:
            return RECOVERING
        return SUSPECT if t.consecutive_failures > 0 else HEALTHY

    def record_success(self, key, latency_s: Optional[float] = None, *,
                       probe: bool = False) -> None:
        t = self.target(key)
        t.consecutive_failures = 0
        t.n_successes += 1
        t.breaker.record_success()
        t.recovering = False
        if latency_s is not None:
            t.last_latency_s = float(latency_s)
        if probe:
            t.n_probes += 1
            t.last_probe_s = latency_s
            t.last_probe_ok = True

    def record_failure(self, key, *, probe: bool = False,
                       latency_s: Optional[float] = None) -> None:
        t = self.target(key)
        t.consecutive_failures += 1
        t.n_failures += 1
        t.breaker.record_failure()
        if probe:
            t.n_probes += 1
            t.last_probe_s = latency_s
            t.last_probe_ok = False

    def force_down(self, key) -> None:
        """Quarantine immediately — an *observed death* (a leg saw the
        target's worker die) needs no three-strikes escalation; the
        suspect ladder is for errors, not corpses."""
        t = self.target(key)
        t.recovering = False
        # drive the breaker open through its own API (no private pokes):
        # each recorded failure is real — the target did fail this leg
        for _ in range(self.down_after + 1):
            if self.state(key) == DOWN:
                break
            self.record_failure(key)

    def begin_recovery(self, key) -> None:
        """Mark a re-materialize in flight; state reads ``recovering``."""
        self.target(key).recovering = True

    def end_recovery(self, key, ok: bool,
                     latency_s: Optional[float] = None) -> None:
        """Close out a re-materialize: success resets the target, failure
        records a strike on the (open) breaker — which re-opens it for a
        fresh quarantine window, the breaker's half-open semantics."""
        t = self.target(key)
        t.recovering = False
        if ok:
            self.record_success(key, latency_s)
        else:
            self.record_failure(key)

    # --- routing ------------------------------------------------------------

    def candidates(self, shard_id: int, n_replicas: int, *,
                   start: int = 0) -> list:
        """Replica serving order for one scatter leg: the ring rotated
        from ``start`` (round-robin fairness — the turn-holder first)
        with DOWN targets dropped entirely, so a quarantined replica
        never stalls the slot's turn; the next live copy inherits it.
        Failover walks this order. RECOVERING (half-open) targets keep
        their turn — the breaker's single-probe admission generalized
        to a replica set. Empty result = the whole shard is
        quarantined."""
        rot = [(start + i) % n_replicas for i in range(n_replicas)]
        return [r for r in rot if self.state((shard_id, r)) != DOWN]

    def quarantined(self, shard_id: int, n_replicas: int) -> bool:
        """True when no serving copy of the shard is live."""
        return not self.candidates(shard_id, n_replicas)

    # --- telemetry ----------------------------------------------------------

    def report(self) -> dict:
        """Per-target snapshot: state, consecutive failures, last probe
        latency — the raw rows ``ShardedTier.health_report`` decorates
        with routing/serving telemetry."""
        out = {}
        for key in sorted(self._targets):
            t = self._targets[key]
            out[key] = {
                "state": self.state(key),
                "consecutive_failures": t.consecutive_failures,
                "failures": t.n_failures,
                "successes": t.n_successes,
                "probes": t.n_probes,
                "last_latency_s": t.last_latency_s,
                "last_probe_s": t.last_probe_s,
                "last_probe_ok": t.last_probe_ok,
            }
        return out
