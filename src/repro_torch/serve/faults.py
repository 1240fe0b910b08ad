"""Deterministic fault injection for the serving envelope (DESIGN.md §12).

Every degradation path in the resilience layer — circuit-broken
compaction, bounded slab regrow, admission shedding, snapshot fallback —
is exercised by *injected* faults rather than asserted in prose. The
harness is deliberately boring: a module-level registry of **named
sites**, armed from tests/benchmarks with :func:`inject` and consulted
from production code with :func:`fire`. A disarmed site costs one dict
lookup on a (normally empty) registry; there are no threads, timers, or
randomness — a fault fires exactly ``times`` times in call order, so a
chaos test replays bit-identically.

Sites instrumented in this codebase (``inject`` validates the name):

  * ``serve.compact``         — inside ``ServeSession`` compaction, after
    the decision to rebuild but before the new snapshot is built: a
    ``delay`` models a compaction *stall*, an ``error`` a failed rebuild.
    Either way the previously published snapshot stays live (the swap is
    the last step), which is exactly what the circuit-breaker tests pin.
  * ``serve.assign.overflow`` — forces the cross-query slab-overflow flag
    in ``assign``'s regrow loop, exercising double-and-retrace, regrow
    telemetry, and the bounded-retry ``CapacityError``.
  * ``serve.ingest.overflow`` — same forced overflow for the delta
    labeling program in ``ServeSession.ingest``.
  * ``serve.ingest.label``    — inside online delta labeling (after the
    delta append): an ``error`` models a mid-ingest crash for
    idempotency/replay tests.
  * ``serve.wal.append``      — top of the WAL append path, before any
    byte is written: death here loses the (unacked) chunk entirely.
  * ``serve.wal.fsync``       — inside the ``durability="fsync"`` sync,
    after the user-space flush but before ``os.fsync`` returns: the
    frame is on disk, the ack never happened — recovery must apply the
    chunk in full (logged-but-unacked is never *partially* applied).
  * ``serve.wal.rotate``      — between closing a full segment and
    creating its successor: both sides end on frame boundaries.
  * ``serve.compact.watermark`` — after a compacted snapshot is
    atomically published but before its WATERMARK record lands in the
    WAL: recovery must use the offset embedded in the snapshot's own
    meta, never a WAL record that may not exist.
  * ``serve.shard.assign``      — top of one scatter leg in the sharded
    router, before the shard's ``assign`` runs: an ``error`` models a
    failing target, a ``Kill`` a dead one (the leg fails over / goes
    partial — the *router* must survive a shard's death).
  * ``serve.shard.probe``       — inside ``ShardedTier.probe`` before
    the heartbeat assign: a ``delay`` past the probe deadline models a
    stalled shard, an ``error``/``Kill`` a dead one.
  * ``serve.shard.rematerialize`` — top of per-shard ``recover_shard``,
    before the checkpoint/WAL are touched: death here leaves the shard
    quarantined for the next attempt.
  * ``serve.shard.ingest``      — top of one ingest scatter leg (the
    owning shard's piece, before the session sees it): a ``Kill`` models
    the owner dying mid-scatter — the chunk stays unacked and the
    client's idempotent retry lands after recovery.

Shard sites are *per-target*: the router passes the target's tag
(``shard-00j/rK``, or ``shard-00j`` for shard-scoped sites) to
:func:`fire`, and :func:`inject` accepts ``tag=`` to arm one target
only. Matching is by prefix — ``tag="shard-001"`` hits every replica of
shard 1, ``tag="shard-001/r0"`` only its primary, no tag hits all —
so a chaos test can kill a specific replica while its siblings serve.

Process death is simulated in-process by arming a site with
:class:`Kill`: it derives from ``BaseException`` and the serving code
re-raises it *without* running rollback/abort handlers — the in-memory
session is then abandoned exactly as a SIGKILL would leave it, and only
the on-disk state (WAL + checkpoints) carries into recovery.

File-level faults don't need a site: :func:`corrupt_checkpoint` damages a
published checkpoint step on disk (truncated arrays, garbage metadata, or
a missing file) for the ``load_snapshot`` fallback tests, and
:func:`malform` returns a poisoned copy of a point chunk (NaN/Inf rows,
wrong dims, wrong dtype) for the input-validation tests.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

SITES = frozenset({
    "serve.compact",
    "serve.assign.overflow",
    "serve.ingest.overflow",
    "serve.ingest.label",
    "serve.wal.append",
    "serve.wal.fsync",
    "serve.wal.rotate",
    "serve.compact.watermark",
    "serve.shard.assign",
    "serve.shard.probe",
    "serve.shard.rematerialize",
    "serve.shard.ingest",
})


class Kill(BaseException):
    """Simulated process death (kill-at-every-site matrix). Derives from
    ``BaseException`` so ``except Exception`` recovery paths never absorb
    it, and the serving code's explicit ``except Kill: raise`` clauses
    skip rollback/abort — in-memory state is abandoned mid-flight, as a
    real SIGKILL would leave it."""


@dataclasses.dataclass
class Fault:
    """One armed fault: fires ``times`` times (-1 = every call), sleeping
    ``delay`` seconds and/or raising ``error`` at each firing. ``tag``
    narrows the fault to fire-calls whose tag starts with it (per-target
    shard faults); None matches every call at the site."""
    site: str
    error: Optional[BaseException] = None
    delay: float = 0.0
    times: int = 1
    tag: Optional[str] = None
    fired: int = 0

    @property
    def armed(self) -> bool:
        return self.times < 0 or self.fired < self.times

    def matches(self, tag: Optional[str]) -> bool:
        return self.tag is None or (tag is not None
                                    and tag.startswith(self.tag))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _REGISTRY.pop((self.site, self.tag), None)
        return False


_REGISTRY: dict = {}   # (site, tag) -> Fault


def inject(site: str, *, error: Optional[BaseException] = None,
           delay: float = 0.0, times: int = 1,
           tag: Optional[str] = None) -> Fault:
    """Arm ``site`` (replacing any previous fault at the same
    ``(site, tag)``). Returns the :class:`Fault`, usable as a context
    manager that disarms on exit."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; known: "
                         + ", ".join(sorted(SITES)))
    f = Fault(site=site, error=error, delay=delay, times=times, tag=tag)
    _REGISTRY[(site, tag)] = f
    return f


def clear(site: Optional[str] = None, tag: Optional[str] = None) -> None:
    """Disarm every fault at one site (any tag), or everything when
    ``site`` is None; with ``tag`` only that exact arming."""
    if site is None:
        _REGISTRY.clear()
        return
    for key in [k for k in _REGISTRY
                if k[0] == site and (tag is None or k[1] == tag)]:
        _REGISTRY.pop(key, None)


def fire(site: str, tag: Optional[str] = None) -> bool:
    """Production-side hook: fire the fault armed at ``site``, if any.

    ``tag`` is the caller's identity at per-target sites (the router
    passes ``shard-00j/rK``); a fault fires only when its own tag is a
    prefix of it (untagged faults always match). The most specific armed
    match (longest tag) fires. Returns True when an armed fault fired
    (boolean faults — e.g. a forced overflow flag), after sleeping its
    ``delay``; raises its ``error`` if one was attached. Disarmed sites
    return False at dict-lookup cost on a normally empty registry.
    """
    if not _REGISTRY:
        return False
    hit = None
    for (s, _t), f in _REGISTRY.items():
        if s == site and f.armed and f.matches(tag):
            if hit is None or len(f.tag or "") > len(hit.tag or ""):
                hit = f
    if hit is None:
        return False
    hit.fired += 1
    if hit.delay:
        time.sleep(hit.delay)
    if hit.error is not None:
        raise hit.error
    return True


def fired_count(site: str, tag: Optional[str] = None) -> int:
    return sum(f.fired for (s, t), f in _REGISTRY.items()
               if s == site and (tag is None or t == tag))


# --- file-level faults ------------------------------------------------------


def corrupt_checkpoint(ckpt_dir: str, step: int, *,
                       mode: str = "truncate") -> str:
    """Damage a *published* checkpoint step in place (crash-after-publish /
    bit-rot scenarios the atomic rename cannot rule out).

    Modes: ``truncate`` (arrays.npz cut to 16 bytes), ``garbage-meta``
    (meta.json overwritten with non-JSON), ``missing-arrays`` (arrays.npz
    deleted). Returns the damaged step directory path.
    """
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    arrays = os.path.join(path, "arrays.npz")
    if mode == "truncate":
        with open(arrays, "rb") as f:
            head = f.read(16)
        with open(arrays, "wb") as f:
            f.write(head)
    elif mode == "garbage-meta":
        with open(os.path.join(path, "meta.json"), "w") as f:
            f.write("{not json")
    elif mode == "missing-arrays":
        os.remove(arrays)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path


def malform(chunk, kind: str):
    """A poisoned copy of ``chunk`` for input-validation tests.

    Kinds: ``nan`` / ``inf`` (one coordinate poisoned), ``wrong-dims``
    ((m, 2) columns), ``wrong-dtype`` (complex64), ``wrong-rank`` (1-D).
    """
    a = np.array(chunk, copy=True)
    if kind == "nan":
        a[len(a) // 2, 0] = np.nan
    elif kind == "inf":
        a[len(a) // 2, 1] = np.inf
    elif kind == "wrong-dims":
        a = a[:, :2]
    elif kind == "wrong-dtype":
        a = a.astype(np.complex64)
    elif kind == "wrong-rank":
        a = a.reshape(-1)
    else:
        raise ValueError(f"unknown malform kind {kind!r}")
    return a
