"""Microbatch shape scheduler: bucketed padding for a fixed set of
program shapes.

A serving frontend sees request batches of every size. The scheduler
quantizes batch sizes to a small fixed ladder of power-of-two *buckets*:
the kernels of the cross-query program then see one shape per bucket (and
the plan's slab), the live count travels as a plain argument, and padded
rows sit at +BIG where they can never hit a finite corpus point. The cost
is bounded padding waste (< 2x rows; padded lanes are masked out of the
slab windows, so they cost no candidate work).

The scheduler also owns the serving telemetry: per-call latencies (p50/p99
come from here, over a bounded window), calls, and the *recompile count*.
The port runs eagerly and compiles nothing per shape, so ``recompiles``
counts what the reference counts as traces: distinct program keys
(snapshot plan + bucket + slab + block_q + device, as built by the assign
path). A scheduler shared across snapshots stays honest because the plan
is part of the key, and regrow retries note their intermediate keys too.
"""
from __future__ import annotations

import collections
import dataclasses
import numpy as np

BIG = 1e30


@dataclasses.dataclass
class BucketScheduler:
    """Shape buckets + serving stats (see module docstring).

    ``min_bucket`` must be a multiple of the cross-query tile (block_q);
    the default matches the kernel default. ``max_bucket`` bounds a single
    device program — larger requests should be split upstream.
    """
    min_bucket: int = 256
    max_bucket: int = 1 << 15
    latency_window: int = 1 << 16  # bounded: long-lived loops must not leak

    def __post_init__(self):
        assert self.min_bucket > 0 and self.max_bucket >= self.min_bucket
        self._seen_keys: set = set()
        self.calls: int = 0
        self.recompiles: int = 0
        self.regrows: int = 0
        self.routed = collections.Counter()  # shards-per-query histogram
        self._latencies = collections.deque(maxlen=self.latency_window)
        # failure-domain telemetry (DESIGN.md §16): scatter legs that
        # failed over to another replica, hedged duplicates issued,
        # retryable-leg retries, active probes, and partial gathers served
        self.failovers: int = 0
        self.hedges: int = 0
        self.leg_retries: int = 0
        self.probes: int = 0
        self.partials: int = 0

    # --- shape bucketing ---------------------------------------------------

    def bucket(self, nq: int) -> int:
        """Smallest power-of-two bucket holding ``nq`` queries."""
        if nq > self.max_bucket:
            raise ValueError(
                f"batch of {nq} queries exceeds max_bucket="
                f"{self.max_bucket}; split the request upstream")
        b = self.min_bucket
        while b < nq:
            b <<= 1
        return b

    def buckets_upto(self, nq: int) -> list:
        """The bucket ladder a warmup pass should run, largest last."""
        out = [self.min_bucket]
        while out[-1] < min(nq, self.max_bucket):
            out.append(out[-1] * 2)
        return out

    def pad(self, queries: np.ndarray) -> tuple:
        """Pad ``queries`` (nq, 3) to its bucket with +BIG rows.

        Returns (padded (B, 3) f32, nq). Padded rows are geometrically dead:
        +BIG coordinates can never be within ε of a finite corpus point, and
        the cross-query program additionally masks them out of the slab
        windows by live count.
        """
        q = np.asarray(queries, np.float32)
        assert q.ndim == 2 and q.shape[1] == 3, q.shape
        nq = q.shape[0]
        B = self.bucket(nq)
        if B == nq:
            return q, nq
        pad = np.full((B - nq, 3), BIG, np.float32)
        return np.concatenate([q, pad]), nq

    # --- telemetry ---------------------------------------------------------

    def note_trace(self, key) -> None:
        """Record a program key without a served call — regrow retries run
        intermediate programs that must not hide from the recompile count."""
        if key not in self._seen_keys:
            self._seen_keys.add(key)
            self.recompiles += 1

    def note_call(self, key, seconds: float) -> None:
        """Record one served call under program ``key``."""
        self.note_trace(key)
        self.calls += 1
        self._latencies.append(seconds)

    def note_route(self, shards_per_query) -> None:
        """Record the sharded router's fan-out: one histogram bump per
        query, keyed by how many shards its ε-dilated window touched
        (DESIGN.md §15.2 — the locality claim is that this is almost
        always 1, occasionally 2, and 0 for far-away queries)."""
        self.routed.update(int(v) for v in np.asarray(shards_per_query)
                           .ravel())

    def note_regrow(self) -> None:
        """Record one slab overflow → regrow retry (assign or delta
        labeling). A nonzero steady-state rate means the corpus plan's
        slab is chronically undersized for the live query distribution —
        the operator signal behind DESIGN.md §12's bounded-regrow cap."""
        self.regrows += 1

    def note_failover(self) -> None:
        """One scatter leg abandoned its target and moved to the next
        live replica (or exhausted the ring into a partial gather)."""
        self.failovers += 1

    def note_hedge(self) -> None:
        """One suspect leg was duplicated to a second replica (§16.2) —
        first result wins, the loser's work is discarded."""
        self.hedges += 1

    def note_leg_retry(self) -> None:
        """One retryable leg error absorbed by jittered backoff."""
        self.leg_retries += 1

    def note_probe(self) -> None:
        """One active health heartbeat served (§16.1)."""
        self.probes += 1

    def note_partial(self) -> None:
        """One gather answered without every routed shard (§16.3)."""
        self.partials += 1

    def reset_stats(self) -> None:
        """Zero counters but *keep* the seen shape keys — the post-warmup
        recompile count should report only genuinely new program keys."""
        self.calls = 0
        self.recompiles = 0
        self.regrows = 0
        self.routed.clear()
        self._latencies.clear()
        self.failovers = 0
        self.hedges = 0
        self.leg_retries = 0
        self.probes = 0
        self.partials = 0

    def latency_percentiles(self, qs=(50, 99)) -> tuple:
        if not self._latencies:
            return tuple(float("nan") for _ in qs)
        arr = np.asarray(self._latencies)
        return tuple(float(np.percentile(arr, q)) for q in qs)
