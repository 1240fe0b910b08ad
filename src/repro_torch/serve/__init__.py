"""Online clustering service of the port: serving sessions and the
sharded tier.

Batch clustering builds an index, labels the corpus, and discards both;
serving keeps them: freeze a clustered index as a :class:`ClusterSnapshot`
(atomic save/load with corrupt-version fallback), answer new-point queries
with :func:`assign` (the ``cross_sweep`` kernel, DBSCAN-predict semantics),
and stream new points through :class:`ServeSession` (bounded delta buffer,
parity-tested compaction). :class:`BucketScheduler` pads request batches
to a small ladder of power-of-two buckets.

The resilience envelope (``resilience.py``, ``faults.py``) wraps all of
it: a structured :class:`ServeError` taxonomy, input validation before
quantization, a :class:`CircuitBreaker` around compaction, a bounded
:class:`AdmissionQueue` shedding load explicitly, idempotent ingest via
request ids, and a deterministic fault-injection harness. The durability
subsystem (``wal.py``) makes acknowledged ingests survive process death:
a segmented, CRC-framed :class:`WriteAheadLog` is written *before* a
chunk is applied, compactions stamp watermarks, and
:meth:`ServeSession.recover` replays the log suffix past the newest
intact snapshot.

The sharded tier (``shard.py``, ``router.py``) lifts all of it from one
snapshot to many: :func:`split_snapshot` partitions the Morton-sorted
corpus into shards with shard-local label tables, and
:class:`ShardedTier` scatter-gathers ``assign``/``ingest`` across them —
merged answers and tier compactions stay bit-identical to the
single-snapshot path, with per-shard WALs and checkpoint namespaces.
Failure domains (``health.py``) finish the envelope at tier scope: a
per-target :class:`HealthRegistry` (passive leg signals and active
deadline-bounded probes, healthy → suspect → down → recovering), replica
failover and hedged legs, jittered :class:`Backoff` on retryable legs,
partial gathers with per-shard :class:`LegStatus`, and per-shard
quarantine and re-materialization from checkpoint namespaces.

Entry points run on ``cuda`` unless given ``device="cpu"``
(``build_snapshot``, ``load_snapshot``, ``ServeSession.recover``,
``ShardedTier.build``); a session, a tier built from a snapshot and
``assign`` run on their snapshot's device, and a tier places its shards on
every visible card (its snapshot's device when that is the CPU).
Snapshots, WALs and shard checkpoint namespaces are interchangeable with
the JAX reference's (``repro.serve``).
"""
from .assign import AssignResult, assign  # noqa: F401
from .health import (DOWN, HEALTHY, RECOVERING, SUSPECT,  # noqa: F401
                     HealthRegistry, TargetHealth)
from .ingest import (IngestResult, RecoveryReport,  # noqa: F401
                     ServeSession)
from .resilience import (AdmissionError, AdmissionQueue,  # noqa: F401
                         Backoff, CapacityError, CircuitBreaker,
                         CompactionError, ServeError, SnapshotFormatError,
                         ValidationError, validate_points)
from .router import LegStatus, ShardedTier  # noqa: F401
from .scheduler import BucketScheduler  # noqa: F401
from .shard import (ShardMap, ShardPart, split_snapshot,  # noqa: F401
                    target_tag)
from .snapshot import (ClusterSnapshot, build_snapshot,  # noqa: F401
                       load_snapshot, published_wal_offsets, save_snapshot)
from .wal import WalRecord, WriteAheadLog  # noqa: F401
from . import faults  # noqa: F401

__all__ = [
    "AssignResult", "assign", "IngestResult", "RecoveryReport",
    "ServeSession", "BucketScheduler", "ClusterSnapshot", "build_snapshot",
    "load_snapshot", "published_wal_offsets", "save_snapshot", "ServeError",
    "ValidationError", "AdmissionError", "CapacityError", "CompactionError",
    "SnapshotFormatError", "CircuitBreaker", "AdmissionQueue", "Backoff",
    "validate_points", "WalRecord", "WriteAheadLog", "faults",
    "ShardedTier", "ShardMap", "ShardPart", "split_snapshot",
    "HealthRegistry", "TargetHealth", "HEALTHY", "SUSPECT", "DOWN",
    "RECOVERING", "LegStatus", "target_tag",
]
