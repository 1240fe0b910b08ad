"""Online clustering service of the port: a single serving session.

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

Entry points run on ``cuda`` unless given ``device="cpu"``
(``build_snapshot``, ``load_snapshot``, ``ServeSession.recover``); a
session and ``assign`` run on their snapshot's device. Snapshots and WALs
are interchangeable with the JAX reference's (``repro.serve``). The
reference's sharded tier (``ShardedTier``, ``split_snapshot``,
``HealthRegistry``) is not ported yet; ``faults.SITES`` already holds its
fault sites.
"""
from .assign import AssignResult, assign  # noqa: F401
from .ingest import (IngestResult, RecoveryReport,  # noqa: F401
                     ServeSession)
from .resilience import (AdmissionError, AdmissionQueue,  # noqa: F401
                         Backoff, CapacityError, CircuitBreaker,
                         CompactionError, ServeError, SnapshotFormatError,
                         ValidationError, validate_points)
from .scheduler import BucketScheduler  # noqa: F401
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
]
