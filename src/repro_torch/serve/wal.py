"""Write-ahead delta log: the serving tier's durable change log.

The ROADMAP's event-sourcing grounding says the delta buffer *is* a
change log; until this module it was an in-memory one, so a process
crash silently dropped every acknowledged ingest since the last
published snapshot. :class:`WriteAheadLog` makes the log real
(DESIGN.md §14): an append-only, segmented, CRC-framed file log that
``ServeSession`` writes **before** applying a chunk, so an ingest is
only acknowledged once it is durable (log → apply → ack), and replays
after the newest intact snapshot reconstruct exactly the acknowledged
state.

Frame format (little-endian, DESIGN.md §14.2)::

    magic "WALF" | type u8 | seq u64 | payload_len u32 | crc u32 | payload

``crc`` is CRC-32 over ``type|seq|payload_len|payload``, so a frame is
self-validating: a torn tail (the process died mid-``write``), a
garbage frame (bit-rot), or a short header all fail the same check.
Record types:

  * ``INGEST``    — one acknowledged-or-in-flight chunk: optional
    ``request_id`` (the idempotency key replay feeds back through the
    dedup window) + the raw float32 point payload;
  * ``WATERMARK`` — a compaction publish: ``(checkpoint step, applied
    log offset)``. Everything below the offset is folded into that
    step's snapshot; segments wholly below the oldest watermark of the
    *newest keep-K* snapshots are garbage-collected, and the checkpoint
    layer's keep-K GC pins every step a live watermark still references
    (a transient, segment-granularity pin: the watermark record unlinks
    with its segment, releasing the pin at the next publish — so neither
    the log nor the checkpoint dir ratchets);
  * ``ABORT``     — an in-process ingest failure after its INGEST frame
    was written (label program raised, rollback ran): replay skips the
    aborted ``seq``. A *crash* (no ABORT) leaves the chunk replayable —
    logged-but-unacked work is applied in full on recovery, never
    partially.

Durability is configurable per log: ``"fsync"`` (flush + ``os.fsync``
per append — an acked write survives OS/power death), ``"flush"``
(user-space buffers drained; survives process death, not kernel death),
``"none"`` (buffered; fastest, replay is best-effort). The segmented
layout (``wal-<start offset>.log``) keeps GC a file unlink, never a
rewrite.

Opening a log **is** crash recovery for the log itself: segments are
scanned in offset order and the scan truncates at the first bad frame
with a :class:`RuntimeWarning` (torn-tail detection) — everything
before it is intact by CRC, everything after it is unreachable framing
and is dropped, including any later segments.

Crash sites (``serve.wal.append``, ``serve.wal.fsync``,
``serve.wal.rotate`` — see ``serve/faults.py``) fire inside the append
path so the kill-at-every-site matrix in ``tests/test_wal.py`` can die
deterministically at each durability boundary.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import warnings
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import faults

MAGIC = b"WALF"
REC_INGEST, REC_WATERMARK, REC_ABORT = 1, 2, 3
_KINDS = {REC_INGEST: "ingest", REC_WATERMARK: "watermark",
          REC_ABORT: "abort"}
# magic(4) type(u8) seq(u64) payload_len(u32) crc(u32)
_HEADER = struct.Struct("<4sBQII")


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded frame. ``offset``/``end`` are *global* log offsets
    (monotone across segments) — ``end`` is what a watermark quotes and
    what ``ServeSession`` tracks as its applied position."""
    kind: str
    seq: int
    offset: int
    end: int
    chunk: Optional[np.ndarray] = None        # ingest
    request_id: Optional[str] = None          # ingest
    step: Optional[int] = None                # watermark
    watermark_offset: Optional[int] = None    # watermark
    aborted_seq: Optional[int] = None         # abort


def _encode_ingest(chunk: np.ndarray, request_id: Optional[str]) -> bytes:
    rid = (request_id or "").encode("utf-8")
    m, cols = chunk.shape
    return (struct.pack("<H", len(rid)) + rid
            + struct.pack("<II", m, cols)
            + np.ascontiguousarray(chunk, np.float32).tobytes())


def _decode_payload(rtype: int, payload: bytes) -> dict:
    if rtype == REC_INGEST:
        (rid_len,) = struct.unpack_from("<H", payload, 0)
        rid = payload[2:2 + rid_len].decode("utf-8") or None
        m, cols = struct.unpack_from("<II", payload, 2 + rid_len)
        body = payload[2 + rid_len + 8:]
        if len(body) != m * cols * 4:
            raise ValueError("ingest payload length mismatch")
        chunk = np.frombuffer(body, np.float32).reshape(m, cols).copy()
        return {"chunk": chunk, "request_id": rid}
    if rtype == REC_WATERMARK:
        step, off = struct.unpack("<qQ", payload)
        return {"step": int(step), "watermark_offset": int(off)}
    if rtype == REC_ABORT:
        (seq,) = struct.unpack("<Q", payload)
        return {"aborted_seq": int(seq)}
    raise ValueError(f"unknown record type {rtype}")


def _segment_name(start: int) -> str:
    return f"wal-{start:016d}.log"


def _segment_start(name: str) -> int:
    return int(name[4:-4])


class WriteAheadLog:
    """Segmented append-only WAL (module docstring; DESIGN.md §14).

    ``__init__`` opens-or-creates the log at ``wal_dir``: existing
    segments are scanned, a torn tail is truncated with a warning
    (``truncated_bytes`` records how much), and the append position
    resumes at the end of the last intact frame. The same open is what
    :meth:`ServeSession.recover` does before replaying.
    """

    def __init__(self, wal_dir: str, *, durability: str = "fsync",
                 segment_bytes: int = 4 << 20):
        if durability not in ("fsync", "flush", "none"):
            raise ValueError(
                f"durability={durability!r}; expected 'fsync', 'flush' or "
                "'none'")
        self.wal_dir = wal_dir
        self.durability = durability
        self.segment_bytes = int(segment_bytes)
        self.truncated_bytes = 0
        self.n_rotations = 0
        os.makedirs(wal_dir, exist_ok=True)
        self._scan_and_repair()

    # --- open / repair ------------------------------------------------------

    def _segments(self) -> List[str]:
        return sorted(f for f in os.listdir(self.wal_dir)
                      if f.startswith("wal-") and f.endswith(".log"))

    def _scan_and_repair(self) -> None:
        """Walk every frame; truncate at the first bad one (torn tail)."""
        self._seq = 0
        segs = self._segments()
        bad_at: Optional[Tuple[int, int]] = None  # (segment idx, local off)
        for i, name in enumerate(segs):
            path = os.path.join(self.wal_dir, name)
            start = _segment_start(name)
            with open(path, "rb") as f:
                data = f.read()
            local = 0
            while local < len(data):
                frame = self._parse_frame(data, local, start)
                if frame is None:
                    bad_at = (i, local)
                    break
                rec_len, seq = frame
                self._seq = max(self._seq, seq + 1)
                local += rec_len
            if bad_at is not None:
                break
        if bad_at is not None:
            i, local = bad_at
            path = os.path.join(self.wal_dir, segs[i])
            lost = os.path.getsize(path) - local
            for later in segs[i + 1:]:
                lost += os.path.getsize(os.path.join(self.wal_dir, later))
                os.remove(os.path.join(self.wal_dir, later))
            with open(path, "r+b") as f:
                f.truncate(local)
            self.truncated_bytes = lost
            warnings.warn(
                f"WAL {self.wal_dir}: bad frame at global offset "
                f"{_segment_start(segs[i]) + local} (torn write or "
                f"corruption); truncated {lost} byte(s) — records before "
                "it are intact by CRC, records after it are unreachable",
                RuntimeWarning)
            segs = segs[:i + 1]
        if not segs:
            self._seg_start = 0
            self._file = open(
                os.path.join(self.wal_dir, _segment_name(0)), "ab")
        else:
            last = segs[-1]
            self._seg_start = _segment_start(last)
            self._file = open(os.path.join(self.wal_dir, last), "ab")
        self._pos = self._seg_start + self._file.tell()

    @staticmethod
    def _parse_frame(data: bytes, local: int, seg_start: int) \
            -> Optional[Tuple[int, int]]:
        """Validate one frame at ``local``; (frame_len, seq) or None."""
        if local + _HEADER.size > len(data):
            return None
        magic, rtype, seq, plen, crc = _HEADER.unpack_from(data, local)
        if magic != MAGIC or rtype not in _KINDS:
            return None
        end = local + _HEADER.size + plen
        if end > len(data):
            return None
        payload = data[local + _HEADER.size:end]
        if zlib.crc32(data[local + 4:local + 4 + 13] + payload) != crc:
            return None
        return _HEADER.size + plen, seq

    # --- append side ---------------------------------------------------------

    @property
    def position(self) -> int:
        """Global offset just past the last appended frame."""
        return self._pos

    @property
    def oldest_offset(self) -> int:
        """Global offset of the first byte still retained (post-GC).
        Replay can serve any baseline whose watermark is >= this; a
        baseline below it has lost part of its suffix to GC and
        :meth:`ServeSession.recover` refuses it."""
        segs = self._segments()
        return _segment_start(segs[0]) if segs else self._seg_start

    def _sync(self) -> None:
        if self.durability == "none":
            return
        self._file.flush()
        if self.durability == "fsync":
            faults.fire("serve.wal.fsync")  # chaos: die inside fsync —
            #   bytes are flushed (replayable), the ack never happens
            os.fsync(self._file.fileno())

    def _maybe_rotate(self) -> None:
        if self._pos - self._seg_start < self.segment_bytes:
            return
        self._file.flush()
        if self.durability == "fsync":
            os.fsync(self._file.fileno())
        self._file.close()
        faults.fire("serve.wal.rotate")  # chaos: die between segments —
        #   the old segment ends on a frame boundary, nothing is torn
        self._seg_start = self._pos
        self._file = open(
            os.path.join(self.wal_dir, _segment_name(self._seg_start)), "ab")
        self.n_rotations += 1

    def _append(self, rtype: int, payload: bytes) -> WalRecord:
        faults.fire("serve.wal.append")  # chaos: die before any byte lands
        self._maybe_rotate()
        seq = self._seq
        self._seq += 1
        head_wo_magic = struct.pack("<BQI", rtype, seq, len(payload))
        crc = zlib.crc32(head_wo_magic + payload)
        offset = self._pos
        self._file.write(MAGIC + head_wo_magic + struct.pack("<I", crc)
                         + payload)
        self._pos = offset + _HEADER.size + len(payload)
        self._sync()
        return WalRecord(kind=_KINDS[rtype], seq=seq, offset=offset,
                         end=self._pos, **_decode_payload(rtype, payload))

    def append_ingest(self, chunk: np.ndarray, *,
                      request_id: Optional[str] = None) -> WalRecord:
        """Log one ingest chunk. Must complete before the chunk is applied
        — the 'log' of log → apply → ack."""
        return self._append(REC_INGEST, _encode_ingest(chunk, request_id))

    def append_watermark(self, step: int, applied_offset: int) -> WalRecord:
        """Stamp a compaction publish: checkpoint ``step`` holds every
        record below ``applied_offset``."""
        return self._append(REC_WATERMARK,
                            struct.pack("<qQ", step, applied_offset))

    def append_abort(self, seq: int) -> WalRecord:
        """Neutralize a logged-but-failed ingest (in-process failure path;
        a crash writes no abort and the chunk replays in full)."""
        return self._append(REC_ABORT, struct.pack("<Q", seq))

    # --- read side -----------------------------------------------------------

    def records(self, start: int = 0) -> Iterator[WalRecord]:
        """Decode every intact frame with ``offset >= start``, in order.

        Reads from disk via the same CRC walk as the repair scan (the
        append handle is flushed first so a same-process reader sees its
        own writes even under ``durability='none'``)."""
        self._file.flush()
        for name in self._segments():
            seg_start = _segment_start(name)
            with open(os.path.join(self.wal_dir, name), "rb") as f:
                data = f.read()
            local = 0
            while local < len(data):
                frame = self._parse_frame(data, local, seg_start)
                if frame is None:  # pragma: no cover - repaired at open
                    return
                rec_len, _ = frame
                if seg_start + local >= start:
                    magic, rtype, seq, plen, _ = _HEADER.unpack_from(
                        data, local)
                    payload = data[local + _HEADER.size:local + rec_len]
                    yield WalRecord(
                        kind=_KINDS[rtype], seq=seq,
                        offset=seg_start + local,
                        end=seg_start + local + rec_len,
                        **_decode_payload(rtype, payload))
                local += rec_len

    def live_watermarks(self) -> List[Tuple[int, int]]:
        """(step, applied_offset) of every watermark record still in the
        log — the steps the checkpoint keep-K GC must pin."""
        return [(r.step, r.watermark_offset) for r in self.records()
                if r.kind == "watermark"]

    # --- gc -----------------------------------------------------------------

    def gc(self, min_offset: int) -> List[str]:
        """Unlink segments wholly below ``min_offset`` (every frame in
        them is folded into a retained snapshot). The active segment is
        never removed. Returns the deleted file names."""
        segs = self._segments()
        deleted = []
        for name, nxt in zip(segs, segs[1:]):  # last (active) never deleted
            if _segment_start(nxt) <= min_offset:
                os.remove(os.path.join(self.wal_dir, name))
                deleted.append(name)
            else:
                break
        return deleted

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            if self.durability == "fsync":
                os.fsync(self._file.fileno())
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
