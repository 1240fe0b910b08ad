"""repro_torch's durable ingest on the CPU, mirroring tests/test_wal.py:
WAL framing, torn-write repair, crash-consistent recovery, the
kill-at-every-site chaos matrix and a real SIGKILL in a subprocess; plus
WALs and snapshots that one package writes and the other recovers to the
same labels.

The bar: for each armed crash site, recovery yields
labels bit-identical to batch ``dbscan()`` on the snapshot corpus plus
every *acked* delta; a logged-but-unacked chunk may additionally appear
— applied in full, never partially; replaying an already-applied chunk
(duplicated tail frame, double recovery) is a byte-level no-op.
"""
import os
import shutil
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core.dbscan import dbscan as jdbscan
from repro.data import synth
from repro_torch import serve
from repro_torch.core import dbscan as _tdbscan
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.serve import faults
from repro_torch.serve.wal import WriteAheadLog, _HEADER

EPS, MINPTS = 0.05, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small tensor operations; beside other test
    workers on the same cores, torch's intra-op threads would mostly wait
    for each other. One thread each keeps them fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def dbscan(pts, eps, min_pts, engine="grid"):
    return _tdbscan.dbscan(pts, eps, min_pts, engine=engine, device="cpu")


def _build(pts):
    return serve.build_snapshot(pts, EPS, MINPTS, device="cpu")


def _recover(ck_dir, wal_dir, **kw):
    return serve.ServeSession.recover(ck_dir, wal_dir, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _chunks(pts, start, size=60):
    return [pts[i:i + size] for i in range(start, len(pts), size)]


def _points_of(sess) -> np.ndarray:
    return np.concatenate([np.asarray(sess.snapshot.points), sess._delta])


def _assert_batch_parity(sess, pts):
    """The recovery invariant: after folding, labels are bit-identical to
    batch ``dbscan()`` on exactly the recovered point set."""
    sess.compact(force=True)
    full = dbscan(pts, EPS, MINPTS, engine="grid")
    np.testing.assert_array_equal(np.asarray(sess.snapshot.labels),
                                  np.asarray(full.labels))
    np.testing.assert_array_equal(np.asarray(sess.snapshot.core),
                                  np.asarray(full.core))


def _tree_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


# --- frame/segment mechanics -------------------------------------------------


def test_frame_roundtrip_across_rotation(tmp_path):
    wal = WriteAheadLog(str(tmp_path), durability="flush",
                        segment_bytes=256)
    rng = np.random.default_rng(0)
    sent = []
    for i in range(7):
        c = rng.uniform(0, 1, (5 + i, 3)).astype(np.float32)
        rid = f"r{i}" if i % 2 else None
        wal.append_ingest(c, request_id=rid)
        sent.append((c, rid))
    wal.append_watermark(3, wal.position)
    wal.append_abort(2)
    assert wal.n_rotations > 0  # 256-byte segments force rotation
    recs = list(wal.records())
    ing = [r for r in recs if r.kind == "ingest"]
    assert len(ing) == 7
    for r, (c, rid) in zip(ing, sent):
        np.testing.assert_array_equal(r.chunk, c)
        assert r.request_id == rid
    wm = [r for r in recs if r.kind == "watermark"]
    ab = [r for r in recs if r.kind == "abort"]
    assert wm[0].step == 3 and ab[0].aborted_seq == 2
    # offsets are global, contiguous, and frame-aligned
    for a, b in zip(recs, recs[1:]):
        assert a.end == b.offset
    # reopening resumes seq numbering and position
    pos = wal.position
    wal.close()
    wal2 = WriteAheadLog(str(tmp_path), durability="flush",
                         segment_bytes=256)
    assert wal2.position == pos and wal2.truncated_bytes == 0
    r = wal2.append_ingest(sent[0][0])
    assert r.seq == 9  # 7 ingests + watermark + abort


def test_rejects_unknown_durability(tmp_path):
    with pytest.raises(ValueError, match="durability"):
        WriteAheadLog(str(tmp_path), durability="sync-ish")


@pytest.mark.parametrize("mode", ["mid-frame", "mid-header", "garbage"])
def test_torn_tail_truncates_at_first_bad_frame(tmp_path, mode):
    wal = WriteAheadLog(str(tmp_path), durability="flush")
    rng = np.random.default_rng(1)
    cs = [rng.uniform(0, 1, (8, 3)).astype(np.float32) for _ in range(3)]
    ends = [wal.append_ingest(c).end for c in cs]
    wal.close()
    seg = os.path.join(str(tmp_path), "wal-0000000000000000.log")
    if mode == "mid-frame":
        cut = ends[1] + _HEADER.size + 5      # last frame: payload torn
    elif mode == "mid-header":
        cut = ends[1] + _HEADER.size - 3      # last frame: header torn
    else:
        cut = None
    if cut is not None:
        with open(seg, "r+b") as f:
            f.truncate(cut)
    else:  # garbage: flip payload bytes of the LAST frame (CRC mismatch)
        with open(seg, "r+b") as f:
            f.seek(ends[1] + _HEADER.size + 2)
            f.write(b"\xde\xad\xbe\xef")
    with pytest.warns(RuntimeWarning, match="torn write or corruption"):
        wal2 = WriteAheadLog(str(tmp_path), durability="flush")
    assert wal2.truncated_bytes > 0
    survivors = [r for r in wal2.records() if r.kind == "ingest"]
    assert len(survivors) == 2  # everything before the bad frame is intact
    for r, c in zip(survivors, cs):
        np.testing.assert_array_equal(r.chunk, c)
    # the log is append-ready again at the repaired tail
    assert wal2.position == ends[1]
    wal2.append_ingest(cs[0])
    assert len(list(wal2.records())) == 3


def test_bad_frame_mid_log_drops_later_segments(tmp_path):
    wal = WriteAheadLog(str(tmp_path), durability="flush",
                        segment_bytes=128)
    rng = np.random.default_rng(2)
    for _ in range(6):
        wal.append_ingest(rng.uniform(0, 1, (6, 3)).astype(np.float32))
    wal.close()
    segs = sorted(f for f in os.listdir(str(tmp_path)))
    assert len(segs) >= 3
    with open(os.path.join(str(tmp_path), segs[1]), "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00\x00\x00")  # corrupt the second segment
    with pytest.warns(RuntimeWarning):
        wal2 = WriteAheadLog(str(tmp_path), durability="flush")
    # framing after the bad frame is unreachable: later segments are gone
    assert sorted(os.listdir(str(tmp_path))) == segs[:2]
    assert all(r.offset < int(segs[2][4:-4]) for r in wal2.records())


# --- keep-K pin (satellite: checkpoint GC must not orphan a watermark) -------


def test_checkpoint_gc_pins_explicit_steps(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": np.arange(3)}
    for s in range(1, 6):
        ckpt.save(d, s, tree, keep=2, pin={1, 2})
    # keep-2 would leave {4, 5}; the pin protects the watermark baselines
    assert ckpt.available_steps(d) == [1, 2, 4, 5]
    # dropping the pin lets the next save reclaim them
    ckpt.save(d, 6, tree, keep=2)
    assert ckpt.available_steps(d) == [5, 6]


def test_compaction_pins_live_watermark_baseline(tmp_path):
    """End to end: with keep=1, steps referenced by live WAL watermarks
    survive GC, so damaging every newer snapshot still leaves recovery a
    baseline + full replay suffix (the orphaned-baseline regression)."""
    pts = synth.blobs(640, k=3, seed=11)
    corpus, chunks = pts[:400], _chunks(pts, 400)
    wal_dir, ck_dir = str(tmp_path / "wal"), str(tmp_path / "snap")
    sess = serve.ServeSession(
        _build(corpus),
        wal=WriteAheadLog(wal_dir), ckpt_dir=ck_dir,
        max_delta_frac=0.2, keep=1)
    for i, c in enumerate(chunks):
        sess.ingest(c, request_id=f"c{i}")
    assert sess.n_compactions >= 1
    steps = ckpt.available_steps(ck_dir)
    assert len(steps) > 1  # keep=1, yet watermark-pinned steps survive
    # every retained step's watermark still has its replay suffix on disk
    offs = serve.published_wal_offsets(ck_dir)
    assert set(offs) == set(steps)
    sess.wal.close()
    # damage everything but the oldest: recovery falls back and replays
    for s in steps[1:]:
        faults.corrupt_checkpoint(ck_dir, s, mode="truncate")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sess2 = _recover(ck_dir, wal_dir, max_delta_frac=0.2)
    assert sess2.last_recovery.baseline_step == steps[0]
    assert sess2.last_recovery.replayed_chunks > 0
    np.testing.assert_array_equal(_points_of(sess2), pts)
    _assert_batch_parity(sess2, pts)


def test_wal_gc_unlinks_segments_and_never_ratchets(tmp_path):
    """The GC bound is the oldest watermark of the newest keep-K steps:
    old segments (and the old steps their watermarks pinned) actually get
    reclaimed, every keep-K baseline keeps its whole replay suffix, and
    recovery from the trimmed log is exact."""
    pts = synth.blobs(760, k=3, seed=12)
    corpus, chunks = pts[:280], _chunks(pts, 280)
    wal_dir, ck_dir = str(tmp_path / "wal"), str(tmp_path / "snap")
    sess = serve.ServeSession(
        _build(corpus),
        wal=WriteAheadLog(wal_dir, segment_bytes=512),
        ckpt_dir=ck_dir, max_delta_frac=0.15, keep=2)
    for i, c in enumerate(chunks):
        sess.ingest(c, request_id=f"c{i}")
    assert sess.n_compactions >= 3      # watermarks advanced several times
    segs = sorted(os.listdir(wal_dir))
    # segments were reclaimed (ever-created = rotations + 1) ...
    assert sess.wal.n_rotations + 1 > len(segs), "WAL never GC'd a segment"
    # ... step 0 was too: its watermark unlinked, so its pin released
    steps = ckpt.available_steps(ck_dir)
    assert 0 not in steps, "pin ratchet: step 0 retained forever"
    # every newest-keep baseline still has its whole suffix in the log
    offs = serve.published_wal_offsets(ck_dir)
    bound = min(offs[s] for s in sorted(offs)[-2:])
    assert sess.wal.oldest_offset <= bound, "keep-K baseline lost its suffix"
    # and recovery from what's on disk is still exact
    sess.wal.close()
    sess2 = _recover(ck_dir, wal_dir, max_delta_frac=0.15)
    np.testing.assert_array_equal(_points_of(sess2), pts)
    _assert_batch_parity(sess2, pts)


# --- log → apply → ack semantics ---------------------------------------------


def _durable_session(tmp_path, corpus, **kw):
    wal_dir, ck_dir = str(tmp_path / "wal"), str(tmp_path / "snap")
    kw.setdefault("max_delta_frac", np.inf)
    sess = serve.ServeSession(_build(corpus),
                              wal=WriteAheadLog(wal_dir), ckpt_dir=ck_dir,
                              **kw)
    return sess, wal_dir, ck_dir


def test_wal_requires_ckpt_dir(tmp_path):
    snap = _build(synth.blobs(120, k=2, seed=0))
    with pytest.raises(ValueError, match="ckpt_dir"):
        serve.ServeSession(snap, wal=WriteAheadLog(str(tmp_path / "w")))


def test_failed_apply_writes_abort_and_replay_skips_it(tmp_path):
    """In-process apply failure: delta rolls back, the logged frame is
    neutralized with ABORT, and recovery reproduces the no-trace contract
    — then a fresh post-recovery retry of the same request_id applies."""
    pts = synth.blobs(460, k=2, seed=13)
    corpus, chunks = pts[:340], _chunks(pts, 340)
    sess, wal_dir, ck_dir = _durable_session(tmp_path, corpus)
    sess.ingest(chunks[0], request_id="a")
    faults.inject("serve.ingest.label",
                  error=RuntimeError("label program died"), times=1)
    with pytest.raises(RuntimeError):
        sess.ingest(chunks[1], request_id="b")
    assert sess.n_delta == len(chunks[0])  # rolled back
    sess.wal.close()
    sess2 = _recover(ck_dir, wal_dir)
    rep = sess2.last_recovery
    assert rep.skipped_aborted == 1 and rep.replayed_chunks == 1
    np.testing.assert_array_equal(
        _points_of(sess2), np.concatenate([corpus, chunks[0]]))
    # the aborted id was never recorded: its retry is a fresh apply
    r = sess2.ingest(chunks[1], request_id="b")
    assert not r.deduped
    _assert_batch_parity(sess2, np.concatenate([corpus] + chunks[:2]))


def test_duplicated_tail_record_replays_as_noop(tmp_path):
    """An at-least-once writer can leave the same frame twice (byte-level
    duplicate): replay applies it once and skips the twin by seq."""
    pts = synth.blobs(420, k=2, seed=14)
    corpus, chunks = pts[:300], _chunks(pts, 300)
    sess, wal_dir, ck_dir = _durable_session(tmp_path, corpus)
    for i, c in enumerate(chunks):
        sess.ingest(c, request_id=f"c{i}")
    sess.wal.close()
    seg = sorted(os.listdir(wal_dir))[-1]
    path = os.path.join(wal_dir, seg)
    with WriteAheadLog(wal_dir, durability="none") as reader:
        last = [r for r in reader.records() if r.kind == "ingest"][-1]
    with open(path, "rb") as f:
        data = f.read()
    seg_start = int(seg[4:-4])
    dup = data[last.offset - seg_start:last.end - seg_start]
    with open(path, "ab") as f:
        f.write(dup)
    sess2 = _recover(ck_dir, wal_dir)
    assert sess2.last_recovery.skipped_duplicates == 1
    assert sess2.last_recovery.replayed_chunks == len(chunks)
    np.testing.assert_array_equal(_points_of(sess2), pts)
    _assert_batch_parity(sess2, pts)


def test_recover_is_byte_level_noop_and_idempotent(tmp_path):
    """Recovery writes nothing: the WAL bytes are identical before and
    after, and recovering twice yields bit-identical state. Post-recovery
    client retries of replayed ids hit the rebuilt dedup window."""
    pts = synth.blobs(480, k=3, seed=15)
    corpus, chunks = pts[:330], _chunks(pts, 330)
    sess, wal_dir, ck_dir = _durable_session(tmp_path, corpus)
    results = [sess.ingest(c, request_id=f"c{i}")
               for i, c in enumerate(chunks)]
    sess.wal.close()
    before = _tree_bytes(wal_dir)
    # recovery must run under the same policy knobs as the crashed
    # session — with compaction off, replay writes nothing at all
    s1 = _recover(ck_dir, wal_dir,
                                    max_delta_frac=np.inf)
    s1.wal.close()
    assert _tree_bytes(wal_dir) == before
    s2 = _recover(ck_dir, wal_dir,
                                    max_delta_frac=np.inf)
    np.testing.assert_array_equal(_points_of(s1), _points_of(s2))
    np.testing.assert_array_equal(np.asarray(s1.snapshot.labels),
                                  np.asarray(s2.snapshot.labels))
    # an upstream at-least-once retry after recovery is a recorded no-op
    r = s2.ingest(chunks[-1], request_id=f"c{len(chunks) - 1}")
    assert r.deduped
    np.testing.assert_array_equal(r.labels, results[-1].labels)
    with pytest.raises(serve.ValidationError):
        s2.ingest(chunks[0], request_id=f"c{len(chunks) - 1}")


@pytest.mark.parametrize("durability", ["fsync", "flush", "none"])
def test_clean_shutdown_recovers_under_every_durability(tmp_path, durability):
    pts = synth.blobs(400, k=2, seed=16)
    corpus, chunks = pts[:300], _chunks(pts, 300)
    wal_dir, ck_dir = str(tmp_path / "wal"), str(tmp_path / "snap")
    sess = serve.ServeSession(
        _build(corpus),
        wal=WriteAheadLog(wal_dir, durability=durability),
        ckpt_dir=ck_dir, max_delta_frac=np.inf)
    for c in chunks:
        sess.ingest(c)
    sess.wal.close()  # clean close drains buffers in every mode
    sess2 = _recover(ck_dir, wal_dir,
                                       durability=durability)
    np.testing.assert_array_equal(_points_of(sess2), pts)
    _assert_batch_parity(sess2, pts)


# --- the kill-at-every-site chaos matrix -------------------------------------

CRASH_SITES = ["serve.wal.append", "serve.wal.fsync", "serve.wal.rotate",
               "serve.compact.watermark", "serve.ingest.label",
               "serve.compact"]


@pytest.mark.parametrize("site", CRASH_SITES)
def test_kill_at_every_site_recovers_to_batch_parity(tmp_path, site):
    """The acceptance matrix: die at ``site`` mid-stream via a
    simulated SIGKILL (``faults.Kill`` skips every in-process handler),
    recover from disk only, and require the exact invariant —

      * every **acked** chunk is present;
      * at most the one in-flight chunk may additionally be present,
        **in full** (logged-but-unacked), never partially;
      * after folding, labels are bit-identical to batch ``dbscan()`` on
        exactly the recovered point set.
    """
    pts = synth.blobs(700, k=3, seed=3)
    corpus, chunks = pts[:400], _chunks(pts, 400)
    wal_dir, ck_dir = str(tmp_path / "wal"), str(tmp_path / "snap")
    sess = serve.ServeSession(
        _build(corpus),
        wal=WriteAheadLog(wal_dir, durability="fsync", segment_bytes=1024),
        ckpt_dir=ck_dir, max_delta_frac=0.2)
    acked, died = [], None
    for i, c in enumerate(chunks):
        if i == 1:  # arm after one ack so the baseline isn't the victim
            faults.inject(site, error=faults.Kill(site), times=1)
        try:
            sess.ingest(c, request_id=f"c{i}")
            acked.append(c)
        except faults.Kill:
            died = i
            break
    assert died is not None, f"{site} never fired — matrix hole"
    faults.clear()
    # the session object is abandoned exactly where it died (no close, no
    # flush beyond what durability already guaranteed): recover from disk
    sess2 = _recover(ck_dir, wal_dir, max_delta_frac=0.2)
    rec = _points_of(sess2)
    exp_acked = np.concatenate([corpus] + acked)
    exp_plus = np.concatenate([corpus] + acked + [chunks[died]])
    if len(rec) == len(exp_acked):
        np.testing.assert_array_equal(rec, exp_acked)
    else:  # logged-but-unacked applied IN FULL — whole chunk or nothing
        np.testing.assert_array_equal(rec, exp_plus)
    _assert_batch_parity(sess2, rec)
    # and the session is live again: it keeps ingesting where it left off
    rest = chunks[died + 1:] or [chunks[died]]
    for j, c in enumerate(rest):
        sess2.ingest(c, request_id=f"post{j}")
    _assert_batch_parity(sess2, np.concatenate([rec] + rest))


# --- subprocess: a REAL SIGKILL, not a simulated one --------------------------

_CHILD = """
import os, signal, sys
import numpy as np
from repro_torch import serve
from repro_torch.core.dbscan import dbscan
from repro_torch.data import synth

EPS, MINPTS, CHUNK = 0.08, 16, 256
mode, wal_dir = sys.argv[1], sys.argv[2]
ck_dir = wal_dir + "-snap"
if mode == "recover":
    sess = serve.ServeSession.recover(ck_dir, wal_dir, device="cpu",
                                      max_delta_frac=0.1)
    rep = sess.last_recovery
    print(f"recovered step {rep.baseline_step}: replayed "
          f"{rep.replayed_chunks} chunks / {rep.replayed_points} pts")
    sess.compact(force=True)
    pts = sess.snapshot.points.numpy()
    full = dbscan(pts, EPS, MINPTS, device="cpu")
    ok = (np.array_equal(sess.snapshot.labels.numpy(), full.labels.numpy())
          and np.array_equal(sess.snapshot.core.numpy(), full.core.numpy()))
    print(f"parity vs batch dbscan on {len(pts)} recovered pts: "
          + ("OK - bit-identical" if ok else "MISMATCH"))
    sys.exit(0 if ok else 1)
snap = serve.build_snapshot(synth.load("taxi2d", 1200, seed=0), EPS, MINPTS,
                            device="cpu")
sess = serve.ServeSession(snap, max_delta_frac=0.1, ckpt_dir=ck_dir,
                          wal=serve.WriteAheadLog(wal_dir))
stream = synth.load("taxi2d", 768, seed=1)
for i in range(0, len(stream), CHUNK):
    if i == CHUNK:  # one chunk acked: die at the sync of the next frame
        serve.faults.inject("serve.wal.fsync", times=1,
                            error=serve.faults.Kill("serve.wal.fsync"))
    try:
        sess.ingest(stream[i:i + CHUNK], request_id=f"stream-{i}")
    except serve.faults.Kill:
        print("SIGKILL mid-ingest: chunk logged but never acknowledged",
              flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
print("never killed")
"""


def test_crash_recovery_subprocess(tmp_path):
    """A genuine process death: the child SIGKILLs itself mid-ingest
    (nothing in that interpreter survives into recovery), a second child
    recovers from disk on the CPU and exits 1 unless the recovered
    labels are bit-identical to batch ``dbscan`` on the recovered points."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    wal = str(tmp_path / "wal")
    run1 = subprocess.run([sys.executable, "-c", _CHILD, "write", wal],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert run1.returncode == -signal.SIGKILL, \
        f"expected SIGKILL, got {run1.returncode}:\n{run1.stdout}" \
        f"\n{run1.stderr}"
    assert "logged but never acknowledged" in run1.stdout
    run2 = subprocess.run([sys.executable, "-c", _CHILD, "recover", wal],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert run2.returncode == 0, run2.stdout + run2.stderr
    assert "OK - bit-identical" in run2.stdout
    # the acked chunk was folded by a compaction (step 1); the logged but
    # unacknowledged one replays in full on top of it
    assert "recovered step 1: replayed 1 chunks / 256 pts" in run2.stdout
    assert "on 1712 recovered pts" in run2.stdout


# --- interop: one package writes, the other recovers -------------------------


def _durable_run(pkg, build, wal_dir, ck_dir, corpus, chunks):
    sess = pkg.ServeSession(build(corpus), wal=pkg.WriteAheadLog(wal_dir),
                            ckpt_dir=ck_dir, max_delta_frac=0.2)
    for i, c in enumerate(chunks):
        sess.ingest(c, request_id=f"c{i}")
    assert sess.n_compactions >= 1
    sess.wal.close()


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_wal_and_snapshots_recover_across_packages(tmp_path, writer):
    """A durable session of one package dies (its WAL and checkpoints stay
    on disk); both packages recover from copies of the same files to the
    same points and, after folding, the same labels as batch dbscan."""
    pts = synth.blobs(560, k=3, seed=18)
    corpus, chunks = pts[:360], _chunks(pts, 360)
    base = tmp_path / "w"
    wal_dir, ck_dir = str(base / "wal"), str(base / "snap")
    if writer == "repro":
        _durable_run(jserve, lambda p: jserve.build_snapshot(p, EPS, MINPTS),
                     wal_dir, ck_dir, corpus, chunks)
    else:
        _durable_run(serve, _build, wal_dir, ck_dir, corpus, chunks)
    # an ingest that was logged but never applied: it replays in full
    with WriteAheadLog(wal_dir) as w:
        w.append_ingest(pts[:40] + np.float32(0.01), request_id="late")
    for d in ("t", "j"):
        shutil.copytree(base, tmp_path / d)
    t = _recover(str(tmp_path / "t" / "snap"), str(tmp_path / "t" / "wal"),
                 max_delta_frac=0.2)
    j = jserve.ServeSession.recover(str(tmp_path / "j" / "snap"),
                                    str(tmp_path / "j" / "wal"),
                                    max_delta_frac=0.2)
    assert t.last_recovery == j.last_recovery
    np.testing.assert_array_equal(_points_of(t), _points_of(j))
    expected = np.concatenate([pts, pts[:40] + np.float32(0.01)])
    np.testing.assert_array_equal(np.sort(_points_of(t), axis=0),
                                  np.sort(expected, axis=0))
    t.compact(force=True)
    j.compact(force=True)
    np.testing.assert_array_equal(np.asarray(t.snapshot.labels),
                                  np.asarray(j.snapshot.labels))
    full = jdbscan(np.asarray(j.snapshot.points), EPS, MINPTS)
    np.testing.assert_array_equal(np.asarray(t.snapshot.labels),
                                  np.asarray(full.labels))


# --- prefix property: every byte-prefix of a valid log is consistent ---------
# hypothesis is an optional dev dependency; without it the same property
# runs over fixed cut fractions so the slim container still exercises it

try:
    from hypothesis import given, settings, strategies as st
    _HYP = True
except ImportError:  # pragma: no cover - exercised in the slim container
    _HYP = False


_PREFIX_STATE = {}


def _prefix_fixture(tmp_factory):
    """One durable run shared by every prefix example (cached): corpus,
    chunks, the WAL/ckpt dirs, and each ingest frame's end offset."""
    if _PREFIX_STATE:
        return _PREFIX_STATE
    base = tmp_factory.mktemp("wal-prefix")
    pts = synth.blobs(520, k=3, seed=17)
    corpus, chunks = pts[:340], _chunks(pts, 340)
    wal_dir, ck_dir = str(base / "wal"), str(base / "snap")
    sess = serve.ServeSession(
        _build(corpus),
        wal=WriteAheadLog(wal_dir), ckpt_dir=ck_dir,
        max_delta_frac=np.inf)
    for i, c in enumerate(chunks):
        sess.ingest(c, request_id=f"c{i}")
    total = sess.wal.position
    ends = [r.end for r in sess.wal.records() if r.kind == "ingest"]
    sess.wal.close()
    _PREFIX_STATE.update(dict(corpus=corpus, chunks=chunks, wal=wal_dir,
                              ck=ck_dir, ends=ends, total=total,
                              base=str(base)))
    return _PREFIX_STATE


def _check_prefix(tmp_factory, frac: float):
    s = _prefix_fixture(tmp_factory)
    cut = int(round(frac * s["total"]))
    work = tmp_factory.mktemp("cut")
    wal_dir = str(work / "wal")
    ck_dir = str(work / "snap")
    shutil.copytree(s["wal"], wal_dir)
    shutil.copytree(s["ck"], ck_dir)
    seg = sorted(os.listdir(wal_dir))[0]  # max_delta_frac=inf: one segment
    with open(os.path.join(wal_dir, seg), "r+b") as f:
        f.truncate(cut)
    k = sum(1 for e in s["ends"] if e <= cut)  # whole frames below the cut
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # torn-tail warn
        sess = _recover(ck_dir, wal_dir,
                                          max_delta_frac=np.inf)
    expected = np.concatenate([s["corpus"]] + s["chunks"][:k]) \
        if k else s["corpus"]
    np.testing.assert_array_equal(_points_of(sess), expected)
    assert sess.last_recovery.replayed_chunks == k
    _assert_batch_parity(sess, expected)


if _HYP:
    @settings(max_examples=8, deadline=None)
    @given(st.floats(0.0, 1.0))
    def test_every_log_prefix_replays_consistently(tmp_path_factory, frac):
        _check_prefix(tmp_path_factory, frac)
else:
    @pytest.mark.parametrize(
        "frac", [0.0, 0.13, 0.37, 0.5, 0.71, 0.86, 0.99, 1.0])
    def test_every_log_prefix_replays_consistently(tmp_path_factory, frac):
        _check_prefix(tmp_path_factory, frac)
