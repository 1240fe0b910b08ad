"""repro_torch's resilient serving envelope on the CPU, mirroring
tests/test_resilience.py: every degradation path is driven by injected
faults, never asserted in prose. The batch-parity oracle is the port's
``dbscan`` (held bit-identical to the reference's in
tests/test_torch_dbscan.py), and the chaos gate's end state is also held
against the reference's ``dbscan``.

The chaos gate: with an injected compaction stall/failure, a
forced slab overflow, and a replayed delta stream —

  (a) ``assign`` keeps answering from the last *published* snapshot, with
      staleness flagged per answer;
  (b) post-recovery labels are bit-identical to batch ``dbscan()`` on the
      concatenation;
  (c) replayed deltas are byte-level no-ops;
  (d) degraded mode adds no program key after warmup (zero recompiles).
"""
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core.dbscan import dbscan as jdbscan
from repro.data import synth
from repro_torch import serve
from repro_torch.core import dbscan as _tdbscan
from repro_torch.core import neighbors as nb
from repro_torch.serve import faults
from repro_torch.serve.resilience import (AdmissionError, AdmissionQueue,
                                          CapacityError, CircuitBreaker,
                                          CompactionError, ServeError,
                                          ValidationError)

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


def dbscan(pts, eps, min_pts, engine="grid"):
    return _tdbscan.dbscan(pts, eps, min_pts, engine=engine, device="cpu")


def _build(pts, eps=EPS, min_pts=MINPTS):
    return serve.build_snapshot(pts, eps, min_pts, device="cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


class _Clock:
    """Deterministic injectable clock for breaker/admission tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _session(pts, n0, clock=None, **kw):
    snap = _build(pts[:n0])
    breaker = CircuitBreaker(failure_threshold=2, reset_after_s=10.0,
                             clock=clock or _Clock())
    return serve.ServeSession(snap, breaker=breaker, **kw)


# --- circuit-broken compaction ---------------------------------------------


def test_assign_available_during_broken_compaction_then_recovers():
    """The chaos gate, end to end: compaction fails persistently, assign
    stays available (stale + degraded flagged), recovery converges to the
    batch labels bit-identically."""
    clock = _Clock()
    pts = synth.blobs(800, k=3, seed=9)
    sess = _session(pts, 600, clock=clock, max_delta_frac=0.05)
    faults.inject("serve.compact", error=RuntimeError("injected rebuild "
                                                      "crash"), times=-1)
    r1 = sess.ingest(pts[600:700])     # 100 ≥ 30: compaction due, fails
    assert not r1.compacted and r1.degraded
    assert r1.labels.shape == (100,)   # online labeling still answered
    assert sess.breaker.n_failures == 1 and sess.breaker.state == "closed"
    r2 = sess.ingest(pts[700:750])     # second failure trips the breaker
    assert not r2.compacted and sess.breaker.state == "open"
    n_fail = sess.breaker.n_failures
    r3 = sess.ingest(pts[750:780])     # breaker open: deferred, no attempt
    assert not r3.compacted and r3.degraded
    assert sess.breaker.n_failures == n_fail  # no hot-path retry storm

    # (a) assign keeps answering from the last published snapshot
    a = sess.assign(pts[:32])
    assert a.staleness == sess.n_delta == 180
    assert a.degraded
    base = serve.assign(sess.snapshot, pts[:32])
    np.testing.assert_array_equal(a.labels, base.labels)

    # explicit compact: breaker open raises a structured, retryable error
    with pytest.raises(CompactionError) as ei:
        sess.compact()
    assert ei.value.retryable and ei.value.retry_after > 0

    # recovery: fault cleared, clock past the reset window -> half-open
    # probe succeeds on the next due-compaction and closes the breaker
    faults.clear("serve.compact")
    clock.t = 11.0
    assert sess.breaker.state == "half-open"
    r4 = sess.ingest(pts[780:800])
    assert r4.compacted and sess.breaker.state == "closed"
    assert not sess.degraded and sess.n_delta == 0

    # (b) bit-identical to batch dbscan on the concatenation
    full = dbscan(pts, EPS, MINPTS, engine="grid")
    np.testing.assert_array_equal(np.asarray(sess.snapshot.labels),
                                  np.asarray(full.labels))
    np.testing.assert_array_equal(np.asarray(sess.snapshot.core),
                                  np.asarray(full.core))
    np.testing.assert_array_equal(np.asarray(sess.snapshot.labels),
                                  np.asarray(jdbscan(pts, EPS, MINPTS).labels))
    a2 = sess.assign(pts[:32])
    assert a2.staleness == 0 and not a2.degraded


def test_compaction_stall_is_survivable_and_snapshot_stays_published():
    """A *stalling* (slow, then failing) compaction must never unpublish:
    the swap is the last step, so mid-rebuild death leaves the old
    snapshot fully live, on disk included."""
    pts = synth.blobs(500, k=2, seed=15)
    sess = _session(pts, 400, max_delta_frac=0.1)
    labels_before = np.asarray(sess.snapshot.labels).copy()
    faults.inject("serve.compact", delay=0.05,
                  error=RuntimeError("stalled then died"), times=1)
    r = sess.ingest(pts[400:460])
    assert not r.compacted and r.degraded
    np.testing.assert_array_equal(np.asarray(sess.snapshot.labels),
                                  labels_before)
    assert faults.fired_count("serve.compact") == 1
    # next due ingest retries (breaker threshold=2 not yet tripped) and,
    # with the fault exhausted, succeeds
    r2 = sess.ingest(pts[460:500])
    assert r2.compacted and sess.breaker.state == "closed"
    full = dbscan(pts, EPS, MINPTS, engine="grid")
    np.testing.assert_array_equal(np.asarray(sess.snapshot.labels),
                                  np.asarray(full.labels))


def test_delta_hard_bound_sheds_when_breaker_open():
    clock = _Clock()
    pts = synth.blobs(700, k=3, seed=16)
    sess = _session(pts, 500, clock=clock, max_delta_frac=np.inf,
                    delta_capacity=128)
    faults.inject("serve.compact", error=RuntimeError("down"), times=-1)
    sess.ingest(pts[500:600])          # 100 < 128: buffered fine
    sess.breaker.record_failure()      # warm the breaker to open
    sess.breaker.record_failure()
    assert sess.breaker.state == "open"
    with pytest.raises(AdmissionError) as ei:
        sess.ingest(pts[600:700])      # would exceed capacity; can't fold
    assert ei.value.retryable and ei.value.retry_after > 0
    assert sess.n_delta == 100         # shed before append: idempotent


# --- bounded slab regrow ----------------------------------------------------


def test_forced_overflow_regrows_and_surfaces_in_telemetry():
    # a skewed corpus at small ε, so the planned slab has real headroom
    # below n_cand and a regrow actually doubles
    pts = synth.load("skewed2d", 2000, seed=17)
    snap = _build(pts, 0.005)
    assert snap.spec.slab < snap.spec.n_cand
    sched = serve.BucketScheduler()
    slab0 = snap.slab
    faults.inject("serve.assign.overflow", times=1)
    r = serve.assign(snap, pts[:16], scheduler=sched)
    oracle = serve.assign(snap, pts[:16])
    np.testing.assert_array_equal(r.labels, oracle.labels)
    assert sched.regrows == 1
    assert snap.slab == min(slab0 * 2, snap.spec.n_cand)


def test_persistent_overflow_hits_retry_cap_with_structured_error():
    pts = synth.blobs(400, k=2, seed=18)
    snap = _build(pts)
    faults.inject("serve.assign.overflow", times=-1)
    with pytest.raises(CapacityError) as ei:
        serve.assign(snap, pts[:8])
    # the error names the final slab capacity and the structural ceiling
    assert ei.value.details["slab"] == snap.spec.n_cand
    assert ei.value.details["n_cand"] == snap.spec.n_cand
    assert str(ei.value.details["slab"]) in str(ei.value)
    assert ei.value.details["attempts"] <= nb.MAX_SLAB_REGROW


def test_ingest_overflow_is_bounded_too():
    pts = synth.load("skewed2d", 2000, seed=19)
    sess = serve.ServeSession(
        _build(pts[:1600], 0.005),
        max_delta_frac=np.inf)
    assert sess.snapshot.spec.slab < sess.snapshot.spec.n_cand
    faults.inject("serve.ingest.overflow", times=1)
    r = sess.ingest(pts[1600:1650])        # one forced regrow, then fine
    assert r.labels.shape == (50,) and sess.scheduler.regrows == 1
    faults.inject("serve.ingest.overflow", times=-1)
    with pytest.raises(CapacityError):
        sess.ingest(pts[1650:1700])
    assert sess.n_delta == 50              # failed ingest rolled back


# --- idempotent ingest ------------------------------------------------------


def test_replayed_stream_is_bit_identical_to_once_only():
    """(c) of the chaos gate: an at-least-once stream (every chunk
    delivered twice) produces the same delta, the same online labels, and
    a bit-identical compacted snapshot as the once-only stream."""
    pts = synth.blobs(900, k=4, seed=20)
    once = serve.ServeSession(_build(pts[:600]),
                              max_delta_frac=np.inf)
    twice = serve.ServeSession(_build(pts[:600]),
                               max_delta_frac=np.inf)
    for i, lo in enumerate(range(600, 900, 64)):
        chunk = pts[lo:lo + 64]
        r_once = once.ingest(chunk, request_id=f"req-{i}")
        r_first = twice.ingest(chunk, request_id=f"req-{i}")
        r_replay = twice.ingest(chunk, request_id=f"req-{i}")
        assert not r_first.deduped and r_replay.deduped
        np.testing.assert_array_equal(r_once.labels, r_first.labels)
        np.testing.assert_array_equal(r_first.labels, r_replay.labels)
        assert once.n_delta == twice.n_delta
    np.testing.assert_array_equal(once._delta, twice._delta)
    once.compact()
    twice.compact()
    np.testing.assert_array_equal(np.asarray(once.snapshot.labels),
                                  np.asarray(twice.snapshot.labels))
    full = dbscan(pts, EPS, MINPTS, engine="grid")
    np.testing.assert_array_equal(np.asarray(twice.snapshot.labels),
                                  np.asarray(full.labels))
    np.testing.assert_array_equal(np.asarray(twice.snapshot.labels),
                                  np.asarray(jdbscan(pts, EPS, MINPTS).labels))


def test_crash_retry_replay_after_mid_ingest_fault():
    """A request that crashes mid-ingest leaves no trace (delta rolled
    back), so the client's retry of the SAME request id succeeds as a
    fresh attempt — at-least-once delivery with exactly-once effect."""
    pts = synth.blobs(500, k=2, seed=21)
    sess = serve.ServeSession(_build(pts[:400]),
                              max_delta_frac=np.inf)
    faults.inject("serve.ingest.label", error=RuntimeError("crash"),
                  times=1)
    with pytest.raises(RuntimeError):
        sess.ingest(pts[400:460], request_id="r1")
    assert sess.n_delta == 0               # rolled back, not half-applied
    r = sess.ingest(pts[400:460], request_id="r1")   # the crash-retry
    assert not r.deduped and sess.n_delta == 60
    r2 = sess.ingest(pts[400:460], request_id="r1")  # a true replay
    assert r2.deduped and sess.n_delta == 60


def test_replay_with_mutated_payload_is_rejected():
    pts = synth.blobs(400, k=2, seed=22)
    sess = serve.ServeSession(_build(pts[:300]),
                              max_delta_frac=np.inf)
    sess.ingest(pts[300:350], request_id="r1")
    with pytest.raises(ValidationError, match="different payload"):
        sess.ingest(pts[350:400], request_id="r1")
    assert sess.n_delta == 50


def test_dedup_window_is_bounded():
    pts = synth.blobs(400, k=2, seed=23)
    sess = serve.ServeSession(_build(pts[:300]),
                              max_delta_frac=np.inf, dedup_window=2)
    for i in range(4):
        sess.ingest(pts[300 + 8 * i:308 + 8 * i], request_id=f"q{i}")
    assert len(sess._dedup) == 2           # oldest evicted
    r = sess.ingest(pts[300:308], request_id="q0")  # fell out of window:
    assert not r.deduped                   # re-ingested (documented limit)


# --- input validation -------------------------------------------------------


@pytest.mark.parametrize("kind", ["nan", "inf", "wrong-dims",
                                  "wrong-dtype", "wrong-rank"])
def test_malformed_inputs_rejected_before_quantization(kind):
    pts = synth.blobs(400, k=2, seed=24)
    sess = serve.ServeSession(_build(pts[:300]),
                              max_delta_frac=np.inf)
    bad = faults.malform(pts[300:340], kind)
    with pytest.raises(ValidationError):
        sess.ingest(bad)
    with pytest.raises(ValidationError):
        sess.assign(bad)
    with pytest.raises(ValidationError):
        serve.assign(sess.snapshot, bad)
    assert sess.n_delta == 0               # nothing poisoned the buffer
    # ValidationError IS a ValueError: pre-envelope callers still work
    with pytest.raises(ValueError):
        sess.ingest(bad)


def test_malformed_then_clean_parity():
    """The parity suite's malformed-input case: a rejected poisoned chunk
    must not perturb subsequent labeling — the clean stream still matches
    batch dbscan bit-identically."""
    pts = synth.blobs(700, k=3, seed=25)
    sess = serve.ServeSession(_build(pts[:500]),
                              max_delta_frac=np.inf)
    with pytest.raises(ValidationError):
        sess.ingest(faults.malform(pts[500:550], "nan"))
    sess.ingest(pts[500:700])
    sess.compact()
    full = dbscan(pts, EPS, MINPTS, engine="grid")
    np.testing.assert_array_equal(np.asarray(sess.snapshot.labels),
                                  np.asarray(full.labels))
    np.testing.assert_array_equal(np.asarray(sess.snapshot.labels),
                                  np.asarray(jdbscan(pts, EPS, MINPTS).labels))


# --- admission control ------------------------------------------------------


def test_admission_depth_shed_and_retry_after():
    clock = _Clock()
    q = AdmissionQueue(max_depth=3, max_age_s=1.0, clock=clock)
    tickets = [q.submit() for _ in range(3)]
    with pytest.raises(AdmissionError) as ei:
        q.submit()
    assert ei.value.retryable and ei.value.retry_after > 0
    assert q.shed_depth == 1 and q.depth == 3
    t = q.take()
    assert t is tickets[0]                 # FIFO
    q.finish(t, 0.01)
    q.submit()                             # depth freed: admitted again
    assert q.admitted == 4


def test_admission_age_shed_at_take():
    clock = _Clock()
    q = AdmissionQueue(max_depth=8, max_age_s=0.5, clock=clock)
    q.submit()
    q.submit(now=0.4)
    clock.t = 0.6                          # first waited 0.6 > 0.5
    t = q.take()
    assert t is not None and t.arrived == 0.4
    assert q.shed_age == 1
    q.finish(t, 0.01)
    assert q.shed == 1 and 0 < q.shed_rate() < 1


def test_session_burst_submit_pump_sheds_aged_requests():
    clock = _Clock()
    pts = synth.blobs(500, k=2, seed=26)
    snap = _build(pts[:400])
    sess = serve.ServeSession(
        snap, admission=AdmissionQueue(max_depth=4, max_age_s=1.0,
                                       clock=clock))
    ids = [sess.submit(pts[i * 8:(i + 1) * 8], now=float(i) * 0.1)
           for i in range(4)]
    with pytest.raises(AdmissionError):    # 5th hits max_depth
        sess.submit(pts[32:40])
    clock.t = 1.15                         # tickets 0,1 now older than 1 s
    results = dict(sess.pump(now=clock.t))
    assert isinstance(results[ids[0]], AdmissionError)
    assert isinstance(results[ids[1]], AdmissionError)
    for tid in ids[2:]:
        r = results[tid]
        assert isinstance(r, serve.AssignResult)
        assert r.labels.shape == (8,)
    assert sess.admission.shed_age == 2 and sess.admission.served == 2


def test_zero_recompiles_preserved_under_degradation():
    """(d) of the chaos gate: degraded mode reuses the exact same traced
    programs — a broken compaction must not cost a single retrace."""
    pts = synth.blobs(900, k=3, seed=27)
    sess = _session(pts, 700, max_delta_frac=0.05)
    rng = np.random.default_rng(28)

    def batch(nq):
        return (rng.uniform(0, 2, (nq, 3)) * [1, 1, 0]).astype(np.float32)

    for b in sess.scheduler.buckets_upto(1024):   # warm the ladder
        sess.assign(batch(b))
    sess.scheduler.reset_stats()

    faults.inject("serve.compact", error=RuntimeError("down"), times=-1)
    sess.ingest(pts[700:900])              # trips the degraded path
    assert sess.degraded
    for nq in (1, 7, 100, 255, 256, 300, 513, 777, 1000):
        r = sess.assign(batch(nq))
        assert r.degraded and r.staleness == 200
    assert sess.scheduler.recompiles == 0
    assert sess.scheduler.calls == 9


# --- snapshot corruption fallback ------------------------------------------


def _two_step_dir(tmp_path, pts):
    snap = _build(pts)
    d = str(tmp_path)
    serve.save_snapshot(snap, d, step=1)
    serve.save_snapshot(snap, d, step=2)
    return snap, d


@pytest.mark.parametrize("mode", ["truncate", "garbage-meta",
                                  "missing-arrays"])
def test_load_falls_back_to_newest_intact_step(tmp_path, mode):
    pts = synth.blobs(400, k=2, seed=29)
    snap, d = _two_step_dir(tmp_path, pts)
    faults.corrupt_checkpoint(d, 2, mode=mode)
    with pytest.warns(RuntimeWarning, match="falling back"):
        snap2 = serve.load_snapshot(d, device="cpu")
    np.testing.assert_array_equal(np.asarray(snap2.labels),
                                  np.asarray(snap.labels))
    # pinning the damaged step explicitly must raise, not fall back
    with pytest.raises(Exception):
        serve.load_snapshot(d, step=2, device="cpu")


def test_load_raises_only_when_no_intact_version_exists(tmp_path):
    pts = synth.blobs(300, k=2, seed=30)
    _, d = _two_step_dir(tmp_path, pts)
    faults.corrupt_checkpoint(d, 1, mode="truncate")
    faults.corrupt_checkpoint(d, 2, mode="truncate")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ServeError, match="no intact snapshot"):
            serve.load_snapshot(d, device="cpu")


def test_newer_format_raises_without_fallback(tmp_path):
    import json
    pts = synth.blobs(300, k=2, seed=31)
    _, d = _two_step_dir(tmp_path, pts)
    mpath = os.path.join(d, "step_0000000002", "meta.json")
    with open(mpath) as f:
        m = json.load(f)
    m["meta"]["format"] = 99
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(serve.SnapshotFormatError):
        serve.load_snapshot(d, device="cpu")
