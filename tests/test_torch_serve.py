"""repro_torch's single-session serving on the CPU against the JAX
reference (``repro.serve``) on the same seeded inputs, mirroring
tests/test_serve.py: snapshot build, ``assign`` against the reference's and
against a brute-force predict oracle, ingest-then-compact against the
reference's session and against batch ``dbscan`` on the concatenation,
online labels, the compaction threshold, snapshot round trips, versions and
GC, engine vetting, the shape scheduler, queries outside the corpus domain,
and snapshots that cross-load between the two packages.

Integer outputs must be bit-identical to the reference. ``dist`` must be
bit-identical to the numpy oracle's unfused f32 arithmetic, and to the
reference's run op by op (compiled, XLA's CPU backend may contract the
reference's d² into fused multiply-adds; see tests/test_torch_cross_sweep.py).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core.dbscan import dbscan as jdbscan
from repro.data import synth
from repro_torch import serve
from repro_torch.core import engines
from repro_torch.core.dbscan import dbscan

INT_MAX = np.iinfo(np.int32).max

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


def _parity_cases():
    """tests/test_serve.py's ``_parity_cases``, same seeds."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (80, 3)).astype(np.float32)
    dup = np.concatenate([base, base, base[:30]])
    spread = (rng.uniform(0, 100, (60, 3)) * np.array([1, 1, 0])) \
        .astype(np.float32)  # pairwise distances >> eps: all noise
    return {
        "skewed2d": synth.load("skewed2d", 1200, seed=4),
        "duplicates": dup,
        "n2": np.asarray([[0., 0., 0.], [0.01, 0., 0.]], np.float32),
        "all_noise": spread,
        "blobs": synth.blobs(900, k=4, seed=1),
    }


def _predict_oracle(pts, labels, core, eps, q):
    """Brute-force DBSCAN predict: min label over ε-reachable core points,
    else noise; corpus neighbor counts; min core distance² (numpy, f32
    rounded per operation)."""
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    hit = d2 <= np.float32(eps * eps)
    ch = hit & core[None, :]
    lab = np.where(ch, labels[None, :], INT_MAX).min(1, initial=INT_MAX)
    return (np.where(lab != INT_MAX, lab, -1),
            hit.sum(1).astype(np.int32),
            np.where(ch, d2, np.inf).min(1, initial=np.inf)
            .astype(np.float32))


def _queries(pts, nq, seed):
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    q = rng.uniform(lo - 2 * EPS, hi + 2 * EPS, (nq, 3)).astype(np.float32)
    near = rng.integers(0, len(pts), nq // 2)
    q[:nq // 2] = pts[near] + rng.normal(0, EPS / 2, (nq // 2, 3))
    q[:, 2] = pts[0, 2] * 0  # stay planar like the corpus (z = 0 for 2D)
    return q


def _snap(pts, **kw):
    return serve.build_snapshot(pts, EPS, MINPTS, device="cpu", **kw)


@pytest.mark.parametrize("name", list(_parity_cases()))
def test_assign_matches_reference_and_predict_oracle(name):
    pts = _parity_cases()[name]
    snap = _snap(pts)
    js = jserve.build_snapshot(pts, EPS, MINPTS)
    for f in ("labels", "core", "counts", "order", "cands", "codes",
              "croot_sorted"):
        np.testing.assert_array_equal(getattr(snap, f).numpy(),
                                      np.asarray(getattr(js, f)))
    q = _queries(pts, 137, seed=5)
    r = serve.assign(snap, q)
    exp_lab, exp_cnt, exp_d2 = _predict_oracle(
        pts, snap.labels.numpy(), snap.core.numpy(), EPS, q)
    np.testing.assert_array_equal(r.labels, exp_lab)
    np.testing.assert_array_equal(r.counts, exp_cnt)
    np.testing.assert_array_equal(r.dist, np.sqrt(exp_d2))
    j = jserve.assign(js, q)
    np.testing.assert_array_equal(r.labels, j.labels)
    np.testing.assert_array_equal(r.counts, j.counts)
    assert r.bucket == j.bucket == 256


def test_assign_dist_matches_reference_op_by_op():
    pts = _parity_cases()["blobs"]
    snap = _snap(pts)
    js = jserve.build_snapshot(pts, EPS, MINPTS)
    q = _queries(pts, 137, seed=6)
    r = serve.assign(snap, q)
    with jax.disable_jit():
        j = jserve.assign(js, q)
    for f in ("labels", "counts", "dist"):
        np.testing.assert_array_equal(getattr(r, f), getattr(j, f))
    assert np.isfinite(r.dist).sum() > 30


@pytest.mark.parametrize("name", list(_parity_cases()))
def test_ingest_then_compact_is_batch_identical(name):
    pts = _parity_cases()[name]
    n = len(pts)
    half = max(n // 2, 1)
    sess = serve.ServeSession(_snap(pts[:half]), max_delta_frac=np.inf)
    # the reference's session alongside, for the cases with clusters
    ref = (jserve.ServeSession(jserve.build_snapshot(pts[:half], EPS,
                                                     MINPTS),
                               max_delta_frac=np.inf)
           if name in ("skewed2d", "duplicates") else None)
    for i in range(half, n, 64):
        res = sess.ingest(pts[i:i + 64])
        assert res.labels.shape == (len(pts[i:i + 64]),)
        if ref is not None:
            np.testing.assert_array_equal(res.labels,
                                          ref.ingest(pts[i:i + 64]).labels)
    sess.compact()
    full = dbscan(pts, EPS, MINPTS, device="cpu")
    jfull = jdbscan(pts, EPS, MINPTS, engine="grid")
    for f in ("labels", "core"):
        got = getattr(sess.snapshot, f).numpy()
        np.testing.assert_array_equal(got, getattr(full, f).numpy())
        np.testing.assert_array_equal(got, np.asarray(getattr(jfull, f)))
    if ref is not None:
        ref.compact()
        np.testing.assert_array_equal(sess.snapshot.labels.numpy(),
                                      np.asarray(ref.snapshot.labels))


def test_online_labels_match_batch_when_no_corpus_drift():
    """Between compactions the online labels are exact DBSCAN over
    corpus ∪ delta whenever the delta doesn't retro-promote corpus points
    (fresh-cluster ids are n_corpus + min member index by construction)."""
    corpus = synth.blobs(600, k=3, seed=7)
    far = synth.blobs(200, k=2, seed=8) + np.asarray([50.0, 0.0, 0.0],
                                                     np.float32)
    sess = serve.ServeSession(_snap(corpus), max_delta_frac=np.inf)
    got = sess.ingest(far).labels
    both = np.concatenate([corpus, far])
    full = dbscan(both, EPS, MINPTS, device="cpu").labels.numpy()
    np.testing.assert_array_equal(got, full[len(corpus):])
    np.testing.assert_array_equal(
        got, np.asarray(jdbscan(both, EPS, MINPTS).labels)[len(corpus):])
    assert (got >= len(corpus)).sum() > 100  # fresh clusters were opened


def test_ingest_auto_compaction_threshold():
    pts = synth.blobs(800, k=3, seed=9)
    sess = serve.ServeSession(_snap(pts[:600]),
                              max_delta_frac=0.2)  # 120 points trigger
    r1 = sess.ingest(pts[600:700])    # 100 < 120: buffered
    assert not r1.compacted and sess.n_delta == 100
    r2 = sess.ingest(pts[700:800])    # 200 >= 120: compacts
    assert r2.compacted and sess.n_delta == 0
    assert sess.snapshot.n == 800
    full = dbscan(pts, EPS, MINPTS, device="cpu")
    assert torch.equal(sess.snapshot.labels, full.labels)
    np.testing.assert_array_equal(r2.labels, full.labels[700:].numpy())


def test_snapshot_roundtrip_and_crash_leftover(tmp_path):
    pts = synth.load("skewed2d", 1000, seed=3)
    snap = _snap(pts)
    d = str(tmp_path)
    serve.save_snapshot(snap, d, step=1)
    # simulate a crash mid-write: a stale tmp dir with partial contents
    leftover = os.path.join(d, "step_0000000002.tmpXYZ")
    os.makedirs(leftover)
    with open(os.path.join(leftover, "arrays.npz"), "wb") as f:
        f.write(b"partial garbage")
    snap2 = serve.load_snapshot(d, device="cpu")  # step 1, not the leftover
    q = np.random.default_rng(6).uniform(0, 10, (64, 3)) \
        .astype(np.float32)
    q[:, 2] = 0
    a = serve.assign(snap, q)
    b = serve.assign(snap2, q)
    for f in ("labels", "counts", "dist"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("points", "labels", "core", "counts", "order", "cands",
              "codes", "croot_sorted"):
        x, y = getattr(snap, f), getattr(snap2, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert snap2.spec == snap.spec
    assert (snap2.eps, snap2.min_pts) == (snap.eps, snap.min_pts)
    # published-then-damaged: a *renamed* step whose arrays were later
    # truncated must fall back to the newest intact version with a warning
    serve.save_snapshot(snap, d, step=2)
    serve.faults.corrupt_checkpoint(d, 2, mode="truncate")
    with pytest.warns(RuntimeWarning, match="falling back"):
        snap3 = serve.load_snapshot(d, device="cpu")
    assert torch.equal(snap3.labels, snap.labels)


def test_save_snapshot_versions_and_gc(tmp_path):
    pts = synth.blobs(300, k=2, seed=10)
    snap = _snap(pts)
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        serve.save_snapshot(snap, d, step=s, keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2  # keep-K gc
    assert serve.load_snapshot(d, device="cpu").n == 300


def test_build_snapshot_rejects_engine_without_query_capability():
    pts = synth.blobs(100, k=2, seed=11)
    for engine in ("grid-hash", "brute"):
        with pytest.raises(ValueError, match="query"):
            serve.build_snapshot(pts, EPS, MINPTS, engine=engine,
                                 device="cpu")
    # the rejection is capability-driven, not name-driven
    assert "query" in engines.get_engine_spec("grid").capabilities
    assert "query" not in engines.get_engine_spec("brute").capabilities


def test_scheduler_buckets_and_program_key_tracking():
    sched = serve.BucketScheduler(min_bucket=256, max_bucket=4096)
    assert sched.bucket(1) == 256
    assert sched.bucket(256) == 256
    assert sched.bucket(257) == 512
    assert sched.bucket(4096) == 4096
    with pytest.raises(ValueError):
        sched.bucket(4097)
    q, nq = sched.pad(np.zeros((300, 3), np.float32))
    assert q.shape == (512, 3) and nq == 300 and (q[300:] > 1e29).all()

    pts = synth.blobs(700, k=3, seed=12)
    snap = _snap(pts)
    rng = np.random.default_rng(13)
    # warmup: one call per bucket in the ladder
    for b in sched.buckets_upto(1024):
        serve.assign(snap, rng.uniform(0, 2, (b, 3)).astype(np.float32),
                     scheduler=sched)
    assert sched.recompiles == len(sched.buckets_upto(1024))
    sched.reset_stats()
    # stream of ragged sizes: every call lands on a known program key
    for nq in (1, 7, 100, 255, 256, 300, 513, 777, 1000):
        r = serve.assign(snap, rng.uniform(0, 2, (nq, 3))
                         .astype(np.float32), scheduler=sched)
        assert r.labels.shape == (nq,)
    assert sched.recompiles == 0
    assert sched.calls == 9
    p50, p99 = sched.latency_percentiles()
    assert np.isfinite(p50) and p99 >= p50


def test_assign_queries_outside_corpus_domain():
    """Queries left/right of the corpus extent clip into border cells; the
    exact refine must still reject them unless genuinely within ε, and a
    coordinate far beyond int32 cells saturates instead of wrapping."""
    pts = synth.blobs(400, k=2, seed=14)
    snap = _snap(pts)
    far = np.asarray([[-1e3, -1e3, 0], [1e3, 1e3, 0], [3e12, -3e12, 0]],
                     np.float32)
    r = serve.assign(snap, far)
    assert (r.labels == -1).all() and (r.counts == 0).all()
    assert np.isinf(r.dist).all()
    # a query just outside the bounding box but within ε of an edge point
    edge = pts[np.argmax(pts[:, 0])]
    near = (edge + np.asarray([EPS * 0.5, 0, 0], np.float32))[None, :]
    exp_lab, exp_cnt, exp_d2 = _predict_oracle(
        pts, snap.labels.numpy(), snap.core.numpy(), EPS, near)
    rn = serve.assign(snap, near)
    np.testing.assert_array_equal(rn.labels, exp_lab)
    np.testing.assert_array_equal(rn.counts, exp_cnt)
    np.testing.assert_array_equal(rn.dist, np.sqrt(exp_d2))


def test_snapshots_cross_load_both_ways(tmp_path):
    """A snapshot saved by the reference loads here and answers ``assign``
    as this package's own snapshot does, and the other way round."""
    pts = synth.load("skewed2d", 1200, seed=4)
    q = _queries(pts, 200, seed=9)
    js = jserve.build_snapshot(pts, EPS, MINPTS)
    ts = _snap(pts)
    jdir, tdir = str(tmp_path / "from_jax"), str(tmp_path / "from_torch")
    jserve.save_snapshot(js, jdir, step=3, wal_offset=17)
    serve.save_snapshot(ts, tdir, step=3, wal_offset=17)
    # the reference's snapshot, loaded here
    t_from_j, meta = serve.load_snapshot(jdir, with_meta=True, device="cpu")
    assert meta["step"] == 3 and meta["wal_offset"] == 17
    assert t_from_j.spec == ts.spec and t_from_j.engine == "grid"
    for f in ("points", "labels", "core", "counts", "order", "cands",
              "codes", "croot_sorted"):
        x, y = getattr(t_from_j, f), getattr(ts, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    a, b = serve.assign(t_from_j, q), serve.assign(ts, q)
    for f in ("labels", "counts", "dist"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # this package's snapshot, loaded by the reference
    j_from_t, jmeta = jserve.load_snapshot(tdir, with_meta=True)
    assert jmeta["step"] == 3 and jmeta["wal_offset"] == 17
    assert j_from_t.spec == js.spec
    ja, jb = jserve.assign(j_from_t, q), jserve.assign(js, q)
    for f in ("labels", "counts", "dist"):
        np.testing.assert_array_equal(getattr(ja, f), getattr(jb, f))
    np.testing.assert_array_equal(ja.labels, a.labels)
    np.testing.assert_array_equal(ja.counts, a.counts)
    # both write the same keys and leaf count
    import json
    metas = [json.load(open(os.path.join(d, "step_0000000003",
                                         "meta.json")))
             for d in (jdir, tdir)]
    assert metas[0]["meta"] == metas[1]["meta"]
    assert metas[0]["n_leaves"] == metas[1]["n_leaves"] == 8
    assert set(metas[0]) == set(metas[1])


def test_entry_points_run_on_cuda_by_default(monkeypatch, tmp_path):
    pts = synth.blobs(120, k=2, seed=15)
    snap = _snap(pts)
    serve.save_snapshot(snap, str(tmp_path), step=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_snapshot(pts, EPS, MINPTS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.load_snapshot(str(tmp_path))
    # a session and assign run on their snapshot's device
    r = serve.ServeSession(snap).assign(pts[:10])
    assert r.labels.shape == (10,) and snap.device.type == "cpu"
