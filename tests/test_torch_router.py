"""repro_torch's sharded tier as failure domains on the CPU, mirroring the
second half of tests/test_shard.py: replica failover, round-robin past a
quarantined copy, hedged legs, ``retry_after`` through the router, partial
gathers as the exact restriction of the full merge, the kill matrix and
the chaos gate. Held to the JAX reference (``repro.serve``) on the same
seeded inputs: a partial gather equal to the reference tier's under the
same quarantines (integers bitwise; ``dist`` to the port's single-snapshot
answers, which tests/test_torch_serve.py holds to the reference run op by
op), and shard checkpoints and WALs written by the reference tier
re-materialized by the port's ``recover_shard`` into the reference's
state. Also: the kernels' first build and launch counts under two host
threads (the hedged leg's), with a stand-in build.
"""
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.data import synth
from repro_torch import serve
from repro_torch.core.dbscan import dbscan
from repro_torch.kernels import build
from tier_cases import (EPS, MINPTS, domain_queries as _domain_queries,
                        same_answer as _same_answer,
                        tier_global_labels as _tier_global_labels)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps them fast
    beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snap(pts):
    return serve.build_snapshot(pts, EPS, MINPTS, device="cpu")


def _points(part):
    return part.snapshot.points.numpy()


def _aimed_queries(tier, shard_id):
    """Queries guaranteed to route to ``shard_id``: its own corpus
    points."""
    return _points(tier.parts[shard_id])[:8]


def test_assign_failover_to_replica_bit_identical():
    pts = synth.load("skewed2d", 600, seed=4)
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(snap, n_shards=2, hedge=False,
                                           auto_recover=False)
    try:
        tier.replicate(0, copies=1)
        tier.warmup(256)
        q = np.concatenate([_domain_queries(pts, 80, seed=29),
                            _points(tier.parts[0])[:8]])
        full = serve.assign(snap, q)
        tier.scheduler.reset_stats()
        with serve.faults.inject(
                "serve.shard.assign", times=-1, tag="shard-000/r0",
                error=serve.CapacityError("injected: r0 wedged")):
            for _ in range(8):
                r = tier.assign(q)
                assert not r.partial
                _same_answer(r, full)
            assert tier.scheduler.failovers >= 1
            assert tier.health.state((0, 0)) == serve.DOWN
        assert tier.scheduler.recompiles == 0
        assert tier.replica_served.get((0, 1), 0) >= 4
        rep = tier.health_report()
        assert rep["targets"]["shard-000/r0"]["state"] == serve.DOWN
        assert rep["scheduler"]["failovers"] == tier.scheduler.failovers
    finally:
        tier.close()


def test_round_robin_skips_quarantined_replica():
    pts = synth.load("skewed2d", 500, seed=4)
    tier = serve.ShardedTier.build(pts, EPS, MINPTS, n_shards=2,
                                   auto_recover=False, device="cpu")
    try:
        tier.replicate(0, copies=2)          # 3 serving copies of shard 0
        tier.warmup(256)
        tier.health.force_down((0, 1))
        tier.scheduler.reset_stats()
        tier.replica_served.clear()
        q = _aimed_queries(tier, 0)
        for _ in range(6):
            assert not tier.assign(q).partial
        served = {k: v for k, v in tier.replica_served.items()
                  if k[0] == 0}
        assert served.get((0, 1), 0) == 0    # quarantined copy never serves
        assert served.get((0, 0), 0) >= 1 and served.get((0, 2), 0) >= 1
        assert sum(served.values()) == 6     # no stalled turns
        rep = tier.health_report()
        assert rep["targets"]["shard-000/r1"]["state"] == serve.DOWN
        assert rep["targets"]["shard-000/r0"]["state"] == serve.HEALTHY
        assert rep["targets"]["shard-000/r1"]["served"] == 0
    finally:
        tier.close()


def test_hedged_suspect_leg_first_result_wins():
    pts = synth.load("skewed2d", 500, seed=4)
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(snap, n_shards=2,
                                           auto_recover=False)
    try:
        tier.replicate(0, copies=1)
        tier.warmup(256)
        q = _aimed_queries(tier, 0)
        full = serve.assign(snap, q)
        tier.scheduler.reset_stats()
        tier.health.record_failure((0, 0))
        assert tier.health.state((0, 0)) == serve.SUSPECT
        r = tier.assign(q)
        assert tier.scheduler.hedges == 1
        assert r.shards[0].hedged and not r.shards[0].missing
        assert r.shards[0].replica in (0, 1)
        # replicas share the shard's buffers: the hedge buys latency, never
        # a different answer, though its two legs ran on two threads
        _same_answer(r, full)
    finally:
        tier.close()


def test_retry_after_survives_tier_reraise():
    pts = synth.load("skewed2d", 400, seed=4)
    sleeps = []
    tier = serve.ShardedTier.build(pts, EPS, MINPTS, n_shards=2,
                                   auto_recover=False, sleep=sleeps.append,
                                   device="cpu")
    try:
        chunk = _points(tier.parts[0])[:8]
        with serve.faults.inject(
                "serve.shard.ingest", times=-1, tag="shard-000",
                error=serve.AdmissionError("downstream shed",
                                           retry_after=7.5)):
            with pytest.raises(serve.AdmissionError) as ei:
                tier.ingest(chunk)
        assert ei.value.retry_after == 7.5
        assert "shard-000" in str(ei.value)
        assert ei.value.details.get("session_id") == "shard-000"
        assert len(sleeps) == tier.leg_retries
        assert all(s >= 7.5 for s in sleeps)
        assert tier.health.state((0, 0)) == serve.DOWN
        tier.health = serve.HealthRegistry()
        tier.allow_partial = False
        q = _aimed_queries(tier, 1)
        with serve.faults.inject(
                "serve.shard.assign", times=-1, tag="shard-001",
                error=serve.CapacityError("slab wedged", retry_after=2.25)):
            with pytest.raises(serve.CapacityError) as ei2:
                tier.assign(q)
        assert ei2.value.retry_after == 2.25
        assert ei2.value.details.get("session_id") == "shard-001"
    finally:
        tier.close()


# --- partial gathers: the restriction property ------------------------------

_PARTIAL = {}


def _partial_setup():
    if not _PARTIAL:
        pts = synth.load("skewed2d", 600, seed=4)
        snap = _snap(pts)
        tier = serve.ShardedTier.from_snapshot(snap, n_shards=3,
                                               auto_recover=False)
        assert tier.n_shards == 3
        q = np.concatenate(
            [_domain_queries(pts, 60, seed=23)]
            + [_points(p)[:5] for p in tier.parts])
        # the reference's tier on the same corpus, every quarantine set
        jtier = jserve.ShardedTier.from_snapshot(
            jserve.build_snapshot(pts, EPS, MINPTS), n_shards=3,
            auto_recover=False)
        ref = {}
        for bits in range(8):
            jtier.health = jserve.HealthRegistry()
            for j in range(3):
                if not bits >> j & 1:
                    jtier.health.force_down((j, 0))
            r = jtier.assign(q)
            ref[bits] = (r.labels, r.counts, r.partial)
        jtier.close()
        _PARTIAL.update(tier=tier, snap=snap, q=q, ref=ref,
                        full=serve.assign(snap, q))
    return (_PARTIAL["tier"], _PARTIAL["snap"], _PARTIAL["q"],
            _PARTIAL["full"], _PARTIAL["ref"])


def _restricted_merge(tier, q, alive):
    """The restriction: the full merge minus the missing shards'
    contributions, from per-shard single-snapshot assigns and the same
    monotone remap/merge the router runs."""
    mask = tier.map.window_shards(q)
    nq = len(q)
    counts = np.zeros(nq, np.int32)
    merged = np.full(nq, np.iinfo(np.int64).max, np.int64)
    dist = np.full(nq, np.inf, np.float32)
    for j in alive:
        idx = np.nonzero(mask[:, j])[0]
        if idx.size == 0:
            continue
        r = serve.assign(tier.parts[j].snapshot, q[idx])
        table = tier.parts[j].label_table.astype(np.int64)
        if table.size:
            glab = np.where(r.labels >= 0,
                            table[np.clip(r.labels, 0, None)],
                            np.iinfo(np.int64).max)
        else:
            glab = np.full(idx.size, np.iinfo(np.int64).max, np.int64)
        merged[idx] = np.minimum(merged[idx], glab)
        counts[idx] += r.counts
        dist[idx] = np.minimum(dist[idx], r.dist)
    labels = np.where(merged != np.iinfo(np.int64).max,
                      merged, -1).astype(np.int32)
    return labels, counts, dist


@pytest.mark.parametrize("bits", list(range(8)))
def test_partial_merge_is_restriction(bits):
    """Every subset of live shards (tests/test_shard.py enumerates the same
    eight with hypothesis); the partial answer equals the reference tier's
    under the same quarantines."""
    tier, snap, q, full, ref = _partial_setup()
    K = tier.n_shards
    alive = [j for j in range(K) if bits >> j & 1]
    tier.health = serve.HealthRegistry()    # fresh: forget previous downs
    for j in range(K):
        if j not in alive:
            tier.health.force_down((j, 0))
    r = tier.assign(q)
    ref_lab, ref_cnt, ref_dist = _restricted_merge(tier, q, alive)
    np.testing.assert_array_equal(r.labels, ref_lab)
    np.testing.assert_array_equal(r.counts, ref_cnt)
    np.testing.assert_array_equal(r.dist, ref_dist)
    np.testing.assert_array_equal(r.labels, ref[bits][0])
    np.testing.assert_array_equal(r.counts, ref[bits][1])
    assert r.partial == ref[bits][2]
    assert (r.counts <= full.counts).all()
    mism = r.labels != full.labels
    assert ((r.labels[mism] == -1)
            | (r.labels[mism].astype(np.int64)
               > full.labels[mism])).all(), "partial merge invented a label"
    routed = tier.map.window_shards(q)
    missing_routed = any(routed[:, j].any()
                         for j in range(K) if j not in alive)
    assert r.partial == missing_routed
    if missing_routed:
        assert any(s.missing for s in r.shards.values())


# --- kill matrix + chaos gate -----------------------------------------------

@pytest.mark.parametrize("site", ["assign", "probe", "rematerialize",
                                  "ingest"])
def test_shard_kill_matrix(site, tmp_path):
    """Kill shard 1 at each site; recovery must converge back to
    bit-identical parity with the unsharded path."""
    pts = synth.load("skewed2d", 400, seed=4)
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(
        snap, n_shards=3, ckpt_root=str(tmp_path / "snap"),
        wal_root=str(tmp_path / "wal"), durability="none",
        auto_recover=False, max_delta_frac=np.inf,
        health=serve.HealthRegistry(probe_deadline_s=30.0))
    try:
        tier.warmup(256)
        j = 1
        sid = serve.target_tag(j, None)
        q = np.concatenate([_domain_queries(pts, 60, seed=31),
                            _points(tier.parts[j])[:8]])
        full = serve.assign(snap, q)
        chunk = _points(tier.parts[j])[:16]
        if site == "assign":
            with serve.faults.inject("serve.shard.assign", times=1,
                                     tag=sid, error=serve.faults.Kill("x")):
                r = tier.assign(q)
            assert r.partial and r.shards[j].missing
            assert tier.health.state((j, 0)) == serve.DOWN
        elif site == "probe":
            with serve.faults.inject("serve.shard.probe", times=1,
                                     tag=sid, error=serve.faults.Kill("x")):
                assert tier.probe(j) is False
            assert tier.health.state((j, 0)) == serve.DOWN
        elif site == "rematerialize":
            tier.health.force_down((j, 0))
            with serve.faults.inject("serve.shard.rematerialize", times=1,
                                     tag=sid, error=serve.faults.Kill("x")):
                assert tier.recover_shard(j) is False
            assert j in tier.quarantined
        elif site == "ingest":
            with serve.faults.inject("serve.shard.ingest", times=1,
                                     tag=sid, error=serve.faults.Kill("x")):
                with pytest.raises(serve.AdmissionError) as ei:
                    tier.ingest(chunk, request_id="kill-chunk")
            assert ei.value.retry_after is not None
            assert j in tier.quarantined
            with pytest.raises(serve.AdmissionError):
                tier.ingest(chunk, request_id="kill-chunk")
        assert tier.recover_shard(j) is True      # re-materialize + certify
        assert tier.quarantined == []
        assert tier.health.state((j, 0)) == serve.HEALTHY
        if site == "ingest":
            res = tier.ingest(chunk, request_id="kill-chunk")
            assert not res.deduped
            tier.compact(force=True)
            ref = dbscan(np.concatenate([pts, chunk]), EPS, MINPTS,
                         device="cpu")
            lab, _ = _tier_global_labels(tier)
            np.testing.assert_array_equal(lab, ref.labels.numpy())
        else:
            r2 = tier.assign(q)
            assert not r2.partial
            _same_answer(r2, full)
            ref = dbscan(pts, EPS, MINPTS, device="cpu")
            lab, _ = _tier_global_labels(tier)
            np.testing.assert_array_equal(lab, ref.labels.numpy())
    finally:
        tier.close()


@pytest.mark.parametrize("k", [2, 3])
def test_chaos_gate_kill_replicas_one_by_one(k, tmp_path):
    """Kill shard 0's serving copies one by one — the tier keeps answering
    (failover, then flagged partials, no new program keys), the
    quarantined shard re-materializes from its checkpoint namespace, and
    post-recovery answers are bit-identical to the single-snapshot path
    and batch ``dbscan()``."""
    pts = synth.load("skewed2d", 500, seed=4)
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(
        snap, n_shards=k, ckpt_root=str(tmp_path / "snap"),
        wal_root=str(tmp_path / "wal"), durability="none",
        auto_recover=False,
        health=serve.HealthRegistry(probe_deadline_s=30.0))
    try:
        tier.replicate(0, copies=1)
        tier.warmup(256)
        q = np.concatenate([_domain_queries(pts, 80, seed=19),
                            _points(tier.parts[0])[:8]])
        full = serve.assign(snap, q)
        tier.scheduler.reset_stats()
        serve.faults.inject("serve.shard.assign", times=-1,
                            tag="shard-000/r0", error=serve.faults.Kill("a"))
        r = tier.assign(q)
        assert not r.partial
        np.testing.assert_array_equal(r.labels, full.labels)
        assert tier.health.state((0, 0)) == serve.DOWN
        serve.faults.inject("serve.shard.assign", times=-1,
                            tag="shard-000/r1", error=serve.faults.Kill("b"))
        r = tier.assign(q)
        assert r.partial and r.degraded
        assert r.shards[0].missing and r.shards[0].state == serve.DOWN
        assert tier.quarantined == [0]
        assert (r.counts <= full.counts).all()
        mism = r.labels != full.labels
        assert ((r.labels[mism] == -1)
                | (r.labels[mism].astype(np.int64)
                   > full.labels[mism])).all()
        assert tier.scheduler.recompiles == 0
        assert tier.scheduler.partials >= 1
        serve.faults.clear()
        assert tier.recover_shard(0) is True
        assert tier.quarantined == []
        r2 = tier.assign(q)
        assert not r2.partial
        _same_answer(r2, full)
        ref = dbscan(pts, EPS, MINPTS, device="cpu")
        lab, core = _tier_global_labels(tier)
        np.testing.assert_array_equal(lab, ref.labels.numpy())
        np.testing.assert_array_equal(core, ref.core.numpy())
        assert tier.scheduler.recompiles == 0
    finally:
        serve.faults.clear()
        tier.close()


def test_auto_recover_in_background():
    """A leg that exhausts its ring schedules the shard's re-materialize
    on the tier's pool; ``join_recovery`` waits for it."""
    pts = synth.load("skewed2d", 400, seed=4)
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(
        snap, n_shards=2, health=serve.HealthRegistry(probe_deadline_s=30.0))
    try:
        q = _aimed_queries(tier, 1)
        with serve.faults.inject("serve.shard.assign", times=1,
                                 tag="shard-001", error=serve.faults.Kill("x")):
            r = tier.assign(q)
        assert r.partial and r.shards[1].missing
        assert tier.join_recovery(timeout=120) is True
        assert tier.quarantined == []
        _same_answer(tier.assign(q), serve.assign(snap, q))
    finally:
        tier.close()


# --- state carried across packages -------------------------------------------

def test_recover_shard_from_reference_checkpoints_and_wals(tmp_path):
    """Shard checkpoints (one namespace each) and WALs written by the
    reference's durable tier, across a compaction and two later ingests,
    re-materialize through the port's ``recover_shard``: every shard's
    snapshot, delta and online labels, and the tier's answers, equal the
    reference tier's."""
    pts = synth.load("skewed2d", 600, seed=4)
    rng = np.random.default_rng(8)
    more = pts[rng.integers(0, len(pts), 192)] + (
        rng.normal(0, EPS / 4, (192, 3)) * [1, 1, 0]).astype(np.float32)
    ckpt_root, wal_root = str(tmp_path / "snap"), str(tmp_path / "wal")
    kw = dict(n_shards=3, max_delta_frac=np.inf, ckpt_root=ckpt_root,
              wal_root=wal_root, durability="none", auto_recover=False)
    jtier = jserve.ShardedTier.build(pts, EPS, MINPTS, **kw)
    jtier.ingest(more[:64])
    jtier.compact(force=True)            # every namespace publishes step 1
    jtier.ingest(more[64:128])           # WAL suffixes past the watermark
    jtier.ingest(more[128:])
    q = np.concatenate([_domain_queries(pts, 60, seed=3),
                        more[:40] + np.float32(EPS / 5)])
    jr = jtier.assign(q)
    jdelta = [np.asarray(s._delta) for s in jtier.sessions]
    jonline = [s._label_delta() if s.n_delta else None
               for s in jtier.sessions]
    jparts = [np.asarray(p.snapshot.labels) for p in jtier.parts]
    corpus = np.concatenate([pts, more[:64]])
    jtier.close()

    # the port's tier over the same global state, on the same directories
    tier = serve.ShardedTier.build(corpus, EPS, MINPTS, device="cpu",
                                   health=serve.HealthRegistry(
                                       probe_deadline_s=30.0), **kw)
    try:
        assert tier.n_shards == len(jparts)
        for j in range(tier.n_shards):
            tier.health.force_down((j, 0))
            assert tier.recover_shard(j) is True
            sess = tier.sessions[j]
            assert sess.last_recovery.baseline_step == 1
            np.testing.assert_array_equal(sess.snapshot.labels.numpy(),
                                          jparts[j])
            np.testing.assert_array_equal(sess._delta, jdelta[j])
            if jonline[j] is not None:
                np.testing.assert_array_equal(sess._label_delta(),
                                              jonline[j])
        assert tier.quarantined == []
        r = tier.assign(q)
        np.testing.assert_array_equal(r.labels, jr.labels)
        np.testing.assert_array_equal(r.counts, jr.counts)
        _same_answer(r, serve.assign(_snap(corpus), q))
        assert tier.n_delta == sum(len(d) for d in jdelta) == 128
    finally:
        tier.close()


# --- the kernels' first build and counts under two host threads -------------

def test_first_build_runs_once_under_two_threads(monkeypatch, tmp_path):
    """Two threads that reach a library first at the same moment: one
    build (a slow stand-in for nvcc), one load, the same library object;
    and launch counts added from both threads lose nothing."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    def slow_load(name):
        calls.append(name)
        time.sleep(0.2)
        return Lib()

    monkeypatch.setattr(build, "_LIBRARIES", {})
    monkeypatch.setattr(build, "load", slow_load)
    gate = threading.Barrier(2)
    got = []

    def first_use():
        gate.wait()
        got.append(build._library("csr_sweep"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == ["csr_sweep"] and got[0] is got[1]

    counts = {"k": 0}
    gate = threading.Barrier(4)

    def count_many():
        gate.wait()
        for _ in range(20_000):
            build.count(counts, "k")

    threads = [threading.Thread(target=count_many) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts["k"] == 80_000
    # a build writes a per-process, per-thread temporary file, renamed
    # into place when complete: two builds never share a file
    cmds = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            cmds.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return "", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    out = build.build(["csr_sweep"])
    tmp = cmds[0][cmds[0].index("-o") + 1]
    assert tmp.endswith(f".{os.getpid()}.{threading.get_ident()}.tmp")
    assert out["csr_sweep"].path.exists() and not Path(tmp).exists()
