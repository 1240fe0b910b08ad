"""repro_torch's sharded serving tier on the CPU, mirroring
tests/test_shard.py's split/route/merge suite (sharded ``assign`` and
ingest-then-compact bit-identical to the single-snapshot path, boundary
routing, the degenerate one-shard split, per-shard checkpoint namespaces,
sheds that name the owning shard, replicas, degraded serving), and held to
the JAX reference (``repro.serve``) on the same seeded inputs:
``split_snapshot``'s map and parts bitwise, ``owner_of`` and
``window_shards`` equal, a tier ``assign`` equal to the reference tier's
(integers bitwise; ``dist`` bitwise to the reference run op by op, since
compiled, XLA's CPU backend may contract its d² into fused multiply-adds)
and tier compaction labels equal.

The reference's outputs are computed once per module (its tiers are slow
on the CPU).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.data import synth
from repro_torch import serve
from repro_torch.core.dbscan import dbscan
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import shard_devices
from tier_cases import (EPS, MINPTS, domain_queries as _domain_queries,
                        same_answer as _same_answer,
                        tier_global_labels as _tier_global_labels)

SNAP_FIELDS = ("points", "labels", "core", "counts", "order", "cands",
               "codes", "croot_sorted")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps them fast
    beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parity_cases():
    """tests/test_shard.py's ``_parity_cases``, same seeds."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (80, 3)).astype(np.float32)
    dup = np.concatenate([base, base, base[:30]])
    spread = (rng.uniform(0, 100, (60, 3)) * np.array([1, 1, 0])) \
        .astype(np.float32)
    return {
        "skewed2d": synth.load("skewed2d", 1200, seed=4),
        "duplicates": dup,
        "n2": np.asarray([[0., 0., 0.], [0.01, 0., 0.]], np.float32),
        "all_noise": spread,
    }


def _snap(pts):
    return serve.build_snapshot(pts, EPS, MINPTS, device="cpu")


# --- reference outputs, once per module -------------------------------------

@pytest.fixture(scope="module")
def ref_split():
    """The reference's split of every parity case at K = 2 and 3: map
    arrays, parts, routes of the domain queries, and (at K = 3) its tier's
    assign."""
    out = {}
    for name, pts in _parity_cases().items():
        js = jserve.build_snapshot(pts, EPS, MINPTS)
        q = _domain_queries(pts, 137)
        for k in (2, 3):
            smap, parts = jserve.split_snapshot(js, k)
            out[name, k] = dict(
                smap=smap, parts=[dict(
                    label_table=p.label_table, orig_index=p.orig_index,
                    code_lo=p.code_lo, code_hi=p.code_hi, spec=p.snapshot.spec,
                    **{f: np.asarray(getattr(p.snapshot, f))
                       for f in SNAP_FIELDS}) for p in parts],
                owner=smap.owner_of(pts), window=smap.window_shards(q))
            if k == 3:
                tier = jserve.ShardedTier(smap, parts, corpus=pts, eps=EPS,
                                          min_pts=MINPTS, n_shards=k)
                r = tier.assign(q)
                out[name, k].update(labels=r.labels, counts=r.counts)
                tier.close()
    return out


@pytest.fixture(scope="module")
def ref_compacted():
    """The reference tier's online labels and compaction after ingesting
    the second half of the skewed2d case in chunks of 64."""
    out = {}
    for name in ("skewed2d",):
        pts = _parity_cases()[name]
        half = len(pts) // 2
        tier = jserve.ShardedTier.build(pts[:half], EPS, MINPTS, n_shards=3,
                                        max_delta_frac=np.inf)
        online = [tier.ingest(pts[i:i + 64]).labels
                  for i in range(half, len(pts), 64)]
        tier.compact(force=True)
        out[name] = dict(online=online, labels=_tier_global_labels(
            tier, local=np.asarray))
        tier.close()
    return out


# --- parity with the reference ----------------------------------------------

@pytest.mark.parametrize("name", list(_parity_cases()))
@pytest.mark.parametrize("k", [2, 3])
def test_split_snapshot_matches_reference_bitwise(name, k, ref_split):
    pts = _parity_cases()[name]
    ref = ref_split[name, k]
    smap, parts = serve.split_snapshot(_snap(pts), k)
    for f in ("codes", "pos_cuts", "cut_codes"):
        x, y = getattr(smap, f), getattr(ref["smap"], f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (smap.side, smap.origin, smap.dims, smap.bits) == (
        ref["smap"].side, ref["smap"].origin, ref["smap"].dims,
        ref["smap"].bits)
    assert len(parts) == len(ref["parts"])
    for p, rp in zip(parts, ref["parts"]):
        assert (p.code_lo, p.code_hi) == (rp["code_lo"], rp["code_hi"])
        for f in ("label_table", "orig_index"):
            assert getattr(p, f).dtype == rp[f].dtype, f
            np.testing.assert_array_equal(getattr(p, f), rp[f], err_msg=f)
        assert tuple(vars(p.snapshot.spec).values()) == \
            tuple(vars(rp["spec"]).values())
        for f in SNAP_FIELDS:
            got = getattr(p.snapshot, f).numpy()
            assert got.dtype == rp[f].dtype, f
            np.testing.assert_array_equal(got, rp[f], err_msg=f)
    q = _domain_queries(pts, 137)
    np.testing.assert_array_equal(smap.owner_of(pts), ref["owner"])
    np.testing.assert_array_equal(smap.window_shards(q), ref["window"])


@pytest.mark.parametrize("name", ["skewed2d", "duplicates"])
def test_window_shards_matches_reference_on_mixed_queries(name, ref_split):
    """The port's routing (windows of distinct query cells, bisected
    against the distinct occupied codes) against the reference's (every
    query's windows, two bisections of every corpus code): near-corpus
    queries, repeats, far-away ones (clipped into the border cells) and
    the corpus itself."""
    pts = _parity_cases()[name]
    rng = np.random.default_rng(21)
    near = pts[rng.integers(0, len(pts), 600)] + rng.normal(
        0, EPS, (600, 3)).astype(np.float32)
    far = rng.uniform(-1e4, 1e4, (50, 3)).astype(np.float32)
    q = np.concatenate([near, near[:100], far, pts,
                        _domain_queries(pts, 300, seed=22)])
    if np.all(pts[:, 2] == pts[0, 2]):
        q[:, 2] = pts[0, 2]
    smap, _ = serve.split_snapshot(_snap(pts), 3)
    got = smap.window_shards(q)
    np.testing.assert_array_equal(got, ref_split[name, 3]["smap"]
                                  .window_shards(q))
    assert smap.window_shards(q[:0]).shape == (0, smap.n_shards)


@pytest.mark.parametrize("name", list(_parity_cases()))
@pytest.mark.parametrize("k", [2, 3])
def test_sharded_assign_bit_identical(name, k, ref_split):
    """tests/test_shard.py's test, plus the reference tier's answer."""
    pts = _parity_cases()[name]
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(snap, n_shards=k)
    q = _domain_queries(pts, 137)
    r1 = serve.assign(snap, q)
    r2 = tier.assign(q)
    _same_answer(r1, r2, "tier vs single snapshot")   # bit-identical, no tol
    if k == 3:
        np.testing.assert_array_equal(r2.labels, ref_split[name, k]["labels"])
        np.testing.assert_array_equal(r2.counts, ref_split[name, k]["counts"])
    assert not r2.partial and sorted(r2.shards) == sorted(
        j for j in range(tier.n_shards) if tier.map.window_shards(q)[:, j]
        .any())


def test_sharded_assign_dist_matches_reference_op_by_op():
    pts = _parity_cases()["skewed2d"]
    snap = _snap(pts)
    rng = np.random.default_rng(6)
    q = _domain_queries(pts, 137)
    near = rng.choice(np.nonzero(snap.core.numpy())[0], 80)
    q[:80] = pts[near] + rng.normal(0, EPS / 2, (80, 3)) * [1, 1, 0]
    tier = serve.ShardedTier.from_snapshot(snap, n_shards=3)
    jtier = jserve.ShardedTier.from_snapshot(
        jserve.build_snapshot(pts, EPS, MINPTS), n_shards=3)
    with jax.disable_jit():
        j = jtier.assign(q)
    _same_answer(tier.assign(q), j, "tier vs reference tier op by op")
    assert np.isfinite(j.dist).sum() > 20
    jtier.close()


@pytest.mark.parametrize("name", list(_parity_cases()))
def test_sharded_ingest_then_compact_bit_identical(name, ref_compacted):
    pts = _parity_cases()[name]
    n = len(pts)
    half = max(n // 2, 1)
    tier = serve.ShardedTier.build(pts[:half], EPS, MINPTS, n_shards=3,
                                   max_delta_frac=np.inf, device="cpu")
    sess = serve.ServeSession(_snap(pts[:half]), max_delta_frac=np.inf)
    online = []
    for i in range(half, n, 64):
        chunk = pts[i:i + 64]
        res = tier.ingest(chunk)
        assert res.labels.shape == (len(chunk),)
        online.append(res.labels)
        sess.ingest(chunk)
    tier.compact(force=True)
    sess.compact(force=True)
    ref = dbscan(pts, EPS, MINPTS, device="cpu")
    lab, core = _tier_global_labels(tier)
    np.testing.assert_array_equal(lab, ref.labels.numpy())
    np.testing.assert_array_equal(core, ref.core.numpy())
    np.testing.assert_array_equal(lab, sess.snapshot.labels.numpy())
    if name in ref_compacted:
        rc = ref_compacted[name]
        for a, b in zip(online, rc["online"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(lab, rc["labels"][0])
        np.testing.assert_array_equal(core, rc["labels"][1])
    q = _domain_queries(pts, 99, seed=7)
    r1 = sess.assign(q)
    r2 = tier.assign(q)
    np.testing.assert_array_equal(r1.labels, r2.labels)
    np.testing.assert_array_equal(r1.dist, r2.dist)


def _line_corpus(n=400):
    """A dense line along x (spacing ε/4 → every interior point is core):
    2D Morton code of (cx, 0) is monotone in cx, so sorted order is x
    order and the shard cut is a *spatial* boundary we can aim queries
    at."""
    x = np.arange(n, dtype=np.float32) * (EPS / 4)
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = x
    return pts


def test_boundary_queries_route_to_both_shards_and_merge_exactly():
    pts = _line_corpus()
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(snap, n_shards=2)
    assert tier.n_shards == 2
    smap = tier.map
    cut_pos = int(smap.pos_cuts[1])
    order = snap.order.numpy()
    b = pts[order[cut_pos]]
    q = np.stack([b,
                  b - [EPS * 0.5, 0, 0],
                  b + [EPS * 0.5, 0, 0],
                  b - [EPS * 0.99, 0, 0],
                  b + [EPS * 0.99, 0, 0]]).astype(np.float32)
    mask = smap.window_shards(q)
    assert mask.shape == (len(q), 2)
    assert mask[0].all(), "a query ON the cut must route to both shards"
    assert (mask.sum(axis=1) >= 1).all()
    assert mask[:, 0].any() and mask[:, 1].any()
    jmap, _ = jserve.split_snapshot(jserve.build_snapshot(pts, EPS, MINPTS),
                                    2)
    np.testing.assert_array_equal(mask, jmap.window_shards(q))
    r1 = serve.assign(snap, q)
    r2 = tier.assign(q)
    _same_answer(r1, r2)
    assert (r2.labels == r1.labels[0]).all() and r1.labels[0] >= 0


def test_degenerate_all_points_one_shard():
    pts = np.tile(np.asarray([[0.3, 0.4, 0.0]], np.float32), (50, 1))
    snap = _snap(pts)
    tier = serve.ShardedTier.from_snapshot(snap, n_shards=4)
    assert tier.n_shards == 1
    assert (tier.map.owner_of(pts) == 0).all()
    q = np.asarray([[0.3, 0.4, 0.0], [5.0, 5.0, 0.0]], np.float32)
    r1 = serve.assign(snap, q)
    r2 = tier.assign(q)
    np.testing.assert_array_equal(r1.labels, r2.labels)
    np.testing.assert_array_equal(r1.counts, r2.counts)
    assert r2.labels[0] == 0 and r2.labels[1] == -1


def test_split_partitions_canonical_corpus():
    pts = synth.load("skewed2d", 800, seed=2)
    snap = _snap(pts)
    smap, parts = serve.split_snapshot(snap, 3)
    rows = np.concatenate([p.orig_index for p in parts])
    assert sorted(rows.tolist()) == list(range(len(pts)))
    for p in parts:
        np.testing.assert_array_equal(p.snapshot.points.numpy(),
                                      pts[p.orig_index])
        assert (np.diff(p.label_table) > 0).all() \
            if p.label_table.size > 1 else True
        assert p.snapshot.device == snap.device
    for p in parts:
        assert (smap.owner_of(pts[p.orig_index]) == p.shard_id).all()


def test_overflow_shed_names_owning_shard():
    pts = synth.load("skewed2d", 600, seed=4)
    tier = serve.ShardedTier.build(pts, EPS, MINPTS, n_shards=2,
                                   delta_capacity=64,
                                   max_delta_frac=np.inf, device="cpu")
    rng = np.random.default_rng(3)
    chunk = pts[rng.integers(0, len(pts), 60)] + rng.normal(
        0, EPS / 10, (60, 3)).astype(np.float32)
    chunk[:, 2] = 0
    with serve.faults.inject("serve.compact", times=-1,
                             error=RuntimeError("injected rebuild fail")):
        tier.ingest(chunk)          # fills buffers
        with pytest.raises(serve.AdmissionError) as ei:
            for _ in range(8):      # overflow + broken compaction -> shed
                tier.ingest(chunk + rng.normal(0, EPS / 10, chunk.shape)
                            .astype(np.float32) * [1, 1, 0])
        assert "shard-" in str(ei.value)
        assert ei.value.details.get("session_id")
        assert ei.value.retry_after is not None


def test_single_session_shed_includes_session_id():
    pts = synth.load("skewed2d", 300, seed=4)
    sess = serve.ServeSession(_snap(pts), session_id="shard-007",
                              delta_capacity=32, max_delta_frac=np.inf)
    chunk = pts[:30]
    with serve.faults.inject("serve.compact", times=-1,
                             error=RuntimeError("injected rebuild fail")):
        sess.ingest(chunk)
        with pytest.raises(serve.AdmissionError) as ei:
            sess.ingest(chunk)
    assert "shard-007" in str(ei.value)
    assert ei.value.details.get("session_id") == "shard-007"


def test_delegated_session_refuses_local_compact():
    pts = synth.load("skewed2d", 300, seed=4)
    tier = serve.ShardedTier.build(pts, EPS, MINPTS, n_shards=2,
                                   device="cpu")
    with pytest.raises(serve.ServeError, match="tier"):
        tier.sessions[0].compact()


def test_checkpoint_namespace_isolates_gc_and_pins(tmp_path):
    """Shard A churning through keep-K steps can never GC shard B's pinned
    baseline — namespaces do not share a step listing."""
    root = str(tmp_path)
    tree = {"x": np.arange(4)}
    ckpt.save(root, 0, tree, keep=2, namespace="shard-001")  # B's baseline
    for s in range(12):  # A churns far past keep
        ckpt.save(root, s, tree, keep=2, namespace="shard-000")
    assert ckpt.available_steps(root, namespace="shard-000") == [10, 11]
    assert ckpt.available_steps(root, namespace="shard-001") == [0]
    ckpt.save(root, 12, tree, keep=1, pin=(0,), namespace="shard-000")
    assert 0 not in ckpt.available_steps(root, namespace="shard-000")[1:]
    assert ckpt.available_steps(root, namespace="shard-001") == [0]
    restored, _ = ckpt.restore(root, tree, namespace="shard-001")
    np.testing.assert_array_equal(np.asarray(restored["x"]), tree["x"])
    with pytest.raises(ValueError):
        ckpt.save(root, 0, tree, namespace="a/b")
    with pytest.raises(ValueError):
        ckpt.save(root, 0, tree, namespace="step_0000000001")


def test_tier_durable_publish_per_shard_namespaces(tmp_path):
    pts = synth.load("skewed2d", 500, seed=4)
    ckpt_root = str(tmp_path / "snap")
    wal_root = str(tmp_path / "wal")
    tier = serve.ShardedTier.build(
        pts, EPS, MINPTS, n_shards=2, max_delta_frac=np.inf,
        ckpt_root=ckpt_root, wal_root=wal_root, durability="none",
        device="cpu")
    try:
        assert tier.n_shards == 2
        for j in range(tier.n_shards):
            ns = f"shard-{j:03d}"
            assert ckpt.available_steps(ckpt_root, namespace=ns) == [0]
            assert os.path.isdir(os.path.join(wal_root, ns))
        tier.ingest(pts[:100] + np.float32(EPS / 7))
        tier.compact(force=True)
        for j in range(tier.n_shards):
            ns = f"shard-{j:03d}"
            steps = ckpt.available_steps(ckpt_root, namespace=ns)
            assert steps[-1] >= 1
            offs = serve.published_wal_offsets(ckpt_root, namespace=ns)
            assert offs, "per-shard WAL watermark must be embedded"
            snap = serve.load_snapshot(ckpt_root, namespace=ns,
                                       device="cpu")
            assert snap.n == tier.parts[j].n
            # the reference loads the port's shard checkpoints too
            jsnap = jserve.load_snapshot(ckpt_root, namespace=ns)
            np.testing.assert_array_equal(np.asarray(jsnap.labels),
                                          tier.parts[j].snapshot.labels
                                          .numpy())
    finally:
        tier.close()


def test_replicas_round_robin_with_zero_new_program_keys():
    pts = synth.load("skewed2d", 600, seed=4)
    tier = serve.ShardedTier.build(pts, EPS, MINPTS, n_shards=2,
                                   device="cpu")
    tier.warmup(512)
    assert tier.replicate(0, copies=1) == 1
    tier.scheduler.reset_stats()
    q = _domain_queries(pts, 100, seed=11)
    for _ in range(4):
        tier.assign(q)
    assert tier.scheduler.recompiles == 0
    served = [k for k in tier.replica_served if k[0] == 0]
    assert len(set(served)) == 2, "round-robin must touch both copies"
    assert set(tier.scheduler.routed) <= {0, 1, 2}
    assert sum(tier.scheduler.routed.values()) == 4 * len(q)


def test_tier_degrades_instead_of_stalling():
    pts = synth.load("skewed2d", 500, seed=4)
    tier = serve.ShardedTier.build(pts, EPS, MINPTS, n_shards=2,
                                   max_delta_frac=0.05, device="cpu")
    q = _domain_queries(pts, 50, seed=13)
    with serve.faults.inject("serve.compact", times=-1,
                             error=RuntimeError("injected rebuild fail")):
        r = tier.ingest(pts[:64] + np.float32(EPS / 9))  # compaction due
        assert r.degraded and not r.compacted
        ra = tier.assign(q)
        assert ra.degraded and ra.staleness >= 0
        with pytest.raises(serve.CompactionError):
            tier.compact()
    tier.compact(force=True)
    ra = tier.assign(q)
    assert not ra.degraded and tier.n_delta == 0


def test_shard_devices_round_robin_and_cpu_placement(monkeypatch):
    cpu = torch.device("cpu")
    assert shard_devices(3, [cpu]) == [cpu, cpu, cpu]
    assert shard_devices(3, ["cpu", "meta"]) == [
        cpu, torch.device("meta"), cpu]
    with pytest.raises(ValueError):
        shard_devices(0, [cpu])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        shard_devices(2)
    # a CPU snapshot's tier never asks for CUDA: placement is the identity
    pts = synth.load("skewed2d", 300, seed=4)
    tier = serve.ShardedTier.from_snapshot(_snap(pts), n_shards=2)
    assert tier._devices == [cpu, cpu] and not tier._multi_device
    assert all(s.snapshot.device == cpu for s in tier.sessions)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.ShardedTier.build(pts, EPS, MINPTS, n_shards=2)


def test_snapshot_to_moves_every_field():
    snap = _snap(synth.load("skewed2d", 300, seed=4))
    meta = snap.to("meta")
    for f in SNAP_FIELDS:
        assert getattr(meta, f).device.type == "meta", f
        assert getattr(meta, f).dtype == getattr(snap, f).dtype, f
    assert meta.spec == snap.spec and meta.eps == snap.eps
    back = snap.to("cpu")
    for f in SNAP_FIELDS:
        assert torch.equal(getattr(back, f), getattr(snap, f)), f
