"""repro_torch ``brute`` and ``grid-hash`` engines, the spatial-hash grid
(``plan_grid``, ``build_grid``, ``neighbor_buckets``) and ``find_neighbors``
on the CPU against the JAX reference on the same data: every integer output
bit-identical (sweep counts and min-root, plan fields, grid arrays, bucket
windows, neighbor lists, DBSCAN labels)."""
import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.baselines.brute import reference_counts
from repro.core import grid as jgrid
from repro.core import neighbors as jnb
from repro.core.dbscan import dbscan as jdbscan
from repro.data import synth
from repro_torch import dbscan, find_neighbors, make_engine
from repro_torch.baselines import brute as tbrute
from repro_torch.core import grid as tgrid
from repro_torch.core import neighbors as tnb

INT_MAX = np.iinfo(np.int32).max
_DUPS = np.random.default_rng(1).uniform(0, 1, (100, 3)).astype(np.float32)

SWEEP_DATA = [("roadnet2d", 0.05), ("taxi2d", 0.1), ("highway", 1.0),
              ("iono3d", 2.0)]
GRID_DATA = [
    ("blobs2", synth.blobs(350, k=3, seed=0), 0.08),
    ("blobs3d", synth.blobs(300, k=4, dims=3, seed=1), 0.12),
    ("taxi", synth.load("taxi2d", 777, seed=2), 0.1),
    ("iono", synth.load("iono3d", 300, seed=4), 2.0),
    ("duplicates", np.concatenate([_DUPS, _DUPS, _DUPS[:40]]), 0.03),
    ("skewed2d", synth.load("skewed2d", 1500, seed=4), 0.05),
]
GRID_IDS = [d[0] for d in GRID_DATA]
GRID_FIELDS = ("points", "index", "valid", "order", "bucket")


def _eq(ref, port):
    a = np.asarray(ref)
    b = port.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _ref_sweep(pts, eps, core, root):
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    hit = d2 <= eps * eps + 0.0
    masked = np.where(hit & core[None, :], root[None, :], INT_MAX)
    return hit.sum(1), masked.min(1)


@pytest.mark.parametrize("engine", ["brute", "grid-hash", "grid"])
@pytest.mark.parametrize("dataset,eps", SWEEP_DATA)
def test_engine_sweep_matches_reference(engine, dataset, eps):
    pts = synth.load(dataset, 400, seed=5)
    n = len(pts)
    rng = np.random.default_rng(0)
    core = rng.uniform(size=n) < 0.4
    root = rng.integers(0, n, n).astype(np.int32)
    jeng = jnb.make_engine(pts, eps, engine=engine)
    eng = make_engine(pts, eps, engine=engine, device="cpu")
    assert eng.name == engine
    ref = jeng.sweep(jeng.state, jnp.asarray(core), jnp.asarray(root))
    got = eng.sweep(eng.state, torch.as_tensor(core), torch.as_tensor(root))
    for a, b in zip(ref, got):
        _eq(a, b)
    oracle = _ref_sweep(pts.astype(np.float64), eps, core, root)
    for a, b in zip(oracle, got):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("chunk", [64, 2048])
def test_chunk_shapes_nothing_but_memory(chunk):
    pts = synth.load("taxi2d", 500, seed=3)
    rng = np.random.default_rng(1)
    core = torch.as_tensor(rng.uniform(size=500) < 0.5)
    root = torch.as_tensor(rng.integers(0, 500, 500).astype(np.int32))
    for engine in ("brute", "grid-hash"):
        jeng = jnb.make_engine(pts, 0.1, engine=engine, chunk=chunk)
        eng = make_engine(pts, 0.1, engine=engine, chunk=chunk, device="cpu")
        ref = jeng.sweep(jeng.state, jnp.asarray(core.numpy()),
                         jnp.asarray(root.numpy()))
        for a, b in zip(ref, eng.sweep(eng.state, core, root)):
            _eq(a, b)


def _plans(pts, eps):
    dims = jnb.infer_dims(pts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return (jgrid.plan_grid(pts, eps, dims=dims),
                tgrid.plan_grid(pts, eps, dims=dims))


@pytest.mark.parametrize("name,pts,eps", GRID_DATA, ids=GRID_IDS)
def test_hash_grid_plan_build_and_buckets_match_reference(name, pts, eps):
    ref_spec, spec = _plans(pts, eps)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    assert spec.n_offsets == ref_spec.n_offsets
    ref = jnb.build_grid_jit(jnp.asarray(pts), ref_spec)
    g = tgrid.build_grid(torch.as_tensor(pts), spec)
    for f in GRID_FIELDS:
        _eq(getattr(ref, f), getattr(g, f))
    rb, rv = jnb.neighbor_buckets_jit(jnp.asarray(pts), ref_spec)
    b, v = tgrid.neighbor_buckets(torch.as_tensor(pts), spec)
    _eq(rb, b)
    _eq(rv, v)
    # every point is placed once; no bucket repeats among a row's valid
    # slots, and every row keeps its own cell
    idx = g.index.numpy().ravel()
    assert np.array_equal(np.sort(idx[idx >= 0]), np.arange(len(pts)))
    assert np.array_equal(g.valid.numpy().ravel(), idx >= 0)
    for i in range(0, len(pts), 37):
        vals = b[i][v[i]].tolist()
        assert len(vals) == len(set(vals))
    assert v.any(dim=1).all()


def test_plan_grid_warns_on_skew_like_reference():
    pts = synth.load("skewed2d", 1500, seed=4)
    with pytest.warns(RuntimeWarning, match="skewed occupancy"):
        tgrid.plan_grid(pts, 0.05, dims=2)


def test_build_grid_drops_past_capacity_like_reference():
    # a plan from other data: buckets past the capacity drop their extra
    # points (the reference's mode="drop"), and nothing else moves
    pts = synth.load("taxi2d", 600, seed=8)
    ref_spec, spec = _plans(pts, 0.1)
    small = dataclasses.replace(ref_spec, capacity=2)
    ref = jnb.build_grid_jit(jnp.asarray(pts), small)
    g = tgrid.build_grid(torch.as_tensor(pts),
                         dataclasses.replace(spec, capacity=2))
    for f in GRID_FIELDS:
        _eq(getattr(ref, f), getattr(g, f))
    assert int(g.valid.sum()) < len(pts)


def test_hash_cells_wrap_like_uint32():
    rng = np.random.default_rng(2)
    c = rng.integers(-(1 << 20), 1 << 20, (5000, 3)).astype(np.int32)
    c[:6] = [[-1, -1, -1], [0, 0, 0], [-1, 0, 5], [2**31 - 1] * 3,
             [-2**31] * 3, [123, -456, 789]]
    for H in (64, 1 << 16, 1 << 22):
        ref = jgrid._hash_cells(c[:, 0], c[:, 1], c[:, 2], H)
        t = torch.as_tensor(c)
        got = tgrid._hash_cells(t[:, 0], t[:, 1], t[:, 2], H)
        _eq(ref, got)
        _eq(jgrid._hash_cells(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]),
                              jnp.asarray(c[:, 2]), H), got)


def test_hash_state_carry_sweeps_reference_layout():
    pts = synth.load("taxi2d", 500, seed=6)
    eps = 0.1
    jeng = jnb.make_engine(pts, eps, engine="grid-hash")
    spec = tgrid.spec_from_fields(dataclasses.asdict(jeng.meta),
                                  tgrid.GridSpec)
    assert isinstance(spec, tgrid.GridSpec)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jeng.meta)
    hash(spec)  # usable as a cache key
    g = tgrid.grid_from_arrays(
        {f: np.asarray(getattr(jeng.state.grid, f)) for f in GRID_FIELDS},
        "cpu", tgrid.Grid)
    for f in GRID_FIELDS:
        _eq(getattr(jeng.state.grid, f), getattr(g, f))
    state = tnb.GridState(
        grid=g, buckets=torch.as_tensor(np.array(jeng.state.buckets)),
        cell_valid=torch.as_tensor(np.array(jeng.state.cell_valid)),
        points=torch.as_tensor(pts),
        occupancy=g.valid.sum(dim=1, dtype=torch.int32))
    sweep = tnb._grid_sweep_fn(float(eps) ** 2, 2048)
    rng = np.random.default_rng(3)
    core = rng.uniform(size=500) < 0.5
    root = rng.integers(0, 500, 500).astype(np.int32)
    ref = jeng.sweep(jeng.state, jnp.asarray(core), jnp.asarray(root))
    for a, b in zip(ref, sweep(state, torch.as_tensor(core),
                               torch.as_tensor(root))):
        _eq(a, b)


@pytest.mark.parametrize("k_max", [8, 64])
@pytest.mark.parametrize("engine", ["grid", "grid-hash", "brute"])
def test_find_neighbors_matches_reference(engine, k_max):
    pts = synth.blobs(300, k=3, seed=9)
    eps = 0.1
    ref = jnb.find_neighbors(pts, eps, k_max=k_max, engine=engine)
    idx, cnt = find_neighbors(pts, eps, k_max, engine=engine, device="cpu")
    assert idx.shape == (300, k_max)
    _eq(ref[0], idx)
    _eq(ref[1], cnt)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    for i in range(0, 300, 23):
        expect = np.where(d2[i] <= eps * eps)[0]
        assert cnt[i] == len(expect)
        got = idx[i][idx[i] >= 0].numpy()
        assert np.array_equal(got, expect[:k_max])


@pytest.mark.parametrize("engine", ["grid", "grid-hash", "brute"])
def test_find_neighbors_exact_boundary_lattice(engine):
    # points on the 1/8 lattice: every d² is exact in f32 and many pairs
    # sit at exactly ε² = 9/64, where one rounding difference flips a hit
    rng = np.random.default_rng(7)
    pts = (rng.integers(0, 24, (400, 3)) / 8).astype(np.float32)
    eps = float(np.sqrt(9 / 64))
    assert np.float32(eps) ** 2 == np.float32(9 / 64)
    ref = jnb.find_neighbors(pts, eps, k_max=32, engine=engine)
    idx, cnt = find_neighbors(pts, eps, 32, engine=engine, device="cpu")
    _eq(ref[0], idx)
    _eq(ref[1], cnt)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    assert (d2 == np.float32(9 / 64)).any()


def test_find_neighbors_truncates_and_rejects_unported_engines():
    pts = np.zeros((40, 3), np.float32)   # everyone neighbors everyone
    idx, cnt = find_neighbors(pts, 0.1, 8, device="cpu")
    assert (cnt == 40).all()              # counts stay exact past k_max
    np.testing.assert_array_equal(
        idx.numpy(), np.tile(np.arange(8, dtype=np.int32), (40, 1)))
    # the BVH engine has no neighbor lists, as in the reference
    with pytest.raises(ValueError, match="neighbor-list"):
        find_neighbors(pts, 0.1, 8, engine="bvh", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        find_neighbors(pts, 0.1, 8, engine="octree", device="cpu")


DBSCAN_CASES = [
    ("blobs2", synth.blobs(350, k=3, seed=0), 0.08, 6),
    ("iono", synth.load("iono3d", 350, seed=4), 3.0, 10),
    ("taxi", synth.load("taxi2d", 400, seed=3), 0.12, 8),
    ("duplicates", np.concatenate([_DUPS, _DUPS, _DUPS[:40]]), 0.03, 3),
]


@pytest.mark.parametrize("hook_loop", ["device", "host"])
@pytest.mark.parametrize("engine", ["brute", "grid-hash"])
@pytest.mark.parametrize("name,pts,eps,minpts", DBSCAN_CASES,
                         ids=[c[0] for c in DBSCAN_CASES])
def test_dbscan_engine_matches_reference(name, pts, eps, minpts, engine,
                                         hook_loop):
    ref = jdbscan(pts, eps, minpts, engine=engine, hook_loop=hook_loop)
    port = dbscan(pts, eps, minpts, engine=engine, hook_loop=hook_loop,
                  device="cpu")
    for f in ("labels", "core", "counts"):
        _eq(getattr(ref, f), getattr(port, f))
    assert int(ref.n_rounds) == port.n_rounds
    grid = dbscan(pts, eps, minpts, device="cpu")
    assert torch.equal(grid.labels, port.labels)


def test_engines_on_identical_points():
    pts = np.zeros((64, 3), np.float32)
    pts[32:] += 0.5
    for engine in ("brute", "grid", "grid-hash"):
        eng = make_engine(pts, 0.1, engine=engine, device="cpu")
        cnt, _ = eng.sweep(eng.state, torch.zeros(64, dtype=torch.bool),
                           torch.arange(64, dtype=torch.int32))
        assert (cnt == 32).all(), engine


def test_grid_hash_handles_tiny_eps_dense_data():
    pts = synth.load("highway", 2000, seed=1)
    eng = make_engine(pts, 0.001, engine="grid-hash", device="cpu")
    cnt, _ = eng.sweep(eng.state, torch.zeros(2000, dtype=torch.bool),
                       torch.arange(2000, dtype=torch.int32))
    np.testing.assert_array_equal(cnt.numpy(), reference_counts(pts, 0.001))


def test_brute_baseline_is_the_references():
    pts = synth.blobs(200, k=3, seed=4)
    from repro.baselines.brute import reference_dbscan
    for a, b in zip(reference_dbscan(pts, 0.08, 5),
                    tbrute.reference_dbscan(pts, 0.08, 5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(reference_counts(pts, 0.08),
                                  tbrute.reference_counts(pts, 0.08))
