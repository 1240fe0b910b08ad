"""repro_torch's BVH engines on the CPU against the JAX reference
``repro.core.bvh`` on the same data, case by case as ``tests/test_bvh.py``:
labels, core, counts and ``n_rounds`` bit-identical on skew, exact
duplicates, n = 2, all-noise and 6-D data; the calibrated
``WavefrontSpec`` equal; the stack engine's depth guard and early stop.
Also build parity (every ``BVH`` array and ``max_leaf_depth`` equal) and
traversal parity apart from the build: the reference's tree, carried over
with ``bvh_from_arrays``, through the port's ``wavefront_sweep``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import fdbscan as jfdbscan
from repro.core import bvh as jbvh
from repro.core import neighbors as jnb
from repro.core.dbscan import dbscan as jdbscan
from repro.data import synth
from repro_torch import dbscan, make_engine
from repro_torch.baselines import fdbscan
from repro_torch.core import bvh as tbvh
from repro_torch.core import engines as tengines
from repro_torch.core import grid as tgrid

INT_MAX = np.iinfo(np.int32).max
ENGINES = ["bvh", "bvh-stack"]
# the reference's build compiled as one program, as its engines build it
# (op by op, each of its 93 search steps would compile on its own)
jbuild = jax.jit(jbvh.build_bvh, static_argnames=("dims",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: beside the other test workers on the
    same cores, torch's intra-op threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(ref, port, what=""):
    for f in ("labels", "core", "counts"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, (what, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")
    assert int(ref.n_rounds) == port.n_rounds, what


def _assert_matches_reference(pts, eps, minpts, engine, **kw):
    ref = jdbscan(pts, eps, minpts, engine=engine, **kw)
    port = dbscan(pts, eps, minpts, engine=engine, device="cpu", **kw)
    _same(ref, port, engine)
    return port


def _spec_equal(ref_spec, port_spec):
    assert dataclasses.asdict(ref_spec) == dataclasses.asdict(port_spec)


@pytest.mark.parametrize("engine", ENGINES)
def test_skewed_occupancy_matches_reference(engine):
    pts = synth.load("skewed2d", 1500, seed=4)
    _assert_matches_reference(pts, 0.05, 8, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_exact_duplicate_points(engine):
    # heavy duplication → duplicate Morton keys (index-augmented splits)
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    pts = np.concatenate([base, base, base[:40]])
    _assert_matches_reference(pts, 0.03, 3, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_n_two(engine):
    # the smallest tree: one internal node, two leaves
    pts = np.array([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0]], np.float32)
    res = _assert_matches_reference(pts, 0.1, 2, engine)
    assert res.labels.tolist() == [0, 0]
    far = np.array([[0.0, 0.0, 0.0], [9.0, 0.0, 0.0]], np.float32)
    res = _assert_matches_reference(far, 0.1, 2, engine)
    assert res.labels.tolist() == [-1, -1]
    with pytest.raises(ValueError, match="n >= 2"):
        make_engine(pts[:1], 0.1, engine=engine, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_all_noise(engine):
    pts = synth.load("highway", 300, seed=6)
    res = _assert_matches_reference(pts, 1e-4, 5, engine)
    assert (res.labels == -1).all()


def test_wavefront_capabilities():
    # the registry drives dispatch off the capabilities, never the name
    pts = synth.blobs(300, k=3, seed=0)
    wave = make_engine(pts, 0.08, engine="bvh", device="cpu")
    stack = make_engine(pts, 0.08, engine="bvh-stack", device="cpu")
    assert wave.sweep_sorted is not None
    assert wave.sweep_counts is not None
    assert wave.sweep_frontier is not None
    assert wave.neighbors is None and wave.query is None
    assert torch.equal(torch.sort(wave.order.long()).values,
                       torch.arange(300))
    assert stack.sweep_sorted is None and stack.sweep_frontier is None
    assert wave.meta.capacity % wave.meta.tile == 0
    assert {"build_s", "tree_s", "calibrate_s"} <= set(wave.timings)
    _spec_equal(jnb.make_engine(pts, 0.08, engine="bvh").meta, wave.meta)
    assert stack.meta == jnb.make_engine(pts, 0.08,
                                         engine="bvh-stack").meta
    # terminate=False keeps the exact engine but drops the frontier plan
    # (its compaction is the termination bound)
    exact = make_engine(pts, 0.08, engine="bvh", terminate=False,
                        device="cpu")
    assert exact.sweep_frontier is None
    for name, caps in (("bvh", {"sweep_sorted", "sweep_counts",
                                "sweep_frontier"}),
                       ("bvh-stack", {"early_stop"})):
        assert tengines.get_engine_spec(name).capabilities == caps


def test_wavefront_host_loop_matches_device_loop():
    pts = synth.blobs(400, k=4, seed=5)
    d = _assert_matches_reference(pts, 0.08, 5, "bvh", hook_loop="device")
    h = _assert_matches_reference(pts, 0.08, 5, "bvh", hook_loop="host")
    np.testing.assert_array_equal(d.labels.numpy(), h.labels.numpy())


def test_wavefront_spec_reuse():
    pts = synth.blobs(500, k=3, seed=9)
    eng = make_engine(pts, 0.08, engine="bvh", device="cpu")
    reused = make_engine(pts, 0.08, engine="bvh", spec=eng.meta,
                         device="cpu")
    assert reused.meta == eng.meta
    r1 = dbscan(pts, 0.08, 6, eng=reused)
    _same(jdbscan(pts, 0.08, 6, engine="bvh"), r1)
    with pytest.raises(ValueError, match="planned for"):
        make_engine(pts[:100], 0.08, engine="bvh", spec=eng.meta,
                    device="cpu")
    # same n and ε, other points: the one certifying probe overflows
    tight = dataclasses.replace(eng.meta, capacity=eng.meta.tile)
    other = synth.blobs(500, k=1, seed=3) * np.float32(0.05)
    with pytest.raises(ValueError, match="overflows"):
        make_engine(other, 0.08, engine="bvh", spec=tight, device="cpu")


def test_wavefront_overflow_flag_fires_when_capacity_too_small():
    # bypass calibration: a frontier far below the block count must raise
    # the overflow flag rather than silently dropping work; past it, the
    # flag and the level histogram are the reference's
    pts = synth.blobs(600, k=2, seed=3)
    jtree = jbuild(jnp.asarray(pts), dims=2)
    ttree = tbvh.build_bvh(torch.as_tensor(pts), dims=2)
    croot = np.full(600, INT_MAX, np.int32)
    for cap in (8, 1 << 16):
        kw = dict(eps=0.1, eps2=0.01, capacity=cap)
        r = jbvh.wavefront_sweep(jtree, jnp.asarray(pts), jnp.asarray(croot),
                                 **kw)
        p = tbvh.wavefront_sweep(ttree, torch.as_tensor(pts),
                                 torch.as_tensor(croot), **kw)
        assert bool(r[2]) == p[2] == (cap == 8)
        np.testing.assert_array_equal(np.asarray(r[3]), p[3].numpy())
        if cap > 8:
            for a, b in zip(r[:2], p[:2]):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert p[3][0] == -(-600 // 8)   # level 0 = one entry per block


def test_stack_overflow_raises_at_build():
    # a 256-leaf tree needs at least log2(256) + 2 = 10 slots; a 4-slot
    # stack must refuse to build rather than drop neighbors
    pts = synth.blobs(256, k=3, seed=7)
    with pytest.raises(RuntimeError, match="stack overflow"):
        make_engine(pts, 0.08, engine="bvh-stack", stack=4, device="cpu")
    with pytest.raises(TypeError, match="early_stop"):
        make_engine(pts, 0.08, engine="bvh", early_stop=4, device="cpu")
    with pytest.raises(TypeError, match="batch"):
        make_engine(pts, 0.08, engine="grid", batch=4, device="cpu")


def test_stack_exact_depth_bound_suffices():
    # the advertised minimum (max_leaf_depth + 1) must suffice: build with
    # exactly that many slots and stay exact
    pts = synth.blobs(256, k=3, seed=7)
    eng = make_engine(pts, 0.08, engine="bvh-stack", device="cpu")
    assert eng.meta == jnb.make_engine(pts, 0.08, engine="bvh-stack").meta
    need = eng.meta["depth"] + 1
    tight = make_engine(pts, 0.08, engine="bvh-stack", stack=need,
                        device="cpu")
    with pytest.raises(RuntimeError, match="stack overflow"):
        make_engine(pts, 0.08, engine="bvh-stack", stack=need - 1,
                    device="cpu")
    _same(jdbscan(pts, 0.08, 6, engine="brute"),
          dbscan(pts, 0.08, 6, eng=tight))


def test_fdbscan_early_stop_counts_are_clipped_exactly():
    # counting stops at minPts: the early counts are min(true, minPts), as
    # the reference's are
    pts = synth.blobs(400, k=3, seed=2)
    eps, mp = 0.08, 6
    true = np.asarray(jdbscan(pts, eps, mp, engine="brute").counts)
    jeng = jbvh.make_bvh_stack_engine(jnp.asarray(pts, jnp.float32), eps,
                                      early_stop=mp)
    r, _ = jeng.sweep(jeng.state, jnp.zeros((400,), bool),
                      jnp.arange(400, dtype=jnp.int32))
    eng = tbvh.make_bvh_stack_engine(torch.as_tensor(pts), eps,
                                     early_stop=mp)
    early, _ = eng.sweep(eng.state, torch.zeros(400, dtype=torch.bool),
                         torch.arange(400, dtype=torch.int32))
    np.testing.assert_array_equal(early.numpy(), np.minimum(true, mp))
    np.testing.assert_array_equal(early.numpy(), np.asarray(r))
    assert (true > mp).any()


def test_fdbscan_early_exit_labels_match_reference():
    pts = synth.load("skewed2d", 600, seed=8)
    ref = jfdbscan.run(pts, 0.05, 8, early_exit=True)
    port = fdbscan.run(pts, 0.05, 8, early_exit=True, device="cpu")
    _same(ref, port)
    brute = jdbscan(pts, 0.05, 8, engine="brute")
    for f in ("core", "labels"):       # counts are clipped at minPts
        np.testing.assert_array_equal(np.asarray(getattr(brute, f)),
                                      getattr(port, f).numpy())


@pytest.mark.parametrize("engine", ENGINES)
def test_dims6_parity(engine):
    # d > 3: the Morton order uses the first three coordinates, the boxes,
    # spheres and payload ranges all six
    pts = synth.blobs(500, k=4, dims=6, seed=11)
    assert pts.shape == (500, 6)
    _assert_matches_reference(pts, 0.35, 6, engine)


def test_bf16_prune_matches_f32_prune():
    # the bf16 prune admits a superset of the f32 prune's candidates and
    # the exact f32 refine decides identically: labels never differ
    for dims, eps in [(2, 0.05), (6, 0.35)]:
        pts = synth.blobs(700, k=4, dims=dims, seed=13)
        res = {}
        for dt in ("bf16", "f32"):
            eng = make_engine(pts, eps, engine="bvh", prune_dtype=dt,
                              device="cpu")
            jeng = jnb.make_engine(pts, eps, engine="bvh", prune_dtype=dt)
            _spec_equal(jeng.meta, eng.meta)
            res[dt] = dbscan(pts, eps, 6, eng=eng)
            _same(jdbscan(pts, eps, 6, eng=jeng), res[dt], dt)
        _same(jdbscan(pts, eps, 6, engine="brute"), res["bf16"], "brute")
        np.testing.assert_array_equal(res["bf16"].labels.numpy(),
                                      res["f32"].labels.numpy())
    with pytest.raises(ValueError, match="prune_dtype"):
        make_engine(pts, 0.35, engine="bvh", prune_dtype="f16",
                    device="cpu")


def test_capacity_calibrated_from_measured_peak():
    # capacity tracks the measured per-level peak (within one tile), and
    # the calibrated spec and the probe's levels are the reference's
    pts = synth.load("skewed2d", 2048, seed=0)
    eng = make_engine(pts, 0.05, engine="bvh", device="cpu")
    jeng = jnb.make_engine(pts, 0.05, engine="bvh")
    _spec_equal(jeng.meta, eng.meta)
    spec = eng.meta
    assert spec.peak >= spec.tile
    assert spec.peak <= spec.capacity <= spec.peak + spec.tile - 1
    levels = tbvh.wavefront_levels(eng)
    np.testing.assert_array_equal(jbvh.wavefront_levels(jeng), levels)
    assert levels.max() == spec.peak
    assert levels[0] == -(-2048 // spec.batch)
    # a second build over the same data reuses the cached spec
    assert make_engine(pts, 0.05, engine="bvh", device="cpu").meta == spec
    with pytest.raises(ValueError, match="bvh"):
        tbvh.wavefront_levels(make_engine(pts, 0.05, device="cpu"))


def test_termination_returns_exactly_clipped_minroot():
    # with a per-query bound the returned minroot is exactly
    # min(exact minroot, bound); the exact sweep equals the reference's
    rng = np.random.default_rng(17)
    pts = synth.blobs(800, k=5, seed=17)
    n = 800
    croot = np.where(rng.uniform(size=n) < 0.6, rng.integers(0, n, n),
                     INT_MAX).astype(np.int32)
    bound = rng.integers(0, n, n).astype(np.int32)
    kw = dict(eps=0.05, eps2=0.05 ** 2, capacity=1 << 14)
    jtree = jbuild(jnp.asarray(pts), dims=2)
    ttree = tbvh.build_bvh(torch.as_tensor(pts), dims=2)
    _, r_exact, _, _ = jbvh.wavefront_sweep(jtree, jtree.pts_sorted,
                                            jnp.asarray(croot), **kw)
    c, m_exact, ovf, _ = tbvh.wavefront_sweep(ttree, ttree.pts_sorted,
                                              torch.as_tensor(croot), **kw)
    assert not ovf
    np.testing.assert_array_equal(np.asarray(r_exact), m_exact.numpy())
    _, m_term, _, _ = tbvh.wavefront_sweep(
        ttree, ttree.pts_sorted, torch.as_tensor(croot),
        bound=torch.as_tensor(bound), **kw)
    np.testing.assert_array_equal(
        m_term.numpy(), np.minimum(m_exact.numpy(), bound))


def test_frontier_driver_matches_device_driver():
    # hook_loop="frontier": labels and round count of the device driver,
    # the per-round live-block histogram of the reference
    pts = synth.load("skewed2d", 1500, seed=4)
    d = _assert_matches_reference(pts, 0.05, 8, "bvh", hook_loop="device")
    ref = jdbscan(pts, 0.05, 8, engine="bvh", hook_loop="frontier")
    f = dbscan(pts, 0.05, 8, engine="bvh", hook_loop="frontier",
               device="cpu")
    _same(ref, f)
    np.testing.assert_array_equal(np.asarray(ref.frontier_tiles),
                                  f.frontier_tiles.numpy())
    np.testing.assert_array_equal(d.labels.numpy(), f.labels.numpy())
    eng = make_engine(pts, 0.05, engine="bvh", device="cpu")
    live = f.frontier_tiles[:f.n_rounds]
    assert (live >= 0).all() and live.max() <= eng.sweep_frontier.n_tiles
    assert (f.frontier_tiles[f.n_rounds:] == -1).all()


def test_terminate_false_has_no_frontier_plan_and_falls_back():
    pts = synth.blobs(300, k=3, seed=1)
    eng = make_engine(pts, 0.08, engine="bvh", terminate=False,
                      device="cpu")
    assert eng.sweep_frontier is None and not eng.meta.terminate
    jeng = jnb.make_engine(pts, 0.08, engine="bvh", terminate=False)
    res = dbscan(pts, 0.08, 5, eng=eng, hook_loop="frontier")
    ref = jdbscan(pts, 0.08, 5, eng=jeng, hook_loop="frontier")
    _same(ref, res)
    assert res.frontier_tiles is None and ref.frontier_tiles is None


def _build_cases():
    rng = np.random.default_rng(21)
    base = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    dup2 = np.concatenate([base, base, base[:7]]) * [1, 1, 0]
    return [
        ("2d-roadnet", synth.load("roadnet2d", 700, seed=1), 2),
        ("2d-dups", dup2.astype(np.float32), 2),
        ("3d-blobs", synth.blobs(513, k=4, dims=3, seed=2), 3),
        ("3d-dups", np.concatenate([base, base]), 3),
        ("6d-blobs", synth.blobs(300, k=3, dims=6, seed=3), 6),
        ("n2", np.array([[0, 0, 0], [1, 1, 1]], np.float32), 3),
        ("n3-same", np.zeros((3, 3), np.float32), 3),
    ]


@pytest.mark.parametrize("name,pts,dims", _build_cases(),
                         ids=[c[0] for c in _build_cases()])
def test_build_matches_reference(name, pts, dims):
    r = jbuild(jnp.asarray(pts), dims=dims)
    p = tbvh.build_bvh(torch.as_tensor(pts), dims=dims)
    for f in tbvh.BVH._fields:
        a, b = np.asarray(getattr(r, f)), getattr(p, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f)
    assert int(jbvh.max_leaf_depth(r.left, r.right)) == \
        tbvh.max_leaf_depth(p.left, p.right)
    # the quantization-extent overrides, as the distributed driver passes
    lo, hi = pts.min(0) - 1, pts.max(0) + 2
    r = jbuild(jnp.asarray(pts), dims=dims, lo=jnp.asarray(lo),
                       hi=jnp.asarray(hi))
    p = tbvh.build_bvh(torch.as_tensor(pts), dims=dims, lo=lo, hi=hi)
    np.testing.assert_array_equal(np.asarray(r.order), p.order.numpy())
    np.testing.assert_array_equal(np.asarray(r.left), p.left.numpy())


@pytest.mark.parametrize("bf16", [True, False])
def test_reference_tree_through_port_traversal(bf16):
    # traversal parity apart from build parity: the reference's tree and
    # queries through both traversals, exact mode
    pts = synth.load("taxi2d", 900, seed=5)
    jtree = jbuild(jnp.asarray(pts), dims=2)
    ttree = tbvh.bvh_from_arrays(
        {f: np.asarray(getattr(jtree, f)) for f in jtree._fields}, "cpu")
    rng = np.random.default_rng(2)
    croot = np.where(rng.uniform(size=900) < 0.7, rng.integers(0, 900, 900),
                     INT_MAX).astype(np.int32)
    kw = dict(eps=0.12, eps2=0.12 ** 2, capacity=4096, tile=512,
              prune_dtype="bf16" if bf16 else "f32")
    r = jbvh.wavefront_sweep(jtree, jtree.pts_sorted, jnp.asarray(croot),
                             **kw)
    p = tbvh.wavefront_sweep(ttree, ttree.pts_sorted,
                             torch.as_tensor(croot), **kw)
    for a, b in zip((r[0], r[1], r[3]), (p[0], p[1], p[3])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert bool(r[2]) == p[2]
    assert (p[3] > 0).sum() > 5
    # the spec carries over as a plain dict of its fields
    spec = jnb.make_engine(pts, 0.12, engine="bvh").meta
    assert tgrid.spec_from_fields(dataclasses.asdict(spec),
                                  kind=tbvh.WavefrontSpec) == \
        tbvh.WavefrontSpec(**dataclasses.asdict(spec))


def test_registry_knows_every_engine():
    pts = synth.blobs(64, k=2, seed=0)
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine(pts, 0.1, engine="octree", device="cpu")
    assert tengines.available_engines() == (
        "brute", "bvh", "bvh-stack", "grid", "grid-hash")


def test_level_split_into_launches_changes_nothing(monkeypatch):
    # a level expanded in several launches (the memory cap, here a tile a
    # launch) gives the reference's exact sweep, overflow drop included,
    # and the same clipped minroot under termination
    pts = synth.load("skewed2d", 1500, seed=4)
    rng = np.random.default_rng(3)
    croot = np.where(rng.uniform(size=1500) < 0.5,
                     rng.integers(0, 1500, 1500), INT_MAX).astype(np.int32)
    bound = rng.integers(0, 1500, 1500).astype(np.int32)
    jtree = jbuild(jnp.asarray(pts), dims=2)
    ttree = tbvh.build_bvh(torch.as_tensor(pts), dims=2)
    for cap in (1 << 14, 3072):           # the second overflows
        kw = dict(eps=0.05, eps2=0.05 ** 2, capacity=cap, tile=512)
        r = jbvh.wavefront_sweep(jtree, jtree.pts_sorted, jnp.asarray(croot),
                                 **kw)
        outs = []
        for entries in (tbvh._LEVEL_ENTRIES, 512):
            monkeypatch.setattr(tbvh, "_LEVEL_ENTRIES", entries)
            exact = tbvh.wavefront_sweep(ttree, ttree.pts_sorted,
                                         torch.as_tensor(croot), **kw)
            for a, b in zip((r[0], r[1], r[3]), (exact[0], exact[1],
                                                 exact[3])):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert exact[2] == bool(r[2]) == (cap == 3072)
            outs.append(tbvh.wavefront_sweep(
                ttree, ttree.pts_sorted, torch.as_tensor(croot),
                bound=torch.as_tensor(bound), **kw)[1])
        if cap > 3072:
            np.testing.assert_array_equal(
                outs[1].numpy(), np.minimum(np.asarray(r[1]), bound))
        np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
