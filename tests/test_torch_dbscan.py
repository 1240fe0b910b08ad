"""repro_torch ``dbscan`` on the CPU against the JAX reference
``repro.core.dbscan.dbscan`` on the same data: ``labels``, ``core``,
``counts`` and ``n_rounds`` must be bit-identical, for the round drivers
``hook_loop="device"`` and ``"host"`` (the frontier driver has its own
file, ``test_torch_frontier.py``)."""
import numpy as np
import pytest

from repro.core import neighbors as jnb
from repro.core.dbscan import dbscan as jdbscan
from repro.data import synth
from repro_torch import dbscan, make_engine
from repro_torch import synth as tsynth
from repro_torch.core import labels as tlabels
from repro_torch.kernels import csr_sweep as tcsr

CASES = [
    ("blobs2", synth.blobs(350, k=3, seed=0), 0.08, 6),
    ("blobs3d", synth.blobs(300, k=4, dims=3, seed=1), 0.12, 5),
    ("roadnet", synth.load("roadnet2d", 400, seed=2), 0.03, 4),
    ("taxi", synth.load("taxi2d", 400, seed=3), 0.12, 8),
    ("iono", synth.load("iono3d", 350, seed=4), 3.0, 10),
    ("dense-empty", synth.load("highway", 300, seed=5), 0.001, 5),
    ("n1", synth.blobs(1, k=1, seed=11), 0.08, 1),
    ("n2", np.asarray([[0, 0, 0], [0.05, 0, 0]], np.float32), 0.08, 2),
    ("all-noise", synth.load("highway", 200, seed=6), 1e-4, 5),
    ("skewed2d", synth.load("skewed2d", 1500, seed=4), 0.05, 8),
]
IDS = [c[0] for c in CASES]


def _assert_same(ref, port):
    for f in ("labels", "core", "counts"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(ref.n_rounds) == port.n_rounds


@pytest.mark.parametrize("hook_loop", ["device", "host"])
@pytest.mark.parametrize("name,pts,eps,minpts", CASES, ids=IDS)
def test_dbscan_matches_reference(name, pts, eps, minpts, hook_loop):
    ref = jdbscan(pts, eps, minpts, hook_loop=hook_loop)
    port = dbscan(pts, eps, minpts, hook_loop=hook_loop, device="cpu")
    _assert_same(ref, port)
    # the grid's counts-only sweep, which the sorted drivers take, also
    # reports the pairs it kept
    kept = {"stage1_kept_pairs"} if hook_loop == "device" else set()
    assert set(port.timings) == {"stage1_s", "stage2_s", "border_s"} | kept


def test_datasets_are_the_references():
    for name in ("roadnet2d", "taxi2d", "highway", "iono3d", "skewed2d"):
        np.testing.assert_array_equal(tsynth.load(name, 500, seed=1),
                                      synth.load(name, 500, seed=1))
    np.testing.assert_array_equal(tsynth.blobs(300, k=4, dims=3, seed=2),
                                  synth.blobs(300, k=4, dims=3, seed=2))


def test_precomputed_counts_reuse():
    # the paper's §VI-B re-run: saved counts skip stage 1
    pts = synth.blobs(300, k=3, seed=7)
    r1 = dbscan(pts, 0.08, 6, device="cpu")
    r2 = dbscan(pts, 0.08, 12, device="cpu", precomputed_counts=r1.counts)
    ref = jdbscan(pts, 0.08, 12,
                  precomputed_counts=jdbscan(pts, 0.08, 6).counts)
    _assert_same(ref, r2)
    direct = dbscan(pts, 0.08, 12, device="cpu")
    np.testing.assert_array_equal(r2.labels.numpy(), direct.labels.numpy())


@pytest.mark.parametrize("hook_loop", ["device", "host"])
def test_engine_reuse_across_minpts(hook_loop):
    pts = synth.blobs(300, k=3, seed=8)
    eng = make_engine(pts, 0.08, device="cpu")
    jeng = jnb.make_engine(pts, 0.08, engine="grid")
    assert eng.name == "grid" and eng.meta.n == 300
    assert set(eng.timings) == {"plan_s", "build_s"}
    for mp in (4, 8, 16):
        a = dbscan(pts, 0.08, mp, eng=eng, hook_loop=hook_loop)
        _assert_same(jdbscan(pts, 0.08, mp, eng=jeng, hook_loop=hook_loop), a)


def test_sorted_stage1_without_counts_capability():
    # an engine without sweep_counts takes stage 1 through sweep_sorted
    pts = synth.load("taxi2d", 400, seed=3)
    eng = make_engine(pts, 0.12, device="cpu")
    a = dbscan(pts, 0.12, 8, eng=eng._replace(sweep_counts=None))
    _assert_same(jdbscan(pts, 0.12, 8), a)


def test_cpu_run_launches_no_kernel():
    tcsr.reset_launches()
    res = dbscan(synth.load("taxi2d", 400, seed=3), 0.12, 8, device="cpu")
    assert tcsr.LAUNCHES == {"csr_sweep": 0, "csr_sweep_counts": 0}
    assert len(tlabels.cluster_sizes(res.labels.numpy())) > 0


def test_frontier_and_unknown_options_raise():
    # hook_loop="frontier" is ported: it matches the reference, histogram
    # included; unknown options and unknown engines raise, and the BVH
    # engines, ported since, build
    pts = synth.blobs(100, k=2, seed=1)
    ref = jdbscan(pts, 0.08, 5, hook_loop="frontier")
    port = dbscan(pts, 0.08, 5, hook_loop="frontier", device="cpu")
    _assert_same(ref, port)
    np.testing.assert_array_equal(np.asarray(ref.frontier_tiles),
                                  port.frontier_tiles.numpy())
    with pytest.raises(ValueError, match="unknown hook_loop"):
        dbscan(pts, 0.08, 5, hook_loop="fronteer", device="cpu")
    with pytest.raises(ValueError, match="unknown engine.*grid"):
        make_engine(pts, 0.08, engine="nope", device="cpu")
    for name in ("bvh", "bvh-stack"):
        assert make_engine(pts, 0.08, engine=name, device="cpu").name == name
