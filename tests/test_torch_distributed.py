"""repro_torch's distributed DBSCAN (``distributed/dbscan_dist.py``) on the
CPU against the JAX reference's ``dbscan_distributed``.

The reference runs once per module, in one subprocess with 8 fake host
devices (meshes of the first 4 and of all 8), as ``tests/test_distributed.py``
runs it; its outputs go through an ``.npz``. The port runs every case
through a :class:`ThreadGroup` (D threads on the CPU) and the D = 4 cases
also through 4 gloo processes (one torch thread each, all cases in one
group). Labels, core and ``n_rounds`` must be bit-identical to the
reference's: the labels are global ids, so they do not depend on the local
engine. The cases: blobs 4,096 (seed 11) at D = 8 and 2,048 at D = 4 on the
``csr``, ``bvh`` and ``brute`` local engines; the ``highway`` ε = 1e-4
all-noise case; regrows forced by ``send_factor``, ``csr_slab=512`` and
``bvh_frontier_factor=0.25``. The port's ``grid`` engine is held to the
reference's ``csr`` run, not to its ``grid`` run, whose counts can exceed
the true ones (ROADMAP §3): on roadnet2d 4,000 at D = 4 the reference's
grid run makes one point more core than its csr run and than the
single-device ``dbscan``. The partition also equals the single-device
port ``dbscan``'s. The reference's driver cannot run on one device (an
IndexError on its empty cut vector); the port's can.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.dbscan import dbscan
from repro_torch.data import synth
from repro_torch.distributed import comm
from repro_torch.distributed.dbscan_dist import DistConfig, dbscan_distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# key: (dataset, n, seed, eps, minPts, D, DistConfig fields)
CASES = {
    "b4096_d8_csr": ("blobs", 4096, 11, 0.07, 6, 8, {"local_engine": "csr"}),
    "b4096_d8_bvh": ("blobs", 4096, 11, 0.07, 6, 8, {"local_engine": "bvh"}),
    "b4096_d8_brute": ("blobs", 4096, 11, 0.07, 6, 8,
                       {"local_engine": "brute"}),
    "b2048_d4_csr": ("blobs", 2048, 11, 0.07, 6, 4, {"local_engine": "csr"}),
    "b2048_d4_bvh": ("blobs", 2048, 11, 0.07, 6, 4, {"local_engine": "bvh"}),
    "b2048_d4_brute": ("blobs", 2048, 11, 0.07, 6, 4,
                       {"local_engine": "brute"}),
    "hw_d8_csr": ("highway", 2048, 1, 1e-4, 5, 8, {"local_engine": "csr"}),
    "hw_d4_csr": ("highway", 2048, 1, 1e-4, 5, 4, {"local_engine": "csr"}),
    "rn_d4_csr": ("roadnet2d", 4000, 0, 0.02, 8, 4, {"local_engine": "csr"}),
    "rn_d4_grid": ("roadnet2d", 4000, 0, 0.02, 8, 4, {}),
    "regrow_send": ("blobs", 2048, 11, 0.07, 6, 4,
                    {"local_engine": "csr", "send_factor": 1.0}),
    "regrow_slab": ("blobs", 2048, 11, 0.07, 6, 4,
                    {"local_engine": "csr", "csr_slab": 512}),
    "regrow_bvh": ("blobs", 2048, 11, 0.07, 6, 4,
                   {"local_engine": "bvh", "bvh_frontier_factor": 0.25}),
}
# the port's runs: (case, the reference run it is held to)
THREAD_RUNS = [(k, k) for k in CASES if k != "rn_d4_grid"] + [
    ("rn_d4_grid", "rn_d4_csr"),
    ("hw_d8_grid", "hw_d8_csr"),
    ("hw_d4_grid", "hw_d4_csr")]


def _base(key):
    """The case of a port run (``*_grid``: its csr case, engine unset)."""
    return key if key in CASES else key.replace("_grid", "_csr")


GLOO_RUNS = [(k, r) for k, r in THREAD_RUNS if CASES[_base(k)][5] == 4]


def _case(key):
    """(points, eps, minPts, D, DistConfig) of a port run."""
    name, n, seed, eps, min_pts, D, kw = CASES[_base(key)]
    if key.endswith("_grid"):
        kw = {k: v for k, v in kw.items() if k != "local_engine"}
    pts = synth.blobs(n, k=5, seed=seed) if name == "blobs" \
        else synth.load(name, n, seed=seed)
    return pts, eps, min_pts, D, DistConfig(**kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs of every case, from one subprocess."""
    out = tmp_path_factory.mktemp("dist") / "ref.npz"
    script = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, {ROOT + "/src"!r})
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.data import synth
    from repro.distributed.dbscan_dist import DistConfig, dbscan_distributed
    cases = {CASES!r}
    res = {{}}
    for key, (name, n, seed, eps, min_pts, D, kw) in cases.items():
        pts = synth.blobs(n, k=5, seed=seed) if name == "blobs" \\
            else synth.load(name, n, seed=seed)
        mesh = Mesh(np.array(jax.devices()[:D]), ("data",))
        d = dbscan_distributed(pts, eps, min_pts, mesh, cfg=DistConfig(**kw))
        res[key + "/labels"] = np.asarray(d.labels)
        res[key + "/core"] = np.asarray(d.core)
        res[key + "/rounds"] = np.asarray(d.n_rounds)
    try:
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        dbscan_distributed(synth.blobs(64, k=2, seed=0), 0.1, 4, mesh)
        res["one_device_error"] = np.asarray("")
    except IndexError as e:
        res["one_device_error"] = np.asarray(str(e))
    np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port_run(group, key):
    pts, eps, min_pts, _, cfg = _case(key)
    d = dbscan_distributed(pts, eps, min_pts, group, cfg=cfg)
    return (d.labels.numpy(), d.core.numpy(), d.n_rounds,
            d.timings["regrows"])


def _gloo_runs(group, keys):
    """Every key's run on this rank of a 4-process gloo group."""
    return {k: _port_run(group, k) for k in keys}


@pytest.fixture(scope="module")
def gloo():
    return comm.spawn(4, _gloo_runs, [k for k, _ in GLOO_RUNS],
                      device="cpu", threads=1, timeout=900)


def _same(got, ref, rkey):
    labels, core, rounds = got[:3]
    np.testing.assert_array_equal(labels, ref[rkey + "/labels"])
    np.testing.assert_array_equal(core, ref[rkey + "/core"])
    assert rounds == int(ref[rkey + "/rounds"])
    assert labels.dtype == np.int32 and core.dtype == bool


@pytest.mark.parametrize("key,rkey", THREAD_RUNS,
                         ids=[k for k, _ in THREAD_RUNS])
def test_thread_group_matches_reference(ref, key, rkey):
    _, _, _, D, _ = _case(key)
    _same(_port_run(comm.ThreadGroup(D, "cpu"), key), ref, rkey)


@pytest.mark.parametrize("key,rkey", GLOO_RUNS, ids=[k for k, _ in GLOO_RUNS])
def test_gloo_processes_match_reference(ref, gloo, key, rkey):
    _same(gloo[key], ref, rkey)


def test_regrows_were_forced(gloo):
    assert {k: gloo[k][3] > 0 for k in
            ("regrow_send", "regrow_slab", "regrow_bvh")} == \
        dict.fromkeys(("regrow_send", "regrow_slab", "regrow_bvh"), True)
    assert gloo["b2048_d4_csr"][3] == 0


def test_reference_grid_run_double_counts(ref):
    """The reference's own grid run differs from its csr run and from the
    single-device answer on this input: one point too many is core."""
    pts, eps, min_pts, _, _ = _case("rn_d4_csr")
    single = dbscan(pts, eps, min_pts, device="cpu")
    assert (ref["rn_d4_csr/core"] == single.core.numpy()).all()
    assert ref["rn_d4_grid/core"].sum() == single.core.numpy().sum() + 1


def _canon(x):
    out = np.full(len(x), -1)
    m = {}
    for i, v in enumerate(x):
        if v != -1:
            out[i] = m.setdefault(v, len(m))
    return out


@pytest.mark.parametrize("key", ["b4096_d8_csr", "rn_d4_grid",
                                 "hw_d8_grid"])
def test_partition_equals_single_device_dbscan(key):
    pts, eps, min_pts, D, cfg = _case(key)
    d = dbscan_distributed(pts, eps, min_pts, comm.ThreadGroup(D, "cpu"),
                           cfg=cfg)
    s = dbscan(pts, eps, min_pts, device="cpu")
    core = s.core.numpy()
    np.testing.assert_array_equal(d.core.numpy(), core)
    la, lb = _canon(d.labels.numpy()), _canon(s.labels.numpy())
    np.testing.assert_array_equal(la == -1, lb == -1)
    np.testing.assert_array_equal(la[core], lb[core])
    # every label is the least global id of a core point of its cluster
    lab = d.labels.numpy()
    for v in np.unique(lab[core]):
        assert v == np.flatnonzero((lab == v) & core)[0]


def test_one_rank_runs_where_the_reference_cannot(ref):
    assert "out of bounds" in str(ref["one_device_error"])
    pts, eps, min_pts, _, cfg = _case("b2048_d4_csr")
    one = dbscan_distributed(pts, eps, min_pts, device="cpu", cfg=cfg)
    np.testing.assert_array_equal(one.labels.numpy(),
                                  ref["b2048_d4_csr/labels"])
    np.testing.assert_array_equal(one.core.numpy(), ref["b2048_d4_csr/core"])
    assert set(one.timings) >= {"cuts", "all_to_all", "halo", "local_build",
                                "stage1", "components", "label_rounds",
                                "border", "return", "local_rounds", "sent",
                                "regrows", "attempts_s"}
    assert len(one.timings["attempts_s"]) == one.timings["regrows"] + 1
    assert one.counts.numpy().tolist() == [0] * len(pts)


def test_entry_point_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = synth.blobs(64, k=2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dbscan_distributed(pts, 0.1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.ThreadGroup(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.spawn(2, _gloo_runs, [])
    with pytest.raises(ValueError, match="divisible"):
        dbscan_distributed(pts[:63], 0.1, 4, comm.ThreadGroup(4, "cpu"))


def test_more_cuda_ranks_than_cards_names_the_thread_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="ThreadGroup"):
        comm.ProcessGroup(0, 4, comm.free_address(), "cuda")


def _fail_on_rank_2(c):
    if c.axis_index() == 2:
        raise ValueError("rank 2 failed")
    return c.psum(torch.ones(1))


def test_a_failing_thread_rank_ends_the_group():
    with pytest.raises(ValueError, match="rank 2 failed"):
        comm.ThreadGroup(4, "cpu").run(_fail_on_rank_2)
    g = comm.ThreadGroup(3, "cpu")
    assert [int(x) for x in g.run(lambda c: c.psum(torch.ones(1)))] == \
        [3, 3, 3]


def _collectives(c):
    r, D = c.axis_index(), c.axis_size()
    x = torch.arange(4 * D, dtype=torch.int32) + 100 * r
    return (c.psum(torch.tensor([r], dtype=torch.int32)),
            c.pmin(torch.tensor([float(r)])), c.pmax(torch.tensor([float(r)])),
            c.all_to_all(x), c.ppermute(x[:2], 1), c.ppermute(x[:2] > 100, -1),
            dict(c.sent))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_thread_collectives_follow_the_references_conventions(D):
    outs = comm.ThreadGroup(D, "cpu").run(_collectives)
    for r, (s, lo, hi, a2a, right, left, sent) in enumerate(outs):
        assert int(s) == D * (D - 1) // 2
        assert float(lo) == 0 and float(hi) == D - 1
        # chunk r of every source, in source order (tiled all_to_all)
        want = torch.cat([torch.arange(4 * r, 4 * r + 4) + 100 * s
                          for s in range(D)]).to(torch.int32)
        assert torch.equal(a2a, want)
        # +1: from rank r - 1; -1: from rank r + 1 (wrapping)
        assert torch.equal(right, torch.arange(2, dtype=torch.int32)
                           + 100 * ((r - 1) % D))
        assert torch.equal(left, torch.arange(2) + 100 * ((r + 1) % D) > 100)
        assert sent["all_to_all"] == 16 * D and sent["ppermute"] == 8 + 2
