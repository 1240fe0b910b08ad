"""repro_torch's G-DBSCAN and DClust baselines on the CPU, mirroring the
rest of tests/test_baselines.py (equivalence to the sequential Algorithm
1, G-DBSCAN's O(n²) guard, DClust's extra rounds on chains) and held to
the JAX reference's ``repro.baselines.gdbscan.run`` and
``repro.baselines.dclust.run`` on the same data: labels, core, counts and
``n_rounds`` bit-identical."""
import numpy as np
import pytest
import torch

from repro.baselines import dclust as jdclust
from repro.baselines import gdbscan as jgdbscan
from repro.data import synth
from repro_torch.baselines import dclust, gdbscan
from repro_torch.baselines.brute import reference_dbscan
from repro_torch.baselines.gdbscan import GDBSCANMemoryError
from repro_torch.core import labels as L
from repro_torch.core.dbscan import dbscan

SYSTEMS = {"gdbscan": (gdbscan, jgdbscan), "dclust": (dclust, jdclust)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps them fast
    beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_result(res, ref):
    for f in ("labels", "core", "counts"):
        a, b = np.asarray(getattr(ref, f)), getattr(res, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert res.n_rounds == int(ref.n_rounds)


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_baseline_equivalence(system, seed):
    """tests/test_baselines.py's test for these two systems, plus the
    reference's result bitwise."""
    mod, jmod = SYSTEMS[system]
    pts = synth.blobs(320, k=3, seed=seed)
    eps, minpts = 0.08, 6
    ref_labels, ref_core = reference_dbscan(pts, eps, minpts)
    res = mod.run(pts, eps, minpts, device="cpu")
    assert np.array_equal(res.core.numpy(), ref_core)
    assert L.equivalent(res.labels.numpy(), ref_labels, ref_core,
                        points=pts, eps=eps)
    _same_result(res, jmod.run(pts, eps, minpts))


def test_gdbscan_oom_guard():
    pts = np.zeros((200, 3), np.float32)
    with pytest.raises(GDBSCANMemoryError):
        gdbscan.run(pts, 0.1, 5, max_n=100, device="cpu")
    assert issubclass(GDBSCANMemoryError, MemoryError)
    # the default guard is the reference's: 100,000 points
    with pytest.raises(GDBSCANMemoryError, match="max_n=100000"):
        gdbscan.run(np.zeros((100_001, 3), np.float32), 0.1, 5,
                    device="cpu")


def test_dclust_needs_more_rounds_on_chains():
    pts = synth.load("roadnet2d", 600, seed=3)
    eps, minpts = 0.03, 3
    rt = dbscan(pts, eps, minpts, engine="grid", device="cpu")
    dc = dclust.run(pts, eps, minpts, device="cpu")
    assert dc.n_rounds >= rt.n_rounds
    _same_result(dc, jdclust.run(pts, eps, minpts))


@pytest.mark.parametrize("row_chunk", [1, 64, 1024])
def test_gdbscan_row_chunks_and_boundary_pairs(row_chunk):
    """Row chunks that do and do not divide n, and pairs at exactly
    d² = ε² (and the float below): the adjacency's d² is the reference's
    unfused sum, so hits at the boundary agree."""
    eps = 0.375                       # ε² = 9/64 exactly in f32
    x = np.arange(37, dtype=np.float32) * np.float32(eps)
    pts = np.zeros((37, 3), np.float32)
    pts[:, 0] = x
    pts[::3, 1] = np.float32(1e-7)    # a few pairs just past ε
    res = gdbscan.run(pts, eps, 3, row_chunk=row_chunk, device="cpu")
    _same_result(res, jgdbscan.run(pts, eps, 3, row_chunk=row_chunk))
    assert (res.counts.numpy() >= 2).any()


def test_baselines_run_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = synth.blobs(40, k=2, seed=0)
    for mod in (gdbscan, dclust):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.run(pts, 0.08, 4)
