"""repro_torch's FDBSCAN baseline (``baselines.fdbscan``, on the
``bvh-stack`` engine) on the CPU against the JAX reference's
``repro.baselines.fdbscan.run`` on ``tests/test_baselines.py``'s data:
labels, core, counts and ``n_rounds`` bit-identical, with and without the
early traversal exit; and equivalent to the sequential Algorithm 1."""
import numpy as np
import pytest
import torch

from repro.baselines import fdbscan as jfdbscan
from repro.data import synth
from repro_torch.baselines import fdbscan
from repro_torch.baselines.brute import reference_dbscan
from repro_torch.core import labels as L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: beside the other test workers on the
    same cores, torch's intra-op threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["fdbscan", "fdbscan-early-exit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fdbscan_matches_reference(early_exit, seed):
    pts = synth.blobs(320, k=3, seed=seed)
    eps, minpts = 0.08, 6
    ref = jfdbscan.run(pts, eps, minpts, early_exit=early_exit)
    res = fdbscan.run(pts, eps, minpts, early_exit=early_exit, device="cpu")
    for f in ("labels", "core", "counts"):
        a, b = np.asarray(getattr(ref, f)), getattr(res, f).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(ref.n_rounds) == res.n_rounds
    ref_labels, ref_core = reference_dbscan(pts, eps, minpts)
    assert np.array_equal(res.core.numpy(), ref_core)
    assert L.equivalent(res.labels.numpy(), ref_labels, ref_core,
                        points=pts, eps=eps)
    if early_exit:                       # stage-1 counts clip at minPts
        assert res.counts.max() == minpts


def test_fdbscan_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = synth.blobs(40, k=2, seed=0)
    for early_exit in (False, True):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fdbscan.run(pts, 0.08, 4, early_exit=early_exit)
