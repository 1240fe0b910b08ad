"""repro_torch ``dbscan`` on the BVH engines on the CPU against the JAX
reference on ``tests/test_torch_dbscan.py``'s cases: ``engine="bvh"`` with
the round drivers ``device``, ``frontier`` and ``host``, and
``engine="bvh-stack"``. ``labels``, ``core``, ``counts`` and ``n_rounds``
must be bit-identical, and so must the frontier driver's
``frontier_tiles``."""
import numpy as np
import pytest
import torch

from repro.core.dbscan import dbscan as jdbscan
from repro_torch import dbscan
from repro_torch.kernels import bvh_sweep as tsweep
from repro_torch.kernels import morton as tmorton
from test_torch_dbscan import CASES, IDS

PATHS = [("bvh", "device"), ("bvh", "frontier"), ("bvh", "host"),
         ("bvh-stack", "device")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: beside the other test workers on the
    same cores, torch's intra-op threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("engine,hook_loop", PATHS,
                         ids=[f"{e}-{h}" for e, h in PATHS])
@pytest.mark.parametrize("name,pts,eps,minpts", CASES, ids=IDS)
def test_bvh_dbscan_matches_reference(name, pts, eps, minpts, engine,
                                      hook_loop):
    kw = dict(engine=engine, hook_loop=hook_loop)
    if len(pts) < 2:       # a BVH needs two leaves, in both packages
        with pytest.raises(ValueError, match="n >= 2"):
            jdbscan(pts, eps, minpts, **kw)
        with pytest.raises(ValueError, match="n >= 2"):
            dbscan(pts, eps, minpts, device="cpu", **kw)
        return
    ref = jdbscan(pts, eps, minpts, **kw)
    port = dbscan(pts, eps, minpts, device="cpu", **kw)
    for f in ("labels", "core", "counts"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(ref.n_rounds) == port.n_rounds
    if ref.frontier_tiles is None:
        assert port.frontier_tiles is None
    else:
        np.testing.assert_array_equal(np.asarray(ref.frontier_tiles),
                                      port.frontier_tiles.numpy())
    assert set(port.timings) == {"stage1_s", "stage2_s", "border_s"}


def test_cpu_run_launches_no_bvh_kernel():
    tsweep.reset_launches()
    tmorton.reset_launches()
    pts = CASES[0][1]
    for engine in ("bvh", "bvh-stack"):
        dbscan(pts, 0.08, 6, engine=engine, device="cpu")
    assert tsweep.LAUNCHES == {"bvh_batch_sweep": 0, "bvh_level": 0}
    assert tmorton.LAUNCHES == {"morton_encode": 0}
