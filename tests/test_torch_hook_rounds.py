"""Stage 2's one hooking loop and the CSR layouts' one cell-code step.

``core.dbscan.hook_rounds`` is the hooking loop of the three batch
drivers, of the serving tier's ingest and of each distributed rank. Given a
stub brute sweep (the min core-neighbor root over a fixed adjacency, the
same on both sides, so no float arithmetic is compared), its forest and
round count equal the reference's ``_device_loop_fn`` on the same sweep,
under a round cap that binds and one that does not. Patching
``core.dbscan._hook_step`` to a step that hooks nothing stops every one of
those callers after one round: the loop looks the step up when it runs.

``core.grid.cell_codes`` is the one step from points to cells to Morton
codes: a plan, an ``assign``, the distributed CSR engine and the tier's
routing each call it once. A shard of the tier is planned and built in one
layout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbscan as jdb
from repro.core.union_find import pointer_jump as jpointer_jump
from repro_torch import dbscan, make_engine, serve, trace
from repro_torch.core import dbscan as dbscan_mod
from repro_torch.core import grid
from repro_torch.data import synth
from repro_torch.distributed import dbscan_dist as tdd
from repro_torch.serve import shard

INT_MAX = np.iinfo(np.int32).max
EPS, MIN_PTS = 0.05, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adjacency(seed: int, n: int = 1500):
    """(points, ε-adjacency (n, n) bool, core (n,) bool) of a roadnet2d
    sample, d² in float64 on the host."""
    pts = synth.load("roadnet2d", n, seed=seed)
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2
          ).sum(-1)
    adj = d2 <= EPS * EPS
    return pts, adj, adj.sum(1) >= MIN_PTS


def _ref_sweep(adj, core, root):
    """The reference's sweep contract over a fixed adjacency: (counts, min
    core-neighbor root, INT32_MAX where there is none)."""
    hit = adj & core[None, :]
    m = jnp.min(jnp.where(hit, root[None, :], INT_MAX), axis=1)
    return hit.sum(1).astype(jnp.int32), m.astype(jnp.int32)


def _brute_min(adj, core):
    """``sweep_min`` of the same adjacency for ``hook_rounds``."""
    hit = torch.as_tensor(adj) & core[None, :]
    return lambda root: torch.where(hit, root[None, :], INT_MAX).amin(dim=1)


@pytest.mark.parametrize("max_rounds", [2, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hook_rounds_matches_the_reference_loop(seed, max_rounds):
    _, adj, core = _adjacency(seed)
    parent, n_ref = jdb._device_loop_fn(_ref_sweep, max_rounds)(
        jnp.asarray(adj), jnp.asarray(core))
    ref = np.asarray(jpointer_jump(parent))
    core_t = torch.as_tensor(core)
    root, n_rounds = dbscan_mod.hook_rounds(core_t, _brute_min(adj, core_t),
                                            max_rounds)
    assert n_rounds == int(n_ref)
    assert root.dtype == torch.int32
    np.testing.assert_array_equal(root.numpy(), ref)
    if max_rounds == 64:
        assert n_rounds > 2          # the cap of 2 binds on this data


def _counting_noop(monkeypatch):
    """Patch ``_hook_step`` to hook nothing; returns its call count."""
    calls = [0]

    def noop(root, m, core):
        calls[0] += 1
        return root, False
    monkeypatch.setattr(dbscan_mod, "_hook_step", noop)
    return calls


def test_one_seam_stops_every_hooking_loop(monkeypatch):
    pts, adj, core = _adjacency(0)
    eng = make_engine(pts, EPS, device="cpu")
    real = {hl: dbscan(pts, EPS, MIN_PTS, eng=eng, hook_loop=hl).n_rounds
            for hl in ("device", "frontier", "host")}
    assert min(real.values()) > 1
    snap = serve.build_snapshot(pts[:1000], EPS, MIN_PTS, device="cpu")
    sess = serve.ServeSession(snap, max_delta_frac=np.inf)
    core_t = torch.as_tensor(core)
    sweep_min = _brute_min(adj, core_t)

    def sweep_all(croot):
        return None, sweep_min(croot)
    _, real_local = tdd._local_components(sweep_all, core_t, 64)
    assert real_local > 1

    calls = _counting_noop(monkeypatch)
    for hl in ("device", "frontier", "host"):
        calls[0] = 0
        res = dbscan(pts, EPS, MIN_PTS, eng=eng, hook_loop=hl)
        assert res.n_rounds == 1 and calls[0] == 1, hl
    calls[0] = 0
    sess.ingest(pts[1000:1256])         # the delta's rounds
    assert calls[0] == 1
    calls[0] = 0
    _, n_local = tdd._local_components(sweep_all, core_t, 64)
    assert n_local == 1 and calls[0] == 1


def test_one_cell_code_step_for_every_csr_layout(monkeypatch):
    pts = synth.load("roadnet2d", 1200, seed=3)
    snap = serve.build_snapshot(pts, EPS, MIN_PTS, device="cpu")
    smap, _ = shard.split_snapshot(snap, 2)
    q = synth.load("roadnet2d", 300, seed=4, structure_seed=3,
                   structure_n=1200)
    cand = torch.as_tensor(np.concatenate(
        [pts[:500], np.full((12, 3), 1e30, np.float32)]))
    calls = [0]
    real = grid.cell_codes

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    monkeypatch.setattr(grid, "cell_codes", counted)
    steps = dict(
        plan=lambda: grid.plan_and_build_csr_grid(torch.as_tensor(pts), EPS),
        assign=lambda: serve.assign(snap, q),
        csr_sweep=lambda: tdd.make_csr_sweep(cand, EPS, 512,
                                             tdd.DistConfig()),
        owner_of=lambda: smap.owner_of(q),
        window_shards=lambda: smap.window_shards(q))
    for name, fn in steps.items():
        calls[0] = 0
        fn()
        assert calls[0] == 1, name


def test_a_shard_is_planned_and_built_in_one_layout():
    pts = synth.load("roadnet2d", 1200, seed=3)
    snap = serve.build_snapshot(pts, EPS, MIN_PTS, device="cpu")
    with trace.recording() as rec:
        _, parts = shard.split_snapshot(snap, 3)
        got = rec.take()
    assert len(parts) == 3
    assert trace.total(got, "csr_layouts") == len(parts)
