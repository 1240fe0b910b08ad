"""repro_torch frontier round driver (``dbscan(hook_loop="frontier")``) on
the CPU against the JAX reference on the same data: labels, core, counts,
``n_rounds`` and the ``frontier_tiles`` histogram must be bit-identical,
and so must the frontier helpers ``slab_touched``, ``slab_payload_min`` and
``compact_tiles`` and every round of the engine's frontier sweep. The
tile-parking safety property is replayed against the port's full sweeps."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import neighbors as jnb
from repro.core.dbscan import dbscan as jdbscan
from repro.core.union_find import pointer_jump as jpointer_jump
from repro.data import synth
from repro_torch import dbscan, make_engine
from repro_torch.core import grid as tgrid
from repro_torch.core.dbscan import _hook_step
from repro_torch.core.union_find import pointer_jump
from repro_torch.kernels import frontier_sweep as tfrontier

INT_MAX = np.iinfo(np.int32).max
_DUPS = np.random.default_rng(1).uniform(0, 1, (100, 3)).astype(np.float32)

CASES = [
    ("skewed", synth.load("skewed2d", 1500, seed=4), 0.05, 8),
    ("deep-clump", synth.load("skewed2d", 4096, seed=10), 1e-4, 8),
    ("duplicates", np.concatenate([_DUPS, _DUPS, _DUPS[:40]]), 0.03, 3),
    ("n2-near", np.array([[0, 0, 0], [0.05, 0, 0]], np.float32), 0.1, 2),
    ("n2-far", np.array([[0, 0, 0], [9.0, 0, 0]], np.float32), 0.1, 2),
    ("all-noise", synth.load("highway", 300, seed=6), 1e-4, 5),
    ("roadnet", synth.load("roadnet2d", 1200, seed=2), 0.03, 4),
]
IDS = [c[0] for c in CASES]


def _assert_same(ref, port):
    for f in ("labels", "core", "counts"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(ref.n_rounds) == port.n_rounds


@pytest.mark.parametrize("name,pts,eps,minpts", CASES, ids=IDS)
def test_frontier_driver_matches_reference(name, pts, eps, minpts):
    ref = jdbscan(pts, eps, minpts, hook_loop="frontier")
    port = dbscan(pts, eps, minpts, hook_loop="frontier", device="cpu")
    _assert_same(ref, port)
    hist = port.frontier_tiles
    assert hist.dtype == torch.int32 and hist.shape == (64,)
    np.testing.assert_array_equal(np.asarray(ref.frontier_tiles),
                                  hist.numpy())
    assert (hist[:port.n_rounds] >= 0).all()
    assert (hist[port.n_rounds:] == -1).all()
    # and the port's own full re-sweep driver agrees
    dev = dbscan(pts, eps, minpts, hook_loop="device", device="cpu")
    for f in ("labels", "core", "counts"):
        assert torch.equal(getattr(dev, f), getattr(port, f)), f
    assert dev.n_rounds == port.n_rounds
    assert set(port.timings) == {"stage1_s", "stage2_s", "border_s",
                                 "stage1_kept_pairs"}


def test_frontier_compacts_deep_clump_and_parks_all_noise():
    name, pts, eps, minpts = CASES[1]
    res = dbscan(pts, eps, minpts, hook_loop="frontier", device="cpu")
    hist = res.frontier_tiles.numpy()[:res.n_rounds]
    eng = make_engine(pts, eps, device="cpu")
    assert hist[-1] < eng.meta.n_tiles
    _, pts, eps, minpts = CASES[5]
    res = dbscan(pts, eps, minpts, hook_loop="frontier", device="cpu")
    assert (res.labels == -1).all() and res.frontier_tiles[0] == 0


def test_frontier_capability_gating():
    # engines without sweep_frontier fall back to the driver "device"
    # would take, never fail
    pts = synth.blobs(300, k=3, seed=0)
    eng = make_engine(pts, 0.08, device="cpu")
    assert eng.sweep_frontier is not None
    plain = eng._replace(sweep_frontier=None)
    f = dbscan(pts, 0.08, 5, eng=plain, hook_loop="frontier")
    d = dbscan(pts, 0.08, 5, eng=eng, hook_loop="device")
    assert torch.equal(f.labels, d.labels) and f.n_rounds == d.n_rounds
    assert f.frontier_tiles is None
    for engine in ("brute", "grid-hash"):
        b = dbscan(pts, 0.08, 5, engine=engine, hook_loop="frontier",
                   device="cpu")
        ref = jdbscan(pts, 0.08, 5, engine=engine, hook_loop="frontier")
        _assert_same(ref, b)
        assert b.frontier_tiles is None
    with pytest.raises(ValueError, match="unknown hook_loop"):
        dbscan(pts, 0.08, 5, eng=eng, hook_loop="fronteer")


def _engines(pts, eps):
    jeng = jnb.make_engine(pts, eps, engine="grid")
    eng = make_engine(pts, eps, device="cpu")
    return jeng, eng


@pytest.mark.parametrize("seed,eps,minpts",
                         [(0, 0.05, 5), (1, 0.08, 3), (2, 0.03, 8),
                          (7, 0.08, 6)])
def test_parked_tiles_only_lose_noop_hooks(seed, eps, minpts):
    """Replays the frontier rounds beside full sweeps: wherever the
    frontier parked a core query, the full sweep's hook must be a no-op
    (``min(m_full, root) == root``). Each round's frontier sweep (min-root,
    pending flags, live count) is also held to the reference's on the same
    inputs."""
    pts = synth.blobs(220, k=3, seed=seed)
    jeng, eng = _engines(pts, eps)
    n = eng.meta.n
    counts = dbscan(pts, eps, minpts, eng=eng).counts
    core_s = (counts >= minpts)[eng.order.long()]
    jcore_s = jnp.asarray(core_s.numpy())
    frontier, jfrontier = eng.sweep_frontier, jeng.sweep_frontier
    assert frontier.n_tiles == jfrontier.n_tiles == eng.meta.n_tiles

    parent = torch.arange(n, dtype=torch.int32)
    prev_croot = torch.full((n,), -1, dtype=torch.int32)
    pending = torch.ones((frontier.n_tiles,), dtype=torch.bool)
    for _ in range(64):
        root = pointer_jump(parent)
        croot = torch.where(core_s, root, INT_MAX)
        qroot = torch.where(core_s, root, -1)
        changed = croot != prev_croot
        jout = jfrontier.sweep(jeng.state, jnp.asarray(croot.numpy()),
                               jnp.asarray(qroot.numpy()),
                               jnp.asarray(changed.numpy()),
                               jnp.asarray(pending.numpy()))
        m_f, pending, n_live = frontier.sweep(eng.state, croot, qroot,
                                              changed, pending)
        for a, b in zip(jout, (m_f, pending, n_live)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        _, m_full = eng.sweep_sorted(eng.state, croot)
        parked = m_f == INT_MAX
        tgt_full = torch.minimum(m_full, root)
        bad = parked & core_s & (tgt_full < root)
        assert not bad.any(), (
            "parked tile would have produced a real union at sorted "
            f"positions {torch.nonzero(bad)[:10].ravel().tolist()}")
        prev_croot = croot
        parent, changed_any = _hook_step(root, m_f, core_s)
        if not changed_any:
            break
    # the border sweep matches the reference's too
    root = pointer_jump(parent)
    np.testing.assert_array_equal(np.asarray(jpointer_jump(
        jnp.asarray(parent.numpy()))), root.numpy())
    croot = torch.where(core_s, root, INT_MAX)
    np.testing.assert_array_equal(
        np.asarray(jfrontier.border(jeng.state, jnp.asarray(croot.numpy()),
                                    jcore_s)),
        frontier.border(eng.state, croot, core_s).numpy())


@pytest.mark.parametrize("seed", [0, 3, 11, 42])
def test_slab_touched_never_misses(seed):
    rng = np.random.default_rng(seed)
    pts = synth.blobs(200, k=2, seed=seed)
    jeng, eng = _engines(pts, 0.08)
    spec, n = eng.meta, eng.meta.n
    flags = rng.uniform(size=n) < rng.uniform(0, 0.2)
    got = tgrid.slab_touched(torch.as_tensor(flags), eng.state.starts,
                             eng.state.nblk, n, block_k=spec.block_k)
    ref = jgrid.slab_touched(jnp.asarray(flags), jeng.state.starts,
                             jeng.state.nblk, n, block_k=spec.block_k)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    starts, nblk = eng.state.starts.numpy(), eng.state.nblk.numpy()
    for t in range(spec.n_tiles):
        lo, hi = starts[t], min(starts[t] + nblk[t] * spec.block_k, n)
        assert bool(got[t]) == bool(flags[lo:hi].any())


@pytest.mark.parametrize("seed,T,bk,nb_tot,max_blocks",
                         [(0, 1, 8, 1, 1), (1, 7, 16, 12, 5),
                          (2, 40, 32, 30, 30), (3, 9, 128, 4, 3)])
def test_slab_payload_min_matches_reference(seed, T, bk, nb_tot, max_blocks):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 1 << 20, nb_tot * bk).astype(np.int32)
    payload[rng.uniform(size=payload.size) < 0.4] = INT_MAX
    starts = (rng.integers(0, nb_tot - max_blocks + 1, T) * bk) \
        .astype(np.int32)
    nblk = rng.integers(0, max_blocks + 1, T).astype(np.int32)
    kw = dict(block_k=bk, max_blocks=max_blocks)
    ref = jgrid.slab_payload_min(jnp.asarray(payload), jnp.asarray(starts),
                                 jnp.asarray(nblk), **kw)
    got = tgrid.slab_payload_min(torch.as_tensor(payload),
                                 torch.as_tensor(starts),
                                 torch.as_tensor(nblk), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert (got[torch.as_tensor(nblk) == 0] == INT_MAX).all()


@pytest.mark.parametrize("seed,T,p", [(0, 1, 0.0), (1, 1, 1.0),
                                      (2, 17, 0.0), (3, 17, 1.0),
                                      (4, 33, 0.3), (5, 200, 0.05)])
def test_compact_tiles_matches_reference(seed, T, p):
    live = np.random.default_rng(seed).uniform(size=T) < p
    ref_active, ref_n = jgrid.compact_tiles(jnp.asarray(live))
    active, n_live = tgrid.compact_tiles(torch.as_tensor(live))
    assert active.dtype == n_live.dtype == torch.int32 and n_live.dim() == 0
    np.testing.assert_array_equal(np.asarray(ref_active), active.numpy())
    assert int(ref_n) == int(n_live) == int(live.sum())
    np.testing.assert_array_equal(active[:int(n_live)].numpy(),
                                  np.nonzero(live)[0])


def test_cpu_frontier_run_launches_no_kernel():
    tfrontier.reset_launches()
    dbscan(synth.blobs(300, k=3, seed=2), 0.08, 5, hook_loop="frontier",
           device="cpu")
    assert tfrontier.LAUNCHES == {"frontier_sweep": 0}
