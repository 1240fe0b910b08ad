"""Card parity of the slab sweep kernels that skip runs: ``frontier_sweep``
and ``cross_sweep`` on CUDA tensors, each bit-identical to its plain
version on the same tensors, on layouts built to be culled
(``cull_layouts.py``: box gaps of exactly ε and one f32 step either side, a
heavy tile split over work items, +1e30 tail runs; for the frontier every
live-set size under the park contract, for the cross query tiles of +1e30
padding rows). And the two kernels that do their own gathers:
``hash_sweep`` against its plain version and the ``gathered_sweep`` path
on small grids with aliased buckets and pairs at d² = ε² (and the float
below); the fused BVH level, every level against ``bvh_level_plain`` and
every traversal against the ``bvh_batch_sweep`` level loop, exact and
terminated, D = 2 and 3, with a capacity that overflows and a probe that
stops there: counts, minroot, overflow and histogram. The LBVH build's
kernels (``lbvh_keys``, ``lbvh_nodes``, ``lbvh_refit``, ``lbvh_depth``)
and the whole ``build_bvh`` of a CUDA tensor against the plain versions
on the same tensors and against the CPU build, every field bitwise
(``cull_layouts.lbvh_cases``: the edge sizes, duplicates, sentinels and
signed zeros). And ``csr_sweep``, ``csr_sweep_counts`` (the culled
layouts), ``pairwise_sweep``, ``gathered_sweep``, ``morton_encode`` and
``bvh_batch_sweep`` against their plain versions. The sharded tier's
``assign`` on the card (a plain and a hedged leg) against the
single-session card ``assign``, and two host threads that first reach a
kernel at the same moment: one build, the same bits. The distributed
driver's four local engines on candidate buffers padded as the all_to_all
leaves them (counts, minroot and overflow equal to the CPU's, and exactly
each engine's kernels launched), ``neighbor_buckets`` of ±1e30 and ±3e9
rows equal to the CPU's, and a 4-rank thread group on the card equal to
one on the CPU.

Every test here is marked ``cuda`` and skips, with its reason, where torch
sees no CUDA device. It imports neither JAX nor the JAX package, so it
runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_card_parity.py
"""
import threading

import numpy as np
import pytest
import torch

from cull_layouts import (EPS, EQ_BELOW, culled_layout, lattice_cloud,
                          lattice_counts, lbvh_cases, payload,
                          with_padding_tiles)
from repro_torch import make_engine, serve
from repro_torch.core import bvh as tbvh
from repro_torch.core import grid as tgrid
from repro_torch.data import synth
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import bvh_sweep as tsweep
from repro_torch.kernels import cross_sweep as tcross
from repro_torch.kernels import csr_sweep as tcsr
from repro_torch.kernels import frontier_sweep as tfrontier
from repro_torch.kernels import gathered_sweep as tgathered
from repro_torch.kernels import lbvh as tlbvh
from repro_torch.kernels import morton as tmorton
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_sweep as tpairwise

INT_MAX = np.iinfo(np.int32).max
LAYOUTS = [(d, bq, bk) for d in (2, 3) for bq, bk in ((32, 128), (64, 512))]
IDS = [f"{d}d-bq{bq}-bk{bk}" for d, bq, bk in LAYOUTS]


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card "
                    "(torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _same(k, p):
    torch.cuda.synchronize()
    assert k.shape == p.shape and torch.equal(k, p), \
        f"{int((k != p).sum())} of {k.numel()} rows differ"


@pytest.mark.cuda
@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_frontier_sweep_kernel_is_its_plain_version(card, layout, eps2):
    dims, bq, bk = layout
    args, kinds = culled_layout(dims, bq, bk, seed=dims)
    q, cp, croot, st, nb = (torch.as_tensor(x, device=card) for x in args)
    T = len(st)
    order = [4, 2, 0, 3, 1, 5, 6]      # the heavy tile first
    kw = dict(max_blocks=len(kinds), block_k=bk)
    for n_active in sorted({0, 1, T // 2, T}):
        live = order[:n_active]
        active = torch.tensor(live + [live[-1] if live else 0] *
                              (T - n_active), dtype=torch.int32, device=card)
        na = torch.tensor([n_active], dtype=torch.int32, device=card)
        k = tfrontier.frontier_sweep(q, cp, croot, st, nb, active, na, eps2,
                                     block_q=bq, **kw)
        p = tfrontier.frontier_sweep_plain(q, cp, croot, st, nb, active, na,
                                           eps2, **kw)
        _same(k, p)
        assert (k[n_active * bq:] == INT_MAX).all()


@pytest.mark.cuda
@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_cross_sweep_kernel_is_its_plain_version(card, layout, eps2):
    dims, bq, bk = layout
    args, kinds = culled_layout(dims, bq, bk, seed=dims)
    args = with_padding_tiles(args, bq, bq // 2)
    q, cp, croot, st, nb = (torch.as_tensor(x, device=card) for x in args)
    kw = dict(max_blocks=len(kinds), block_k=bk)
    k = tcross.cross_sweep(q, cp, croot[None, :], st, nb, eps2, block_q=bq,
                           **kw)
    p = tcross.cross_sweep_plain(q, cp, croot[None, :], st, nb, eps2, **kw)
    for a, b in zip(k, p):
        _same(a, b)
    assert torch.isfinite(k[2]).any()


HASH_CASES = ["roadnet2d", "aliased", "lattice2d", "lattice3d"]


def _hash_engine(name, card):
    if name == "roadnet2d":
        pts, eps, dims, spec = synth.load(name, 3_000, seed=0), 0.02, 2, None
    elif name == "aliased":
        pts = synth.load("roadnet2d", 2_000, seed=1)
        eps, dims = 0.05, 2
        spec = tgrid.plan_grid(pts, eps, dims=2, max_table_size=64)
    else:
        dims = int(name[-2])
        pts = lattice_cloud(np.random.default_rng(dims), 3_000, dims)
        eps, spec = EPS, None
    eng = make_engine(pts, eps, engine="grid-hash", dims=dims, spec=spec,
                      device=card)
    core, root = payload(np.random.default_rng(7), len(pts))
    st, g = eng.state, eng.state.grid
    args = (st.points, g.order, st.buckets, st.cell_valid, g.points, g.index,
            st.occupancy, torch.as_tensor(core, device=card),
            torch.as_tensor(root, device=card))
    return pts, eps, args


@pytest.mark.cuda
@pytest.mark.parametrize("name", HASH_CASES)
def test_hash_sweep_kernel_is_its_plain_version(card, name):
    pts, eps, args = _hash_engine(name, card)
    if name == "aliased":
        assert bool((~args[3]).any())
    for eps2 in EQ_BELOW if name.startswith("lattice") else [eps * eps]:
        tgathered.reset_launches()
        k = tgathered.hash_sweep(*args, eps2)
        assert tgathered.LAUNCHES == {"gathered_sweep": 0, "hash_sweep": 1}
        p = tgathered.hash_sweep_plain(*args, eps2)
        a = tgathered.sweep_windows(tgathered.gathered_sweep, *args, eps2)
        for i in range(2):
            _same(k[i], p[i])
            _same(k[i], a[i])
        if name.startswith("lattice"):
            np.testing.assert_array_equal(
                k[0][:200].cpu().numpy(), lattice_counts(pts[:200], pts,
                                                         eps2))


def _checked_level(monkeypatch, levels):
    """Every bvh_level launch also runs the plain version on a copy of the
    state, and the two must agree."""
    real = tsweep.bvh_level

    def level(inputs, state, lvl, eps2, **kw):
        plain = tsweep.LevelState._make(
            None if x is None else x.clone() for x in state)
        real(inputs, state, lvl, eps2, **kw)
        tsweep.bvh_level_plain(inputs, plain, lvl, eps2, **kw)
        for f in ("counts", "minroot", "nlive", "overflow", "hist"):
            _same(getattr(state, f), getattr(plain, f))
        nxt = int(plain.nlive[lvl + 1])
        wrote = state.fb.shape[1] if kw.get("stop_on_overflow") and \
            bool(plain.overflow[0]) and nxt == 0 else nxt
        dst = (lvl + 1) % 2
        _same(state.fb[dst, :wrote], plain.fb[dst, :wrote])
        _same(state.fn[dst, :wrote], plain.fn[dst, :wrote])
        levels.append(lvl)
    monkeypatch.setattr(tsweep, "bvh_level", level)


BVH_CASES = [(mode, dims, cap) for mode in ("exact", "terminated")
             for dims in (2, 3) for cap in ("fits", "overflows", "probe")]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dims,cap", BVH_CASES,
                         ids=["-".join(map(str, c)) for c in BVH_CASES])
def test_bvh_level_traversal_is_the_plain_loop(card, monkeypatch, mode, dims,
                                               cap):
    name, eps, small = (("skewed2d", 0.05, 1536) if dims == 2 else
                        ("iono3d", 8.0, 1024))
    pts = torch.as_tensor(synth.load(name, 1_500, seed=4 if dims == 2
                                     else 0), device=card)
    n = pts.shape[0]
    rng = np.random.default_rng(3)
    croot = torch.as_tensor(np.where(rng.uniform(size=n) < 0.5,
                                     rng.integers(0, n, n), INT_MAX)
                            .astype(np.int32), device=card)
    bound = torch.as_tensor(rng.integers(0, n, n).astype(np.int32),
                            device=card)
    tree = tbvh.build_bvh(pts, dims=dims)
    kw = dict(eps=eps, eps2=eps * eps, tile=512,
              capacity=1 << 16 if cap == "fits" else small,
              stop_on_overflow=cap == "probe",
              bound=bound if mode == "terminated" else None)
    levels = []
    _checked_level(monkeypatch, levels)
    tsweep.reset_launches()
    f = tbvh.wavefront_sweep(tree, tree.pts_sorted, croot, **kw)
    monkeypatch.undo()
    a = tbvh.wavefront_sweep_plain(tree, tree.pts_sorted, croot, **kw)
    for x, y in zip((f[0], f[1], f[3]), (a[0], a[1], a[3])):
        _same(x, y)
    assert f[2] == a[2] == (cap != "fits")
    ran = int((a[3] >= 0).sum())
    assert ran <= len(levels) <= ran + 1


LBVH_CASES = lbvh_cases()
LBVH_IDS = [c[0] for c in LBVH_CASES]


def _bitwise(k, p):
    """``_same`` on the bits: -0.0 and +0.0 differ."""
    if k.dtype == torch.float32:
        k, p = k.view(torch.int32), p.view(torch.int32)
    _same(k, p)


def _extent(t, lo, hi):
    dev = t.device
    return (t.amin(0) if lo is None else torch.as_tensor(lo, device=dev),
            t.amax(0) if hi is None else torch.as_tensor(hi, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name,pts,dims,lo,hi", LBVH_CASES, ids=LBVH_IDS)
def test_lbvh_kernels_are_their_plain_versions(card, name, pts, dims, lo,
                                               hi):
    t = torch.as_tensor(pts, device=card)
    lo_t, hi_t = _extent(t, lo, hi)
    tlbvh.reset_launches()
    codes = tlbvh.lbvh_keys(t, lo_t, hi_t, dims=min(dims, 3))
    _same(codes, tlbvh.lbvh_keys_plain(t, lo_t, hi_t, dims=min(dims, 3)))
    codes, order = torch.sort(codes, stable=True)
    nodes = tlbvh.lbvh_nodes(codes)
    plain = tlbvh.lbvh_nodes_plain(codes)
    for a, b in zip(nodes, plain):
        _same(a, b)
    fit = tlbvh.lbvh_refit(t, order, nodes)
    for a, b in zip(fit, tlbvh.lbvh_refit_plain(t, order, plain)):
        _bitwise(a, b)
    _same(tlbvh.lbvh_depth(nodes.left, nodes.right),
          tlbvh.lbvh_depth_plain(nodes.left, nodes.right))
    assert set(tlbvh.LAUNCHES.values()) == {1}


@pytest.mark.cuda
@pytest.mark.parametrize("name,pts,dims,lo,hi", LBVH_CASES, ids=LBVH_IDS)
def test_build_bvh_on_the_card_is_the_plain_build(card, name, pts, dims, lo,
                                                  hi):
    t = torch.as_tensor(pts, device=card)
    tlbvh.reset_launches()
    tree = tbvh.build_bvh(t, dims=dims, lo=lo, hi=hi)
    depth = tbvh.max_leaf_depth(tree.left, tree.right)
    assert tlbvh.LAUNCHES == {"lbvh_keys": 1, "lbvh_nodes": 1,
                              "lbvh_refit": 1, "lbvh_depth": 1}
    lo_t, hi_t = _extent(t, lo, hi)
    codes = tlbvh.lbvh_keys_plain(t, lo_t, hi_t, dims=min(dims, 3))
    codes, order = torch.sort(codes, stable=True)
    nodes = tlbvh.lbvh_nodes_plain(codes)
    fit = tlbvh.lbvh_refit_plain(t, order, nodes)
    plain = dict(nodes._asdict(), **fit._asdict())
    cpu = tbvh.build_bvh(torch.as_tensor(pts), dims=dims, lo=lo, hi=hi)
    for f in tbvh.BVH._fields:
        _bitwise(getattr(tree, f), plain[f])
        _bitwise(getattr(tree, f).cpu(), getattr(cpu, f))
    assert depth == int(tlbvh.lbvh_depth_plain(nodes.left, nodes.right)[0])
    assert depth == tbvh.max_leaf_depth(cpu.left, cpu.right)


@pytest.mark.cuda
@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_csr_sweeps_are_their_plain_versions(card, layout, eps2):
    dims, bq, bk = layout
    args, kinds = culled_layout(dims, bq, bk, seed=dims)
    q, cp, croot, st, nb = (torch.as_tensor(x, device=card) for x in args)
    kw = dict(max_blocks=len(kinds), block_k=bk)
    k = tcsr.csr_sweep(q, cp, croot, st, nb, eps2, block_q=bq, **kw)
    p = tcsr.csr_sweep_plain(q, cp, croot, st, nb, eps2, **kw)
    for a, b in zip(k, p):
        _same(a, b)
    kc = tcsr.csr_sweep_counts(q, cp, st, nb, eps2, block_q=bq, **kw)
    _same(kc, tcsr.csr_sweep_counts_plain(q, cp, st, nb, eps2, **kw))
    _same(kc, k[0])
    assert int(k[0][:bq].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nc", [(1, 1), (7, 513), (256, 512), (513, 257)])
def test_pairwise_sweep_is_its_plain_version(card, nq, nc):
    rng = np.random.default_rng(nq)
    q = rng.uniform(-1, 1, (nq, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (nc, 3)).astype(np.float32)
    core = rng.uniform(size=nc) < 0.5
    root = rng.integers(0, nc, nc).astype(np.int32)
    args = tops.pairwise_sweep_args(
        *(torch.as_tensor(x, device=card) for x in (q, c, core, root)))
    k = tpairwise.pairwise_sweep(*args, 0.3)
    p = tpairwise.pairwise_sweep_plain(*args, 0.3)
    for a, b in zip(k, p):
        _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(1, 1), (128, 512), (130, 100), (3, 700)])
def test_gathered_sweep_is_its_plain_version(card, b, k):
    rng = np.random.default_rng(b + k)
    arrays = (rng.uniform(-1, 1, (b, 3)).astype(np.float32),
              rng.uniform(-1, 1, (b, k, 3)).astype(np.float32),
              rng.uniform(size=(b, k)) < 0.8,
              rng.uniform(size=(b, k)) < 0.5,
              rng.integers(0, 9999, (b, k)).astype(np.int32))
    args = tops.gathered_sweep_args(
        *(torch.as_tensor(x, device=card) for x in arrays))
    k_out = tgathered.gathered_sweep(*args, 0.2)
    p_out = tgathered.gathered_sweep_plain(*args, 0.2)
    for a, b_ in zip(k_out, p_out):
        _same(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("n", [1, 5, 1_023, 4_097])
def test_morton_encode_is_its_plain_version(card, dims, n):
    hi = 1 << 15 if dims == 2 else 1 << 10
    c = np.random.default_rng(n).integers(0, hi, (n, 3)).astype(np.int32)
    edge = np.array([[hi - 1] * 3, [0, 0, 0], [hi, hi + 1, 3 * hi],
                     [-1, -hi, 5], [hi - 1, 0, hi - 1]], np.int32)
    c[:min(n, 5)] = edge[:min(n, 5)]
    t = torch.as_tensor(c, device=card)
    _same(tmorton.morton_encode(t, dims=dims),
          tmorton.morton_encode_plain(t, dims=dims))


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("e,dims", [(1, 3), (129, 3), (300, 2), (256, 6)])
def test_bvh_batch_sweep_is_its_plain_version(card, e, dims, bf16, payload):
    rng = np.random.default_rng(e + dims)
    B = 8
    q = rng.uniform(-1, 1, (e, B, dims)).astype(np.float32)
    a = rng.uniform(-1, 1, (e, dims)).astype(np.float32)
    b = a + rng.uniform(0, 0.5, (e, dims)).astype(np.float32)
    lo = torch.as_tensor(np.minimum(a, b) - 0.25)
    hi = torch.as_tensor(np.maximum(a, b) + 0.25)
    if bf16:
        lo = tbvh._bf16_directed(lo, up=False)
        hi = tbvh._bf16_directed(hi, up=True)
    ints = [rng.integers(0, 9999, e).astype(np.int32),
            rng.integers(0, 9999, e).astype(np.int32),
            (rng.uniform(size=e) < 0.5).astype(np.int32),
            rng.integers(0, 9999, (e, B)).astype(np.int32)]
    croot, nmin, leaf, bound = (torch.as_tensor(x, device=card)
                                for x in ints)
    args = [torch.as_tensor(q, device=card), lo.to(card), hi.to(card),
            torch.as_tensor(a, device=card), croot,
            nmin if payload else None, leaf, bound if payload else None]
    kw = dict(bf16_prune=bf16, prune_payload=payload)
    k = tsweep.bvh_batch_sweep(*args, 0.09, **kw)
    p = tsweep.bvh_batch_sweep_plain(*args, 0.09, **kw)
    for x, y in zip(k, p):
        _same(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_tier_assign_on_the_card_is_the_single_session_assign(card, k):
    pts = synth.load("skewed2d", 20_000, seed=4)
    eps = 0.02
    snap = serve.build_snapshot(pts, eps, 8, device=card)
    tier = serve.ShardedTier.from_snapshot(snap, n_shards=k)
    try:
        assert all(s.snapshot.device.type == "cuda" for s in tier.sessions)
        rng = np.random.default_rng(k)
        q = pts[rng.integers(0, len(pts), 3_000)] + (
            rng.normal(0, eps / 2, (3_000, 3)) * [1, 1, 0]).astype(np.float32)
        full = serve.assign(snap, q)
        tier.replicate(0, copies=1)
        tier.health.record_failure((0, 0))      # hedge shard 0's leg
        for r in (tier.assign(q), tier.assign(q)):
            for f in ("labels", "counts", "dist"):
                np.testing.assert_array_equal(getattr(r, f),
                                              getattr(full, f), err_msg=f)
        assert tier.scheduler.hedges >= 1
        cpu = serve.ShardedTier.build(pts, eps, 8, n_shards=k, device="cpu")
        r = cpu.assign(q)
        for f in ("labels", "counts", "dist"):
            np.testing.assert_array_equal(getattr(r, f), getattr(full, f),
                                          err_msg=f)
        cpu.close()
    finally:
        tier.close()


@pytest.mark.cuda
def test_two_threads_first_reaching_a_kernel_build_it_once(card, monkeypatch,
                                                            tmp_path):
    """A fresh build directory and no loaded library: two threads call
    ``cross_sweep`` at the same moment; nvcc runs once, both launches count,
    and both get the bits of the plain version."""
    args, kinds = culled_layout(2, 64, 512, seed=2)
    q, cp, croot, st, nb = (torch.as_tensor(x, device=card) for x in args)
    croot = croot.reshape(1, -1)
    kw = dict(max_blocks=len(kinds), block_q=64, block_k=512)
    plain = tcross.cross_sweep_plain(q, cp, croot, st, nb, EPS * EPS,
                                     max_blocks=len(kinds), block_k=512)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tbuild, "_LIBRARIES", {})
    tbuild._function.cache_clear()
    runs = []
    real_popen = tbuild.subprocess.Popen

    def popen(cmd, **kw2):
        runs.append(cmd[-1])
        return real_popen(cmd, **kw2)

    monkeypatch.setattr(tbuild.subprocess, "Popen", popen)
    before = tcross.LAUNCHES["cross_sweep"]
    gate = threading.Barrier(2)
    outs = [None, None]

    def first_use(i):
        gate.wait()
        outs[i] = tcross.cross_sweep(q, cp, croot, st, nb, EPS * EPS, **kw)
        torch.cuda.synchronize()

    threads = [threading.Thread(target=first_use, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tbuild._function.cache_clear()
    assert [r.endswith("csr_sweep.cu") for r in runs] == [True]
    assert tcross.LAUNCHES["cross_sweep"] - before == 2
    for out in outs:
        for k, p in zip(out, plain):
            _same(k, p)


def _dist_layout(name, n, D, seed=0):
    """A distributed local engine's candidates as the all_to_all and the
    halo exchange leave them: D owned chunks and two halo chunks, each a
    run of real rows then +1e30 padding rows; (cand_pts, p_own, real)."""
    pts = synth.load(name, n, seed=seed)
    cap, cap_halo = 4 * n // (D * D), n // (2 * D)
    rng = np.random.default_rng(seed)
    sizes = [cap] * D + [cap_halo] * 2
    fill = [min(s, n // D + int(rng.integers(0, n // (4 * D))))
            for s in sizes[:D]] + [cap_halo // 2, 0]
    pts = np.resize(pts, (sum(fill), 3))
    out, pos = [], 0
    for s, f in zip(sizes, fill):
        chunk = np.full((s, 3), 1e30, np.float32)
        chunk[:f] = pts[pos:pos + f]
        pos += f
        out.append(chunk)
    cand = np.concatenate(out)
    return cand, D * cap, cand[:, 0] < 1e29


def _dist_local(engine, cand, eps, p_own, croot, device):
    from repro_torch.distributed import dbscan_dist as tdd
    build = tdd.engines.get_local_engine(engine)
    sweep_all, sweep_own, ovf = build(
        torch.as_tensor(cand, device=device), eps, cand.shape[0], p_own,
        tdd.DistConfig(local_engine=engine))
    r = torch.as_tensor(croot, device=device)
    return [x.cpu() for x in (*sweep_all(r), *sweep_own(r))] + [bool(ovf)]


DIST_KERNELS = {"grid": ("hash_sweep",), "csr": ("csr_sweep",),
                "bvh": ("lbvh_keys", "lbvh_nodes", "lbvh_refit",
                        "bvh_level"),
                "brute": ("pairwise_sweep",)}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(DIST_KERNELS))
@pytest.mark.parametrize("name,n,eps", [("roadnet2d", 12_000, 0.02),
                                        ("iono3d", 12_000, 4.0)],
                         ids=["roadnet2d", "iono3d"])
def test_distributed_local_engine_on_the_card_is_its_plain_run(
        card, engine, name, n, eps):
    cand, p_own, real = _dist_layout(name, n, 4)
    rng = np.random.default_rng(1)
    croot = np.where(real & (rng.uniform(size=len(real)) < 0.5),
                     rng.integers(0, len(real), len(real)),
                     INT_MAX).astype(np.int32)
    mods = (tcsr, tpairwise, tgathered, tlbvh, tsweep)
    for m in mods:
        m.reset_launches()
    k = _dist_local(engine, cand, eps, p_own, croot, card)
    torch.cuda.synchronize()
    launched = {kk: v for m in mods for kk, v in m.LAUNCHES.items() if v}
    p = _dist_local(engine, cand, eps, p_own, croot, "cpu")
    for a, b, what in zip(k, p, ("counts_all", "minroot_all", "counts_own",
                                 "minroot_own", "overflow")):
        assert (a == b) if what == "overflow" else torch.equal(a, b), what
    assert set(launched) == set(DIST_KERNELS[engine]), launched


@pytest.mark.cuda
def test_neighbor_buckets_of_far_rows_on_the_card_are_the_cpus(card):
    rows = np.array([[1e30, 0, 0], [-1e30, 1e30, 3e9], [1e30] * 3,
                     [-3e9, 2.2e9, -1e30], [0.5, -0.25, 0.125]], np.float32)
    for dims, side, table in ((3, 0.02, 64), (2, 1.0, 1 << 16)):
        spec = tgrid.GridSpec(side=side, origin=(0.0, 0.0, 0.0),
                              table_size=table, capacity=8, dims=dims)
        kb, kv = tgrid.neighbor_buckets(torch.as_tensor(rows, device=card),
                                        spec)
        pb, pv = tgrid.neighbor_buckets(torch.as_tensor(rows), spec)
        assert torch.equal(kb.cpu(), pb) and torch.equal(kv.cpu(), pv)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(DIST_KERNELS))
def test_distributed_thread_group_on_the_card_is_the_cpus(card, engine):
    from repro_torch.distributed.comm import ThreadGroup
    from repro_torch.distributed.dbscan_dist import (DistConfig,
                                                     dbscan_distributed)
    # iono3d at ε = 4.0 clusters and hooks without regrowing the grid
    # engine, whose plain sweep (padded 27 × C windows) is slow once C grows
    pts = synth.load("iono3d", 8_000, seed=3)
    cfg = DistConfig(local_engine=engine)
    k = dbscan_distributed(pts, 4.0, 16, ThreadGroup(4, card), cfg=cfg)
    p = dbscan_distributed(pts, 4.0, 16, ThreadGroup(4, "cpu"), cfg=cfg)
    assert torch.equal(k.labels.cpu(), p.labels)
    assert torch.equal(k.core.cpu(), p.core)
    assert k.n_rounds == p.n_rounds
