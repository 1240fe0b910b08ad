"""The skip of the CSR slab sweep kernels (``csr_sweep``,
``csr_sweep_counts``), in its plain version: run boxes, tile boxes and the
kept-run mask of ``repro_torch.kernels.csr_sweep``.

(a) The lower bound ``lb`` of two boxes never exceeds the reference's d²
    (``repro.kernels.ref._dist2``) of a pair inside them, nor the port's:
    at a box gap of exactly ε on the 1/8 lattice and one f32 step either
    side, in 2-D with z = 0, against +1e30 padding runs, with duplicate
    points; and the port's alone where the squares are subnormal, which
    the reference flushes.
(b) The sweep restricted to the kept runs is bit-identical to the
    unrestricted plain sweep and to the reference's csr sweep (its ``ref``
    backend): on the roadnet2d and iono3d layouts at n = 20,000, on the
    lattice cases of the kernel parity phase, and on layouts built to be
    culled.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro_torch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import csr_sweep as tcsr
from repro_torch.kernels import ref as tref
from cull_layouts import EPS, EPS2, EQ_BELOW, culled_layout
from cull_layouts import lattice as _lattice

INT_MAX = np.iinfo(np.int32).max
SUBSET = 12                     # tiles of the n = 20,000 layouts swept


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside other test workers on the same cores, torch's intra-op
    threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- (a) the lower bound -----------------------------------------------------

def _pair_sets(seed, kind):
    """(queries, candidates), f32 (n, 3) each."""
    rng = np.random.default_rng(seed)
    dims = 2 if kind == "planar" else 3
    q = _lattice(rng, 24, dims)
    if kind in ("lattice", "planar"):
        # candidates a box gap of exactly ε (then one f32 step either
        # side) from the queries along one axis, shifted on the others
        axis = int(rng.integers(0, dims))
        step = int(rng.integers(-1, 2))
        c = _lattice(rng, 24, dims)
        shift = rng.integers(-4, 5, 3).astype(np.float32) / 8
        shift[axis] = 0.5 + EPS
        if dims == 2:
            shift[2] = 0
        c = (c + shift).astype(np.float32)
        if step:
            c[:, axis] = np.nextafter(c[:, axis], np.float32(step * np.inf))
        if rng.integers(0, 2):
            q, c = c, q
        return q, c
    if kind == "padding":
        c = np.full((24, 3), 1e30, np.float32)
        n_real = int(rng.integers(0, 24))
        c[:n_real] = _lattice(rng, max(n_real, 2), 3)[:n_real]
        return q, c
    if kind == "dups":
        c = q[rng.integers(0, len(q), 24)]
        return q[rng.integers(0, len(q), 24)], c
    if kind == "subnormal":
        # gaps of about 1e-25 .. 1e-18, whose squares are mostly f32
        # subnormals (below 1.18e-38) or round to 0
        scale = np.float32(10.0 ** rng.uniform(-25, -19))
        q = (rng.normal(size=(24, 3)) * scale).astype(np.float32)
        c = (rng.normal(size=(24, 3)) * scale
             + rng.normal(size=3) * scale * 4).astype(np.float32)
        return q, c
    # "uniform": scales from small to overflowing d², anywhere relative to
    # each other; above the subnormal range, which XLA:CPU flushes to 0 in
    # the reference's d² (ROADMAP §3) and the card and torch do not
    scale = np.float32(10.0 ** rng.uniform(-9, 30))
    q = (rng.normal(size=(24, 3)) * scale).astype(np.float32)
    c = (rng.normal(size=(24, 3)) * scale
         + rng.normal(size=3) * scale * 4).astype(np.float32)
    return q, c


def _check_lower_bound(seed, kind):
    q, c = _pair_sets(seed, kind)
    qlo, qhi = tcsr.tile_boxes_plain(torch.as_tensor(q), 1)
    clo, chi = tcsr.run_boxes_plain(torch.as_tensor(np.ascontiguousarray(
        c.T)), len(c))
    lb = tcsr.box_lower_bound(qlo, qhi, clo, chi).numpy()
    # the port's d² (the kernel's arithmetic)
    d2_port = tref._dist2(torch.as_tensor(q)[:, None, :],
                          torch.as_tensor(c)[None, :, :]).numpy()
    assert not np.isnan(lb).any()
    if kind == "subnormal":
        # the reference flushes these squares (ROADMAP §3): the bound is
        # held to the port's d² alone
        assert lb[0] <= d2_port.min(), (seed, lb, d2_port.min())
        return
    d2 = np.asarray(jref._dist2(jnp.asarray(q)[:, None, :],
                                jnp.asarray(c)[None, :, :]))
    # the port's d² is the reference's here
    np.testing.assert_array_equal(d2_port, d2)
    assert lb[0] <= d2.min(), (kind, seed, lb, d2.min())
    # so every run holding a hit is kept
    for eps2 in EQ_BELOW:
        e = np.float32(eps2)
        if (d2 <= e).any():
            assert lb[0] <= e
    if kind == "padding" and (c == np.float32(1e30)).all():
        assert lb[0] == np.inf


try:
    from hypothesis import given, settings, strategies as st
    _HYP = True
except ImportError:  # pragma: no cover - the fixed seeds below instead
    _HYP = False

KINDS = ["lattice", "planar", "padding", "dups", "uniform", "subnormal"]

if _HYP:
    @settings(max_examples=300, deadline=None, derandomize=True,
              database=None)
    @given(st.integers(0, 2 ** 32 - 1), st.sampled_from(KINDS))
    def test_lower_bound_never_exceeds_a_pair_d2(seed, kind):
        _check_lower_bound(seed, kind)
else:
    @pytest.mark.parametrize("seed", range(60))
    @pytest.mark.parametrize("kind", KINDS)
    def test_lower_bound_never_exceeds_a_pair_d2(seed, kind):
        _check_lower_bound(seed, kind)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("step", [-1, 0, 1])
def test_lower_bound_at_a_gap_of_exactly_eps(dims, step):
    # the closest pair straddles two boxes whose gap is ε (or one f32 step
    # either side): the run is kept exactly when the pair is a hit
    rng = np.random.default_rng(dims * 3 + step)
    q = _lattice(rng, 16, dims, lo=1.0)
    q[2] = (1.5, 1.0, 1.0 if dims == 3 else 0.0)   # faces c[0] across x
    c = _lattice(rng, 16, dims, lo=1.0)
    c[:, 0] += np.float32(0.5 + EPS)
    if step:
        c[:, 0] = np.nextafter(c[:, 0], np.float32(step * np.inf))
    qlo, qhi = tcsr.tile_boxes_plain(torch.as_tensor(q), 1)
    clo, chi = tcsr.run_boxes_plain(torch.as_tensor(np.ascontiguousarray(
        c.T)), len(c))
    lb = float(tcsr.box_lower_bound(qlo, qhi, clo, chi)[0])
    d2 = np.asarray(jref._dist2(jnp.asarray(q)[:, None, :],
                                jnp.asarray(c)[None, :, :]))
    assert lb == float(d2.min())          # the corner pair is the bound
    assert (lb == EPS2) == (step == 0)
    assert (lb <= EPS2) == (step <= 0) == bool((d2 <= np.float32(EPS2)).any())


def test_boxes_drop_nan_and_run_width():
    x = torch.tensor([[np.nan, 1.0, 2.0], [0.5, np.nan, 3.0]])
    lo, hi = tcsr.tile_boxes_plain(x, 1)
    assert lo.tolist() == [[0.5, 1.0, 2.0]] and hi.tolist() == [[0.5, 1.0,
                                                                3.0]]
    lo, hi = tcsr.tile_boxes_plain(torch.full((4, 3), np.nan), 1)
    assert (lo == np.inf).all() and (hi == -np.inf).all()
    lb = tcsr.box_lower_bound(lo, hi, torch.zeros(1, 3), torch.ones(1, 3))
    assert lb.tolist() == [np.inf]
    assert [tcsr.run_width(k) for k in (512, 128, 1024, 100, 1)] == \
        [128, 128, 128, 4, 1]
    assert tcsr.SEG_RUNS == 32      # the kernel's kSegRuns: one bitmask


# --- (b) the restricted sweep ------------------------------------------------

def _kept_sweep(q, cp, croot, starts_blk, kept, eps2, *, block_k):
    """counts and minroot of the slab sweep over the kept runs alone, one
    G-column run index at a time, only the tiles that keep it."""
    G = tcsr.run_width(block_k)
    T = starts_blk.shape[0]
    qt = q.reshape(T, -1, 3)
    counts = torch.zeros(qt.shape[:2], dtype=torch.int32)
    minroot = torch.full(qt.shape[:2], INT_MAX, dtype=torch.int32)
    eps2_t = tref.eps2_tensor(eps2, q.device)
    for j in range(kept.shape[1]):
        tiles = kept[:, j].nonzero()[:, 0]
        if not len(tiles):
            continue
        idx = ((starts_blk[tiles].long() * (block_k // G) + j) * G)[:, None] \
            + torch.arange(G)                                   # (k, G)
        d2 = tref._dist2(qt[tiles][:, :, None, :],
                         cp[:, idx].permute(1, 2, 0)[:, None])  # (k, bq, G)
        hit = d2 <= eps2_t
        counts[tiles] += hit.sum(dim=2, dtype=torch.int32)
        r = torch.where(hit, croot[idx][:, None, :], INT_MAX).amin(dim=2)
        minroot[tiles] = torch.minimum(minroot[tiles], r)
    return counts.reshape(-1), minroot.reshape(-1)


def _three_sweeps(q, cp, croot, starts_blk, nblk, eps2, *, max_blocks,
                  block_q, block_k):
    """Kept mask, then (counts, minroot, counts-only) of the reference, the
    unrestricted plain sweep and the sweep of the kept runs alone."""
    kw = dict(max_blocks=max_blocks, block_k=block_k)
    t = [torch.as_tensor(np.asarray(x)) for x in (q, cp, croot, starts_blk,
                                                  nblk)]
    kept = tcsr.kept_runs_plain(t[0], t[1], t[3], t[4], eps2, **kw)
    full = tcsr._sweep_plain(*t, eps2, **kw)
    cut = _kept_sweep(t[0], t[1], t[2], t[3], kept, eps2, block_k=block_k)
    cut_counts = cut[0]
    jkw = dict(slab=max_blocks * block_k, block_q=block_q, block_k=block_k,
               backend="ref")
    starts = jnp.asarray(np.asarray(starts_blk) * block_k)
    j = [jnp.asarray(np.asarray(x)) for x in (q, cp, croot, nblk)]
    r = jops.csr_sweep(j[0], j[1], j[2], starts, j[3], eps2, **jkw)
    rc = jops.csr_sweep_counts(j[0], j[1], starts, j[3], eps2, **jkw)
    ref = [np.asarray(x) for x in (*r, rc)]
    for name, got in (("full", (*full, full[0])),
                      ("kept", (*cut, cut_counts))):
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    return kept


def _tile_subset(kept, nblk, seed):
    """SUBSET tile ids: the widest slab, the most kept runs, seeded others."""
    T = nblk.shape[0]
    must = {int(nblk.argmax()), int(kept.sum(1).argmax())}
    rng = np.random.default_rng(seed)
    others = [t for t in rng.permutation(T).tolist() if t not in must]
    return np.sort(list(must) + others[:SUBSET - len(must)])


@pytest.mark.parametrize("name,eps", [("roadnet2d", 0.02), ("iono3d", 2.0)])
def test_kept_sweep_on_the_reduced_layouts(name, eps):
    pts = repro_torch.synth.load(name, 20_000, seed=0)
    eng = repro_torch.make_engine(pts, eps, device="cpu")
    g, spec = eng.state, eng.meta
    st_blk = (g.starts // spec.block_k).to(torch.int32)
    kw = dict(max_blocks=spec.slab // spec.block_k, block_k=spec.block_k)
    eps2 = float(eps) ** 2
    kept = tcsr.kept_runs_plain(g.q_sorted, g.cands, st_blk, g.nblk, eps2,
                                **kw)
    live = int(g.nblk.sum()) * (spec.block_k // tcsr.run_width(
        spec.block_k))
    # both kept and skipped runs (45% / 56% kept at G = 512)
    assert 0.2 * live < int(kept.sum()) < 0.8 * live
    tiles = _tile_subset(kept.numpy(), g.nblk.numpy(), seed=0)
    idx = torch.as_tensor(tiles)
    q = g.q_sorted.reshape(spec.n_tiles, spec.chunk, 3)[idx].reshape(-1, 3)
    rng = np.random.default_rng(1)
    croot = rng.integers(0, spec.n, spec.n_cand).astype(np.int32)
    croot[rng.uniform(size=spec.n_cand) < 0.5] = INT_MAX
    sub_kept = _three_sweeps(q.numpy(), g.cands.numpy(), croot,
                             st_blk[idx].numpy(), g.nblk[idx].numpy(), eps2,
                             block_q=spec.chunk, **kw)
    assert torch.equal(sub_kept, kept[idx])


def _lattice_pairs(T, block_q, nc_blocks, bk, seed):
    """chip_smoke.py's ``_lattice``: points on the 1/8 lattice, candidates
    at d² ∈ {8, 9, 10}/64 of queries, the whole array every tile's slab."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-16, 17, (T * block_q, 3)).astype(np.float32) / 8
    offs = np.array([(2, 2, 0), (2, 0, 2), (0, 2, 2), (3, 0, 0), (0, 0, 3),
                     (2, 2, 1), (1, 2, 2), (3, 1, 0), (0, 1, 3)], np.float32)
    offs = offs * rng.choice([-1, 1], (len(offs), 3))
    nc = nc_blocks * bk
    c = q[rng.integers(0, len(q), nc)] + offs[rng.integers(0, len(offs), nc)] / 8
    croot = rng.integers(0, 9999, nc).astype(np.int32)
    croot[rng.uniform(size=nc) < 0.3] = INT_MAX
    return (q, np.ascontiguousarray(c.T.astype(np.float32)), croot,
            np.zeros(T, np.int32), np.full(T, nc_blocks, np.int32))


@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
@pytest.mark.parametrize("T,block_q,nc_blocks", [(2, 32, 2), (3, 256, 4)])
def test_kept_sweep_on_lattice_cases(T, block_q, nc_blocks, eps2):
    args = _lattice_pairs(T, block_q, nc_blocks, 128, seed=T)
    _three_sweeps(*args, eps2, max_blocks=nc_blocks, block_q=block_q,
                  block_k=128)


@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
@pytest.mark.parametrize("block_q,block_k", [(32, 128), (64, 512)])
@pytest.mark.parametrize("dims", [2, 3])
def test_kept_sweep_on_culled_layouts(dims, block_q, block_k, eps2):
    args, kinds = culled_layout(dims, block_q, block_k, seed=dims)
    n_runs = len(kinds)
    kept = _three_sweeps(*args, eps2, max_blocks=n_runs, block_q=block_q,
                         block_k=block_k).numpy()
    G = tcsr.run_width(block_k)
    per = block_k // G                       # G-runs per block
    kept = kept.reshape(len(kept), n_runs, per)
    assert (kept == kept[:, :, :1]).all()    # a block's runs alike
    kept = kept[:, :, 0]
    starts, nblk = args[3], args[4]
    eq = eps2 == EPS2
    for t in range(4):              # the near runs of each lattice tile
        own = 5 * t - starts[t]
        got = dict(zip(("own", "edge", "edge-", "edge+", "far"),
                       kept[t, own:own + 5]))
        assert got == {"own": True, "edge": eq, "edge-": True,
                       "edge+": False, "far": False}, (t, got)
    tail = kept[3, nblk[3] - 3:nblk[3]]
    assert [kinds[r] for r in range(n_runs - 3, n_runs)] == ["padding"] * 3
    assert not tail.any() and not kept[4, n_runs - 3:].any()
    assert kept[4].sum() * per > tcsr.SEG_RUNS   # split over items
    assert not kept[5:].any()
    if eq:  # pairs at exactly d² = ε² exist, and they count
        q, cp = args[0], args[1]
        d2 = np.asarray(jref._dist2(jnp.asarray(q[:block_q])[:, None, :],
                                    jnp.asarray(cp.T[block_k:2 * block_k])
                                    [None]))
        assert (d2 == np.float32(EPS2)).any()
