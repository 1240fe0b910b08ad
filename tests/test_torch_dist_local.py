"""repro_torch's distributed local engines and helpers against the JAX
reference's module functions, on one device.

The candidate buffers are laid out as the all_to_all and the halo exchange
leave them: D owned chunks, each a run of real rows then +1e30 padding
rows, then two halo chunks of the same shape. Each local builder is held
bitwise to the reference's (counts, minroot, overflow), the reference's
builders run under ``jax.jit`` as the driver runs them:

  * ``csr`` against ``make_csr_sweep``, also at ``csr_slab=512``;
  * ``bvh`` against ``make_bvh_wave_sweep``, also at
    ``bvh_frontier_factor=0.25`` (its probe overflows);
  * ``brute`` against ``_sweep_local``;
  * ``grid``: minroot and overflow against ``make_grid_sweep``'s; counts
    against ``_sweep_local``'s on every real row, and against
    ``make_grid_sweep``'s on the rows whose window has no repeated bucket
    (the reference counts a candidate again for every window offset whose
    cell hashes to a bucket already in the window; pinned below on its
    smallest input).

Padding rows: the reference's ``_sweep_local`` counts a padding query's
hits on padding candidates (both at +1e30, d² = 0), and the port's brute
sweep pads the candidates further to its block width, so brute counts are
compared on the real rows only; the reference's grid counts a padding
query's hits on the empty slots of its window, the port's grid query
carries a −BIG sentinel and hits nothing. The driver never reads a padding
row's output: a padding row is never core.

The helpers ``_pack_by_dest``, ``_select_first_k``, ``_compress``,
``_local_components`` and the slab-cut arithmetic (the reference's
``make_distributed_dbscan`` lines, jitted and op by op) are held bitwise
too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synth
from repro.distributed import dbscan_dist as jdd
from repro_torch.distributed import dbscan_dist as tdd

INT_MAX = np.iinfo(np.int32).max
BIG = np.float32(1e30)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(pts, D, cap, cap_halo, seed):
    """(cand_pts (D·cap + 2·cap_halo, 3) f32, p_own, real mask): real rows
    then +1e30 rows in each owned and each halo chunk."""
    rng = np.random.default_rng(seed)
    pts = pts[rng.permutation(len(pts))]
    sizes = [cap] * D + [cap_halo] * 2
    fill = [int(rng.integers(s // 3, s + 1)) for s in sizes]
    fill[0] = sizes[0]                       # one chunk full
    fill[-1] = 0                             # one halo side empty
    total = sum(fill)
    pts = np.resize(pts, (total, 3))         # repeats are duplicates
    out, pos = [], 0
    for s, f in zip(sizes, fill):
        chunk = np.full((s, 3), BIG, np.float32)
        chunk[:f] = pts[pos:pos + f]
        pos += f
        out.append(chunk)
    cand = np.concatenate(out).astype(np.float32)
    return cand, D * cap, cand[:, 0] < 1e29


def _payload(real, seed):
    """A fused croot plane: about half the real rows core with roots drawn
    from the row ids, INT32_MAX elsewhere (padding is never core)."""
    rng = np.random.default_rng(seed)
    n = len(real)
    core = real & (rng.uniform(size=n) < 0.5)
    root = rng.integers(0, n, n).astype(np.int32)
    return np.where(core, root, INT_MAX).astype(np.int32)


CASES = [
    ("roadnet2d", synth.load("roadnet2d", 1500, seed=3), 0.02, 4, 500, 150),
    ("iono3d", synth.load("iono3d", 1200, seed=5), 4.0, 4, 400, 120),
    ("blobs3d", synth.blobs(1000, k=4, dims=3, seed=2), 0.1, 2, 600, 200),
]
IDS = [c[0] for c in CASES]


def _case(case, seed=0):
    name, pts, eps, D, cap, cap_halo = case
    cand, p_own, real = _layout(pts, D, cap, cap_halo, seed)
    return name, cand, eps, p_own, real


def _ref_local(builder, cand, eps, p_own, cfg, croot):
    """(counts_all, minroot_all, counts_own, minroot_own, overflow) of a
    reference local builder, under jit as the driver runs it."""
    n_cand = cand.shape[0]

    def run(c, r):
        sweep_all, sweep_own, ovf = builder(c, eps, n_cand, p_own, cfg)
        ca, ma = sweep_all(r)
        co, mo = sweep_own(r)
        return ca, ma, co, mo, ovf

    out = jax.jit(run)(jnp.asarray(cand), jnp.asarray(croot))
    return [np.asarray(x) for x in out]


def _port_local(name, cand, eps, p_own, cfg, croot):
    n_cand = cand.shape[0]
    build = tdd.engines.get_local_engine(name)
    sweep_all, sweep_own, ovf = build(torch.as_tensor(cand), float(eps),
                                      n_cand, p_own, cfg)
    r = torch.as_tensor(croot)
    ca, ma = sweep_all(r)
    co, mo = sweep_own(r)
    return [x.numpy() for x in (ca, ma, co, mo)] + [bool(ovf)]


def _ref_sweep_local(cand, queries, croot, eps, chunk):
    return [np.asarray(x) for x in jax.jit(
        jdd._sweep_local, static_argnums=(3, 4))(
            jnp.asarray(queries), jnp.asarray(cand), jnp.asarray(croot),
            float(np.float32(eps * eps)), chunk)]


def test_local_registry_matches_the_references():
    from repro.core import engines as jeng
    from repro_torch.core import engines as teng
    assert teng.available_local_engines() == jeng.available_local_engines()
    with pytest.raises(ValueError, match="unknown local_engine"):
        teng.get_local_engine("nope")


@pytest.mark.parametrize("cfg_kw", [{}, {"csr_slab": 512}],
                         ids=["default", "slab512"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_csr_local_matches_make_csr_sweep(case, cfg_kw):
    name, cand, eps, p_own, real = _case(case)
    cfg = jdd.DistConfig(local_engine="csr", **cfg_kw)
    tcfg = tdd.DistConfig(local_engine="csr", **cfg_kw)
    for seed in (1, 2):
        croot = _payload(real, seed) if seed == 1 else \
            np.full(len(real), INT_MAX, np.int32)
        ref = _ref_local(jdd._local_csr, cand, eps, p_own, cfg, croot)
        got = _port_local("csr", cand, eps, p_own, tcfg, croot)
        for a, b, what in zip(ref, got, ("counts_all", "minroot_all",
                                         "counts_own", "minroot_own",
                                         "overflow")):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {what}")


def test_csr_slab_512_overflows_where_the_reference_does():
    name, cand, eps, p_own, real = _case(CASES[0])
    ovf = [bool(_ref_local(jdd._local_csr, cand, eps, p_own,
                           jdd.DistConfig(csr_slab=s), _payload(real, 1))[4])
           for s in (512, 4096)]
    assert ovf == [True, False]       # the case above exercises both


@pytest.mark.parametrize("cfg_kw", [{}, {"bvh_frontier_factor": 0.25}],
                         ids=["default", "frontier0.25"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bvh_local_matches_make_bvh_wave_sweep(case, cfg_kw):
    name, cand, eps, p_own, real = _case(case)
    cfg = jdd.DistConfig(local_engine="bvh", **cfg_kw)
    tcfg = tdd.DistConfig(local_engine="bvh", **cfg_kw)
    croot = _payload(real, 3)
    ref = _ref_local(jdd._local_bvh, cand, eps, p_own, cfg, croot)
    got = _port_local("bvh", cand, eps, p_own, tcfg, croot)
    if cfg_kw:
        assert bool(ref[4]), "the small frontier must overflow the probe"
    for a, b, what in zip(ref, got, ("counts_all", "minroot_all",
                                     "counts_own", "minroot_own",
                                     "overflow")):
        np.testing.assert_array_equal(b, a, err_msg=f"{name} {what}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_brute_local_matches_sweep_local(case):
    name, cand, eps, p_own, real = _case(case)
    cfg = tdd.DistConfig(local_engine="brute")
    croot = _payload(real, 4)
    got = _port_local("brute", cand, eps, p_own, cfg, croot)
    ra = _ref_sweep_local(cand, cand, croot, eps, cfg.query_chunk)
    ro = _ref_sweep_local(cand, cand[:p_own], croot, eps, cfg.query_chunk)
    own = real[:p_own]
    np.testing.assert_array_equal(got[0][real], ra[0][real])
    np.testing.assert_array_equal(got[1], ra[1])
    np.testing.assert_array_equal(got[2][own], ro[0][own])
    np.testing.assert_array_equal(got[3], ro[1])
    assert got[4] is False


@pytest.mark.parametrize("cfg_kw", [{}, {"grid_capacity": 256},
                                    {"grid_capacity": 4}],
                         ids=["default", "capacity256", "capacity4"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grid_local_against_make_grid_sweep_and_sweep_local(case, cfg_kw):
    from repro.core import grid as jgrid
    name, cand, eps, p_own, real = _case(case)
    cfg = jdd.DistConfig(**cfg_kw)
    tcfg = tdd.DistConfig(**cfg_kw)
    croot = _payload(real, 5)
    ref = _ref_local(jdd._local_grid, cand, eps, p_own, cfg, croot)
    got = _port_local("grid", cand, eps, p_own, tcfg, croot)
    assert got[4] == bool(ref[4])
    np.testing.assert_array_equal(got[1], ref[1], err_msg="minroot_all")
    np.testing.assert_array_equal(got[3], ref[3], err_msg="minroot_own")
    if cfg_kw.get("grid_capacity") == 4:
        assert got[4], "a bucket capacity of 4 must overflow"
    if got[4]:
        return                      # dropped points: counts are partial
    exact = _ref_sweep_local(cand, cand, croot, eps, cfg.query_chunk)[0]
    np.testing.assert_array_equal(got[0][real], exact[real])
    np.testing.assert_array_equal(got[2], got[0][:p_own])
    # the reference's own counts, on the rows whose window repeats no
    # bucket (no hash aliasing), and on padding rows (no hits at all)
    n_cand = cand.shape[0]
    table = 1 << max(6, int(np.ceil(np.log2(max(
        n_cand / cfg.grid_occupancy, 1.0)))))
    spec = jgrid.GridSpec(side=eps, origin=(0.0, 0.0, 0.0),
                          table_size=table, capacity=cfg.grid_capacity,
                          dims=3)
    _, cvalid = jgrid.neighbor_buckets(jnp.asarray(cand), spec)
    unaliased = np.asarray(cvalid).all(axis=1)
    unaliased &= real
    assert unaliased.sum() > len(cand) // 4
    np.testing.assert_array_equal(got[0][unaliased], ref[0][unaliased])
    # a padding query (the port's −BIG sentinel) hits nothing; the
    # reference's +1e30 one counts the empty slots of its window (+1e30
    # fill, d² = 0)
    assert (got[0][~real] == 0).all()
    assert (got[1][~real] == INT_MAX).all()


def test_grid_double_count_fault_smallest_input():
    """The reference's ``make_grid_sweep`` counts each of two points 4
    times: the two cells' windows alias two buckets each, and the counts
    are not masked by ``cell_valid``. The port counts 2, as
    ``_sweep_local`` does (ROADMAP §3)."""
    p = np.array([0.98920, 2.36529, 0.90958], np.float32)
    cand = np.stack([p, p + np.float32(0.01)]).astype(np.float32)
    croot = np.full(2, INT_MAX, np.int32)
    ref = _ref_local(jdd._local_grid, cand, 0.07, 2, jdd.DistConfig(),
                     croot)
    got = _port_local("grid", cand, 0.07, 2, tdd.DistConfig(), croot)
    exact = _ref_sweep_local(cand, cand, croot, 0.07, 1024)[0]
    assert ref[0].tolist() == [4, 4]
    assert got[0].tolist() == [2, 2] == exact.tolist()
    assert ref[1].tolist() == got[1].tolist() == [INT_MAX, INT_MAX]


@pytest.mark.parametrize("n,D,cap", [(200, 4, 64), (200, 4, 40), (37, 3, 8),
                                     (64, 1, 64)])
def test_pack_by_dest_matches_reference(n, D, cap):
    rng = np.random.default_rng(n + D + cap)
    values = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    dest = rng.integers(0, D, n).astype(np.int32)
    rb, ro = jdd._pack_by_dest(jnp.asarray(values), jnp.asarray(dest), D,
                               cap)
    tb, to = tdd._pack_by_dest(torch.as_tensor(values),
                               torch.as_tensor(dest), D, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    assert bool(to) == bool(ro)


@pytest.mark.parametrize("n,k,p", [(100, 30, 0.2), (100, 30, 0.6),
                                   (50, 50, 0.0), (40, 64, 0.5)])
def test_select_first_k_matches_reference(n, k, p):
    rng = np.random.default_rng(n + k)
    values = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    pred = rng.uniform(size=n) < p
    ref = jdd._select_first_k(jnp.asarray(values), jnp.asarray(pred), k)
    got = tdd._select_first_k(torch.as_tensor(values), torch.as_tensor(pred),
                              k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", range(4))
def test_compress_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 300
    # a forest: each node points at a node earlier in a random order (or
    # at itself), so there is no cycle
    rank = rng.permutation(n)               # node at each position
    parent = np.empty(n, np.int32)
    for pos, node in enumerate(rank):
        parent[node] = rank[rng.integers(0, pos + 1)]
    ref = np.asarray(jdd._compress(jnp.asarray(parent)))
    np.testing.assert_array_equal(
        tdd._compress(torch.as_tensor(parent)).numpy(), ref)


@pytest.mark.parametrize("rounds", [1, 32])
def test_local_components_matches_reference(rounds):
    name, cand, eps, p_own, real = _case(CASES[0], seed=7)
    n_cand = cand.shape[0]
    cfg = jdd.DistConfig(local_engine="csr")
    rng = np.random.default_rng(9)
    core = real & (rng.uniform(size=n_cand) < 0.7)

    def ref_fn(c, k):
        sweep_all, _ = jdd.make_csr_sweep(c, eps, n_cand, cfg)
        return jdd._local_components(sweep_all, k, n_cand, rounds)

    ref = np.asarray(jax.jit(ref_fn)(jnp.asarray(cand), jnp.asarray(core)))
    sweep_all, _ = tdd.make_csr_sweep(
        torch.as_tensor(cand), eps, n_cand,
        tdd.DistConfig(local_engine="csr"))
    got, it = tdd._local_components(sweep_all, torch.as_tensor(core), n_cand,
                                    rounds)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 1 <= it <= rounds


class _OneRank:
    """Collectives of a group whose ranks all hold this rank's data."""
    sent = {}

    def pmin(self, x):
        return x

    pmax = psum = pmin


def _ref_cuts(pts_local, n, D, b):
    """The reference's slab-cut lines (``make_distributed_dbscan``, step 1)
    with the collectives of :class:`_OneRank`."""
    lo, hi = pts_local.min(axis=0), pts_local.max(axis=0)
    widest = jnp.argmax(hi - lo)
    c = jnp.take_along_axis(pts_local, widest[None, None].repeat(
        pts_local.shape[0], 0), axis=1)[:, 0]
    clo = lo[widest]
    chi = jnp.maximum(hi[widest], clo + 1e-6)
    bin_of = jnp.clip(((c - clo) / (chi - clo) * b).astype(jnp.int32),
                      0, b - 1)
    hist = jnp.zeros((b,), jnp.int32).at[bin_of].add(1)
    cum = jnp.cumsum(hist)
    targets = (jnp.arange(1, D, dtype=jnp.float32) / D) * n
    cut_bins = jnp.searchsorted(cum.astype(jnp.float32), targets)
    cuts = clo + (cut_bins.astype(jnp.float32) + 1) / b * (chi - clo)
    dest = jnp.searchsorted(cuts, c).astype(jnp.int32)
    return widest, cuts, dest


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "op-by-op"])
@pytest.mark.parametrize("name,n,D,bins", [
    ("roadnet2d", 4000, 4, 512), ("iono3d", 3000, 8, 512),
    ("taxi2d", 2000, 2, 64), ("skewed2d", 1500, 4, 512),
    ("highway", 2048, 8, 512)])
def test_slab_cuts_match_reference(name, n, D, bins, jit):
    """Op by op, the cuts and every point's slab are the reference's bit
    for bit. Compiled, XLA:CPU contracts ``clo + a * (chi - clo)`` into an
    FMA and moves a cut by up to 2 ulp (ROADMAP §3, the FMA family): the
    port keeps the unfused f32 of the reference's source; no point of
    these inputs lies between the two values, so every slab is the same."""
    pts = synth.load(name, n, seed=1)
    if jit:
        ref = jax.jit(_ref_cuts, static_argnums=(1, 2, 3))(
            jnp.asarray(pts), n, D, bins)
    else:
        with jax.disable_jit():
            ref = _ref_cuts(jnp.asarray(pts), n, D, bins)
    widest, cuts, c = tdd._slab_cuts(_OneRank(), torch.as_tensor(pts), n, D,
                                     bins)
    dest = torch.searchsorted(cuts, c).to(torch.int32)
    assert int(widest) == int(ref[0])
    ulps = np.abs(cuts.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(ref[1]).view(np.int32))
    assert ulps.max(initial=0) <= (2 if jit else 0)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(ref[2]))


def test_dist_config_fields_and_defaults_are_the_references():
    assert [(f.name, f.default) for f in dataclasses.fields(tdd.DistConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(jdd.DistConfig)]
