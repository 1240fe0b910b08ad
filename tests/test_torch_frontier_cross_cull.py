"""The skip of the frontier and cross-corpus slab sweep kernels
(``frontier_sweep``, ``cross_sweep``), in its plain version: the kernels
keep, per output tile, the candidate runs whose box comes within ε of the
box of the query tile the output reads (``csr_sweep.kept_runs_plain``; for
the frontier ``frontier_sweep.kept_runs_plain``, which keeps nothing for a
parked slot), and fold the hits of those runs alone.

(a) The frontier sweep restricted to the kept runs of the active tiles is
    bit-identical to ``frontier_sweep_plain`` and to the reference's
    ``frontier_sweep_ref``, with n_active = 0, 1, T/2 and T under the park
    contract: on the roadnet2d and iono3d layouts at n = 20,000 and on the
    layouts built to be culled (``cull_layouts.py``).
(b) The cross query restricted the same way gives counts, minroot and
    ``mind2`` bit-identical to ``cross_sweep_plain`` and to the reference's
    ``cross_sweep_ref`` run op by op (``jax.disable_jit``, as
    ``test_torch_cross_sweep.py`` runs it): on the sweep of an assign of
    fresh points padded to its bucket, and on the culled layouts with a
    tile half of +1e30 padding rows and one of padding rows alone.
(c) The kernel folds ``mind2`` as an integer min over the bits of d²: on
    non-negative f32 values (+0, subnormals, normals, +inf), the min of
    their int32 bit patterns is their float min.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels import ref as jref
from repro_torch.core import neighbors as tnb
from repro_torch.kernels import cross_sweep as tcross
from repro_torch.kernels import csr_sweep as tcsr
from repro_torch.kernels import frontier_sweep as tfrontier
from repro_torch.kernels import ref as tref
from cull_layouts import EPS2, EQ_BELOW, culled_layout, with_padding_tiles

INT_MAX = np.iinfo(np.int32).max
SUBSET = 12                     # tiles of the n = 20,000 layouts swept
# the culled layouts: 2-D and 3-D, G = 128 and 512, each at ε² exactly or
# one f32 step below (EQ_BELOW)
CULLED = [(2, 32, 128, 0), (2, 64, 512, 1), (3, 32, 128, 1), (3, 64, 512, 0)]
CULLED_IDS = [f"{d}d-bq{bq}-bk{bk}-{('eq', 'below')[e]}"
              for d, bq, bk, e in CULLED]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside other test workers on the same cores, torch's intra-op
    threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kept_sweep(q_tiles, cp, croot, starts_blk, kept, eps2, *, block_k):
    """counts, minroot and mind2 of the slab sweep of query tiles
    ``q_tiles`` (T, block_q, 3) over the runs ``kept`` (T, R) alone, one
    G-column run index at a time, only the tiles that keep it."""
    G = tcsr.run_width(block_k)
    T, bq = q_tiles.shape[:2]
    counts = torch.zeros((T, bq), dtype=torch.int32)
    minroot = torch.full((T, bq), INT_MAX, dtype=torch.int32)
    mind2 = torch.full((T, bq), float("inf"), dtype=torch.float32)
    eps2_t = tref.eps2_tensor(eps2, q_tiles.device)
    for j in range(kept.shape[1]):
        tiles = kept[:, j].nonzero()[:, 0]
        if not len(tiles):
            continue
        idx = ((starts_blk[tiles].long() * (block_k // G) + j) * G)[:, None] \
            + torch.arange(G)                                   # (k, G)
        d2 = tref._dist2(q_tiles[tiles][:, :, None, :],
                         cp[:, idx].permute(1, 2, 0)[:, None])  # (k, bq, G)
        hit = d2 <= eps2_t
        r = croot[idx][:, None, :]
        counts[tiles] += hit.sum(dim=2, dtype=torch.int32)
        minroot[tiles] = torch.minimum(
            minroot[tiles], torch.where(hit, r, INT_MAX).amin(dim=2))
        core_hit = hit & (r != INT_MAX)
        mind2[tiles] = torch.minimum(
            mind2[tiles], torch.where(core_hit, d2, float("inf")).amin(dim=2))
    return counts.reshape(-1), minroot.reshape(-1), mind2.reshape(-1)


# --- layouts -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reduced(name, eps):
    """SUBSET tiles (the widest slab among them) of the grid layout at
    n = 20,000 with a seeded payload, as (q, cands, croot, starts_blk,
    nblk), and its max_blocks and block_k."""
    pts = repro_torch.synth.load(name, 20_000, seed=0)
    eng = repro_torch.make_engine(pts, eps, device="cpu")
    g, spec = eng.state, eng.meta
    rng = np.random.default_rng(2)
    others = [t for t in rng.permutation(spec.n_tiles).tolist()
              if t != int(g.nblk.argmax())]
    tiles = torch.as_tensor(np.sort([int(g.nblk.argmax())] +
                                    others[:SUBSET - 1]))
    croot = rng.integers(0, spec.n, spec.n_cand).astype(np.int32)
    croot[rng.uniform(size=spec.n_cand) < 0.5] = INT_MAX
    q = g.q_sorted.reshape(spec.n_tiles, spec.chunk, 3)[tiles]
    args = (q.reshape(-1, 3).numpy(), g.cands.numpy(), croot,
            (g.starts // spec.block_k).to(torch.int32)[tiles].numpy(),
            g.nblk[tiles].numpy())
    return args, spec.slab // spec.block_k, spec.block_k


def _frontier_layouts():
    """(id, args, eps2, max_blocks, block_k) of every frontier case."""
    for name, eps in (("roadnet2d", 0.02), ("iono3d", 2.0)):
        def reduced(name=name, eps=eps):
            args, max_blocks, bk = _reduced(name, eps)
            return args, float(eps) ** 2, max_blocks, bk
        yield name, reduced
    for (dims, bq, bk, e), cid in zip(CULLED, CULLED_IDS):
        def make(dims=dims, bq=bq, bk=bk, eps2=EQ_BELOW[e]):
            args, kinds = culled_layout(dims, bq, bk, seed=dims)
            return args, eps2, len(kinds), bk
        yield f"culled-{cid}", make


FRONTIER = dict(_frontier_layouts())


def _active(T, n_active, seed):
    """A seeded live set of n_active tiles in no particular order, parked
    under the reference's contract: the last live id repeated (0 when
    none)."""
    live = np.random.default_rng(seed).permutation(T)[:n_active].tolist()
    return np.array(live + [live[-1] if live else 0] * (T - n_active),
                    np.int32)


# --- (a) the frontier sweep --------------------------------------------------

@pytest.mark.parametrize("frac", ["0", "1", "half", "all"])
@pytest.mark.parametrize("layout", list(FRONTIER))
def test_frontier_kept_sweep_is_the_plain_and_reference_sweep(layout, frac):
    args, eps2, max_blocks, bk = FRONTIER[layout]()
    q, cp, croot, st, nb = args
    T = len(st)
    n_active = {"0": 0, "1": 1, "half": T // 2, "all": T}[frac]
    active = _active(T, n_active, seed=T + n_active)
    t = [torch.as_tensor(x) for x in (q, cp, croot, st, nb, active)]
    na = torch.tensor([n_active], dtype=torch.int32)
    kw = dict(max_blocks=max_blocks, block_k=bk)
    kept = tfrontier.kept_runs_plain(t[0], t[1], t[3], t[4], t[5], na, eps2,
                                     **kw)
    # parked slots keep nothing; live ones keep what csr_sweep keeps
    assert not kept[n_active:].any()
    csr_kept = tcsr.kept_runs_plain(t[0], t[1], t[3], t[4], eps2, **kw)
    live = t[5][:n_active].long()
    assert torch.equal(kept[:n_active], csr_kept[live])
    q_tiles = t[0].reshape(T, -1, 3)[t[5].long()]
    cut = _kept_sweep(q_tiles, t[1], t[2], t[3][t[5].long()], kept, eps2,
                      block_k=bk)[1]
    plain = tfrontier.frontier_sweep_plain(*t[:5], t[5], na, eps2, **kw)
    ref = jref.frontier_sweep_ref(
        *(jnp.asarray(x) for x in (q, cp, croot[None, :], st, nb, active)),
        jnp.asarray([n_active], jnp.int32), jnp.float32(eps2), **kw)
    np.testing.assert_array_equal(np.asarray(ref), plain.numpy())
    assert torch.equal(cut, plain)
    bq = q_tiles.shape[1]
    assert (plain[n_active * bq:] == INT_MAX).all()
    if layout.startswith("culled") and n_active == T:
        # the culled tiles skip runs, and still find core hits
        live_runs = csr_kept.shape[1] * (nb > 0).sum()
        assert 0 < int(kept.sum()) < live_runs
        assert (plain != INT_MAX).any()


def test_frontier_kept_runs_of_the_heavy_culled_tile_span_several_items():
    args, kinds = culled_layout(3, 32, 128, seed=3)
    t = [torch.as_tensor(x) for x in args]
    active = torch.tensor([4, 4, 4, 4, 4, 4, 4], dtype=torch.int32)
    kept = tfrontier.kept_runs_plain(
        t[0], t[1], t[3], t[4], active, torch.tensor([1], dtype=torch.int32),
        EPS2, max_blocks=len(kinds), block_k=128)
    # slot 0 reads the heavy tile; the parked slots that repeat its id
    # keep nothing, so they never write into its rows
    assert int(kept[0].sum()) > tcsr.SEG_RUNS
    assert not kept[1:].any()


# --- (b) the cross query -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assign_call():
    """The cross_sweep call of an assign of 1,000 fresh points padded to a
    bucket of 1,024 (+1e30 rows) against the roadnet2d corpus at
    n = 20,000 (its grid layout, with a seeded payload in place of the
    snapshot's labels): its (q, cands, croot, starts_blk, nblk), ε² and
    kw."""
    name, eps = "roadnet2d", 0.02
    pts = repro_torch.synth.load(name, 20_000, seed=0)
    eng = repro_torch.make_engine(pts, eps, device="cpu")
    spec = eng.meta
    rng = np.random.default_rng(3)
    croot = torch.as_tensor(np.where(rng.uniform(size=spec.n_cand) < 0.5,
                                     rng.integers(0, spec.n, spec.n_cand),
                                     INT_MAX).astype(np.int32))
    fresh = repro_torch.synth.load(name, 1_000, seed=1, structure_seed=0,
                                   structure_n=20_000)
    q = np.concatenate([fresh, np.full((24, 3), 1e30, np.float32)])
    calls = []
    real = tcross.cross_sweep
    try:
        tcross.cross_sweep = lambda *a, **k: calls.append((a, k)) or real(
            *a, **k)
        tnb._csr_cross_query_fn(spec, float(eps) ** 2, spec.slab, 256)(
            eng.state.codes, eng.state.cands, croot, torch.as_tensor(q),
            1_000)
    finally:
        tcross.cross_sweep = real
    (a, k), = calls
    args = tuple(x.reshape(-1).numpy() if i == 2 else x.numpy()
                 for i, x in enumerate(a[:5]))
    return args, float(a[5]), dict(max_blocks=k["max_blocks"],
                                   block_k=k["block_k"])


def _cross_cases():
    yield "assign", _assign_call
    for (dims, bq, bk, e), cid in zip(CULLED, CULLED_IDS):
        def make(dims=dims, bq=bq, bk=bk, eps2=EQ_BELOW[e]):
            args, kinds = culled_layout(dims, bq, bk, seed=dims)
            return (with_padding_tiles(args, bq, bq // 2), eps2,
                    dict(max_blocks=len(kinds), block_k=bk))
        yield f"culled-padded-{cid}", make


CROSS = dict(_cross_cases())


@pytest.mark.parametrize("case", list(CROSS))
def test_cross_kept_sweep_is_the_plain_and_reference_sweep(case):
    args, eps2, kw = CROSS[case]()
    q, cp, croot, st, nb = args
    T = len(st)
    t = [torch.as_tensor(x) for x in args]
    kept = tcsr.kept_runs_plain(t[0], t[1], t[3], t[4], eps2, **kw)
    cut = _kept_sweep(t[0].reshape(T, -1, 3), t[1], t[2], t[3], kept, eps2,
                      block_k=kw["block_k"])
    plain = tcross.cross_sweep_plain(t[0], t[1], t[2][None, :], *t[3:], eps2,
                                     **kw)
    with jax.disable_jit():
        ref = jref.cross_sweep_ref(
            *(jnp.asarray(x) for x in (q, cp, croot[None, :], st, nb)),
            jnp.float32(eps2), **kw)
    for a, b, c, dt in zip(ref, plain, cut, (torch.int32, torch.int32,
                                             torch.float32)):
        assert b.dtype == c.dtype == dt
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)
    counts, minroot, mind2 = plain
    assert counts.sum() > 0 and (minroot != INT_MAX).any()
    assert ((minroot != INT_MAX) == torch.isfinite(mind2)).all()
    # a tile with padding rows keeps every run its real rows keep: its box
    # only grows, and the bound falls with a growing box
    bq = len(q) // T
    pad = np.flatnonzero((q.reshape(T, bq, 3) == np.float32(1e30))
                         .all(-1).any(-1))
    assert len(pad) > 0
    for tile in pad:
        rows = q.reshape(T, bq, 3)[tile]
        real = ~(rows == np.float32(1e30)).all(-1)
        if not real.any():
            continue
        unpadded = np.where(real[:, None], rows, rows[real][0])
        q2 = q.copy().reshape(T, bq, 3)
        q2[tile] = unpadded
        kept2 = tcsr.kept_runs_plain(torch.as_tensor(q2.reshape(-1, 3)),
                                     t[1], t[3], t[4], eps2, **kw)
        assert (kept[tile] | ~kept2[tile]).all()
        assert int(kept[tile].sum()) >= int(kept2[tile].sum())


# --- (c) the mind2 fold ------------------------------------------------------

def _check_bits_min(values):
    v = np.asarray(values, np.float32)
    bits = v.view(np.int32)
    assert (bits >= 0).all()                 # no sign bit: never -0
    # the fold: start at +inf (0x7f800000), atomicMin on the bits
    acc = np.int32(np.float32(np.inf).view(np.int32))
    for b in bits:
        acc = min(acc, b)
    assert np.array_equal(np.int32(acc).view(np.float32),
                          v.min(initial=np.inf))
    # and the order of every pair, not only the min
    i, j = np.triu_indices(len(v), 1)
    np.testing.assert_array_equal(bits[i] < bits[j], v[i] < v[j])
    np.testing.assert_array_equal(bits[i] == bits[j], v[i] == v[j])


try:
    from hypothesis import given, settings, strategies as st
    _HYP = True
except ImportError:  # pragma: no cover - the fixed seeds below instead
    _HYP = False

_TINY = float(np.finfo(np.float32).smallest_subnormal)
_NORMAL = float(np.finfo(np.float32).tiny)
_SPECIAL = [0.0, _TINY, 2 * _TINY, float(np.nextafter(np.float32(_NORMAL),
                                                      np.float32(0))),
            _NORMAL, 1.0, float(np.finfo(np.float32).max), float("inf")]

if _HYP:
    _f32 = st.one_of(
        st.sampled_from(_SPECIAL),
        st.floats(min_value=0.0, max_value=_NORMAL, width=32),  # subnormal
        st.floats(min_value=0.0, allow_infinity=True, width=32))

    @settings(max_examples=300, deadline=None, derandomize=True,
              database=None)
    @given(st.lists(_f32.map(abs), min_size=1, max_size=24))
    def test_int_min_of_nonnegative_f32_bits_is_the_float_min(values):
        _check_bits_min(values)
else:
    @pytest.mark.parametrize("seed", range(60))
    def test_int_min_of_nonnegative_f32_bits_is_the_float_min(seed):
        rng = np.random.default_rng(seed)
        v = rng.choice(_SPECIAL, 8).tolist() + (
            rng.uniform(size=8) * _NORMAL).tolist() + \
            (10.0 ** rng.uniform(-45, 38, 8)).tolist()
        _check_bits_min(v)


def test_a_hit_d2_is_never_negative_zero_or_nan():
    # d² of coincident, opposite-signed-zero and subnormal-gap pairs: a sum
    # of rounded squares, +0 at least, with the sign bit clear
    q = torch.tensor([[0.0, -0.0, 0.0], [1e-30, 0.0, -1e-30],
                      [-1.0, 2.0, -3.0]], dtype=torch.float32)
    c = torch.tensor([[-0.0, 0.0, -0.0], [0.0, -0.0, 0.0], [-1.0, 2.0, -3.0],
                      [np.nan, 0.0, 0.0]], dtype=torch.float32)
    d2 = tref._dist2(q[:, None, :], c[None, :, :])
    hit = d2 <= tref.eps2_tensor(1.0, q.device)
    assert not hit[:, 3].any()               # NaN never hits
    bits = d2[hit].numpy().view(np.int32)
    assert (bits >= 0).all() and (d2[hit] >= 0).all()
