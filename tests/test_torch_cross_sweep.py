"""repro_torch's cross-corpus sweep (plain version, CPU) against the JAX
reference on the same seeded inputs: ``cross_sweep_plain`` against
``repro.kernels.ref.cross_sweep_ref``, ``ops.cross_sweep`` against the
reference's ``ops.cross_sweep``, and ``neighbors._csr_cross_query_fn``
against the reference's on the serving parity cases. All three outputs
(counts, minroot, mind2) and the overflow flag must be bit-identical, the
float ``mind2`` included. Also the device dispatch of the wrapper: a tensor
off the CPU launches the kernel or raises, never the plain version.

The float output is compared with the reference run op by op
(``jax.disable_jit``): compiled, XLA's CPU backend may contract the
reference's ``acc + d * d`` into fused multiply-adds, which moves ``mind2``
by up to 2 ulp from the unfused f32 arithmetic both packages document.
Op by op the reference computes exactly that arithmetic. It is also held
against a numpy brute-force oracle of the same arithmetic."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import neighbors as jnb
from repro.data import synth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import serve as tserve
from repro_torch.core import engines as tengines
from repro_torch.core import neighbors as tnb
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import cross_sweep as tcross
from repro_torch.kernels import ops as tops

INT_MAX = np.iinfo(np.int32).max
SHAPES = [(1, 8, 1, 1), (4, 64, 8, 3), (3, 256, 6, 6), (7, 32, 16, 2)]
EQ_BELOW = (9 / 64, float(np.nextafter(np.float32(9 / 64), np.float32(0))))
EPS, MINPTS = 0.05, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small tensor operations; beside other test
    workers on the same cores, torch's intra-op threads would mostly wait
    for each other. One thread each keeps them fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_cross(T, block_q, nc_blocks, slab_blocks, bk, seed=11):
    """The reference's cross-sweep shape-sweep inputs (tests/test_kernels.py
    ``test_cross_sweep_shapes``): slab starts in blocks."""
    nc = nc_blocks * bk
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (T * block_q, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (nc, 3)).astype(np.float32)
    croot = rng.integers(0, 9999, nc).astype(np.int32)
    croot[rng.uniform(size=nc) < 0.5] = INT_MAX
    starts_blk = rng.integers(0, nc_blocks - slab_blocks + 1, T) \
        .astype(np.int32)
    nblk = rng.integers(0, slab_blocks + 1, T).astype(np.int32)
    return q, np.ascontiguousarray(c.T), croot[None, :], starts_blk, nblk


def _lattice(T, block_q, nc_blocks, bk, seed):
    """Points on the 1/8 lattice, candidates at d² ∈ {8, 9, 10}/64 of
    queries: every d² is exact in f32, many sit at exactly ε² = 9/64."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-16, 17, (T * block_q, 3)).astype(np.float32) / 8
    offs = np.array([(2, 2, 0), (2, 0, 2), (0, 2, 2), (3, 0, 0), (0, 0, 3),
                     (2, 2, 1), (1, 2, 2), (3, 1, 0), (0, 1, 3)], np.float32)
    offs = offs * rng.choice([-1, 1], (len(offs), 3))
    nc = nc_blocks * bk
    c = q[rng.integers(0, len(q), nc)] + offs[rng.integers(0, len(offs),
                                                           nc)] / 8
    croot = rng.integers(0, 9999, nc).astype(np.int32)
    croot[rng.uniform(size=nc) < 0.3] = INT_MAX
    return (q, np.ascontiguousarray(c.T.astype(np.float32)), croot[None, :],
            np.zeros(T, np.int32), np.full(T, nc_blocks, np.int32))


def _both(args, eps2, *, max_blocks, bk):
    """(reference oracle run op by op, port plain version) outputs as
    numpy."""
    with jax.disable_jit():
        r = jref.cross_sweep_ref(*(jnp.asarray(x) for x in args),
                                 jnp.float32(eps2), max_blocks=max_blocks,
                                 block_k=bk)
    p = tcross.cross_sweep_plain(*(torch.as_tensor(x) for x in args), eps2,
                                 max_blocks=max_blocks, block_k=bk)
    return [np.asarray(x) for x in r], [x.numpy() for x in p]


def _assert_same(ref, port):
    for a, b, dt in zip(ref, port, (np.int32, np.int32, np.float32)):
        assert a.dtype == b.dtype == dt
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T,block_q,nc_blocks,slab_blocks", SHAPES)
def test_cross_sweep_plain_matches_reference(T, block_q, nc_blocks,
                                             slab_blocks):
    bk = 128
    args = _mk_cross(T, block_q, nc_blocks, slab_blocks, bk)
    ref, port = _both(args, 0.4, max_blocks=slab_blocks, bk=bk)
    _assert_same(ref, port)
    # the wrapper on CPU tensors is the plain version
    w = tcross.cross_sweep(*(torch.as_tensor(x) for x in args), 0.4,
                           max_blocks=slab_blocks, block_q=block_q,
                           block_k=bk)
    _assert_same(ref, [x.numpy() for x in w])
    # mind2 is a min over the core hits only, and finite exactly there
    assert ((port[1] != INT_MAX) == np.isfinite(port[2])).all()


@pytest.mark.parametrize("eps2", EQ_BELOW)
def test_cross_sweep_plain_exact_boundary(eps2):
    T, bq, ncb, bk = 3, 64, 3, 128
    args = _lattice(T, bq, ncb, bk, seed=7)
    d2 = ((args[0][:, None, :] - args[1].T[None]) ** 2).sum(-1)
    assert (d2 == np.float32(9 / 64)).any()
    ref, port = _both(args, eps2, max_blocks=ncb, bk=bk)
    _assert_same(ref, port)
    np.testing.assert_array_equal(port[0], (d2 <= np.float32(eps2)).sum(1))
    core = args[2][0] != INT_MAX
    exp = np.where((d2 <= np.float32(eps2)) & core[None], d2, np.inf) \
        .min(1).astype(np.float32)
    np.testing.assert_array_equal(port[2], exp)


def test_cross_sweep_plain_empty_tiles_and_no_core_payload():
    bk, T, bq = 128, 5, 32
    q, cp, croot, st, _ = _mk_cross(T, bq, 4, 2, bk, seed=9)
    nblk = np.array([0, 2, 0, 1, 0], np.int32)
    ref, port = _both((q, cp, croot, st, nblk), 0.4, max_blocks=2, bk=bk)
    _assert_same(ref, port)
    rows = np.repeat(nblk == 0, bq)
    assert (port[0][rows] == 0).all() and (port[1][rows] == INT_MAX).all()
    assert np.isposinf(port[2][rows]).all()
    assert (port[0][~rows] > 0).any()
    # an all-INT32_MAX payload: counts unchanged, no label, no distance
    none = np.full_like(croot, INT_MAX)
    ref2, port2 = _both((q, cp, none, st, nblk), 0.4, max_blocks=2, bk=bk)
    _assert_same(ref2, port2)
    np.testing.assert_array_equal(port2[0], port[0])
    assert (port2[1] == INT_MAX).all() and np.isposinf(port2[2]).all()


@pytest.mark.parametrize("T,block_q,nc_blocks,slab_blocks", SHAPES[1:3])
def test_ops_cross_sweep_matches_reference(T, block_q, nc_blocks,
                                           slab_blocks):
    # the ops layer: starts in elements, croot as (nc,), slab capacity
    bk = 128
    q, cp, croot, st, nb = _mk_cross(T, block_q, nc_blocks, slab_blocks, bk)
    kw = dict(slab=slab_blocks * bk, block_q=block_q, block_k=bk)
    starts = st * bk
    with jax.disable_jit():
        r = jops.cross_sweep(jnp.asarray(q), jnp.asarray(cp),
                             jnp.asarray(croot[0]), jnp.asarray(starts),
                             jnp.asarray(nb), 0.4, backend="ref", **kw)
    p = tops.cross_sweep(torch.as_tensor(q), torch.as_tensor(cp),
                         torch.as_tensor(croot[0]), torch.as_tensor(starts),
                         torch.as_tensor(nb), 0.4, **kw)
    _assert_same([np.asarray(x) for x in r], [x.numpy() for x in p])


# --- the cross query of the grid engine -------------------------------------


def _parity_cases():
    """tests/test_serve.py's ``_parity_cases``, same seeds."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (80, 3)).astype(np.float32)
    dup = np.concatenate([base, base, base[:30]])
    spread = (rng.uniform(0, 100, (60, 3)) * np.array([1, 1, 0])) \
        .astype(np.float32)
    return {
        "skewed2d": synth.load("skewed2d", 1200, seed=4),
        "duplicates": dup,
        "n2": np.asarray([[0., 0., 0.], [0.01, 0., 0.]], np.float32),
        "all_noise": spread,
        "blobs": synth.blobs(900, k=4, seed=1),
    }


def _queries(pts, nq, Qp, seed):
    """nq seeded queries around the corpus (planar like it), padded to Qp
    rows with +BIG as the scheduler pads them."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    q = rng.uniform(lo - 2 * EPS, hi + 2 * EPS, (nq, 3)).astype(np.float32)
    # half of them near corpus points, so that many hit core points
    near = rng.integers(0, len(pts), nq // 2)
    q[:nq // 2] = pts[near] + rng.normal(0, EPS / 2, (nq // 2, 3))
    q[:, 2] = pts[0, 2] * 0
    # duplicates: fresh queries share cells (and exact codes) all the time
    q[nq // 2:nq // 2 + 8] = q[:8]
    return np.concatenate([q, np.full((Qp - nq, 3), 1e30, np.float32)])


def _query_both(js, ts, q, nq, *, slab, block_q=256, op_by_op=False):
    eps2 = float(EPS) ** 2
    jf = jnb._csr_cross_query_fn(js.spec, eps2, "ref", slab, block_q)
    if op_by_op:
        with jax.disable_jit():
            r = jf(js.codes, js.cands, js.croot_sorted, jnp.asarray(q),
                   jnp.int32(nq))
    else:
        r = jf(js.codes, js.cands, js.croot_sorted, jnp.asarray(q),
               jnp.int32(nq))
    tf = tnb._csr_cross_query_fn(ts.spec, eps2, slab, block_q)
    p = tf(ts.codes, ts.cands, ts.croot_sorted, torch.as_tensor(q), nq)
    return [np.asarray(x) for x in r], [x.numpy() for x in p]


def _brute_mind2(pts, core, q):
    """Min d² over the core corpus points within ε of each query, +inf
    when none: numpy, unfused f32 (``(a + b) + c`` of rounded squares)."""
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    ch = (d2 <= np.float32(EPS ** 2)) & core[None, :]
    return np.where(ch, d2, np.inf).min(1, initial=np.inf).astype(np.float32)


@pytest.mark.parametrize("name", list(_parity_cases()))
def test_cross_query_matches_reference(name):
    pts = _parity_cases()[name]
    js = jserve.build_snapshot(pts, EPS, MINPTS)
    ts = tserve.build_snapshot(pts, EPS, MINPTS, device="cpu")
    assert ts.spec == tnb.grid_mod.spec_from_fields(vars(js.spec))
    core = ts.core.numpy()
    # a partly filled bucket, and one of two small tiles
    for nq, Qp, block_q in ((137, 256, 256), (77, 128, 64)):
        q = _queries(pts, nq, Qp, seed=nq)
        ref, port = _query_both(js, ts, q, nq, slab=ts.spec.slab,
                                block_q=block_q)
        for a, b in zip(ref[:2], port[:2]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        assert bool(ref[3]) == bool(port[3]) is False
        np.testing.assert_array_equal(port[2][:nq],
                                      _brute_mind2(pts, core, q[:nq]))
        # padded rows never hit a real point
        assert (port[1][nq:] == INT_MAX).all()
        assert np.isposinf(port[2][nq:]).all()


def test_cross_query_mind2_matches_reference_op_by_op():
    pts = _parity_cases()["blobs"]
    js = jserve.build_snapshot(pts, EPS, MINPTS)
    ts = tserve.build_snapshot(pts, EPS, MINPTS, device="cpu")
    q = _queries(pts, 137, 256, seed=5)
    ref, port = _query_both(js, ts, q, 137, slab=ts.spec.slab,
                            op_by_op=True)
    for a, b in zip(ref[:3], port[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert bool(ref[3]) == bool(port[3])
    assert np.isfinite(port[2]).sum() > 30


def test_cross_query_overflow_decision_matches_reference():
    # one block per tile against a skewed corpus at small ε: some query
    # tiles' windows outgrow it, and the overflow flag must agree
    pts = synth.load("skewed2d", 2000, seed=17)
    js = jserve.build_snapshot(pts, 0.005, MINPTS)
    ts = tserve.build_snapshot(pts, 0.005, MINPTS, device="cpu")
    eps2 = 0.005 ** 2
    q = _queries(pts, 512, 512, seed=3)
    seen = set()
    for slab in (ts.spec.block_k, 2 * ts.spec.block_k, ts.spec.slab):
        jf = jnb._csr_cross_query_fn(js.spec, eps2, "ref", slab, 256)
        r = jf(js.codes, js.cands, js.croot_sorted, jnp.asarray(q),
               jnp.int32(512))
        tf = tnb._csr_cross_query_fn(ts.spec, eps2, slab, 256)
        p = tf(ts.codes, ts.cands, ts.croot_sorted, torch.as_tensor(q), 512)
        for a, b in zip(r[:2], p[:2]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert bool(r[3]) == bool(p[3])
        seen.add(bool(p[3]))
    assert seen == {True, False}


def test_engine_query_capability():
    pts = synth.blobs(600, k=3, seed=2)
    assert "query" in tengines.get_engine_spec("grid").capabilities
    for name in ("grid-hash", "brute"):
        assert "query" not in tengines.get_engine_spec(name).capabilities
    eng = tnb.make_engine(pts, EPS, device="cpu")
    ts = tserve.build_snapshot(pts, EPS, MINPTS, device="cpu")
    q = _queries(pts, 200, 256, seed=8)
    got = eng.query(eng.state, torch.as_tensor(q), 200, ts.croot_sorted)
    exp = tnb._csr_cross_query_fn(ts.spec, EPS ** 2, ts.spec.slab, 256)(
        ts.codes, ts.cands, ts.croot_sorted, torch.as_tensor(q), 200)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert tnb.make_engine(pts, EPS, engine="brute", device="cpu").query \
        is None


# --- device dispatch --------------------------------------------------------


def _meta_call():
    q, cp, croot, st, nb = (torch.as_tensor(x).to("meta")
                            for x in _mk_cross(4, 64, 8, 3, 128))
    return lambda: tcross.cross_sweep(q, cp, croot, st, nb, 0.4,
                                      max_blocks=3, block_q=64, block_k=128)


def test_cpu_calls_do_not_count_launches_and_bad_inputs_raise():
    tcross.reset_launches()
    args = [torch.as_tensor(x) for x in _mk_cross(4, 64, 8, 3, 128)]
    tcross.cross_sweep(*args, 0.4, max_blocks=3, block_q=64, block_k=128)
    assert tcross.LAUNCHES == {"cross_sweep": 0}
    with pytest.raises(ValueError, match="not meta"):
        _meta_call()()
    with pytest.raises(ValueError, match="croot"):
        tcross.cross_sweep(args[0], args[1], args[2][0], *args[3:], 0.4,
                           max_blocks=3, block_q=64, block_k=128)
    with pytest.raises(TypeError, match="float32"):
        tcross.cross_sweep(args[0].double(), *args[1:], 0.4, max_blocks=3,
                           block_q=64, block_k=128)


def _c_params(fn: str) -> list:
    """Parameter types of ``fn`` in csrc/csr_sweep.cu, as launch letters."""
    src = (tbuild.CSRC_DIR / "csr_sweep.cu").read_text()
    decl = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    out = []
    for p in decl.split(","):
        p = p.strip()
        out.append("p" if "*" in p else "f" if p.startswith("float")
                   else "i")
    return out


def test_cuda_tensors_launch_or_raise_never_plain(monkeypatch):
    # with the device check passed (as a CUDA tensor passes it), the
    # wrapper goes to its kernel's launcher with the C function's signature
    def boom(*a, **k):
        raise AssertionError("plain version called on a device tensor")
    monkeypatch.setattr(tcross, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tcross, "cross_sweep_plain", boom)
    monkeypatch.setattr(tcross, "_sweep_plain", boom)
    launched = []

    def refuse(lib, fn, sig, kernel, device, *args):
        launched.append((lib, fn, sig, kernel, len(args)))
        raise RuntimeError(f"{kernel} launch failed: CUDA error 209")
    monkeypatch.setattr(tbuild, "launch", refuse)
    with pytest.raises(RuntimeError, match="cross_sweep launch failed"):
        _meta_call()()
    lib, fn, sig, kernel, n_args = launched[0]
    assert (lib, fn, kernel) == ("csr_sweep", "cross_sweep_launch",
                                 "cross_sweep")
    assert n_args == len(sig)
    # device first and stream last, as build.launch passes them
    assert ["i", *sig, "p"] == _c_params("cross_sweep_launch")
    assert tcross.LAUNCHES == {"cross_sweep": 0}

    monkeypatch.undo()
    monkeypatch.setattr(tcross, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tbuild.shutil, "which", lambda _: None)
    monkeypatch.setattr(tbuild.os.path, "exists", lambda _: False)
    monkeypatch.setattr(tbuild.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _meta_call()()
