"""repro_torch's BVH kernels (plain versions, CPU) against the JAX
reference on the same seeded inputs: ``morton_encode`` and
``bvh_batch_sweep`` against ``repro.kernels.ref`` and against the Pallas
kernels run in interpret mode (``ops.*(backend="interpret")``), every
output bit-identical; the d² = ε² lattice held to numpy's unfused f32;
``_bf16_directed`` bitwise on special values. Also the device dispatch of
the two wrappers: a tensor off the CPU launches the kernel or raises, never
the plain version."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bvh as jbvh
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bvh as tbvh
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import bvh_sweep as tsweep
from repro_torch.kernels import morton as tmorton
from repro_torch.kernels import ops as tops

INT_MAX = np.iinfo(np.int32).max
EQ_BELOW = (9 / 64, float(np.nextafter(np.float32(9 / 64), np.float32(0))))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: beside the other test workers on the
    same cores, torch's intra-op threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- morton_encode -----------------------------------------------------------


def _coords(n, hi, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, hi, (n, 3)).astype(np.int32)
    edge = [[0, 0, 0], [hi - 1] * 3, [hi - 1, 0, 0], [0, hi - 1, 0],
            [0, 0, hi - 1], [hi, hi + 1, 2 * hi + 3],     # above the mask
            [-1, -hi, 7]]                                  # negative
    m = min(n, len(edge))
    c[:m] = np.asarray(edge[:m], np.int32)
    return c


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("n", [1, 5, 1024, 1500])
def test_morton_encode_matches_reference_and_interpret(dims, n):
    hi = 1 << 15 if dims == 2 else 1 << 10
    c = _coords(n, hi, seed=n + dims)
    r = np.asarray(jref.morton_encode_ref(jnp.asarray(c), dims=dims))
    k = np.asarray(jops.morton_encode(jnp.asarray(c), dims=dims,
                                      backend="interpret"))
    t = torch.as_tensor(c)
    for p in (tmorton.morton_encode(t, dims=dims),
              tmorton.morton_encode_plain(t, dims=dims),
              tops.morton_encode(t.to(torch.int64), dims=dims)):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(r, p.numpy())
        np.testing.assert_array_equal(k, p.numpy())


# --- bvh_batch_sweep ---------------------------------------------------------


def _entries(e, dims, seed=6, B=8):
    """The reference's ragged shape-sweep inputs (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (e, B, dims)).astype(np.float32)
    a = rng.uniform(-1, 1, (e, dims)).astype(np.float32)
    b = a + rng.uniform(0, 0.5, (e, dims)).astype(np.float32)
    leaf = (rng.uniform(size=e) < 0.5).astype(np.int32)
    eps = 0.25
    dlo = (np.minimum(a, b) - eps).astype(np.float32)
    dhi = (np.maximum(a, b) + eps).astype(np.float32)
    croot = rng.integers(0, 9999, e).astype(np.int32)
    nmin = rng.integers(0, 9999, e).astype(np.int32)
    bound = rng.integers(0, 9999, (e, B)).astype(np.int32)
    return (q, dlo, dhi, a, croot, nmin, leaf, bound), eps * eps


def _three(args, eps2, **kw):
    """(reference oracle, interpret-mode kernel, port plain, port ops)."""
    j = [jnp.asarray(x) for x in args]
    t = [torch.as_tensor(x) for x in args]
    return ([np.asarray(x) for x in jops.bvh_batch_sweep(
                *j, eps2, backend="ref", **kw)],
            [np.asarray(x) for x in jops.bvh_batch_sweep(
                *j, eps2, backend="interpret", **kw)],
            [x.numpy() for x in tsweep.bvh_batch_sweep_plain(*t, eps2, **kw)],
            [x.numpy() for x in tops.bvh_batch_sweep(*t, eps2, **kw)])


def _assert_all_same(results):
    first = results[0]
    for other in results[1:]:
        for a, b in zip(first, other):
            assert b.dtype == np.int32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", [2, 3, 6])
@pytest.mark.parametrize("e", [1, 5, 129, 256, 300])
def test_bvh_batch_sweep_plain_matches_reference(e, dims):
    args, eps2 = _entries(e, dims)
    for payload in (False, True):
        for bf16 in (False, True):
            _assert_all_same(_three(args, eps2, prune_payload=payload,
                                    bf16_prune=bf16))


@pytest.mark.parametrize("dims", [2, 3, 6])
def test_bvh_batch_sweep_takes_bf16_boxes_and_no_payload_inputs(dims):
    # boxes stored as bf16 (as the engine keeps them) give the outputs of
    # the same boxes widened to f32; without prune_payload, nmin and bound
    # may be None and give the outputs of any placeholder arrays
    args, eps2 = _entries(129, dims)
    t = [torch.as_tensor(x) for x in args]
    t[1] = tbvh._bf16_directed(t[1], up=False)
    t[2] = tbvh._bf16_directed(t[2], up=True)
    wide = [x.float() if x.dtype == torch.bfloat16 else x for x in t]
    oracle = _three([x.numpy() for x in wide], eps2, bf16_prune=True,
                    prune_payload=False)[0]
    _assert_all_same([oracle] + [
        [x.numpy() for x in f(*a, eps2, bf16_prune=True)]
        for f in (tsweep.bvh_batch_sweep, tsweep.bvh_batch_sweep_plain,
                  tops.bvh_batch_sweep)
        for a in (t, t[:5] + [None, t[6], None])])
    for payload in (False, True):
        _assert_all_same([
            [x.numpy() for x in tsweep.bvh_batch_sweep(
                *a, eps2, prune_payload=payload)] for a in (t, wide)])
    with pytest.raises(ValueError, match="needs nmin and bound"):
        tsweep.bvh_batch_sweep(*t[:5], None, t[6], None, eps2,
                               prune_payload=True)
    with pytest.raises(TypeError, match="dhi"):
        tsweep.bvh_batch_sweep(t[0], t[1], wide[2], *t[3:], eps2)


def test_bvh_batch_sweep_bf16_prune_queries_one_ulp_from_an_edge():
    # queries a fraction of a bf16 ulp either side of a bf16 box's lower
    # edge (entry e at offset OFF[e % 8]): the f32 prune decides by the
    # sign of the offset, the bf16 prune by the query's round to nearest,
    # identically in every version
    e, B = 64, 8
    rng = np.random.default_rng(3)
    lo = rng.uniform(-2, 2, (e, 3)).astype(np.float32)
    lo = torch.as_tensor(lo).to(torch.bfloat16).to(torch.float32).numpy()
    hi = lo + np.float32(0.5)
    ulp = np.ldexp(np.float32(1), np.frexp(lo[:, 0])[1] - 8) \
        .astype(np.float32)
    off = np.array([-1, -0.5, -0.25, 0, 0.25, 0.5, 1, 2], np.float32)[
        np.arange(e) % 8]
    q = np.repeat(((lo + hi) / 2)[:, None, :], B, axis=1).astype(np.float32)
    q[:, :, 0] = (lo[:, 0] + off * ulp)[:, None]
    args = (q, lo, hi, lo, np.arange(e, dtype=np.int32),
            np.zeros(e, np.int32), np.zeros(e, np.int32),
            np.ones((e, B), np.int32))
    pushes = {}
    for bf16 in (False, True):
        results = _three(args, 0.01, bf16_prune=bf16, prune_payload=False)
        _assert_all_same(results)
        pushes[bf16] = results[0][2].astype(bool)
    np.testing.assert_array_equal(pushes[False], off >= 0)
    assert (pushes[True] >= pushes[False]).all()
    assert pushes[True].sum() > pushes[False].sum()


def test_bvh_batch_sweep_dead_entries_never_hit_or_push():
    # the reference's dead-entry encoding: box lo +BIG, hi -BIG, query
    # -BIG, payload INT32_MAX, leaf 0
    args, eps2 = _entries(40, 3, seed=9)
    q, dlo, dhi, pt, croot, nmin, leaf, bound = (x.copy() for x in args)
    dead = np.arange(40) % 3 == 0
    q[dead], dlo[dead], dhi[dead] = -1e30, 1e30, -1e30
    croot[dead], nmin[dead], leaf[dead] = INT_MAX, INT_MAX, 0
    args = (q, dlo, dhi, pt, croot, nmin, leaf, bound)
    for payload in (False, True):
        for bf16 in (False, True):
            results = _three(args, eps2, prune_payload=payload,
                             bf16_prune=bf16)
            _assert_all_same(results)
            hit, mr, push = results[2]
            assert not hit[dead].any() and not push[dead].any()
            assert (mr[dead] == INT_MAX).all()


@pytest.mark.parametrize("eps2", EQ_BELOW)
def test_bvh_batch_sweep_plain_exact_boundary(eps2):
    # leaf points on the 1/8 lattice at d² ∈ {8, 9, 10}/64 of their queries:
    # every d² is exact in f32 and many sit at exactly ε² = 9/64
    rng = np.random.default_rng(5)
    e, B = 300, 8
    q = rng.integers(-16, 17, (e, B, 3)).astype(np.float32) / 8
    offs = np.array([(2, 2, 0), (2, 0, 2), (0, 2, 2), (3, 0, 0), (0, 0, 3),
                     (2, 2, 1), (1, 2, 2), (3, 1, 0)], np.float32) / 8
    pt = (q[:, 0] + offs[rng.integers(0, len(offs), e)]).astype(np.float32)
    q[:, 1:] = q[:, :1] + (rng.integers(-1, 2, (e, B - 1, 3)) / 8)
    q = q.astype(np.float32)
    leaf = np.ones(e, np.int32)
    args = (q, pt - 1, pt + 1, pt, rng.integers(0, 99, e).astype(np.int32),
            np.zeros(e, np.int32), leaf, np.zeros((e, B), np.int32))
    d2 = np.zeros((e, B), np.float32)          # numpy's unfused f32
    for k in range(3):
        d = (q[:, :, k] - pt[:, None, k]).astype(np.float32)
        d2 = (d2 + (d * d).astype(np.float32)).astype(np.float32)
    assert (d2 == np.float32(9 / 64)).sum() > 10
    hit = (d2 <= np.float32(eps2)).astype(np.int32)
    for bf16 in (False, True):
        t = [torch.as_tensor(x) for x in args]
        p = tsweep.bvh_batch_sweep_plain(*t, eps2, bf16_prune=bf16)
        np.testing.assert_array_equal(p[0].numpy(), hit)
        k = jops.bvh_batch_sweep(*[jnp.asarray(x) for x in args], eps2,
                                 bf16_prune=bf16, backend="interpret")
        np.testing.assert_array_equal(np.asarray(k[0]), hit)


# --- _bf16_directed ----------------------------------------------------------


def _special_values():
    tiny = np.finfo(np.float32).tiny
    sub = np.array([1, 2, 3, 0x7F, 0x80, 0x81, 0xFFFF, 0x10000, 0x7FFFFF],
                   np.uint32).view(np.float32)
    rep = np.array([1.0, 1.0078125, 0.5, 2.0 ** -126, 2.0 ** -133, 3.0,
                    65280.0], np.float32)
    rng = np.random.default_rng(0)
    rand = (rng.standard_normal(2000) *
            10.0 ** rng.integers(-44, 38, 2000)).astype(np.float32)
    vals = np.concatenate([[0.0, tiny, 1e-45, 1e30, 3.0e38], sub, rep,
                           np.nextafter(rep, np.float32(np.inf)),
                           np.nextafter(rep, np.float32(0)), rand])
    vals = np.concatenate([vals, -vals, [-0.0]]).astype(np.float32)
    return vals


def _directed_oracle(x, up):
    """bf16 rounding of f32 ``x`` toward +inf (``up``) or -inf, from the
    bits: truncation is rounding toward zero; an inexact value moves one
    bf16 ulp away from zero when that is the asked direction."""
    bits = x.view(np.uint32)
    trunc = bits & np.uint32(0xFFFF0000)
    inexact = trunc != bits
    neg = (bits >> 31) == 1
    away = inexact & (neg != up)
    return np.where(away, trunc + np.uint32(0x10000), trunc) \
        .astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("up", [False, True])
def test_bf16_directed_matches_reference_bitwise(up):
    # bitwise against the reference on ±0, the smallest normals, values
    # already representable in bf16 and one f32 ulp either side, negative
    # values and large magnitudes; and against an exact oracle of directed
    # rounding on every value, f32 subnormals included. On subnormal
    # inputs the reference's XLA:CPU comparisons flush them to zero, so it
    # is held there to neither (ROADMAP §3).
    x = _special_values()
    p = tbvh._bf16_directed(torch.as_tensor(x), up=up)
    assert p.dtype == torch.bfloat16
    p = p.to(torch.float32).numpy()
    np.testing.assert_array_equal(p.view(np.uint32),
                                  _directed_oracle(x, up).view(np.uint32))
    r = np.asarray(jbvh._bf16_directed(jnp.asarray(x), up=up)
                   .astype(jnp.float32))
    normal = (np.abs(x) >= np.finfo(np.float32).tiny) | (x == 0)
    assert normal.sum() > 2000 and (~normal).sum() > 20
    np.testing.assert_array_equal(r[normal].view(np.uint32),
                                  p[normal].view(np.uint32))


# --- device dispatch ---------------------------------------------------------


def _meta_calls():
    """Each new wrapper called on tensors that are not on the CPU."""
    args, eps2 = _entries(16, 3)
    meta = [torch.as_tensor(x).to("meta") for x in args]
    coords = torch.zeros((10, 3), dtype=torch.int32, device="meta")
    return {
        "bvh_batch_sweep": lambda: tsweep.bvh_batch_sweep(*meta, eps2),
        "morton_encode": lambda: tmorton.morton_encode(coords, dims=3),
    }


def _c_params(fn: str) -> list:
    """Parameter types of ``fn`` in csrc/bvh_sweep.cu, as launch letters."""
    src = (tbuild.CSRC_DIR / "bvh_sweep.cu").read_text()
    decl = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    return ["p" if "*" in p else "f" if p.strip().startswith("float")
            else "i" for p in decl.split(",")]


def test_cpu_calls_do_not_count_launches_and_bad_inputs_raise():
    tsweep.reset_launches()
    tmorton.reset_launches()
    args, eps2 = _entries(16, 3)
    t = [torch.as_tensor(x) for x in args]
    tsweep.bvh_batch_sweep(*t, eps2)
    tmorton.morton_encode(torch.zeros((4, 3), dtype=torch.int32))
    assert tsweep.LAUNCHES == {"bvh_batch_sweep": 0, "bvh_level": 0}
    assert tmorton.LAUNCHES == {"morton_encode": 0}
    for call in _meta_calls().values():
        with pytest.raises(ValueError, match="not meta"):
            call()
    with pytest.raises(TypeError, match="bound"):
        tsweep.bvh_batch_sweep(*t[:7], t[7].to(torch.int64), eps2)
    with pytest.raises(ValueError, match="dhi"):
        tsweep.bvh_batch_sweep(t[0], t[1], t[2][:3], *t[3:], eps2)
    d9 = [torch.zeros((2, 8, 9))] + [torch.zeros((2, 9))] * 3 + \
        [torch.zeros(2, dtype=torch.int32)] * 3 + \
        [torch.zeros((2, 8), dtype=torch.int32)]
    with pytest.raises(ValueError, match="D <= 8"):
        tsweep.bvh_batch_sweep(*d9, eps2)
    with pytest.raises(ValueError, match="contiguous"):
        tsweep.bvh_batch_sweep(t[0].transpose(0, 1).contiguous()
                               .transpose(0, 1), *t[1:], eps2)
    with pytest.raises(TypeError, match="int32"):
        tmorton.morton_encode(torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        tmorton.morton_encode(torch.zeros((4, 2), dtype=torch.int32))


def test_device_tensors_launch_or_raise_never_plain(monkeypatch):
    # with the device check passed (as a CUDA tensor passes it), each
    # wrapper goes to its kernel's launcher with the C function's
    # signature; a launch error, or a kernel that cannot build, raises; no
    # plain version is ever called
    def boom(*a, **k):
        raise AssertionError("plain version called on a device tensor")
    for mod in (tsweep, tmorton):
        monkeypatch.setattr(mod, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tsweep, "bvh_batch_sweep_plain", boom)
    monkeypatch.setattr(tmorton, "morton_encode_plain", boom)
    monkeypatch.setattr(tmorton, "morton_encode_ref", boom)
    launched = []

    def refuse(lib, fn, sig, kernel, device, *args):
        launched.append((lib, fn, sig, kernel, len(args)))
        raise RuntimeError(f"{kernel} launch failed: CUDA error 209")
    monkeypatch.setattr(tbuild, "launch", refuse)
    calls = _meta_calls()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} launch failed"):
            call()
    assert [x[3] for x in launched] == list(calls)
    for lib, fn, sig, kernel, n_args in launched:
        assert lib == "bvh_sweep" and fn == f"{kernel}_launch"
        assert n_args == len(sig)
        # device first and stream last, as build.launch passes them
        assert ["i", *sig, "p"] == _c_params(fn)
    assert tsweep.LAUNCHES == {"bvh_batch_sweep": 0, "bvh_level": 0}
    assert tmorton.LAUNCHES == {"morton_encode": 0}

    monkeypatch.undo()
    for mod in (tsweep, tmorton):
        monkeypatch.setattr(mod, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tbuild.shutil, "which", lambda _: None)
    monkeypatch.setattr(tbuild.os.path, "exists", lambda _: False)
    monkeypatch.setattr(tbuild.Path, "exists", lambda self: False)
    for call in calls.values():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
