"""repro_torch's LBVH build (``kernels/lbvh.py``, plain versions, CPU)
against the JAX reference's jitted ``build_bvh`` and ``max_leaf_depth``
(``src/repro/core/bvh.py``, jnp, no Pallas) on the same seeded points:
``lbvh_keys_plain`` equal to ``ref.morton_encode_ref`` of the reference's
quantization; ``lbvh_nodes_plain``'s children and leaf ranges,
``lbvh_refit_plain``'s sorted points, order and boxes and
``lbvh_depth_plain`` equal to the reference's fields, floats bitwise
(int32 views, so -0.0 and +0.0 differ); ``parent`` consistent with the
children; the whole ``build_bvh``. Cases (``cull_layouts.lbvh_cases``):
n = 2, 3, 5, 1,023, 4,097; 2-D in (n, 3) and in (n, 2), 3-D, 4-D; all
points equal; heavy duplicates; +1e30 sentinels under a ``lo``/``hi``
override; coordinates holding both signed zeros. Also ``_infer_dims`` on
the points' device against ``infer_dims``, and the wrappers' device
dispatch: a tensor off the CPU launches the kernel or raises, never the
plain version."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cull_layouts import lbvh_cases
from repro.core import bvh as jbvh
from repro.core import neighbors as jnb
from repro.kernels import ref as jref
from repro_torch import dbscan
from repro_torch.core import bvh as tbvh
from repro_torch.core import neighbors as tnb
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import lbvh as tlbvh

# the reference's build compiled as one program, as its engines build it
jbuild = jax.jit(jbvh.build_bvh, static_argnames=("dims",))
CASES = lbvh_cases()
IDS = [c[0] for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: beside the other test workers on the
    same cores, torch's intra-op threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _ref_keys(pts, dims, lo, hi) -> np.ndarray:
    """The reference's quantization (``src/repro/core/bvh.py`` build_bvh,
    before its ``morton_encode``) and ``ref.morton_encode_ref``."""
    p = jnp.asarray(pts)
    lo = p.min(axis=0) if lo is None else jnp.asarray(lo)
    hi = p.max(axis=0) if hi is None else jnp.asarray(hi)
    scale = jnp.where(hi > lo, 1023.0 / (hi - lo), 0.0)
    q = jnp.clip(((p - lo) * scale), 0, 1023).astype(jnp.int32)
    q3 = jnp.pad(q, ((0, 0), (0, 3 - q.shape[1]))) if q.shape[1] < 3 \
        else q[:, :3]
    return np.asarray(jref.morton_encode_ref(q3, dims=min(dims, 3)))


def _ref_build(pts, dims, lo, hi):
    kw = {} if lo is None else dict(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    return jbuild(jnp.asarray(pts), dims=dims, **kw)


def _plain_build(pts, dims, lo, hi):
    """(codes, nodes, refit) of the plain versions, in build_bvh's order."""
    t = torch.as_tensor(pts)
    lo_t = t.amin(0) if lo is None else torch.as_tensor(lo)
    hi_t = t.amax(0) if hi is None else torch.as_tensor(hi)
    codes = tlbvh.lbvh_keys_plain(t, lo_t, hi_t, dims=min(dims, 3))
    sorted_codes, order = torch.sort(codes, stable=True)
    nodes = tlbvh.lbvh_nodes_plain(sorted_codes)
    return codes, nodes, tlbvh.lbvh_refit_plain(t, order, nodes)


def _assert_parent(nodes, n):
    parent = nodes.parent.numpy()
    assert parent.shape == (2 * n - 1,) and parent[0] == -1
    ids = np.arange(n - 1)
    np.testing.assert_array_equal(parent[nodes.left.numpy()], ids)
    np.testing.assert_array_equal(parent[nodes.right.numpy()], ids)
    # every node but the root is exactly one node's child
    kids = np.concatenate([nodes.left.numpy(), nodes.right.numpy()])
    np.testing.assert_array_equal(np.sort(kids), np.arange(1, 2 * n - 1))


@pytest.mark.parametrize("name,pts,dims,lo,hi", CASES, ids=IDS)
def test_keys_plain_is_the_reference_quantization(name, pts, dims, lo, hi):
    codes, _, _ = _plain_build(pts, dims, lo, hi)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), _ref_keys(pts, dims, lo, hi))


@pytest.mark.parametrize("name,pts,dims,lo,hi", CASES, ids=IDS)
def test_nodes_and_refit_plain_are_the_reference_build(name, pts, dims, lo,
                                                       hi):
    r = _ref_build(pts, dims, lo, hi)
    _, nodes, fit = _plain_build(pts, dims, lo, hi)
    got = dict(nodes._asdict(), **fit._asdict())
    for f in tbvh.BVH._fields:
        a, b = np.asarray(getattr(r, f)), got[f].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    n = len(pts)
    _assert_parent(nodes, n)
    assert not nodes.arrivals.any()
    depth = tlbvh.lbvh_depth_plain(nodes.left, nodes.right)
    assert depth.dtype == torch.int32 and depth.shape == (1,)
    assert int(depth[0]) == int(jbvh.max_leaf_depth(r.left, r.right))


@pytest.mark.parametrize("name,pts,dims,lo,hi", CASES, ids=IDS)
def test_build_bvh_is_the_reference_build(name, pts, dims, lo, hi):
    tlbvh.reset_launches()
    r = _ref_build(pts, dims, lo, hi)
    p = tbvh.build_bvh(torch.as_tensor(pts), dims=dims, lo=lo, hi=hi)
    for f in tbvh.BVH._fields:
        a, b = np.asarray(getattr(r, f)), getattr(p, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    assert tbvh.max_leaf_depth(p.left, p.right) == \
        int(jbvh.max_leaf_depth(r.left, r.right))
    assert set(tlbvh.LAUNCHES.values()) == {0}


def test_signed_zero_rule_is_the_references():
    # the plain min / max take -0 below +0 in either argument order, as
    # jnp.minimum / jnp.maximum do; torch.minimum returns its first
    # argument where the two compare equal
    vals = np.float32([-0.0, 0.0, 1.0, -1.0, 2.5])
    a, b = (x.ravel() for x in np.meshgrid(vals, vals))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for ours, ref in ((tlbvh.min_signed_zero, jnp.minimum),
                      (tlbvh.max_signed_zero, jnp.maximum)):
        np.testing.assert_array_equal(
            _bits(ours(ta, tb).numpy()),
            _bits(ref(jnp.asarray(a), jnp.asarray(b))))
    first = torch.minimum(torch.tensor([0.0]), torch.tensor([-0.0]))
    assert _bits(first.numpy())[0] == 0      # +0: order-dependent


def test_signed_zero_smallest_input_is_the_references():
    # +0.0 then -0.0 under one code: the stable sort keeps that order, and
    # a first-argument minimum would give the root box +0.0 where the
    # reference gives -0.0
    pts = np.array([[0.0, 0, 0], [-0.0, 0, 0]], np.float32)
    r = _ref_build(pts, 3, None, None)
    p = tbvh.build_bvh(torch.as_tensor(pts), dims=3)
    assert np.signbit(np.asarray(r.box_lo)[0, 0])
    for f in ("box_lo", "box_hi"):
        np.testing.assert_array_equal(_bits(np.asarray(getattr(r, f))),
                                      _bits(getattr(p, f).numpy()))


def test_signed_zero_case_meets_both_zeros_in_a_box():
    # the case the bitwise box comparisons rely on: some node's range
    # holds -0.0 and +0.0 and nothing below (above) them, so its box_lo x
    # (box_hi y) is a zero whose sign the rule decides
    name, pts, dims, lo, hi = next(c for c in CASES if c[0] == "signed-zero")
    r = _ref_build(pts, dims, lo, hi)
    ps = np.asarray(r.pts_sorted)
    first, last = np.asarray(r.first), np.asarray(r.last)
    neg = np.signbit(ps) & (ps == 0)
    pos = ~np.signbit(ps) & (ps == 0)
    both = [k for k in range(len(first))
            if neg[first[k]:last[k] + 1, 0].any()
            and pos[first[k]:last[k] + 1, 0].any()
            and (ps[first[k]:last[k] + 1, 0] >= 0).all()]
    assert both
    assert (_bits(np.asarray(r.box_lo))[both, 0] == np.int32(-2**31)).all()


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("z", ["zero", "negzero", "mixed", "nan", "nonzero"])
def test_infer_dims_on_device_is_infer_dims(z, d):
    rng = np.random.default_rng(d)
    pts = rng.uniform(-1, 1, (9, d)).astype(np.float32)
    if d >= 3:
        pts[:, 2] = {"zero": 0.0, "negzero": -0.0, "nonzero": 0.5,
                     "mixed": 0.0, "nan": 0.0}[z]
        if z == "mixed":
            pts[::2, 2] = -0.0
        if z == "nan":
            pts[4, 2] = np.nan
    want = jnb.infer_dims(pts)
    assert tnb.infer_dims(pts) == want
    assert tbvh._infer_dims(torch.as_tensor(pts)) == want


def test_cpu_run_launches_no_lbvh_kernel():
    tlbvh.reset_launches()
    pts = CASES[5][1]
    for engine in ("bvh", "bvh-stack"):
        dbscan(pts, 0.1, 5, engine=engine, device="cpu")
    assert tlbvh.LAUNCHES == {"lbvh_keys": 0, "lbvh_nodes": 0,
                              "lbvh_refit": 0, "lbvh_depth": 0}


# --- device dispatch ---------------------------------------------------------


def _inputs(device):
    pts = torch.as_tensor(CASES[5][1]).to(device)
    n = pts.shape[0]
    i32 = dict(dtype=torch.int32, device=device)
    nodes = tlbvh.Nodes(*(torch.zeros(m, **i32)
                          for m in (n - 1,) * 4 + (2 * n - 1, n - 1)))
    return pts, n, nodes


def _calls(device):
    """Each wrapper called on tensors of ``device``."""
    pts, n, nodes = _inputs(device)
    lo = torch.zeros(3, dtype=torch.float32, device=device)
    order = torch.zeros(n, dtype=torch.int64, device=device)
    codes = torch.zeros(n, dtype=torch.int32, device=device)
    return {
        "lbvh_keys": lambda: tlbvh.lbvh_keys(pts, lo, lo, dims=3),
        "lbvh_nodes": lambda: tlbvh.lbvh_nodes(codes),
        "lbvh_refit": lambda: tlbvh.lbvh_refit(pts, order, nodes),
        "lbvh_depth": lambda: tlbvh.lbvh_depth(nodes.left, nodes.right),
    }


def _c_params(fn: str) -> list:
    """Parameter types of ``fn`` in csrc/lbvh.cu, as launch letters."""
    src = (tbuild.CSRC_DIR / "lbvh.cu").read_text()
    decl = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    return ["p" if "*" in p else "f" if p.strip().startswith("float")
            else "i" for p in decl.split(",")]


def test_cpu_calls_do_not_count_launches_and_bad_inputs_raise():
    tlbvh.reset_launches()
    for call in _calls("cpu").values():
        call()
    assert set(tlbvh.LAUNCHES.values()) == {0}
    for call in _calls("meta").values():
        with pytest.raises(ValueError, match="not meta"):
            call()
    pts, n, nodes = _inputs("cpu")
    lo = torch.zeros(3)
    with pytest.raises(TypeError, match="points"):
        tlbvh.lbvh_keys(pts.double(), lo, lo)
    with pytest.raises(ValueError, match=r"\(D,\)"):
        tlbvh.lbvh_keys(pts, lo[:2], lo)
    with pytest.raises(ValueError, match="contiguous"):
        tlbvh.lbvh_keys(pts.T.contiguous().T, lo, lo)
    with pytest.raises(ValueError, match="2 <= n"):
        tlbvh.lbvh_nodes(torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="codes"):
        tlbvh.lbvh_nodes(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError, match="order"):
        tlbvh.lbvh_refit(pts, torch.zeros(n, dtype=torch.int32), nodes)
    with pytest.raises(ValueError, match="2n - 1"):
        tlbvh.lbvh_refit(pts[:-1], torch.zeros(n - 1, dtype=torch.int64),
                         nodes)
    with pytest.raises(ValueError, match="right"):
        tlbvh.lbvh_depth(nodes.left, nodes.right[:-1])


def test_device_tensors_launch_or_raise_never_plain(monkeypatch):
    # with the device check passed (as a CUDA tensor passes it), each
    # wrapper goes to its kernel's launcher with the C function's
    # signature; a launch error, or a kernel that cannot build, raises; no
    # plain version is ever called
    def boom(*a, **k):
        raise AssertionError("plain version called on a device tensor")
    monkeypatch.setattr(tlbvh, "_cuda_or_raise", lambda x, kernel: None)
    for name in ("lbvh_keys_plain", "lbvh_nodes_plain", "lbvh_refit_plain",
                 "lbvh_depth_plain", "morton_encode_ref",
                 "range_table_query"):
        monkeypatch.setattr(tlbvh, name, boom)
    launched = []

    def refuse(lib, fn, sig, kernel, device, *args):
        launched.append((lib, fn, sig, kernel, len(args)))
        raise RuntimeError(f"{kernel} launch failed: CUDA error 209")
    monkeypatch.setattr(tbuild, "launch", refuse)
    calls = _calls("meta")
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} launch failed"):
            call()
    assert [x[3] for x in launched] == list(calls)
    for lib, fn, sig, kernel, n_args in launched:
        assert lib == "lbvh" and fn == f"{kernel}_launch"
        assert n_args == len(sig)
        # device first and stream last, as build.launch passes them
        assert ["i", *sig, "p"] == _c_params(fn)
    assert set(tlbvh.LAUNCHES.values()) == {0}

    monkeypatch.undo()
    monkeypatch.setattr(tlbvh, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tbuild.shutil, "which", lambda _: None)
    monkeypatch.setattr(tbuild.os.path, "exists", lambda _: False)
    monkeypatch.setattr(tbuild.Path, "exists", lambda self: False)
    for call in calls.values():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
