"""The CSR layout's window bounds (``kernels/csr_layout.py``): per query
cell, the ``[lo, hi)`` range of the code-sorted corpus that covers the
occupied cells of its 9 / 27 window.

On the CPU: the plain version (the reference's loop over the offsets) equals
a brute-force numpy oracle and the reference's own ``_csr_window_bounds``
on edge layouts: cells at 0 and at ``2^bits - 2``, padding rows at
``2^bits - 1`` (the distributed driver's), 2-D cells with a nonzero z
column, windows with no occupied cell, a corpus of one code, more queries
than corpus points and fewer, an empty corpus. A CPU tensor takes the plain
path and launches nothing; any device but the CPU and CUDA raises.

On the card (marked ``cuda``; they skip, with their reason, where torch sees
no CUDA device): the kernel equals the plain version on the same CUDA
tensors, on the edge layouts and at the benchmark's three sizes (roadnet2d
434,874, iono3d 1M, a 2M taxi2d stand-in for Porto), and each caller
(``plan_and_build_csr_grid``, the serving tier's cross query, the
distributed driver's CSR engine on padded candidates) gives the same bits
with the kernel as with the plain version in its place; a call is one
launch and no host sync; a corpus of 2^30 codes, past the int32 of the
kernel's bisection, raises. They import no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_window_bounds.py
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch import serve, trace
from repro_torch.core import grid as tgrid
from repro_torch.data import synth
from repro_torch.kernels import csr_layout as tlayout
from repro_torch.kernels.ref import morton_encode_ref


# --- the layouts --------------------------------------------------------------


def _morton_np(cells, dims):
    """Morton codes by interleaving one bit at a time (independent of the
    shift chains of ``morton_encode_ref``)."""
    c = cells.astype(np.int64)
    axes, width = (2, 15) if dims == 2 else (3, 10)
    code = np.zeros(len(c), np.int64)
    for b in range(width):
        for a in range(axes):
            code |= ((c[:, a] >> b) & 1) << (b * axes + a)
    return code.astype(np.int32)


def _corpus(cells, dims):
    """The sorted corpus codes of ``cells`` as ``_csr_layout`` sorts
    them."""
    return np.sort(morton_encode_ref(torch.as_tensor(cells), dims=dims)
                   .numpy(), kind="stable")


def _case(name):
    """(sorted_codes (n,), cells (m, 3), dims, bits) as int32 numpy."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    dims = 2 if name.endswith("2d") else 3
    bits = 15 if dims == 2 else 10
    cap = (1 << bits) - 2
    ax = 3 if dims == 3 else 2

    def cells(m, lo, hi):
        c = rng.integers(lo, hi + 1, (m, 3)).astype(np.int32)
        if dims == 2:
            c[:, 2] = 0
        return c

    if name.startswith("edges"):
        # every cell whose coordinates are 0, 1, cap - 1 or cap
        grid = np.array(np.meshgrid(*[[0, 1, cap - 1, cap]] * ax,
                                    indexing="ij")).reshape(ax, -1).T
        q = np.zeros((len(grid), 3), np.int32)
        q[:, :ax] = grid
        corpus = np.concatenate([q[::2], q[1::3], cells(50, 0, 3),
                                 cells(50, cap - 3, cap)])
    elif name.startswith("pads"):
        # real rows near the top, padding rows at 2^bits - 1 in the queries
        # and in the corpus, as the distributed driver leaves them
        corpus = cells(300, cap - 6, cap)
        pad = np.full((40, 3), cap + 1, np.int32)
        if dims == 2:
            pad[:, 2] = 0
        corpus = np.concatenate([corpus, pad])
        q = np.concatenate([cells(200, cap - 8, cap), pad, cells(20, 0, 5)])
        q = q[rng.permutation(len(q))]
    elif name == "z-nonzero-2d":
        corpus = cells(500, 100, 140)
        corpus[:, 2] = rng.integers(-5, 1 << 20, len(corpus))
        q = cells(400, 95, 145)
        q[:, 2] = rng.integers(-(1 << 30), 1 << 30, len(q))
    elif name.startswith("empty-windows"):
        corpus = cells(200, 0, 10)
        q = cells(100, 50, 90)
    elif name.startswith("one-code"):
        corpus = np.repeat(cells(1, 40, 40), 64, axis=0)
        q = np.concatenate([cells(50, 38, 42), cells(20, 0, cap)])
    elif name.startswith("more-queries"):
        corpus = cells(150, 0, 12)
        q = cells(700, 0, 12)
    elif name.startswith("fewer-queries"):
        corpus = cells(3000, 0, 40)
        q = cells(90, 0, 40)
    elif name.startswith("no-corpus"):
        corpus = np.zeros((0, 3), np.int32)
        q = cells(30, 0, cap)
    else:
        raise KeyError(name)
    codes = _corpus(corpus, dims)
    return codes, np.ascontiguousarray(q, np.int32), dims, bits


CASES = [f"{kind}-{d}" for kind in ("edges", "pads", "empty-windows",
                                    "one-code", "more-queries",
                                    "fewer-queries", "no-corpus")
         for d in ("2d", "3d")] + ["z-nonzero-2d"]


def _tensors(name, device="cpu"):
    codes, q, dims, bits = _case(name)
    return (torch.as_tensor(codes, device=device),
            torch.as_tensor(q, device=device), dims, bits)


# --- oracles ------------------------------------------------------------------


def _brute_force(codes, cells, dims, bits):
    """lo = the first, hi = one past the last corpus position whose code is
    one of the window's codes; (n, 0) where none is."""
    n, m = len(codes), len(cells)
    cap = (1 << bits) - 2
    rng = (-1, 0, 1)
    offs = np.array([(dx, dy, dz) for dx in rng for dy in rng
                     for dz in (rng if dims == 3 else (0,))], np.int64)
    nb = np.clip(cells.astype(np.int64)[:, None, :] + offs, 0, cap)
    win = _morton_np(nb.reshape(-1, 3), dims).reshape(m, len(offs))
    hit = (codes[None, None, :] == win[:, :, None]).any(axis=1)
    if n == 0:
        return np.zeros(m, np.int32), np.zeros(m, np.int32)
    anyhit = hit.any(axis=1)
    lo = np.where(anyhit, hit.argmax(axis=1), n)
    hi = np.where(anyhit, n - hit[:, ::-1].argmax(axis=1), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


def _equal(got, want):
    for g, w, what in zip(got, want, ("lo", "hi")):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape and np.array_equal(g, w), \
            f"{what}: {int((g != w).sum())} of {g.size} rows differ"


# --- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_plain_version_is_the_brute_force_oracle(name):
    codes, q, dims, bits = _case(name)
    got = tlayout.window_bounds_plain(torch.as_tensor(codes),
                                      torch.as_tensor(q), dims, bits)
    _equal(got, _brute_force(codes, q, dims, bits))
    if name.startswith("empty-windows") or name.startswith("no-corpus"):
        assert (got[0] == len(codes)).all() and (got[1] == 0).all()


@pytest.mark.parametrize("name", CASES)
def test_plain_version_is_the_references(name):
    import jax.numpy as jnp
    from repro.core import grid as jgrid
    codes, q, dims, bits = _case(name)
    got = tlayout.window_bounds_plain(torch.as_tensor(codes),
                                      torch.as_tensor(q), dims, bits)
    want = jgrid._csr_window_bounds(jnp.asarray(codes), jnp.asarray(q), dims,
                                    bits)
    _equal(got, [np.asarray(w) for w in want])


def test_a_cpu_tensor_takes_the_plain_path_and_launches_nothing():
    codes, q, dims, bits = _tensors("fewer-queries-3d")
    tlayout.reset_launches()
    with trace.recording() as rec:
        got = tgrid._csr_window_bounds(codes, q, dims, bits)
        taken = rec.take()
    _equal(got, tlayout.window_bounds_plain(codes, q, dims, bits))
    assert tlayout.LAUNCHES["window_bounds"] == 0
    assert trace.total(taken, "window_bounds_launches") == 0


def test_another_device_raises():
    codes, q, dims, bits = _tensors("edges-3d", device="meta")
    with pytest.raises(ValueError, match="window_bounds takes CPU tensors"):
        tlayout.window_bounds(codes, q, dims, bits)


# --- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card "
                    "(torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _with_plain(fn):
    """``fn()`` with the plain version in the kernel wrapper's place."""
    real = tlayout.window_bounds
    tlayout.window_bounds = tlayout.window_bounds_plain
    try:
        return fn()
    finally:
        tlayout.window_bounds = real


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_is_the_plain_version(card, name):
    codes, q, dims, bits = _tensors(name, device=card)
    before = tlayout.LAUNCHES["window_bounds"]
    got = tlayout.window_bounds(codes, q, dims, bits)
    torch.cuda.synchronize()
    _equal(got, tlayout.window_bounds_plain(codes, q, dims, bits))
    assert tlayout.LAUNCHES["window_bounds"] - before == 1


FULL = [("roadnet2d", 434_874, 0.02), ("iono3d", 1_000_000, 2.0),
        ("taxi2d", 2_000_000, 0.01)]


@pytest.mark.cuda
@pytest.mark.parametrize("dataset,n,eps", FULL, ids=[f[0] for f in FULL])
def test_full_size_layout_is_the_plain_versions(card, dataset, n, eps):
    """The benchmark's sizes (taxi2d stands in for Porto): the kernel's
    bounds on the layout's own inputs, and the whole plan and grid, equal
    those of the plain version."""
    pts = torch.as_tensor(synth.load(dataset, n, seed=0), device=card)
    captured = []
    real = tlayout.window_bounds

    def record(*args):
        out = real(*args)
        captured.append((args, out))
        return out
    tlayout.window_bounds = record
    try:
        spec, grid = tgrid.plan_and_build_csr_grid(pts, eps)
    finally:
        tlayout.window_bounds = real
    (args, out), = captured
    assert args[1].shape[0] == n
    _equal(out, tlayout.window_bounds_plain(*args))
    p_spec, p_grid = _with_plain(lambda: tgrid.plan_and_build_csr_grid(
        pts, eps))
    assert spec == p_spec
    for f in grid._fields:
        assert torch.equal(getattr(grid, f), getattr(p_grid, f)), f


@pytest.mark.cuda
def test_cross_query_with_dead_lanes_is_the_plain_versions(card):
    """``assign`` pads a batch to its bucket: the padded lanes' bounds are
    computed and then dropped. Labels, counts and distances equal those of
    the plain version, and of the CPU."""
    pts = synth.load("roadnet2d", 20_000, seed=3)
    q = synth.load("roadnet2d", 3_000, seed=4, structure_seed=3,
                   structure_n=20_000)
    snap = serve.build_snapshot(pts, 0.02, 8, device=card)
    got = serve.assign(snap, q)
    want = _with_plain(lambda: serve.assign(snap, q))
    cpu = serve.assign(serve.build_snapshot(pts, 0.02, 8, device="cpu"), q)
    assert got.bucket > len(q)
    for f in ("labels", "counts", "dist"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(cpu, f))


@pytest.mark.cuda
def test_distributed_csr_layout_with_pads_is_the_plain_versions(card):
    """The distributed CSR engine's candidates: owned and halo chunks, each
    real rows then +1e30 padding rows, whose cells sit at 2^bits - 1."""
    from repro_torch.distributed import dbscan_dist as tdd
    rng = np.random.default_rng(5)
    real = synth.load("iono3d", 12_000, seed=5)
    cand = np.full((16_384, 3), 1e30, np.float32)
    keep = np.sort(rng.choice(len(cand), len(real), replace=False))
    cand[keep] = real
    croot = np.where(cand[:, 0] < 1e29, rng.integers(0, len(cand),
                                                     len(cand)),
                     np.iinfo(np.int32).max).astype(np.int32)
    cand_t = torch.as_tensor(cand, device=card)
    croot_t = torch.as_tensor(croot, device=card)

    def run():
        sweep, ovf = tdd.make_csr_sweep(cand_t, 4.0, len(cand),
                                        tdd.DistConfig(local_engine="csr"))
        return [*sweep(croot_t), ovf]
    before = tlayout.LAUNCHES["window_bounds"]
    got = run()
    assert tlayout.LAUNCHES["window_bounds"] - before == 1
    want = _with_plain(run)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_call_is_one_launch_and_no_host_sync(card):
    codes, q, dims, bits = _tensors("fewer-queries-3d", device=card)
    tlayout.window_bounds(codes, q, dims, bits)       # build the kernel
    torch.cuda.synchronize()
    tlayout.reset_launches()
    with trace.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tgrid._csr_window_bounds(codes, q, dims, bits)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        taken = rec.take()
    assert tlayout.LAUNCHES["window_bounds"] == 1
    assert trace.total(taken, "window_bounds_launches") == 1
    _equal(got, tlayout.window_bounds_plain(codes, q, dims, bits))


@pytest.mark.cuda
def test_a_corpus_past_the_kernels_int32_raises(card):
    codes = torch.zeros(1 << 30, dtype=torch.int32, device=card)
    cells = torch.zeros((4, 3), dtype=torch.int32, device=card)
    before = tlayout.LAUNCHES["window_bounds"]
    with pytest.raises(ValueError, match="fewer than 2"):
        tlayout.window_bounds(codes, cells, 3, 10)
    assert tlayout.LAUNCHES["window_bounds"] == before
