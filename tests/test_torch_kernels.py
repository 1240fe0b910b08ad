"""repro_torch sweeps (plain versions, CPU) against the JAX reference's
``repro.kernels.ops`` and ``repro.kernels.ref`` on the same seeded inputs:
integer outputs must be bit-identical. Also the Morton code and the device
dispatch of the kernel wrappers: a tensor off the CPU launches the kernel
or raises, never the plain version."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import csr_sweep as tcsr
from repro_torch.kernels import frontier_sweep as tfrontier
from repro_torch.kernels import gathered_sweep as tgathered
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_sweep as tpairwise
from repro_torch.kernels import ref as tref

INT_MAX = np.iinfo(np.int32).max
SHAPES = [(1, 8, 1, 1), (4, 64, 8, 3), (3, 256, 6, 6), (7, 32, 16, 2)]


def _mk_slab(T, block_q, nc_blocks, slab_blocks, bk, seed=4):
    """The reference's ragged shape-sweep inputs (tests/test_kernels.py)."""
    nc = nc_blocks * bk
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (T * block_q, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (nc, 3)).astype(np.float32)
    croot = rng.integers(0, 9999, nc).astype(np.int32)
    croot[rng.uniform(size=nc) < 0.5] = INT_MAX
    starts = (rng.integers(0, nc_blocks - slab_blocks + 1, T) * bk) \
        .astype(np.int32)
    nblk = rng.integers(0, slab_blocks + 1, T).astype(np.int32)
    return q, np.ascontiguousarray(c.T), croot, starts, nblk


def _both(q, cp, croot, starts, nblk, eps2, *, slab, block_q, bk):
    """(reference, port) results of csr_sweep and csr_sweep_counts."""
    kw = dict(slab=slab, block_q=block_q, block_k=bk)
    jargs = (jnp.asarray(q), jnp.asarray(cp))
    jst = (jnp.asarray(starts), jnp.asarray(nblk))
    r = jops.csr_sweep(*jargs, jnp.asarray(croot), *jst, eps2,
                       backend="ref", **kw)
    rc = jops.csr_sweep_counts(*jargs, *jst, eps2, backend="ref", **kw)
    targs = (torch.as_tensor(q), torch.as_tensor(cp))
    tst = (torch.as_tensor(starts), torch.as_tensor(nblk))
    p = tops.csr_sweep(*targs, torch.as_tensor(croot), *tst, eps2, **kw)
    pc = tops.csr_sweep_counts(*targs, *tst, eps2, **kw)
    return ([np.asarray(x) for x in (*r, rc)],
            [x.numpy() for x in (*p, pc)])


def _assert_same(ref, port):
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T,block_q,nc_blocks,slab_blocks", SHAPES)
def test_csr_sweep_plain_matches_reference(T, block_q, nc_blocks,
                                           slab_blocks):
    bk = 128
    args = _mk_slab(T, block_q, nc_blocks, slab_blocks, bk)
    ref, port = _both(*args, 0.4, slab=slab_blocks * bk, block_q=block_q,
                      bk=bk)
    _assert_same(ref, port)
    np.testing.assert_array_equal(port[0], port[2])  # counts-only == fused


def _lattice_pairs(T, block_q, nc_blocks, bk, seed):
    """Points on the 1/8 lattice with candidates at d² ∈ {8, 9, 10}/64 of
    queries: every d² is exact in f32, so many pairs sit at exactly ε² =
    9/64 and one rounding difference flips a hit."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-16, 17, (T * block_q, 3)).astype(np.float32) / 8
    offs = np.array([(2, 2, 0), (2, 0, 2), (0, 2, 2), (3, 0, 0), (0, 0, 3),
                     (2, 2, 1), (1, 2, 2), (3, 1, 0), (0, 1, 3)], np.float32)
    offs = offs * rng.choice([-1, 1], (len(offs), 3))
    nc = nc_blocks * bk
    c = q[rng.integers(0, len(q), nc)] + offs[rng.integers(0, len(offs), nc)] / 8
    croot = rng.integers(0, 9999, nc).astype(np.int32)
    croot[rng.uniform(size=nc) < 0.3] = INT_MAX
    return q, np.ascontiguousarray(c.T.astype(np.float32)), croot


@pytest.mark.parametrize("eps2", [9 / 64, float(np.nextafter(
    np.float32(9 / 64), np.float32(0)))], ids=["eq", "below"])
@pytest.mark.parametrize("T,block_q,nc_blocks", [(2, 32, 2), (3, 256, 4)])
def test_csr_sweep_plain_exact_boundary(T, block_q, nc_blocks, eps2):
    bk = 128
    q, cp, croot = _lattice_pairs(T, block_q, nc_blocks, bk, seed=T)
    starts = np.zeros(T, np.int32)
    nblk = np.full(T, nc_blocks, np.int32)
    ref, port = _both(q, cp, croot, starts, nblk, eps2, slab=nc_blocks * bk,
                      block_q=block_q, bk=bk)
    _assert_same(ref, port)
    # the boundary really is exercised: d² = 9/64 pairs exist and count
    # only when ε² is 9/64 itself
    d2 = ((q[:, None, :] - cp.T[None]) ** 2).sum(-1)
    n_edge = int((d2 == np.float32(9 / 64)).sum())
    assert n_edge > 0
    assert port[0].sum() == (d2 <= np.float32(eps2)).sum()


def test_csr_sweep_plain_empty_tiles():
    # nblk = 0 tiles return count 0 and minroot INT32_MAX, whatever start
    T, block_q, bk = 5, 32, 128
    q, cp, croot, starts, _ = _mk_slab(T, block_q, 4, 2, bk, seed=9)
    nblk = np.array([0, 2, 0, 1, 0], np.int32)
    ref, port = _both(q, cp, croot, starts, nblk, 0.4, slab=2 * bk,
                      block_q=block_q, bk=bk)
    _assert_same(ref, port)
    rows = np.repeat(nblk == 0, block_q)
    assert (port[0][rows] == 0).all() and (port[1][rows] == INT_MAX).all()
    assert port[0][~rows].sum() > 0


@pytest.mark.parametrize("dims,hi", [(2, 1 << 15), (3, 1 << 10)])
def test_morton_encode_matches_reference(dims, hi):
    rng = np.random.default_rng(dims)
    coords = rng.integers(0, hi, (2000, 3)).astype(np.int32)
    coords[:4] = [[0, 0, 0], [hi - 1] * 3, [hi - 1, 0, 0], [0, hi - 1, 0]]
    r = np.asarray(jref.morton_encode_ref(jnp.asarray(coords), dims=dims))
    p = tref.morton_encode_ref(torch.as_tensor(coords), dims=dims).numpy()
    assert p.dtype == np.int32
    np.testing.assert_array_equal(r, p)


def test_dist2_is_unfused():
    # the plain d² equals separately rounded f32 ops, coordinate by
    # coordinate, on the reference's own oracle
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    r = np.asarray(jref._dist2(jnp.asarray(q), jnp.asarray(c)))
    p = tref._dist2(torch.as_tensor(q), torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(r, p)


def test_cpu_calls_do_not_count_launches():
    tcsr.reset_launches()
    args = _mk_slab(3, 256, 6, 6, 128)
    _both(*args, 0.4, slab=6 * 128, block_q=256, bk=128)
    assert tcsr.LAUNCHES == {"csr_sweep": 0, "csr_sweep_counts": 0}


def test_wrapper_rejects_non_cpu_non_cuda_and_bad_inputs():
    q, cp, croot, starts, nblk = (torch.as_tensor(x) for x in
                                  _mk_slab(4, 64, 8, 3, 128))
    kw = dict(max_blocks=3, block_q=64, block_k=128)
    meta = [x.to("meta") for x in (q, cp, croot, starts, nblk)]
    with pytest.raises(ValueError, match="not meta"):
        tcsr.csr_sweep(*meta, 0.4, **kw)
    with pytest.raises(ValueError, match="not meta"):
        tcsr.csr_sweep_counts(meta[0], meta[1], meta[3], meta[4], 0.4, **kw)
    with pytest.raises(TypeError, match="croot"):
        tcsr.csr_sweep(q, cp, croot.long(), starts, nblk, 0.4, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tcsr.csr_sweep(q, cp.T.contiguous().T, croot, starts, nblk, 0.4,
                       **kw)
    with pytest.raises(ValueError, match="exceeds nc"):
        tcsr.csr_sweep(q, cp, croot, starts, nblk, 0.4, max_blocks=9,
                       block_q=64, block_k=128)


# --- pairwise_sweep, gathered_sweep, frontier_sweep -------------------------

EQ_BELOW = [9 / 64, float(np.nextafter(np.float32(9 / 64), np.float32(0)))]


def _mk_pairs(seed, nq, nc, dtype):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (nq, 3)).astype(dtype)
    c = rng.uniform(-1, 1, (nc, 3)).astype(dtype)
    core = rng.uniform(size=nc) < 0.5
    root = rng.integers(0, max(nc, 1), nc).astype(np.int32)
    return q, c, core, root


def _pairwise_both(q, c, core, root, eps2, **kw):
    r = jops.pairwise_sweep(*(jnp.asarray(x) for x in (q, c, core, root)),
                            eps2, backend="ref")
    p = tops.pairwise_sweep(*(torch.as_tensor(x) for x in (q, c, core,
                                                           root)),
                            eps2, **kw)
    return [np.asarray(x) for x in r], [x.numpy() for x in p]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("nq,nc", [(1, 1), (7, 513), (256, 512),
                                   (100, 1000), (513, 257)])
def test_pairwise_sweep_plain_matches_reference(nq, nc, dtype):
    ref, port = _pairwise_both(*_mk_pairs(0, nq, nc, dtype), 0.3)
    _assert_same(ref, port)


def test_pairwise_sweep_plain_chunks_and_blocks_change_nothing():
    q, c, core, root = _mk_pairs(5, 700, 40000, np.float32)
    ref, port = _pairwise_both(q, c, core, root, 0.01)
    _assert_same(ref, port)
    _, small = _pairwise_both(q, c, core, root, 0.01, chunk=64, block_q=8,
                              block_c=128)
    _assert_same(ref, small)


@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
def test_pairwise_sweep_plain_exact_boundary(eps2):
    q, cp, croot = _lattice_pairs(2, 64, 2, 128, seed=5)
    core = croot != INT_MAX
    ref, port = _pairwise_both(q, cp.T.copy(), core, croot, eps2)
    _assert_same(ref, port)
    d2 = ((q[:, None, :] - cp.T[None]) ** 2).sum(-1)
    assert (d2 == np.float32(9 / 64)).any()
    assert port[0].sum() == (d2 <= np.float32(eps2)).sum()


def _mk_windows(seed, b, k, lattice=False):
    rng = np.random.default_rng(seed)
    if lattice:
        q = rng.integers(-8, 9, (b, 3)).astype(np.float32) / 8
        offs = rng.integers(-3, 4, (b, k, 3)).astype(np.float32) / 8
        c = (q[:, None, :] + offs).astype(np.float32)
    else:
        q = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
        c = rng.uniform(-1, 1, (b, k, 3)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) < 0.8
    core = rng.uniform(size=(b, k)) < 0.5
    root = rng.integers(0, 9999, (b, k)).astype(np.int32)
    return q, c, valid, core, root


def _gathered_both(args, eps2):
    r = jref.gathered_sweep_ref(*(jnp.asarray(x) for x in args),
                                jnp.float32(eps2))
    p = tops.gathered_sweep(*(torch.as_tensor(x) for x in args), eps2)
    return [np.asarray(x) for x in r], [x.numpy() for x in p]


@pytest.mark.parametrize("b,k", [(1, 1), (128, 512), (130, 100), (3, 700)])
def test_gathered_sweep_plain_matches_reference(b, k):
    ref, port = _gathered_both(_mk_windows(1, b, k), 0.2)
    _assert_same(ref, port)


@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
def test_gathered_sweep_plain_exact_boundary(eps2):
    args = _mk_windows(2, 130, 300, lattice=True)
    ref, port = _gathered_both(args, eps2)
    _assert_same(ref, port)
    q, c, valid = args[:3]
    d2 = ((q[:, None, :] - c) ** 2).sum(-1)
    assert ((d2 == np.float32(9 / 64)) & valid).any()
    assert port[0].sum() == ((d2 <= np.float32(eps2)) & valid).sum()


def test_gathered_sweep_plain_masks_invalid_and_duplicate_cells():
    # a window whose second half repeats its first (an aliased bucket) and
    # whose repeat is masked invalid counts each candidate once
    q, c, valid, core, root = _mk_windows(3, 64, 256)
    c[:, 128:] = c[:, :128]
    root[:, 128:] = root[:, :128]
    core[:, 128:] = core[:, :128]
    valid[:, 128:] = False
    ref, port = _gathered_both((q, c, valid, core, root), 0.5)
    _assert_same(ref, port)
    single, _ = _gathered_both((q, c[:, :128], valid[:, :128],
                                core[:, :128], root[:, :128]), 0.5)
    _assert_same(single, port)


def _frontier_both(args, active, n_active, eps2, *, slab, block_q, bk):
    q, cp, croot, starts, nblk = args
    kw = dict(slab=slab, block_q=block_q, block_k=bk)
    r = jops.frontier_sweep(
        *(jnp.asarray(x) for x in (q, cp, croot, starts, nblk, active)),
        jnp.asarray([n_active], jnp.int32), eps2, backend="ref", **kw)
    p = tops.frontier_sweep(
        *(torch.as_tensor(x) for x in (q, cp, croot, starts, nblk, active)),
        torch.tensor([n_active], dtype=torch.int32), eps2, **kw)
    return [np.asarray(r)], [p.numpy()]


def _park(live_ids, T):
    """The reference's park contract: live ids first, then the last live
    id (0 when none) repeated."""
    fill = live_ids[-1] if len(live_ids) else 0
    return np.array(list(live_ids) + [fill] * (T - len(live_ids)), np.int32)


@pytest.mark.parametrize("T,block_q,nc_blocks,slab_blocks", SHAPES)
def test_frontier_sweep_plain_matches_reference(T, block_q, nc_blocks,
                                                slab_blocks):
    bk = 128
    args = _mk_slab(T, block_q, nc_blocks, slab_blocks, bk)
    rng = np.random.default_rng(T)
    kw = dict(slab=slab_blocks * bk, block_q=block_q, bk=bk)
    full = tops.csr_sweep(*(torch.as_tensor(x) for x in args), 0.4,
                          slab=slab_blocks * bk, block_q=block_q,
                          block_k=bk)[1].numpy().reshape(T, block_q)
    for n_active in sorted({0, 1, T, T // 2}):
        live = np.sort(rng.choice(T, n_active, replace=False))
        ref, port = _frontier_both(args, _park(live, T), n_active, 0.4,
                                   **kw)
        _assert_same(ref, port)
        got = port[0].reshape(T, block_q)
        np.testing.assert_array_equal(got[:n_active], full[live])
        assert (got[n_active:] == INT_MAX).all()


@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
def test_frontier_sweep_plain_exact_boundary_and_empty_tiles(eps2):
    T, block_q, bk, ncb = 4, 32, 128, 3
    q, cp, croot = _lattice_pairs(T, block_q, ncb, bk, seed=8)
    starts = np.zeros(T, np.int32)
    nblk = np.array([ncb, 0, ncb, 1], np.int32)
    ref, port = _frontier_both((q, cp, croot, starts, nblk),
                               np.array([3, 1, 0, 0], np.int32), 3, eps2,
                               slab=ncb * bk, block_q=block_q, bk=bk)
    _assert_same(ref, port)
    got = port[0].reshape(T, block_q)
    assert (got[1] == INT_MAX).all() and (got[3] == INT_MAX).all()
    assert (got[0] != INT_MAX).any() and (got[2] != INT_MAX).any()


def test_cpu_calls_of_new_kernels_do_not_count_launches():
    for m in (tpairwise, tgathered, tfrontier):
        m.reset_launches()
    _pairwise_both(*_mk_pairs(0, 100, 1000, np.float32), 0.3)
    _gathered_both(_mk_windows(1, 130, 100), 0.2)
    _frontier_both(_mk_slab(3, 256, 6, 6, 128), np.arange(3, dtype=np.int32),
                   3, 0.4, slab=6 * 128, block_q=256, bk=128)
    assert tpairwise.LAUNCHES == {"pairwise_sweep": 0}
    assert tgathered.LAUNCHES == {"gathered_sweep": 0, "hash_sweep": 0}
    assert tfrontier.LAUNCHES == {"frontier_sweep": 0}


def _meta_calls():
    """Each wrapper called on tensors that are not on the CPU."""
    q, cp, croot, starts, nblk = (torch.as_tensor(x).to("meta") for x in
                                  _mk_slab(4, 64, 8, 3, 128))
    active = torch.zeros(4, dtype=torch.int32, device="meta")
    n_active = torch.ones(1, dtype=torch.int32, device="meta")
    kw = dict(max_blocks=3, block_q=64, block_k=128)
    wq = torch.empty((8, 3), device="meta")
    wc = torch.empty((3, 8, 16), device="meta")
    wr = torch.empty((8, 16), dtype=torch.int32, device="meta")
    return {
        "csr_sweep": lambda: tcsr.csr_sweep(q, cp, croot, starts, nblk, 0.4,
                                            **kw),
        "csr_sweep_counts": lambda: tcsr.csr_sweep_counts(
            q, cp, starts, nblk, 0.4, **kw),
        "frontier_sweep": lambda: tfrontier.frontier_sweep(
            q, cp, croot, starts, nblk, active, n_active, 0.4, **kw),
        "pairwise_sweep": lambda: tpairwise.pairwise_sweep(
            q, cp, croot, 0.4, block_q=64, block_c=128),
        "gathered_sweep": lambda: tgathered.gathered_sweep(wq, wc, wr, 0.4),
    }


def test_new_wrappers_reject_non_cpu_non_cuda():
    for name, call in _meta_calls().items():
        with pytest.raises(ValueError, match="not meta"):
            call()


def test_device_tensors_launch_or_raise_never_plain(monkeypatch):
    # with the device check passed (as a CUDA tensor passes it), every
    # wrapper goes to its kernel's launcher; a launch error, or a kernel
    # that cannot build, raises; no plain version is ever called
    def boom(*a, **k):
        raise AssertionError("plain version called on a device tensor")
    for mod in (tcsr, tfrontier, tpairwise, tgathered):
        monkeypatch.setattr(mod, "_cuda_or_raise", lambda x, kernel: None)
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, boom)
    launched = []

    def refuse(lib, fn, sig, kernel, device, *args):
        launched.append(kernel)
        raise RuntimeError(f"{kernel} launch failed: CUDA error 209")
    monkeypatch.setattr(tbuild, "launch", refuse)
    calls = _meta_calls()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} launch failed"):
            call()
    assert launched == list(calls)
    for mod in (tcsr, tfrontier, tpairwise, tgathered):
        assert all(v == 0 for v in mod.LAUNCHES.values())

    monkeypatch.undo()
    for mod in (tcsr, tfrontier, tpairwise, tgathered):
        monkeypatch.setattr(mod, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tbuild.shutil, "which", lambda _: None)
    monkeypatch.setattr(tbuild.os.path, "exists", lambda _: False)
    monkeypatch.setattr(tbuild.Path, "exists", lambda self: False)
    for call in calls.values():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
