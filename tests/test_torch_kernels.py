"""repro_torch slab sweeps (plain versions, CPU) against the JAX reference's
``repro.kernels.ops`` on the same seeded inputs: integer outputs must be
bit-identical. Also the Morton code and the device dispatch of the kernel
wrappers."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import csr_sweep as tcsr
from repro_torch.kernels import ops as tops
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
