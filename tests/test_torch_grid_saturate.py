"""repro_torch's hash-grid quantization on coordinates far outside the
domain, against the JAX reference: the reference's f32 → int32 cast
saturates (+huge → INT32_MAX, -huge → INT32_MIN), and so must the port's.
A plain cast on the CPU sends +1e30 / 0.02 to INT32_MIN, which gave a +1e30
padding row (the distributed grid engine sweeps such rows as queries) other
buckets than the reference's. ``neighbor_buckets`` is held bitwise to the
reference's, jitted and op by op; ``build_grid`` and ``plan_grid`` stay
equal to the reference's on real data."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.data import synth
from repro_torch.core import grid as tgrid

SMALLEST = np.array([[1e30, 0.0, 0.0]], np.float32)


def _specs(side, origin, table, dims, capacity=8):
    kw = dict(side=side, origin=origin, table_size=table, capacity=capacity,
              dims=dims)
    return jgrid.GridSpec(**kw), tgrid.GridSpec(**kw)


def _ref_buckets(q, spec, jit):
    fn = jax.jit(jgrid.neighbor_buckets, static_argnums=1) if jit \
        else jgrid.neighbor_buckets
    if jit:
        b, v = fn(jnp.asarray(q), spec)
    else:
        with jax.disable_jit():
            b, v = fn(jnp.asarray(q), spec)
    return np.asarray(b), np.asarray(v)


def _mixes(dims: int):
    """Rows far outside the domain (±1e30, ±3e9 cells at side 1, each axis
    alone and together) among real rows, NaN-free."""
    rng = np.random.default_rng(dims)
    real = rng.uniform(-2, 2, (32, 3)).astype(np.float32)
    far = []
    for v in (1e30, -1e30, 3e9, -3e9, 2.2e9, -2.2e9):
        for axis in range(3):
            row = rng.uniform(-2, 2, 3).astype(np.float32)
            row[axis] = v
            far.append(row)
        far.append(np.full(3, v, np.float32))
    far.append(np.array([1e30, -1e30, 3e9], np.float32))
    far.append(np.array([-3e9, 1e30, -1e30], np.float32))
    q = np.concatenate([real, np.asarray(far, np.float32)])
    return q[rng.permutation(len(q))]


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "op-by-op"])
def test_smallest_input_buckets_are_the_references(jit):
    jspec, tspec = _specs(0.02, (0.0, 0.0, 0.0), 64, 3)
    rb, rv = _ref_buckets(SMALLEST, jspec, jit)
    b, v = tgrid.neighbor_buckets(torch.as_tensor(SMALLEST), tspec)
    np.testing.assert_array_equal(b.numpy(), rb)
    np.testing.assert_array_equal(v.numpy(), rv)
    # the reference's row, as the saturated cell (INT32_MAX, 0, 0) gives it
    assert rb[0, :9].tolist() == [46, 39, 16, 15, 6, 49, 16, 25, 46]


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("side,origin,table", [
    (0.02, (0.0, 0.0, 0.0), 64),
    (1.0, (-1.5, 0.25, 3.0), 1 << 12),
    (0.3, (2.0, -2.0, 0.0), 1 << 20),
], ids=["eps0.02-t64", "side1-t4096", "side0.3-t2^20"])
@pytest.mark.parametrize("jit", [True, False], ids=["jit", "op-by-op"])
def test_far_rows_buckets_are_the_references(dims, side, origin, table, jit):
    jspec, tspec = _specs(side, origin, table, dims)
    q = _mixes(dims)
    rb, rv = _ref_buckets(q, jspec, jit)
    b, v = tgrid.neighbor_buckets(torch.as_tensor(q), tspec)
    np.testing.assert_array_equal(b.numpy(), rb)
    np.testing.assert_array_equal(v.numpy(), rv)


def test_quantize_saturates_as_xla_converts():
    x = np.array([[1e30, -1e30, 3e9], [2147483648.0, 2147483520.0,
                                       -2147483648.0],
                  [-2147483904.0, 0.5, -0.5]], np.float32)
    spec = tgrid.GridSpec(side=1.0, origin=(0.0, 0.0, 0.0), table_size=64,
                          capacity=8, dims=3)
    want = np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32))
    got = tgrid._quantize(torch.as_tensor(x), spec).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [2147483647, -2147483648, 2147483647]


@pytest.mark.parametrize("name,pts,eps", [
    ("roadnet", synth.load("roadnet2d", 3000, seed=2), 0.02),
    ("iono", synth.load("iono3d", 2000, seed=4), 3.0),
    ("blobs3d", synth.blobs(1500, k=4, dims=3, seed=1), 0.1),
], ids=["roadnet", "iono", "blobs3d"])
def test_plan_and_build_grid_unchanged_on_real_data(name, pts, eps):
    dims = 2 if name == "roadnet" else 3
    ref_spec = jgrid.plan_grid(pts, eps, dims=dims)
    spec = tgrid.plan_grid(pts, eps, dims=dims)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    ref = jgrid.build_grid(jnp.asarray(pts), ref_spec)
    g = tgrid.build_grid(torch.as_tensor(pts), spec)
    for f in ("points", "index", "valid", "order", "bucket"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    rb, rv = jgrid.neighbor_buckets(jnp.asarray(pts), ref_spec)
    b, v = tgrid.neighbor_buckets(torch.as_tensor(pts), spec)
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
