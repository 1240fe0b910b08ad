"""repro_torch CSR grid (plan and build) against the JAX reference on the
same datasets: the plan must equal field by field and the built grid array
by array, both for host points planned with ``plan_csr_grid`` and built
with ``build_csr_grid`` and for device points planned and built in one
layout pass by ``plan_and_build_csr_grid`` (``dims`` inferred from its
bounds read); a reference plan and grid carried over with
``spec_from_fields`` and ``grid_from_arrays`` must sweep to the reference's
own answers."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import neighbors as jnb
from repro.data import synth
from repro_torch.core import grid as tgrid
from repro_torch.core import neighbors as tnb

_DUPS = np.random.default_rng(1).uniform(0, 1, (100, 3)).astype(np.float32)

DATASETS = [
    ("blobs2", synth.blobs(350, k=3, seed=0), 0.08),
    ("blobs3d", synth.blobs(300, k=4, dims=3, seed=1), 0.12),
    ("roadnet", synth.load("roadnet2d", 400, seed=2), 0.03),
    ("taxi", synth.load("taxi2d", 400, seed=3), 0.12),
    ("iono", synth.load("iono3d", 350, seed=4), 3.0),
    ("dense-empty", synth.load("highway", 300, seed=5), 0.001),
    ("duplicates", np.concatenate([_DUPS, _DUPS, _DUPS[:40]]), 0.03),
    ("skewed2d", synth.load("skewed2d", 1500, seed=4), 0.05),
]
IDS = [d[0] for d in DATASETS]
FIELDS = ("order", "q_sorted", "cands", "starts", "nblk", "codes",
          "overflow")


PATHS = ["plan_then_build", "plan_and_build"]


def _plans(pts, eps, path="plan_then_build", **kw):
    """The reference's plan, and the port's plan and grid along ``path``."""
    dims = jnb.infer_dims(pts)
    assert tnb.infer_dims(pts) == dims
    ref = jgrid.plan_csr_grid(pts, eps, dims=dims, **kw)
    if path == "plan_then_build":
        port = tgrid.plan_csr_grid(pts, eps, dims=dims, device="cpu", **kw)
        return ref, port, tgrid.build_csr_grid(torch.as_tensor(pts), port)
    port, g = tgrid.plan_and_build_csr_grid(torch.as_tensor(pts), eps, **kw)
    built = tgrid.build_csr_grid(torch.as_tensor(pts), port)
    for f in FIELDS:
        assert torch.equal(getattr(g, f), getattr(built, f)), f
    return ref, port, g


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name,pts,eps", DATASETS, ids=IDS)
def test_plan_and_build_match_reference(name, pts, eps, path):
    ref_spec, spec, g = _plans(pts, eps, path)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    ref = jnb.build_csr_grid_jit(jnp.asarray(pts), ref_spec)
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(g, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert not bool(g.overflow)


@pytest.mark.parametrize("path", PATHS)
def test_plan_with_small_tiles_and_blocks_matches_reference(path):
    pts = synth.load("taxi2d", 900, seed=7)
    ref_spec, spec, _ = _plans(pts, 0.05, path, chunk=64, block_k=128)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)


@pytest.mark.parametrize("path", PATHS)
def test_plan_side_grows_when_extent_saturates_bits(path):
    # a 3D extent of 2000 ε needs more than 2^10 - 2 cells per axis
    pts = np.random.default_rng(5).uniform(0, 20.0, (500, 3)) \
        .astype(np.float32)
    ref_spec, spec, _ = _plans(pts, 0.01, path)
    assert spec.side > 0.01
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)


def _z(*z):
    pts = np.random.default_rng(9).uniform(0, 1, (len(z), 3)) \
        .astype(np.float32)
    pts[:, 2] = z
    return pts


@pytest.mark.parametrize("pts", [
    _z(0, 0, 0, 0), _z(0, -0.0, 0, 0), _z(0, 0, np.nan, 0),
    _z(0, 0, 0, 1e-30),
    np.random.default_rng(8).uniform(0, 1, (5, 2)).astype(np.float32)],
    ids=["z_zero", "z_negative_zero", "z_one_nan", "z_one_nonzero",
         "two_columns"])
def test_dims_from_the_bounds_read_equal_infer_dims(pts):
    mins, maxs, dims = tgrid.csr_bounds(torch.as_tensor(pts))
    assert dims == tnb.infer_dims(pts) == jnb.infer_dims(pts)
    np.testing.assert_array_equal(mins, pts.min(axis=0))
    np.testing.assert_array_equal(maxs, pts.max(axis=0))
    assert tgrid.csr_bounds(torch.as_tensor(pts), dims=7)[2] == 7


def test_state_carry_sweeps_reference_layout():
    pts = synth.load("roadnet2d", 700, seed=3)
    eps = 0.03
    ref_eng = jnb.make_engine(pts, eps, engine="grid", backend="ref")
    spec = tgrid.spec_from_fields(dataclasses.asdict(ref_eng.meta))
    assert isinstance(spec, tgrid.CSRGridSpec)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_eng.meta)
    hash(spec)  # usable as a cache key
    g = tgrid.grid_from_arrays(
        {f: np.asarray(getattr(ref_eng.state, f)) for f in FIELDS}, "cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(ref_eng.state, f)))
    assert g.order.dtype == torch.int32 and g.cands.dtype == torch.float32
    sweep, sweep_sorted, sweep_counts = tnb._csr_sweep_fns(spec,
                                                           float(eps) ** 2)
    rng = np.random.default_rng(0)
    core = rng.uniform(size=spec.n) < 0.5
    root = rng.integers(0, spec.n, spec.n).astype(np.int32)
    r = ref_eng.sweep(ref_eng.state, jnp.asarray(core), jnp.asarray(root))
    p = sweep(g, torch.as_tensor(core), torch.as_tensor(root))
    for a, b in zip(r, p):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(ref_eng.sweep_counts(
        ref_eng.state)), sweep_counts(g).numpy())
