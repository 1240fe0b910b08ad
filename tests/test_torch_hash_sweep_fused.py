"""The grid-hash sweep that reads the bucket table (``hash_sweep``) on the
CPU: the facts its kernel rests on, and its plain version against a walk
over the occupied slots alone and against the JAX reference.

The kernel (``csrc/gathered_sweep.cu``, ``hash_sweep_kernel``) walks, for
each query, only the first ``occupancy[h]`` slots of each bucket ``h`` of
its window whose cell is valid. That is exact when the valid slots of a
bucket are a prefix of it (so the occupancy counts them) and the slots it
skips (padding, and every slot of an aliased bucket) could never hit.
Here: the prefix property on every case; a plain walk over only the
occupied slots of the valid buckets (the kernel's loop, as tensor code)
bit-identical to ``hash_sweep``'s plain version (the padded windows, chunk
by chunk) and to the reference's grid-hash sweep; cases n = 20,000
roadnet2d, iono3d and skewed2d (against the padded path: the queries of
its fullest bucket and others, 2,048 in all), a table of 64 buckets
(aliased windows), 2-D and 3-D 1/8 lattices at d² = ε² and the float
below. And the
wrapper's contract: CPU calls count no launch, other devices launch or
raise, and the launch signature is the C function's.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cull_layouts import (EQ_BELOW, EPS, FUSED_DATASETS, lattice_cloud,
                          lattice_counts, payload)
from repro.core import neighbors as jnb
from repro.data import synth
from repro_torch import make_engine
from repro_torch.core import grid as tgrid
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import gathered_sweep as tgathered
from repro_torch.kernels import ref as tref

INT_MAX = np.iinfo(np.int32).max
# queries per chunk of the padded windows (the plain version's and the
# reference's): skewed2d's fullest bucket holds 3,379 points, so a window
# is 9 x 3,384 slots
CHUNK = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: beside the other test workers on the
    same cores, torch's intra-op threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    """(points, ε, dims, spec or None) of a named case."""
    if name == "aliased":
        pts = synth.load("roadnet2d", 2_000, seed=1)
        return pts, 0.05, 2, tgrid.plan_grid(pts, 0.05, dims=2,
                                             max_table_size=64)
    if name.startswith("lattice"):
        dims = int(name[-2])
        return lattice_cloud(np.random.default_rng(dims), 3_000, dims), \
            EPS, dims, None
    _, n, eps, dims = next(c for c in FUSED_DATASETS if c[0] == name)
    return synth.load(name, n, seed=0), eps, dims, None


CASES = [c[0] for c in FUSED_DATASETS] + ["aliased", "lattice2d",
                                          "lattice3d"]


def _engine(name):
    pts, eps, dims, spec = _case(name)
    eng = make_engine(pts, eps, engine="grid-hash", dims=dims, spec=spec,
                      chunk=CHUNK, device="cpu")
    return pts, eps, dims, eng


def _args(eng, core, root):
    st, g = eng.state, eng.state.grid
    return (st.points, g.order, st.buckets, st.cell_valid, g.points, g.index,
            st.occupancy, torch.as_tensor(core), torch.as_tensor(root))


def occupied_walk(args, eps2):
    """The kernel's loop as tensor code: every (query, occupied slot of a
    valid bucket of its window) pair, tested with ``_dist2`` and folded by
    query; no padded slot and no slot of an aliased bucket is touched."""
    q, _, buckets, cell_valid, gpoints, gindex, occ, core, root = args
    n, n_off = buckets.shape
    cap = gpoints.shape[1]
    m = (occ[buckets.long()] * cell_valid).reshape(-1).long()
    qi = torch.arange(n).repeat_interleave(n_off).repeat_interleave(m)
    b = buckets.reshape(-1).long().repeat_interleave(m)
    start = torch.cumsum(m, 0) - m
    s = torch.arange(int(m.sum())) - start.repeat_interleave(m)
    slot = b * cap + s
    d2 = tref._dist2(q[qi], gpoints.reshape(-1, 3)[slot])
    hit = d2 <= tref.eps2_tensor(eps2, "cpu")
    j = gindex.reshape(-1)[slot].long()
    counts = torch.zeros(n, dtype=torch.int32).index_add_(
        0, qi, hit.to(torch.int32))
    pay = torch.where(hit & core[j], root[j], INT_MAX).to(torch.int32)
    minroot = torch.full((n,), INT_MAX, dtype=torch.int32).scatter_reduce_(
        0, qi, pay, "amin")
    return counts, minroot, int(m.sum())


@pytest.mark.parametrize("name", CASES)
def test_valid_slots_are_a_prefix_and_the_occupancy_counts_them(name):
    _, _, _, eng = _engine(name)
    g, occ = eng.state.grid, eng.state.occupancy
    assert occ.dtype == torch.int32
    assert torch.equal(occ, g.valid.sum(dim=1, dtype=torch.int32))
    prefix = torch.arange(g.valid.shape[1])[None, :] < occ[:, None]
    assert torch.equal(g.valid, prefix)
    # the padded slots are the ones the kernel never reads
    assert bool((g.points[~g.valid] == tgrid.BIG).all())
    assert bool((g.index[~g.valid] == -1).all())


def _rows(name, eng):
    """The query rows held to the padded path: all of them, but for
    skewed2d (whose padded windows hold 9 x 3,384 slots a query) the
    queries of the fullest bucket and as many seeded others, 2,048 in all."""
    n = eng.state.points.shape[0]
    if name != "skewed2d":
        return torch.arange(n)
    g = eng.state.grid
    full = g.index[int(eng.state.occupancy.argmax())]
    full = full[full >= 0][:1024].long()
    rest = torch.as_tensor(np.random.default_rng(11).choice(
        n, 2_048 - full.numel(), replace=False))
    return torch.cat([full, rest])


@pytest.mark.parametrize("name", CASES)
def test_occupied_walk_is_the_padded_path_and_the_reference(name):
    pts, eps, dims, eng = _engine(name)
    core, root = payload(np.random.default_rng(7), len(pts))
    args = _args(eng, core, root)
    rows = _rows(name, eng)
    sub = (args[0][rows], torch.arange(rows.numel(), dtype=torch.int32),
           args[2][rows], args[3][rows], *args[4:])
    # the lattices: ε² = 9/64 exactly, and the float below
    eps2s = EQ_BELOW if name.startswith("lattice") else [float(eps) ** 2]
    for eps2 in eps2s:
        counts, minroot, pairs = occupied_walk(args, eps2)
        plain = tgathered.hash_sweep(*sub, eps2, chunk=CHUNK)
        assert torch.equal(counts[rows], plain[0])
        assert torch.equal(minroot[rows], plain[1])
        if name.startswith("lattice"):
            np.testing.assert_array_equal(
                counts[:200].numpy(), lattice_counts(pts[:200], pts, eps2))
        if eps2 == eps2s[0]:
            at_eps = counts, minroot
    counts, minroot = at_eps
    # the engine's sweep is that function
    if name != "skewed2d":
        sweep = eng.sweep(eng.state, torch.as_tensor(core),
                          torch.as_tensor(root))
        assert torch.equal(sweep[0], counts) and torch.equal(sweep[1],
                                                             minroot)
    # the padded windows hold more pairs than the occupied slots
    st = eng.state
    assert pairs < len(pts) * st.buckets.shape[1] * st.grid.points.shape[1]
    if name == "aliased":
        assert bool((~st.cell_valid).any())
    jeng = jnb.make_engine(pts, eps, engine="grid-hash", dims=dims,
                           chunk=CHUNK, spec=None if name != "aliased" else
                           _reference_spec(pts, eps))
    ref = jeng.sweep(jeng.state, jnp.asarray(core), jnp.asarray(root))
    np.testing.assert_array_equal(np.asarray(ref[0]), counts.numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), minroot.numpy())


def _reference_spec(pts, eps):
    from repro.core import grid as jgrid
    return jgrid.plan_grid(pts, eps, dims=2, max_table_size=64)


def test_the_chunk_size_changes_nothing():
    _, eps, _, eng = _engine("aliased")
    core, root = payload(np.random.default_rng(8), 2_000)
    args = _args(eng, core, root)
    outs = [tgathered.hash_sweep(*args, float(eps) ** 2, chunk=c)
            for c in (2048, 128, 100)]
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], o))


def test_cpu_calls_count_no_launch_and_bad_inputs_raise():
    _, eps, _, eng = _engine("aliased")
    core, root = payload(np.random.default_rng(9), 2_000)
    args = list(_args(eng, core, root))
    tgathered.reset_launches()
    tgathered.hash_sweep(*args, 0.01)
    assert tgathered.LAUNCHES == {"gathered_sweep": 0, "hash_sweep": 0}
    bad = [(2, args[2].to(torch.int64), TypeError, "buckets"),
           (3, args[3][:, :4].contiguous(), ValueError, "cell_valid"),
           (6, args[6][:10], ValueError, "occupancy"),
           (7, args[7].to(torch.int32), TypeError, "core"),
           (4, args[4].transpose(0, 1), ValueError, "gpoints")]
    for i, x, err, what in bad:
        with pytest.raises(err, match=what):
            tgathered.hash_sweep(*args[:i], x, *args[i + 1:], 0.01)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="not meta"):
        tgathered.hash_sweep(*meta, 0.01)


def _c_params(fn):
    src = (tbuild.CSRC_DIR / "gathered_sweep.cu").read_text()
    decl = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    return ["p" if "*" in p else "f" if p.strip().startswith("float")
            else "i" for p in decl.split(",")]


def test_device_tensors_launch_or_raise_never_plain(monkeypatch):
    # with the device check passed (as a CUDA tensor passes it), hash_sweep
    # goes to its launcher with the C function's signature; a refused
    # launch raises and counts nothing; no plain version is called
    def boom(*a, **k):
        raise AssertionError("plain version called on a device tensor")
    monkeypatch.setattr(tgathered, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tgathered, "hash_sweep_plain", boom)
    monkeypatch.setattr(tgathered, "gathered_sweep_plain", boom)
    launched = []

    def refuse(lib, fn, sig, kernel, device, *args):
        launched.append((lib, fn, sig, kernel, len(args)))
        raise RuntimeError(f"{kernel} launch failed: CUDA error 209")
    monkeypatch.setattr(tbuild, "launch", refuse)
    _, _, _, eng = _engine("aliased")
    core, root = payload(np.random.default_rng(10), 2_000)
    meta = [x.to("meta") for x in _args(eng, core, root)]
    tgathered.reset_launches()
    with pytest.raises(RuntimeError, match="hash_sweep launch failed"):
        tgathered.hash_sweep(*meta, 0.01)
    (lib, fn, sig, kernel, n_args), = launched
    assert (lib, fn, kernel) == ("gathered_sweep", "hash_sweep_launch",
                                 "hash_sweep")
    assert n_args == len(sig) and ["i", *sig, "p"] == _c_params(fn)
    assert tgathered.LAUNCHES["hash_sweep"] == 0
