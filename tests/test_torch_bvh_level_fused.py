"""The fused BVH level (``bvh_sweep.bvh_level``) on the CPU, where it runs
its plain version: held level by level to the plain level loop of
``core/bvh.py`` (``_plain_level``, the per-entry kernel's loop and the CPU
path of ``wavefront_sweep``).

The kernel (``csrc/bvh_sweep.cu``, ``bvh_level_kernel``) expands each live
parent entry e into its children at positions (e // tile)·2·tile +
side·tile + e % tile, adds leaf hits by atomics, decides pushes against
the bounds as they stood when the level started, and compacts the pushes
in position order, at most C of them. Its plain version does the same in
tensor code. Here, level by level: the next frontier in order, counts,
minroot, the overflow flag and the histogram equal the plain loop's, in
exact and payload modes, D = 2 and 3, with a capacity that fits and one
that overflows (the truncation order), and with ``stop_on_overflow``
(calibration probes). Then the fused driver (``wavefront_sweep_fused``)
against ``wavefront_sweep_plain`` as a whole, the calibrated
``WavefrontSpec`` and ``dbscan`` through it, and the wrapper's contract.
The reference's ``wavefront_sweep`` outputs stay held to the port's by
``test_torch_bvh.py``.
"""
import re

import numpy as np
import pytest
import torch

from repro.data import synth
from repro_torch import dbscan, make_engine
from repro_torch.core import bvh as tbvh
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import bvh_sweep as tsweep

INT_MAX = np.iinfo(np.int32).max
# by dims: (points, ε, a capacity that overflows at tile 512); the exact
# sweeps peak at 7,980 / 2,020 entries, the payload sweeps at 2,843 / 1,703
DATA = {2: (lambda: synth.load("skewed2d", 1500, seed=4), 0.05, 1536),
        3: (lambda: synth.load("iono3d", 1500, seed=0), 8.0, 1024)}
LEVELS = tbvh.MAX_LEVELS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: beside the other test workers on the
    same cores, torch's intra-op threads would mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dims, seed=3):
    make, eps, small = DATA[dims]
    pts = make()
    n = len(pts)
    rng = np.random.default_rng(seed)
    croot = torch.as_tensor(np.where(rng.uniform(size=n) < 0.5,
                                     rng.integers(0, n, n), INT_MAX)
                            .astype(np.int32))
    bound = torch.as_tensor(rng.integers(0, n, n).astype(np.int32))
    tree = tbvh.build_bvh(torch.as_tensor(pts), dims=dims)
    return tree, croot, bound, eps, small


CASES = [(mode, dims, cap, stop)
         for mode in ("exact", "payload") for dims in (2, 3)
         for cap, stop in (("fits", False), ("overflows", False),
                           ("overflows", True))]


@pytest.mark.parametrize("mode,dims,cap,stop", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_fused_level_is_the_plain_loop_level_by_level(mode, dims, cap, stop):
    tree, croot, bound, eps, small = _inputs(dims)
    payload = mode == "payload"
    kw = dict(eps=eps, capacity=1 << 16 if cap == "fits" else small,
              tile=512, batch=8, prune_dtype="bf16",
              bound=bound if payload else None)
    eps2 = eps * eps
    inputs, counts_a, minroot_a, nb, tile, C = tbvh._sweep_setup(
        tree, tree.pts_sorted, croot, **kw)
    _, counts_b, minroot_b, _, _, _ = tbvh._sweep_setup(
        tree, tree.pts_sorted, croot, **kw)
    state = tsweep.new_level_state(counts_b, minroot_b, capacity=C,
                                   levels=LEVELS, prune_payload=payload)
    live = min(nb, C)
    fb = torch.arange(live)
    fn = torch.zeros(live, dtype=torch.int64)
    state.fb[0, :live] = fb.to(torch.int32)
    state.fn[0, :live] = 0
    state.nlive[0] = live
    ovf, hist = nb > C, []
    for level in range(LEVELS):
        running = fb.shape[0] and not (stop and ovf)
        assert int(state.nlive[level]) == (fb.shape[0] if running else 0)
        if not running:
            break
        hist.append(fb.shape[0])
        fb, fn, over = tbvh._plain_level(
            inputs, counts_a, minroot_a, fb, fn, eps2, nb=nb, tile=tile, C=C,
            bf16_prune=True, prune_payload=payload)
        ovf = ovf or over
        if payload:
            state.bound.copy_(minroot_b)
        tsweep.bvh_level(inputs, state, level, eps2, tile=tile,
                         prune_payload=payload, stop_on_overflow=stop)
        dst, m = (level + 1) % 2, fb.shape[0]
        assert torch.equal(state.fb[dst, :m], fb.to(torch.int32)), level
        assert torch.equal(state.fn[dst, :m], fn.to(torch.int32)), level
        assert torch.equal(counts_a, counts_b) and \
            torch.equal(minroot_a, minroot_b), level
        assert bool(state.overflow[0]) == ovf
        assert int(state.hist[level]) == hist[-1]
    assert (state.hist[len(hist):] == -1).all()
    assert ovf == (cap == "overflows")
    assert len(hist) > 10 or stop


@pytest.mark.parametrize("n_live,tile", [(1, 512), (700, 512), (1024, 512),
                                         (1500, 256), (37, 8)])
def test_positions_are_the_loop_child_order(n_live, tile):
    # the loop lays a level's children out per tile: its left children,
    # then its right children; the padding entries of the last tile take
    # no position among the live ones
    nt = -(-n_live // tile)
    e = torch.arange(nt * tile).view(nt, 1, tile).expand(nt, 2, tile)
    side = torch.arange(2).view(1, 2, 1).expand(nt, 2, tile)
    loop = [(int(a), int(b)) for a, b in zip(e.reshape(-1), side.reshape(-1))
            if a < n_live]
    ee = torch.arange(n_live)
    pos = (ee // tile) * 2 * tile + ee % tile
    both = sorted([(int(p), i, 0) for i, p in enumerate(pos)]
                  + [(int(p) + tile, i, 1) for i, p in enumerate(pos)])
    assert [(i, s) for _, i, s in both] == loop


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("prune", ["bf16", "f32"])
def test_fused_sweep_is_the_plain_sweep(dims, prune):
    tree, croot, bound, eps, small = _inputs(dims, seed=5)
    for kw in (dict(capacity=1 << 16), dict(capacity=small),
               dict(capacity=small, stop_on_overflow=True),
               dict(capacity=1 << 16, bound=bound),
               dict(capacity=1 << 16, max_levels=5)):
        kw = dict(kw, eps=eps, eps2=eps * eps, tile=512, prune_dtype=prune)
        a = tbvh.wavefront_sweep_plain(tree, tree.pts_sorted, croot, **kw)
        f = tbvh.wavefront_sweep_fused(tree, tree.pts_sorted, croot, **kw)
        for x, y in zip((a[0], a[1], a[3]), (f[0], f[1], f[3])):
            assert torch.equal(x, y), kw
        assert a[2] == f[2]


def test_calibration_and_dbscan_through_the_fused_driver(monkeypatch):
    # the probes stop at their first overflowing level; the calibrated
    # spec and every label equal the plain loop's
    pts = synth.load("skewed2d", 1500, seed=4)
    tbvh._SPEC_CACHE.clear()
    plain = make_engine(pts, 0.05, engine="bvh", device="cpu")
    ref = dbscan(pts, 0.05, 8, eng=plain)
    monkeypatch.setattr(tbvh, "wavefront_sweep", tbvh.wavefront_sweep_fused)
    tbvh._SPEC_CACHE.clear()
    fused = make_engine(pts, 0.05, engine="bvh", device="cpu")
    assert fused.meta == plain.meta
    for loop in ("device", "frontier"):
        res = dbscan(pts, 0.05, 8, eng=fused, hook_loop=loop)
        for f in ("labels", "core", "counts"):
            assert torch.equal(getattr(res, f), getattr(ref, f))
    tbvh._SPEC_CACHE.clear()


def test_level_counts_end_at_a_zero_count():
    nlive = torch.tensor([5, 3, 0, 0], dtype=torch.int32)
    reader = tbvh._LevelCounts(nlive)
    assert not reader.ended()
    reader.launched(0)
    assert not reader.ended()
    reader.launched(1)
    assert reader.ended() and reader.waits == 0


def _state(dims=3, capacity=1024, payload=False):
    tree, croot, bound, eps, _ = _inputs(dims)
    inputs, counts, minroot, nb, tile, C = tbvh._sweep_setup(
        tree, tree.pts_sorted, croot, eps=eps, capacity=capacity, tile=512,
        batch=8, prune_dtype="bf16", bound=bound if payload else None)
    state = tsweep.new_level_state(counts, minroot, capacity=C, levels=8,
                                   prune_payload=payload)
    state.nlive[0] = 1
    state.fb[0, 0] = 0
    state.fn[0, 0] = 0
    return inputs, state, eps * eps


def test_cpu_calls_count_no_launch_and_bad_inputs_raise():
    tsweep.reset_launches()
    inputs, state, eps2 = _state()
    tsweep.bvh_level(inputs, state, 0, eps2, tile=512)
    assert int(state.nlive[1]) > 0 and int(state.hist[0]) == 1
    assert tsweep.LAUNCHES == {"bvh_batch_sweep": 0, "bvh_level": 0}
    with pytest.raises(ValueError, match="multiple of the tile"):
        tsweep.bvh_level(inputs, state, 0, eps2, tile=300)
    with pytest.raises(ValueError, match="level"):
        tsweep.bvh_level(inputs, state, 8, eps2, tile=512)
    # the arrays are checked once a traversal, by its driver
    tsweep.check_level_arrays(inputs, state, prune_payload=False)
    with pytest.raises(ValueError, match="node_min"):
        tsweep.check_level_arrays(inputs, state, prune_payload=True)
    with pytest.raises(TypeError, match="qblocks"):
        tsweep.check_level_arrays(
            inputs._replace(qblocks=inputs.qblocks.double()), state,
            prune_payload=False)
    with pytest.raises(ValueError, match="status"):
        tsweep.check_level_arrays(
            inputs, state._replace(status=state.status[:1]),
            prune_payload=False)
    # the status words tell 255 levels apart
    deep = tsweep.new_level_state(state.counts, state.minroot,
                                  capacity=state.fb.shape[1], levels=256,
                                  prune_payload=False)
    with pytest.raises(ValueError, match="255"):
        tsweep.check_level_arrays(inputs, deep, prune_payload=False)
    with pytest.raises(ValueError, match="level 255"):
        tsweep.bvh_level(inputs, deep, 255, eps2, tile=512)
    meta_in = tsweep.LevelInputs._make(
        None if x is None else x.to("meta") for x in inputs)
    meta_st = tsweep.LevelState._make(
        None if x is None else x.to("meta") for x in state)
    with pytest.raises(ValueError, match="not meta"):
        tsweep.bvh_level(meta_in, meta_st, 0, eps2, tile=512)


def _c_params(fn):
    src = (tbuild.CSRC_DIR / "bvh_sweep.cu").read_text()
    decl = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    return ["p" if "*" in p else "f" if p.strip().startswith("float")
            else "i" for p in decl.split(",")]


@pytest.mark.parametrize("payload", [False, True])
def test_device_tensors_launch_or_raise_never_plain(monkeypatch, payload):
    # with the device check passed (as CUDA tensors pass it), bvh_level
    # goes to its launcher with the C function's signature, one pointer
    # for each array of the level; a refused launch raises and counts
    # nothing; the plain version is never called
    def boom(*a, **k):
        raise AssertionError("plain version called on a device tensor")
    inputs, state, eps2 = _state(payload=payload)
    meta_in = tsweep.LevelInputs._make(
        None if x is None else x.to("meta") for x in inputs)
    meta_st = tsweep.LevelState._make(
        None if x is None else x.to("meta") for x in state)
    monkeypatch.setattr(tsweep, "_cuda_or_raise", lambda x, kernel: None)
    monkeypatch.setattr(tsweep, "bvh_level_plain", boom)
    launched = []

    def refuse(lib, fn, sig, kernel, device, *args):
        launched.append((lib, fn, sig, kernel, args))
        raise RuntimeError(f"{kernel} launch failed: CUDA error 209")
    monkeypatch.setattr(tbuild, "launch", refuse)
    tsweep.reset_launches()
    with pytest.raises(RuntimeError, match="bvh_level launch failed"):
        tsweep.bvh_level(meta_in, meta_st, 1, eps2, tile=512,
                         prune_payload=payload)
    (lib, fn, sig, kernel, args), = launched
    assert (lib, fn, kernel) == ("bvh_sweep", "bvh_level_launch",
                                 "bvh_level")
    assert len(args) == len(sig) and ["i", *sig, "p"] == _c_params(fn)
    # level 1 reads frontier row 1 and writes row 0
    assert args[0].data_ptr() == meta_st.fb[1].data_ptr()
    assert args[sig.index("f") + 11].data_ptr() == meta_st.fb[0].data_ptr()
    assert (args[10] is None) == (not payload)
    assert tsweep.LAUNCHES["bvh_level"] == 0
