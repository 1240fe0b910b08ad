"""``repro_torch.trace``, the program's spans and counters, on the CPU.

Off, a span is one shared no-op context that records and allocates
nothing. On, spans nest by thread and counters go to the innermost open
span. ``trace.timed`` writes the same ``timings`` keys either way. Under
``recording()``, ``dbscan`` opens one ``stage2.round`` span a hooking round
in each round driver, its ``jump_steps`` and ``host_syncs`` equal counts
taken by wrapping ``torch.equal`` and ``trace.synchronize``, and its
labels, core flags and round counts are those of a run with recording off.
``serve.assign`` opens its four host-path spans in order.

The bytes copied to the card at the benchmark's sizes are held in one
``cuda``-marked test, which skips here; on the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_trace.py
"""
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import dbscan, make_engine, serve, trace
from repro_torch.data import synth

CASES = [
    ("roadnet", lambda: synth.load("roadnet2d", 2000, seed=2), 0.03, 4),
    ("iono", lambda: synth.load("iono3d", 1500, seed=4), 10.0, 8),
    ("blobs3d", lambda: synth.blobs(800, k=4, dims=3, seed=1), 0.12, 5),
]
DRIVERS = ["device", "frontier", "host"]
PLAN_SPANS = ["plan.bounds", "plan.layout", "plan.need"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: one intra-op thread each keeps them
    fast beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(rec, parent=None):
    """Names of the spans under ``parent`` (id), in the order they
    opened."""
    return [s.name for s in sorted(rec.spans, key=lambda s: s.t0_ns)
            if s.parent == parent]


def _one(rec, name):
    (s,) = [s for s in rec.spans if s.name == name]
    return s


# --- the module ------------------------------------------------------------

def test_off_span_is_one_shared_noop_and_records_nothing():
    assert not trace._on
    first = trace.span("x")
    assert trace.span("y", round=3) is first
    with first as got:
        assert got is None
        trace.count("host_syncs")
    with trace.recording() as rec:
        pass
    assert rec.take() == ([], {})
    assert getattr(trace._local, "stack", []) == []


def test_off_span_allocates_nothing():
    def spans(k):
        for i in range(k):
            with trace.span("stage2.round", round=i):
                trace.count("jump_steps")

    spans(100)                        # warm every cache first
    tracemalloc.start()
    try:
        spans(100)
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spans(20_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # a recorded span keeps ~200 B: 20,000 of them would be megabytes
    assert after - before < 1024
    assert peak - before < 1024


def test_spans_nest_and_counters_go_to_the_innermost_span():
    with trace.recording() as rec:
        trace.count("loose", 2)
        with trace.span("a", k=1):
            trace.count("c")
            with trace.span("b"):
                trace.count("c", 5)
                trace.count("d")
            with trace.span("b2"):
                pass
            trace.count("c")
        got = rec.take()
        assert rec.take() == ([], {})        # take clears
    a, b, b2 = _one(got, "a"), _one(got, "b"), _one(got, "b2")
    assert a.parent is None and b.parent == a.id and b2.parent == a.id
    assert a.attrs == {"k": 1} and b.attrs == {}
    assert [s.name for s in got.spans] == ["b", "b2", "a"]   # as they closed
    assert a.t0_ns <= b.t0_ns <= b.t1_ns <= b2.t0_ns <= b2.t1_ns <= a.t1_ns
    assert got.counts == {(None, "loose"): 2, (a.id, "c"): 2,
                          (b.id, "c"): 5, (b.id, "d"): 1}
    assert trace.total(got, "c") == 7
    assert trace.total(got, "c", under="b") == 5
    assert trace.total(got, "c", under="a") == 7
    assert trace.total(got, "loose", under="a") == 0
    assert not trace._on


def test_spans_of_threads_nest_apart():
    barrier = threading.Barrier(2, timeout=30)

    def work(name):
        with trace.span(name):
            barrier.wait()
            with trace.span(name + ".inner"):
                trace.count("n")
            barrier.wait()

    with trace.recording() as rec:
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("t0", "t1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        got = rec.take()
    for name in ("t0", "t1"):
        outer, inner = _one(got, name), _one(got, name + ".inner")
        assert outer.parent is None and inner.parent == outer.id
        assert got.counts[(inner.id, "n")] == 1


@pytest.mark.parametrize("on", [False, True])
def test_timed_writes_the_same_keys_off_and_on(on, monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    card = torch.device("cuda")        # a descriptor: nothing runs on it
    timings = {}
    with trace.recording() if on else trace.span("unused") as rec:
        with trace.timed(timings, "stage1_s", card):
            pass
        with trace.timed(timings, "plan_s"):
            pass
        with trace.timed(timings, "build_s", card, name="engine.build"):
            pass
        got = rec.take() if on else None
    assert list(timings) == ["stage1_s", "plan_s", "build_s"]
    assert all(isinstance(v, float) and v >= 0 for v in timings.values())
    assert synced == [card, card]      # synchronized, recording or not
    if on:
        assert [s.name for s in got.spans] == ["stage1", "plan",
                                               "engine.build"]
        assert trace.total(got, "host_syncs") == 2


def test_timed_leaves_its_key_unwritten_when_the_block_raises():
    timings = {}
    with trace.recording() as rec:
        with pytest.raises(ValueError):
            with trace.timed(timings, "stage2_s", torch.device("cpu")):
                raise ValueError("boom")
        got = rec.take()
    assert timings == {}
    assert [s.name for s in got.spans] == ["stage2"]
    assert trace._local.stack == []


def test_copy_counter_counts_only_across_the_host_boundary():
    cpu, card = torch.device("cpu"), torch.device("cuda:0")
    assert trace.copy_counter(cpu, cpu) is None
    assert trace.copy_counter(card, torch.device("cuda:1")) is None
    assert trace.copy_counter(cpu, card) == "h2d_bytes"
    assert trace.copy_counter(card, cpu) == "d2h_bytes"
    assert trace.copy_counter(cpu, torch.device("meta")) == "h2d_bytes"


def test_to_device_counts_the_bytes_it_moves():
    pts = np.zeros((1000, 3), np.float32)
    with trace.recording() as rec:
        with trace.span("s"):
            a = trace.to_device(pts, torch.device("cpu"))
            b = trace.to_device(pts, torch.device("meta"))  # off the host
            c = trace.to_device(torch.as_tensor(pts), torch.device("meta"),
                                torch.float64)
            h = trace.to_host(a)
        got = rec.take()
    assert a.device.type == h.device.type == "cpu"
    assert b.device.type == c.device.type == "meta"
    assert trace.total(got, "h2d_bytes") == 12_000 + 24_000
    assert trace.total(got, "d2h_bytes") == 0         # a was on the host
    assert trace.total(got, "host_syncs") == 1


def test_a_span_opens_record_function_while_the_profiler_runs():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with trace.span("not_recorded"):
            pass
        with trace.recording() as rec:
            with trace.span("outer"):
                with trace.span("inner"):
                    torch.ones(4).sum()
            rec.take()
    names = {e.name for e in prof.events()}
    assert {"repro_torch.outer", "repro_torch.inner"} <= names
    assert "repro_torch.not_recorded" not in names


# --- the main path ----------------------------------------------------------

def _counting(monkeypatch):
    """Count calls of ``torch.equal`` and ``trace.synchronize``, the points
    where the driver waits for the device, apart from the trace module's
    own counters."""
    calls = {"equal": 0, "sync": 0}
    equal, sync = torch.equal, trace.synchronize

    def counted_equal(a, b):
        calls["equal"] += 1
        return equal(a, b)

    def counted_sync(device):
        calls["sync"] += 1
        return sync(device)
    monkeypatch.setattr(torch, "equal", counted_equal)
    monkeypatch.setattr(trace, "synchronize", counted_sync)
    return calls


@pytest.mark.parametrize("hook_loop", DRIVERS)
@pytest.mark.parametrize("name,make,eps,min_pts", CASES,
                         ids=[c[0] for c in CASES])
def test_dbscan_records_a_round_span_each_round(name, make, eps, min_pts,
                                                hook_loop, monkeypatch):
    pts = make()
    eng = make_engine(pts, eps, device="cpu")
    off = dbscan(pts, eps, min_pts, eng=eng, hook_loop=hook_loop)
    calls = _counting(monkeypatch)
    with trace.recording() as rec:
        on = dbscan(pts, eps, min_pts, eng=eng, hook_loop=hook_loop)
        got = rec.take()
    for f in ("labels", "core", "counts"):
        np.testing.assert_array_equal(getattr(on, f).numpy(),
                                      getattr(off, f).numpy(), err_msg=f)
    assert on.n_rounds == off.n_rounds >= 1
    # the grid's counts-only sweep (sorted drivers) reports its kept pairs,
    # read once after stage 1: one more host sync
    kept = hook_loop != "host"
    assert set(on.timings) == set(off.timings) == {
        "stage1_s", "stage2_s", "border_s"} | ({"stage1_kept_pairs"}
                                               if kept else set())
    assert on.timings.get("stage1_kept_pairs") == \
        off.timings.get("stage1_kept_pairs")

    top = _one(got, "dbscan")
    assert top.parent is None
    assert _names(got, top.id) == ["stage1", "stage2", "border"]
    stage2 = _one(got, "stage2")
    rounds = [s for s in got.spans if s.name == "stage2.round"]
    assert len(rounds) == on.n_rounds
    assert all(s.parent == stage2.id for s in rounds)
    assert [s.attrs["round"] for s in sorted(rounds, key=lambda s: s.t0_ns)
            ] == list(range(on.n_rounds))

    # every torch.equal is one step of pointer_jump or _hook_step's check
    jumps = trace.total(got, "jump_steps")
    assert jumps == calls["equal"] - on.n_rounds
    assert trace.total(got, "host_syncs") == calls["equal"] + calls["sync"] \
        + kept
    assert calls["sync"] == 3               # stage 1, stage 2, the border
    # a round: two jumps and the check; then the loop's last jump and the
    # synchronize, in every driver
    s2 = trace.total(got, "host_syncs", under="stage2")
    assert s2 >= 3 * on.n_rounds + 2
    assert trace.total(got, "h2d_bytes") == trace.total(got, "d2h_bytes") \
        == 0                                 # nothing leaves the CPU


def test_make_engine_records_the_plan_and_the_build():
    pts = synth.load("roadnet2d", 2000, seed=2)
    ref = make_engine(pts, 0.03, device="cpu")
    with trace.recording() as rec:
        eng = make_engine(pts, 0.03, device="cpu")
        got = rec.take()
    assert eng.meta == ref.meta
    assert list(eng.timings) == list(ref.timings) == ["plan_s", "build_s"]
    for f in eng.state._fields:
        assert torch.equal(getattr(eng.state, f), getattr(ref.state, f)), f

    top = _one(got, "make_engine")
    assert top.parent is None and top.attrs == {"engine": "grid"}
    assert _names(got, top.id) == ["engine.to_device", "engine.build"]
    build = _one(got, "engine.build")
    assert _names(got, build.id) == ["plan", "build.slabs", "build.check"]
    assert _names(got, _one(got, "plan").id) == PLAN_SPANS
    # the bounds read (plan.bounds), the worst tile extent's read
    # (plan.need), the overflow flag (build.check), the synchronize that
    # ends build_s (engine.build)
    assert trace.total(got, "host_syncs") == 4
    for name in ("plan.bounds", "plan.need", "build.check"):
        assert trace.total(got, "host_syncs", under=name) == 1, name
    assert trace.total(got, "h2d_bytes") == trace.total(got, "d2h_bytes") \
        == 0


@pytest.mark.parametrize("reuse", [False, True],
                         ids=["planned", "spec_passed"])
def test_one_csr_layout_a_build_and_none_in_dbscan(reuse):
    pts = synth.load("roadnet2d", 2000, seed=2)
    ref = make_engine(pts, 0.03, device="cpu")
    with trace.recording() as rec:
        eng = make_engine(pts, 0.03, spec=ref.meta if reuse else None,
                          device="cpu")
        dbscan(pts, 0.03, 4, eng=eng)
        got = rec.take()
    assert eng.meta == ref.meta
    for f in eng.state._fields:
        assert torch.equal(getattr(eng.state, f), getattr(ref.state, f)), f
    assert trace.total(got, "csr_layouts") == 1
    assert trace.total(got, "csr_layouts", under="engine.build") == 1
    assert trace.total(got, "csr_layouts", under="dbscan") == 0
    # the plain loop on the CPU: a layout, and no window-bounds launch
    assert trace.total(got, "window_bounds_launches") == 0
    build = _one(got, "engine.build")
    if reuse:
        assert _names(got, build.id) == ["build.layout", "build.slabs",
                                         "build.check"]
        assert list(eng.timings) == ["plan_s", "build_s"]
        assert eng.timings["plan_s"] == 0.0
    else:
        assert _one(got, "plan.layout").parent == _one(got, "plan").id


def test_other_engines_record_only_the_build():
    pts = synth.load("roadnet2d", 600, seed=3)
    for engine in ("brute", "bvh"):
        with trace.recording() as rec:
            make_engine(pts, 0.03, engine=engine, device="cpu")
            got = rec.take()
        top = _one(got, "make_engine")
        assert _names(got, top.id) == ["engine.to_device", "engine.build"]
        assert _names(got, _one(got, "engine.build").id) == []


def test_precomputed_counts_rerun_records_rounds_only():
    pts = synth.load("roadnet2d", 2000, seed=2)
    eng = make_engine(pts, 0.03, device="cpu")
    counts = dbscan(pts, 0.03, 4, eng=eng).counts
    with trace.recording() as rec:
        res = dbscan(pts, 0.03, 8, eng=eng, precomputed_counts=counts)
        got = rec.take()
    assert not any(s.name.startswith(("plan", "make_engine", "build"))
                   for s in got.spans)
    assert sum(s.name == "stage2.round" for s in got.spans) == res.n_rounds


def test_stage2_syncs_repeat_for_one_input():
    pts = synth.load("roadnet2d", 2000, seed=5)
    eng = make_engine(pts, 0.03, device="cpu")
    seen = []
    for _ in range(2):
        with trace.recording() as rec:
            dbscan(pts, 0.03, 4, eng=eng)
            got = rec.take()
        seen.append((trace.total(got, "host_syncs", under="stage2"),
                     trace.total(got, "jump_steps")))
    assert seen[0] == seen[1]


def test_assign_records_its_host_path_in_order():
    pts = synth.load("roadnet2d", 1500, seed=6)
    snap = serve.build_snapshot(pts, 0.03, 4, device="cpu")
    q = synth.load("roadnet2d", 300, seed=7, structure_seed=6,
                   structure_n=1500)
    off = serve.assign(snap, q)
    with trace.recording() as rec:
        on = serve.assign(snap, q)
        got = rec.take()
    for f in ("labels", "counts", "dist"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f))
    assert on.bucket == off.bucket and on.seconds > 0
    top = _one(got, "serve.assign")
    assert top.parent is None
    assert _names(got, top.id) == ["assign.pad", "assign.to_device",
                                   "assign.sweep", "assign.readback"]
    # the sweep's synchronize and overflow flag; three arrays read back
    assert trace.total(got, "host_syncs", under="assign.sweep") == 2
    assert trace.total(got, "host_syncs", under="assign.readback") == 3


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bytes counted are those "
                    "copied to and from the card (torch.cuda.is_available() "
                    "is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dataset,n,eps,mib", [
    ("roadnet2d", 434_874, 0.02, 4.98), ("iono3d", 1_000_000, 2.0, 11.44)])
def test_a_cluster_call_copies_the_points_once_and_the_plans_scalars(
        card, dataset, n, eps, mib):
    """Points to the card once (n × 12 B); back to the host only scalars:
    the plan's (2, 3) f32 bounds and int32 worst tile extent, and stage
    1's int32 kept-run count."""
    pts = synth.load(dataset, n, seed=0)
    make_engine(pts, eps, device=card)              # build the kernels
    with trace.recording() as rec:
        eng = make_engine(pts, eps, device=card)
        res = dbscan(pts, eps, 8, eng=eng)
        got = rec.take()
    assert trace.total(got, "h2d_bytes") == n * 12
    assert trace.total(got, "d2h_bytes") == 2 * 3 * 4 + 4 + 4
    moved = trace.total(got, "h2d_bytes") + trace.total(got, "d2h_bytes")
    assert abs(moved / 2**20 - mib) < 0.01
    assert trace.total(got, "h2d_bytes", under="dbscan") == 0
    assert trace.total(got, "csr_layouts") == 1
    assert trace.total(got, "window_bounds_launches") == 1
    assert trace.total(got, "window_bounds_launches",
                       under="plan.layout") == 1
    assert sum(s.name == "stage2.round" for s in got.spans) == res.n_rounds
