"""The metric arithmetic on hand-made cases: the window's rate, the tail
with its count, the roofline's pair and byte counts, the trace's busy
time and idle gaps, the comparison, and the readers."""
import pytest
import torch

from portbench import check, devtrace, harness, readers, roofline
from portbench.reference import dbscan as ref


def test_window_rate():
    assert readers.window_ms(10.0, 200) == pytest.approx(50.0)
    assert readers.window_ms(10.0, 0) is None


def test_p95_is_nearest_rank_with_the_count_beyond_it():
    assert readers.percentile([float(v) for v in range(1, 201)], 95) == \
        (190.0, 10)
    assert readers.percentile([3.0, 1.0, 2.0], 95) == (3.0, 0)
    assert readers.percentile([], 95) is None


def test_roofline_counts_pairs_and_bytes():
    # four points: two within ε of each other, two alone; 6 ordered pairs
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [5.0, 5.0, 0.0],
                        [9.0, 1.0, 0.0]]).numpy()
    pairs = int(ref.neighbour_pairs(pts, 0.2, 2, device="cpu").counts.sum())
    assert pairs == 6
    assert roofline.stage1_flops(pairs) == 60.0
    assert roofline.stage1_bytes(4) == 64.0
    # bytes-bound here: 64 B at 3.35 TB/s exceeds 60 FLOP at 67 TFLOP/s
    assert roofline.stage1_least_s(pairs, 4) == pytest.approx(64 / 3.35e12)
    # operations-bound for a dense cloud: 138 pairs a point (iono3d-1m)
    assert roofline.stage1_least_s(137_700_000, 1_000_000) == \
        pytest.approx(1.377e9 / 67e12)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_time_and_idle_gaps_by_span():
    events = [
        _ev("user_annotation", "portbench.make_engine", 0, 50),
        _ev("user_annotation", "portbench.dbscan", 50, 40),
        _ev("user_annotation", "portbench.labels_to_host", 90, 10),
        _ev("user_annotation", "aten::mul", 20, 1),   # not a call's part
        _ev("kernel", "sweep", 40, 20),          # overlaps the next
        _ev("kernel", "sweep", 55, 10),
        _ev("gpu_memcpy", "Memcpy DtoH", 92, 4),
        _ev("cpu_op", "aten::add", 0, 100),      # host work: not the device
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    t = devtrace.summarize(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(29e-6)       # [40, 65] and [92, 96]
    assert t.device_ops[0] == ["sweep", pytest.approx(30e-6)]
    # [0, 40] in make_engine, [65, 92] in dbscan, [96, 100] after
    assert t.idle_gaps == [
        ["make_engine (1 gaps)", pytest.approx(40e-6)],
        ["dbscan (1 gaps)", pytest.approx(27e-6)],
        ["labels_to_host (1 gaps)", pytest.approx(4e-6)],
        ["make_engine (one gap)", pytest.approx(40e-6)],
        ["dbscan (one gap)", pytest.approx(27e-6)],
        ["labels_to_host (one gap)", pytest.approx(4e-6)]]


def test_trace_without_device_work_reads_nothing():
    assert devtrace.summarize([_ev("user_annotation", "portbench.dbscan",
                                   0, 5)]) is None


def test_comparison_counts_each_layer():
    want = ref.Answer(torch.tensor([3, 3, 3, 1, 2], dtype=torch.int32),
                      torch.tensor([True, True, True, False, False]),
                      torch.tensor([0, 0, 0, -1, 0], dtype=torch.int32))
    same = check.compare(want, want.counts, want.core, want.labels)
    assert same == dict.fromkeys(check.LIMITS, 0) and check.within(same)
    # the same partition under other ids: only the labels differ
    renamed = torch.tensor([7, 7, 7, -1, 7], dtype=torch.int32)
    got = check.compare(want, want.counts, want.core, renamed)
    assert got["partition_mismatch"] == 0 and got["label_mismatch"] == 4
    split = torch.tensor([0, 0, 2, -1, 0], dtype=torch.int32)
    got = check.compare(want, want.counts, want.core, split)
    assert got["partition_mismatch"] == 1 and not check.within(got)
    counts = want.counts.clone()
    counts[3] = 2
    got = check.compare(want, counts, want.core, want.labels)
    assert got["count_mismatch"] == 1 and got["core_mismatch"] == 0


def _outcome(**kw):
    calls = [harness.Call(i, i % 2, 2.0, 8, 0.1 + 0.01 * i,
                          {"stage1_s": 0.002, "stage2_s": 0.01,
                           "border_s": 0.001},
                          {"plan_s": 0.05, "build_s": 0.06}, 6 + i % 2)
             for i in range(4)]
    base = dict(setup_s=9.5, window_s=0.5, calls=calls, attempted=4,
                memory_peak_bytes=3 * 2**30, ref_s=0.1,
                traced=devtrace.TraceSummary(0.2, 1.0, [], []),
                ref_pairs={(0, 2.0): 1_340_000_000, (1, 2.0): 1_340_000_000},
                checks=dict.fromkeys(check.LIMITS, 0), compared=2,
                failed=0, n=1_000_000)
    base.update(kw)
    return harness.Outcome(**base)


def test_readers_on_a_made_up_outcome():
    out = _outcome()
    want = {"dbscan_ms": 125.0, "dbscan_p95_ms": 130.0,
            "dbscan_p95_ms.host": 130.0, "peak_mem_gib": 3.0,
            "setup_s": 9.5, "plan_ms": 50.0, "build_ms": 10.0,
            "stage2_ms": 10.0, "hook_rounds": 6.5,
            "stage1_roofline": 100 * 2e-4 / 2e-3, "device_idle_pct": 80.0}
    for name, value in want.items():
        assert harness.load_reader(name)(out) == pytest.approx(value), name
    assert out.correct


def test_the_roofline_reads_only_calls_whose_pairs_it_knows():
    # the pairs are known for (dataset, ε) = (0, 2.0) only: half the calls
    out = _outcome(ref_pairs={(0, 2.0): 670_000_000})
    assert harness.load_reader("stage1_roofline")(out) == \
        pytest.approx(100 * 1e-4 / 2e-3)
    assert harness.load_reader("stage1_roofline")(_outcome(ref_pairs={})) \
        is None


def test_readers_that_find_nothing_return_nothing():
    out = _outcome(traced=None, memory_peak_bytes=None, calls=[
        harness.Call(0, 0, 2.0, 8, 0.1, {}, None, 3)])
    for name in ("plan_ms", "build_ms", "stage2_ms", "stage1_roofline",
                 "device_idle_pct", "peak_mem_gib"):
        assert harness.load_reader(name)(out) is None, name
