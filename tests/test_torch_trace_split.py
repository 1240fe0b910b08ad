"""``tools/trace_split.py``'s naming of idle gaps by the program's spans,
on synthetic Chrome-trace events: a gap is named by the innermost span
around it (a ``repro_torch.`` span where the host is in one, else the
benchmark's), and the idle time it names is the window less the busy time
that ``portbench.devtrace.summarize`` reads, with or without the
program's spans in the trace. Then ``_call_row`` and ``_summary`` on the
record of a small CPU call."""
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import devtrace  # noqa: E402

from repro_torch import dbscan, make_engine, trace  # noqa: E402
from repro_torch.data import synth  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "trace_split", ROOT / "tools" / "trace_split.py")
split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(split)


def _span(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0}


def _op(t0, t1, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}


BENCH = [_span("portbench.make_engine", 0, 100),
         _span("portbench.dbscan", 100, 200),
         _span("portbench.between_calls", 200, 210)]
PROGRAM = [_span("repro_torch.make_engine", 1, 99),
           _span("repro_torch.engine.build", 2, 98),
           _span("repro_torch.plan", 3, 60),
           _span("repro_torch.plan.bounds", 4, 40),
           _span("repro_torch.plan.need", 45, 55),
           _span("repro_torch.dbscan", 101, 199),
           _span("repro_torch.stage2", 110, 190),
           _span("repro_torch.stage2.round", 111, 150),
           _span("repro_torch.stage2.round", 151, 189)]
DEVICE = [_op(-5, 2), _op(40, 45, "gpu_memcpy", "Memcpy HtoD"),
          _op(55, 58), _op(58, 97, "gpu_memset"), _op(130, 140),
          _op(135, 145), _op(160, 170), _op(205, 230)]
# idle gaps, by midpoint: 2-40 (21) in plan.bounds, 45-55 (50) in
# plan.need, 97-130 (113.5) in round 0, 145-160 (152.5) and 170-205
# (187.5) in round 1


def test_gaps_are_named_by_the_innermost_span():
    got = split.name_gaps(BENCH + PROGRAM + DEVICE)
    assert got == {
        "repro_torch.plan.bounds": [pytest.approx(38e-6), 1],
        "repro_torch.stage2.round": [pytest.approx(83e-6), 3],
        "repro_torch.plan.need": [pytest.approx(10e-6), 1],
    }


def test_without_program_spans_gaps_fall_to_the_benchmark_spans():
    got = split.name_gaps(BENCH + DEVICE)
    assert got == {
        "portbench.dbscan": [pytest.approx(83e-6), 3],
        "portbench.make_engine": [pytest.approx(48e-6), 2],
    }


def test_gaps_outside_every_span_and_an_empty_trace():
    events = [_span("portbench.a", 0, 10), _span("portbench.b", 20, 30),
              _op(0, 10), _op(18, 19), _op(25, 30)]
    assert split.name_gaps(events) == {
        "outside_spans": [pytest.approx(8e-6), 1],
        "portbench.b": [pytest.approx(6e-6), 1]}
    assert split.name_gaps(BENCH) == {}
    assert split.name_gaps(DEVICE) == {}


@pytest.mark.parametrize("program", [False, True])
def test_idle_named_is_the_benchmarks_window_less_busy(program):
    events = BENCH + DEVICE + (PROGRAM if program else [])
    summary = devtrace.summarize(events)
    plain = devtrace.summarize(BENCH + DEVICE)
    # the program's spans move none of the benchmark's numbers
    assert summary == plain
    idle = sum(s for s, _ in split.name_gaps(events).values())
    assert math.isclose(idle, summary.window_s - summary.busy_s,
                        rel_tol=1e-12)
    assert summary.window_s == pytest.approx(210e-6)


def test_a_call_row_reads_the_record():
    pts = synth.load("roadnet2d", 1500, seed=3)
    with trace.recording() as rec:
        eng = make_engine(pts, 0.03, device="cpu")
        res = dbscan(pts, 0.03, 4, eng=eng)
        record = rec.take()
    got = type("Output", (), {"timings": res.timings,
                              "engine_timings": eng.timings,
                              "n_rounds": res.n_rounds})
    row = split._call_row(got, record, trace)
    assert row["copy_mib"] == 0.0                      # a CPU run
    assert row["stage2_syncs"] == trace.total(record, "host_syncs",
                                              under="stage2")
    assert row["stage2_syncs"] >= 3 * res.n_rounds + 2
    assert 0 < row["plan_host_ms"] < 1e3 * eng.timings["plan_s"]
    assert row["span_ms"]["stage2.round"] <= row["span_ms"]["stage2"]
    out = split._summary([row, row])
    assert out["hook_rounds"] == res.n_rounds
    assert out["plan_ms"] == pytest.approx(1e3 * eng.timings["plan_s"])
    assert out["stage2_syncs_range"] == [row["stage2_syncs"]] * 2
    assert np.isclose(out["build_ms"], 1e3 * (eng.timings["build_s"]
                                              - eng.timings["plan_s"]))
