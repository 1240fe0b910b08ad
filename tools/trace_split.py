#!/usr/bin/env python3
"""Where a benchmark cell's calls spend their time, by the program's spans.

    python3 tools/trace_split.py --workload <cell> [--workload <cell> ...] \\
        [--src DIR] [--seed N] [--calls K] [--seconds S] [--rounds R]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
sets up a cell of ``portbench/`` as its harness does: the pool from
``--seed``, the op's set-up, one period of calls to warm every shape. Then:

1. Traced: ``--calls`` calls (default: the mix's ``trace_calls``) under
   ``torch.profiler``, each call's spans and counters taken from
   ``repro_torch.trace.recording()`` where ``DIR`` has the module (an older
   tree runs them unrecorded). Per call, means of what the benchmark reads
   (``plan_ms``, ``build_ms``, ``stage2_ms``, ``hook_rounds``) and of what the
   record holds: ``plan_host_ms`` (``plan.layout``: the host enqueueing the
   plan's one sort-by-cell pass, eager launches the card waits on; the
   plan's two reads, ``plan.bounds`` and ``plan.need``, are left out, since
   there the host waits on the card), ``copy_mib`` (``h2d_bytes`` +
   ``d2h_bytes``, in MiB), ``stage2_syncs`` (``host_syncs`` inside
   ``stage2``), ``host_syncs``, ``jump_steps``, ``kept_gpairs`` (the pairs
   the call's slab sweeps tested, ``sweep_kept_pairs``, in 10^9; absent
   where ``DIR``'s sweeps count none) and each span's host ms.
   The device's busy and window seconds and idle share are
   ``portbench.devtrace.summarize``'s, the benchmark's own; the idle time is
   then named by the innermost span around each gap (:func:`name_gaps`):
   a ``repro_torch.`` span where the host is in one, else a ``portbench.``
   one.
2. Cost: ``--rounds`` pairs of ``--seconds`` windows run untraced, one with
   recording off and one on, in turns (off first in even rounds); a
   window's ms a call is its seconds over its calls, as the benchmark's
   ``dbscan_ms`` (with recording on, every call's record is taken).

Prints one JSON line a cell, with the card's name and power limit. Exits 2
without a CUDA device, unless ``--device cpu`` (a rehearsal at a size the
configuration gives, so only with a shrunk one).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PREFIXES = ("repro_torch.", "portbench.")
PLAN_HOST = ("plan.layout",)


def name_gaps(events):
    """Idle seconds and gaps of a Chrome trace's window by the innermost
    span around each gap: {span name (prefix kept): [seconds, gaps]}.

    The window, the busy time and the gaps are those of
    ``portbench.devtrace.summarize``: from the first to the last
    ``portbench.`` span, busy where a device operation runs. Spans of one
    thread nest, so the innermost span holding a gap's midpoint is the one
    that started last among those that hold it; ``outside_spans`` where
    none does."""
    from portbench.devtrace import DEVICE_CATS, PREFIX, _merge
    spans, device = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        t0, t1 = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        name = ev.get("name", "")
        if ev.get("cat") == "user_annotation" and name.startswith(PREFIXES):
            spans.append((t0, t1, name))
        elif ev.get("cat") in DEVICE_CATS:
            device.append((t0, t1))
    win = [(a, b) for a, b, n in spans if n.startswith(PREFIX)]
    if not win or not device:
        return {}
    w0, w1 = min(a for a, _ in win), max(b for _, b in win)
    gaps, t = [], w0
    for a, b in _merge(device):
        a, b = max(a, w0), min(b, w1)
        if b <= w0 or a >= w1:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    spans.sort()
    starts = [a for a, _, _ in spans]
    out = defaultdict(lambda: [0.0, 0])
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "outside_spans"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[i][1] >= mid:
                name = spans[i][2]
                break
        out[name][0] += (b - a) * 1e-6
        out[name][1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def _mean(values):
    values = list(values)
    return statistics.fmean(values) if values else None


def _call_row(got, record, trace):
    """What one call reports: the benchmark's fields, and the record's."""
    row = {"timings": dict(got.timings),
           "engine_timings": dict(got.engine_timings or {}),
           "n_rounds": got.n_rounds}
    if record is None:
        return row
    span_ms = defaultdict(float)
    for s in record.spans:
        span_ms[s.name] += (s.t1_ns - s.t0_ns) * 1e-6
    row["span_ms"] = dict(span_ms)
    row["plan_host_ms"] = sum(span_ms.get(n, 0.0) for n in PLAN_HOST) \
        if "plan" in span_ms else None
    row["copy_mib"] = (trace.total(record, "h2d_bytes")
                       + trace.total(record, "d2h_bytes")) / 2**20
    row["stage2_syncs"] = trace.total(record, "host_syncs", under="stage2")
    row["host_syncs"] = trace.total(record, "host_syncs")
    row["jump_steps"] = trace.total(record, "jump_steps")
    if any(c == "sweep_kept_pairs" for _, c in record.counts):
        row["kept_gpairs"] = trace.total(record, "sweep_kept_pairs") / 1e9
    return row


def _summary(rows):
    out = {}
    built = [r["engine_timings"] for r in rows
             if "plan_s" in r["engine_timings"]]
    if built:
        out["plan_ms"] = 1e3 * _mean(t["plan_s"] for t in built)
        out["build_ms"] = 1e3 * _mean(t["build_s"] - t["plan_s"]
                                      for t in built)
    out["stage2_ms"] = 1e3 * _mean(r["timings"]["stage2_s"] for r in rows)
    out["hook_rounds"] = _mean(r["n_rounds"] for r in rows)
    for key in ("plan_host_ms", "copy_mib", "stage2_syncs", "host_syncs",
                "jump_steps", "kept_gpairs"):
        vals = [r[key] for r in rows if r.get(key) is not None]
        if vals:
            out[key] = _mean(vals)
            out[key + "_range"] = [min(vals), max(vals)]
    names = sorted({n for r in rows for n in r.get("span_ms", {})})
    if names:
        out["span_ms"] = {n: _mean(r["span_ms"].get(n, 0.0) for r in rows)
                          for n in names}
    return out


def run(cell_name, seed, calls, seconds, rounds, device):
    import torch

    from portbench import devtrace, harness
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ModuleNotFoundError:
        trace = None
    cell = harness.load_cell(cell_name)
    cfg, tr = cell.config, cell.traffic
    op = harness.load_op(tr["op"])
    dev = torch.device(device)
    ctx = harness.Context(cfg, tr, harness.make_pool(cfg, tr, seed), dev)
    op.setup(ctx)
    period = harness.schedule(cfg, tr)

    def call(i, span):
        return op.call(ctx, harness.job(i, period), span)

    for i in range(len(period)):
        call(i, harness._no_span)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    # 1. traced calls, each call's record taken
    n_calls = calls or tr["trace_calls"]
    rows = []
    record_ctx = trace.recording() if trace else contextlib.nullcontext()
    prof = devtrace.profiler()
    with record_ctx as rec:
        prof.start()
        for i in range(n_calls):
            got = call(i, devtrace.span)
            with devtrace.span("between_calls"):
                rows.append(_call_row(got, rec.take() if rec else None,
                                      trace))
        prof.stop()
    events = _events(prof)
    summary = devtrace.summarize(events)
    line = {"workload": cell_name, "seed": seed, "traced_calls": n_calls,
            "recorded": trace is not None, **_summary(rows)}
    if summary is not None:
        line.update(busy_s=summary.busy_s, window_s=summary.window_s,
                    device_idle_pct=100.0 * (summary.window_s
                                             - summary.busy_s)
                    / summary.window_s,
                    device_ops=summary.device_ops)
        line["idle_by_span"] = name_gaps(events)

    # 2. the cost of recording: untraced windows, off and on in turns
    i = n_calls
    per_call = {"off": [], "on": []}
    for r in range(rounds):
        modes = ("off", "on") if r % 2 == 0 else ("on", "off")
        for mode in modes:
            if mode == "on" and trace is None:
                continue
            ctx_mgr = trace.recording() if mode == "on" else \
                contextlib.nullcontext()
            with ctx_mgr as rec:
                k, t0 = 0, time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    call(i, harness._no_span)
                    if rec is not None:
                        rec.take()
                    i, k = i + 1, k + 1
                per_call[mode].append(1e3 * (time.perf_counter() - t0) / k)
    line["dbscan_ms"] = {m: v for m, v in per_call.items() if v}
    line["dbscan_ms_median"] = {m: statistics.median(v)
                                for m, v in per_call.items() if v}
    return line


def _events(prof):
    """The stopped profiler's Chrome trace events (through a temporary
    file under ``TMPDIR``, deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=2_147_486_001)
    ap.add_argument("--calls", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    import torch
    on_card = args.device.startswith("cuda")
    if on_card and not torch.cuda.is_available():
        print("trace_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    card = "no card"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    for name in args.workload:
        line = run(name, args.seed, args.calls, args.seconds, args.rounds,
                   args.device)
        line.update(src=args.src, card=card)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
