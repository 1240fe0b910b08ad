"""The device trace of a traced window, from ``torch.profiler``.

The harness marks the parts of each call with :func:`span`, a
``record_function`` whose name starts with ``PREFIX``; the profiler
records them beside the card's kernels, copies and fills on one
clock. :func:`summarize` reads the exported Chrome trace: the traced
window runs from the first span's start to the last span's end; the device
is busy where a kernel, copy or fill runs; every stretch of the window
where none runs is an idle gap, named by the span the host was in. The
breakdown gives the idle time under each span, then the longest gaps.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160              # device operation names are cut to this


class TraceSummary(NamedTuple):
    busy_s: float                 # seconds in which a device operation ran
    window_s: float               # the traced window's length
    device_ops: list              # [[name, seconds], ...], most time first
    idle_gaps: list               # [[what, seconds], ...]: idle time by
    #                               span, then the longest single gaps


def profiler():
    """A profiler of the host and the card, not yet started."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def span(name: str):
    """Mark a part of a call (``make_engine``, ``dbscan``, ...) in the
    trace."""
    from torch.profiler import record_function
    return record_function(PREFIX + name)


def read(prof) -> TraceSummary | None:
    """Summarize a stopped profiler's trace (written to a temporary file
    under ``TMPDIR`` and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events) -> TraceSummary | None:
    """Busy time, the top device operations and the longest idle gaps of
    a Chrome trace's events (times in microseconds). None where the trace
    holds no span or no device operation."""
    spans, device = [], []
    op_time = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        t0, dur = float(ev["ts"]), float(ev["dur"])
        cat = ev.get("cat")
        name = ev.get("name", "")
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((t0, t0 + dur, name[len(PREFIX):]))
        elif cat in DEVICE_CATS:
            device.append((t0, t0 + dur))
            op_time[ev.get("name", cat)] += dur
    if not spans or not device:
        return None
    spans.sort()
    w0, w1 = spans[0][0], max(b for _, b, _ in spans)
    busy = [[max(a, w0), min(b, w1)] for a, b in _merge(device)
            if b > w0 and a < w1]
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    starts = [a for a, _, _ in spans]

    def where(a, b):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        # spans do not nest: the one starting last before mid holds it, if any
        if i >= 0 and spans[i][1] >= mid:
            return spans[i][2]
        return "outside_spans"

    named = [(where(a, b), (b - a) * 1e-6) for a, b in gaps]
    totals, count = defaultdict(float), defaultdict(int)
    for span, sec in named:
        totals[span] += sec
        count[span] += 1
    idle = [[f"{span} ({count[span]} gaps)", sec] for span, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])]
    longest = sorted(named, key=lambda g: -g[1])[:TOP - len(idle)]
    ops = sorted(op_time.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        device_ops=[[name[:NAME_CHARS], us * 1e-6] for name, us in ops[:TOP]],
        idle_gaps=idle + [[f"{span} (one gap)", sec]
                          for span, sec in longest])
