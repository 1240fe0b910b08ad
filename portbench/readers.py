"""What the per-metric readers in ``metrics/`` compute, from a run's
``harness.Outcome``. Each returns None where it finds nothing to read, and
the harness then leaves its metric out of the result."""
from __future__ import annotations

import math

from .roofline import stage1_least_s


def window_ms(window_s: float, calls: int) -> float | None:
    """Milliseconds a call: the whole window over the calls completed in
    it (the time between calls included)."""
    if calls < 1:
        return None
    return 1000.0 * window_s / calls


def percentile(values, q: float) -> tuple[float, int] | None:
    """The nearest-rank ``q``-th percentile of ``values`` and the number of
    values that lie above its rank."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1], len(ordered) - rank


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def call_ms(out):
    """Milliseconds a call: the window's seconds over its calls (host
    clock), the time between calls included."""
    return window_ms(out.window_s, len(out.calls))


def p95_ms(out):
    """The 95th percentile of the window's calls, each timed on the host
    clock from the points handed in to the labels on the host (ms)."""
    p = percentile([c.seconds for c in out.calls], 95)
    return None if p is None else 1000.0 * p[0]


def peak_gib(out):
    """``torch.cuda.max_memory_allocated()`` over the window, reset at its
    start (GiB)."""
    if out.memory_peak_bytes is None:
        return None
    return out.memory_peak_bytes / 2**30


def setup_s(out):
    """Seconds from the process's start to the window's."""
    return out.setup_s


def _engine_ms(out, part):
    rows = [c.engine_timings for c in out.calls
            if c.engine_timings and "plan_s" in c.engine_timings]
    v = mean(part(t) for t in rows)
    return None if v is None else 1000.0 * v


def plan_ms(out):
    """Mean ``Engine.timings["plan_s"]`` of the calls that built their
    engine (ms)."""
    return _engine_ms(out, lambda t: t["plan_s"])


def build_ms(out):
    """Mean ``build_s - plan_s`` of the calls that built their engine (ms):
    the device build after the plan."""
    return _engine_ms(out, lambda t: t["build_s"] - t["plan_s"])


def stage2_ms(out):
    """Mean ``DBSCANResult.timings["stage2_s"]`` (ms): the hooking rounds
    from the first to the last compression."""
    v = mean(c.timings["stage2_s"] for c in out.calls
             if "stage2_s" in c.timings)
    return None if v is None else 1000.0 * v


def hook_rounds(out):
    """Mean ``DBSCANResult.n_rounds``: hooking rounds a call (a count)."""
    return mean(c.n_rounds for c in out.calls)


def stage1_roofline(out):
    """The least time stage 1's work could take on the card
    (``roofline.stage1_least_s``, from the reference's pair count) over
    the mean ``DBSCANResult.timings["stage1_s"]`` (%)."""
    calls = [c for c in out.calls if "stage1_s" in c.timings
             and (c.dataset, c.eps) in out.ref_pairs]
    spent = mean(c.timings["stage1_s"] for c in calls)
    if not spent:
        return None
    least = mean(stage1_least_s(out.ref_pairs[(c.dataset, c.eps)], out.n)
                 for c in calls)
    return 100.0 * least / spent


def device_idle_pct(out):
    """The share of the traced window in which no kernel, copy or fill ran
    on the card (torch.profiler), in %."""
    t = out.traced
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
