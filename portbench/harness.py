"""The one generator and the run of a cell.

A cell is found by name: ``workloads/<cell>.json`` names its configuration
and traffic mix, ``BENCHMARK.json`` the configuration's file and the
metrics the cell reports. A traffic mix is a closed loop with one client,
an analyst or pipeline that waits for each answer, stated by the
parameters of ``traffic/<mix>.json``:

  * ``op``: the entry of the program that each call drives, the module
    ``ops/<op>.py`` (``setup(ctx)`` once, ``call(ctx, job, span)`` a
    call);
  * ``pool``: datasets drawn at set-up, dataset k from seed ``seed·pool +
    k``;
  * ``min_pts``: the minPts values the calls go through (null: the
    configuration's);
  * ``eps_scale``: the ε values, as multiples of the configuration's
    (absent: ``[1]``);
  * ``trace_calls``: in a traced run, the calls the profiler sees;
  * further keys for the op itself (see ``ops/``).

The schedule repeats one period, every (dataset, ε, minPts) once, the
datasets changing fastest, then ε, then minPts. One period runs before the
window to warm every shape. Each (dataset, ε, minPts) is compared with the
reference twice: once in one of its first ``SAMPLE_PERIODS`` occurrences,
drawn from the seed, and once late in the timed window, in its first call
that starts after a share of the window drawn from the seed between
``LATE`` bounds. A traced run first runs ``trace_calls`` calls under the
profiler, then the same window untraced, so the late calls come after
the profiled ones. The window runs calls back to back for ``seconds``,
and on until every sampled call is done.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from . import check, devtrace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SAMPLE_PERIODS = 3
LATE = (0.5, 0.95)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list


class Job(NamedTuple):
    """What call ``index`` asks for."""
    index: int
    dataset: int
    eps: float
    min_pts: int


class Output(NamedTuple):
    """What an op's call hands back: the answer, compared with the
    reference, and what the program reports about its work."""
    counts: object            # (n,) stage 1's counts
    core: object              # (n,) stage 1's core flags
    labels: object            # (n,) the labels, on the host
    timings: dict             # DBSCANResult.timings
    engine_timings: dict | None   # Engine.timings, where the call built it
    n_rounds: int


@dataclasses.dataclass
class Call:
    index: int
    dataset: int
    eps: float
    min_pts: int
    seconds: float            # host clock, the call's whole work
    timings: dict
    engine_timings: dict | None
    n_rounds: int


@dataclasses.dataclass
class Context:
    """What an op sees: the configuration, the traffic, the pooled
    datasets, the device, and a place for the state it builds."""
    config: dict
    traffic: dict
    pool: list
    device: object
    state: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float
    calls: list               # the Calls of the timed window
    attempted: int            # every call after set-up, traced ones too
    memory_peak_bytes: int | None
    ref_s: float              # the reference's and the comparison's time
    traced: devtrace.TraceSummary | None
    ref_pairs: dict           # (dataset, ε) -> Σ counts (ε-pairs)
    checks: dict              # check.LIMITS' names -> summed mismatches
    compared: int
    failed: int
    n: int
    sampled_early: list = dataclasses.field(default_factory=list)
    sampled_late: list = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.compared > 0 and self.failed == 0 and \
            check.within(self.checks)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])

    def applies(metric):
        return name in metric.get("workloads", (name,))
    return Cell(
        name=name,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "traffic" / f"{entry['traffic']}.json").read_text()),
        chips=int(entry["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def load_reader(metric: str):
    """``metrics/<metric>.py``'s ``read(out)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def load_op(name: str):
    """``ops/<name>.py``: ``setup(ctx)`` and ``call(ctx, job, span)``."""
    return importlib.import_module(f"portbench.ops.{name}")


def _seed(seed: int) -> int:
    return seed % (1 << 62)       # numpy's generators take no negative seed


def make_pool(config: dict, traffic: dict, seed: int) -> list:
    gen = importlib.import_module(f"portbench.data.{config['dataset']}")
    pool = traffic["pool"]
    return [gen.generate(config["n"], _seed(seed) * pool + k)
            for k in range(pool)]


def min_pts_list(config: dict, traffic: dict) -> list:
    return list(traffic.get("min_pts") or [config["min_pts"]])


def eps_list(config: dict, traffic: dict) -> list:
    return [config["eps"] * s for s in traffic.get("eps_scale", [1])]


def schedule(config: dict, traffic: dict) -> list:
    """One period: every (dataset, ε, minPts) once, as (k, ε, minPts)."""
    return [(k, e, m) for m in min_pts_list(config, traffic)
            for e in eps_list(config, traffic)
            for k in range(traffic["pool"])]


def job(i: int, period: list) -> Job:
    return Job(i, *period[i % len(period)])


def early_calls(seed: int, period: int) -> set:
    """The calls compared early: one occurrence of each position of the
    period among the first ``SAMPLE_PERIODS`` periods, drawn from the
    seed."""
    rng = np.random.default_rng([_seed(seed), 1])
    return {c + period * int(rng.integers(0, SAMPLE_PERIODS))
            for c in range(period)}


def late_shares(seed: int, period: int) -> list:
    """For each position of the period, the share of the window after
    which its next call is compared, drawn from the seed."""
    rng = np.random.default_rng([_seed(seed), 2])
    return [float(v) for v in rng.uniform(*LATE, size=period)]


def _no_span(_name):
    return contextlib.nullcontext()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> Outcome:
    """Set up, run the window, then check the sampled calls against the
    reference. ``t_start`` is the host clock at the process's start, so
    set-up counts the imports too."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    op = load_op(tr["op"])
    ctx = Context(cfg, tr, make_pool(cfg, tr, seed), dev)
    op.setup(ctx)
    period = schedule(cfg, tr)

    def one_call(i, span):
        jb = job(i, period)
        t0 = time.perf_counter()
        got = op.call(ctx, jb, span)
        call = Call(i, jb.dataset, jb.eps, jb.min_pts,
                    time.perf_counter() - t0, dict(got.timings),
                    got.engine_timings, got.n_rounds)
        return call, got

    for i in range(len(period)):
        one_call(i, _no_span)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    early = early_calls(seed, len(period))
    shares = late_shares(seed, len(period))
    late_due = dict(enumerate(shares))     # position -> share, until taken
    calls, retained, taken_late = [], {}, []

    def step(i, span, share=None):
        call, got = one_call(i, span)
        with span("between_calls"):
            calls.append(call)
            pos = i % len(period)
            late = share is not None and pos in late_due and \
                share >= late_due[pos]
            if late:
                del late_due[pos]
                taken_late.append(i)
            if late or i in early:
                # to the host now, so kept answers add nothing to the peak
                retained[i] = (period[pos], got.counts.cpu(),
                               got.core.cpu(), got.labels)
            del got

    # a traced run profiles its first calls, then times the window
    summary, n_traced = None, tr["trace_calls"] if traced else 0
    if traced:
        prof = devtrace.profiler()
        prof.start()
        for i in range(n_traced):
            step(i, devtrace.span)
        prof.stop()
        summary = devtrace.read(prof)
    i, least = n_traced, max(early) + 1
    t_w0 = time.perf_counter()
    while True:
        share = (time.perf_counter() - t_w0) / seconds if seconds > 0 \
            else math.inf
        if share >= 1 and i >= least and not late_due:
            break
        step(i, _no_span, share)
        i += 1
    window_s = time.perf_counter() - t_w0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    # the program's state goes before the reference runs
    ctx.state.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    totals = dict.fromkeys(check.LIMITS, 0)
    ref_pairs, failed = {}, 0
    wanted = {key for key, *_ in retained.values()}
    for k, e in sorted({(k, e) for k, e, _ in wanted}):
        pairs = ref.neighbour_pairs(ctx.pool[k], e, cfg["dims"], device=dev)
        ref_pairs[(k, e)] = int(pairs.counts.sum())
        for m in sorted({m for kk, ee, m in wanted if (kk, ee) == (k, e)}):
            ans = ref.answer(pairs, m)
            ans = type(ans)(*(t.cpu() for t in ans))
            for key, counts, core, labels in retained.values():
                if key != (k, e, m):
                    continue
                got = check.compare(ans, counts, core, labels)
                failed += not check.within(got)
                for name, v in got.items():
                    totals[name] += v
        del pairs
        if cuda:
            torch.cuda.empty_cache()

    return Outcome(setup_s=setup_s, window_s=window_s,
                   calls=calls[n_traced:], attempted=len(calls),
                   memory_peak_bytes=peak, ref_s=time.perf_counter() - t_ref,
                   traced=summary, ref_pairs=ref_pairs, checks=totals,
                   compared=len(retained), failed=failed, n=cfg["n"],
                   sampled_early=sorted(early), sampled_late=taken_late)


def metrics(cell: Cell, out: Outcome, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run), each from its reader; a reader that finds nothing to
    read leaves its metric out."""
    out_metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = load_reader(m["name"])(out)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return out_metrics


def result(cell: Cell, out: Outcome, traced: bool, kind: str,
           card: str) -> dict:
    """The run's result line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, a traced run's ``breakdown``, and last
    ``checks``, each compared number beside its limit."""
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics(cell, out, traced),
            "device": device}
    if traced:
        t = out.traced
        if t is None:
            raise RuntimeError("the profiler saw no device operation")
        device["busy_s"], device["window_s"] = t.busy_s, t.window_s
        line["breakdown"] = {"device_ops": t.device_ops,
                             "idle_gaps": t.idle_gaps}
    line["card"] = card
    line["compared"] = out.compared
    line["checks"] = {name: {"value": out.checks[name], "limit": lim}
                      for name, lim in check.LIMITS.items()}
    return line
