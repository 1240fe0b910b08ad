#!/usr/bin/env python3
"""Times the full-size slab sweeps on the card for a given checkout of the
port: the grid engine's ``csr_sweep`` and ``csr_sweep_counts``, and
``frontier_sweep`` and ``cross_sweep`` on their paths' own inputs.

    python3 tools/csr_sweep_time.py [--src DIR] [--reps 5] [--runs 512,64]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two versions of the port can be measured on one card in one call (one
process per tree). For roadnet2d 435,000 (ε = 0.02, minPts = 8) and iono3d
1,000,000 (ε = 2.0, minPts = 16), seed 0, it builds the grid engine, runs
``dbscan`` for the payload (``croot`` built as ``chip_smoke.times_csr``
builds it), then prints one JSON line: the median ms of each kernel over
``--reps`` launches after a warm-up (CUDA events; the box and cull passes
included), a digest of its outputs (equal digests: bit-identical outputs
across trees), the slab pair tests and, where the tree has the plain skip,
the kept pair tests, G and S. Each G of ``--runs`` adds a line for the same
kernels launched at that run width: the tool calls their C entry points
itself, with scratch sized for it, since the port's wrappers always pass
their own G. A last line per dataset times ``frontier_sweep`` on the first
round of ``dbscan(hook_loop="frontier")`` (the widest frontier) and
``cross_sweep`` on the call of an ``assign`` of 32,768 fresh points of the
same world (``serve.build_snapshot``, then ``serve.assign``), each with the
digest of its outputs, the device ms of each kernel of one call
(torch.profiler) and the host ms of the wrapper's launch path, and, where
the tree has the plain skip,
its kept pair tests and work items (segments of S runs that keep one or
more). Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DATASETS = [("roadnet2d", 435_000, 0.02, 8), ("iono3d", 1_000_000, 2.0, 16)]
ASSIGN_Q = 32_768     # fresh points of the assign (the largest bucket)


def digest(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def launch_at(torch, build, csr, run, q, cands, croot, st, nblk, eps2, *,
                max_blocks, block_k, block_q):
    """csr_sweep's kernel (csr_sweep_counts' when ``croot`` is None) at run
    width ``run``, as the wrapper launches it at its own G."""
    T, nc, dev = st.shape[0], cands.shape[1], q.device
    cap = T * -(-(max_blocks * (block_k // run)) // csr.SEG_RUNS)
    boxes = torch.empty(nc // run * 8, dtype=torch.float32, device=dev)
    items = torch.empty(max(cap, 1) * 3, dtype=torch.int32, device=dev)
    # kCounters ints: three, where older trees' kernels use two
    counters = torch.empty(3, dtype=torch.int32, device=dev)
    counts = torch.empty(q.shape[0], dtype=torch.int32, device=dev)
    head = (T, block_q, nc, max_blocks, block_k, run)
    if croot is None:
        build.launch("csr_sweep", "csr_sweep_counts_launch",
                     "ppppfiiiiiipppp", "csr_sweep_counts", dev, q, cands,
                     st, nblk, csr._eps2_f32(eps2), *head, counts, boxes,
                     items, counters)
        return (counts,)
    minroot = torch.empty_like(counts)
    build.launch("csr_sweep", "csr_sweep_launch", "pppppfiiiiiippppp",
                 "csr_sweep", dev, q, cands, croot, st, nblk,
                 csr._eps2_f32(eps2), *head, counts, minroot, boxes, items,
                 counters)
    return counts, minroot


def first_call(module, attr, fn):
    """Runs ``fn`` and returns the (args, kw) of its first call of
    ``module.attr``."""
    calls, real = [], getattr(module, attr)

    def record(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    setattr(module, attr, record)
    try:
        fn()
    finally:
        setattr(module, attr, real)
    return calls[0]


def items(kept, seg: int) -> int:
    """Work items of a kept-run mask (T, R): segments of ``seg`` runs of a
    tile's slab that keep one or more."""
    import torch
    k = torch.cat([kept, kept.new_zeros(kept.shape[0], -kept.shape[1] % seg)],
                  1)
    return int(k.view(k.shape[0], -1, seg).any(-1).sum())


def device_split(fn) -> dict:
    """Device ms of one call of ``fn`` by kernel (torch.profiler), and the
    host ms of its launch path, timed outside the profiler: the call after
    a synchronize returns once its launches are queued."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            m = re.search(r"\w+_kernel", ev.key)
            out[m.group(0) if m else ev.key[:40]] = \
                ev.self_device_time_total / 1e3
    out["host_launch_ms"] = host_ms
    return out


def frontier_cross_row(repro_torch, csr, ms, name, n, eps, min_pts, pts):
    """frontier_sweep on round 1 of the frontier driver and cross_sweep on
    an assign of ASSIGN_Q fresh points: ms, output digests, pair tests."""
    from repro_torch import serve
    from repro_torch.kernels import cross_sweep, frontier_sweep
    eng = repro_torch.make_engine(pts, eps)
    (f_args, f_kw) = first_call(frontier_sweep, "frontier_sweep",
                                lambda: repro_torch.dbscan(
                                    pts, eps, min_pts, eng=eng,
                                    hook_loop="frontier"))
    q, cp, _, st, nblk, active, n_active, eps2 = f_args
    na = int(n_active[0])
    bk, bq = f_kw["block_k"], f_kw["block_q"]
    row = dict(dataset=name, n=n, live_tiles=na, tiles=st.shape[0],
               frontier_slab_pairs=int(nblk[active[:na].long()].sum()) * bk
               * bq)
    if hasattr(frontier_sweep, "kept_runs_plain"):
        kept = frontier_sweep.kept_runs_plain(
            q, cp, st, nblk, active, n_active, eps2,
            max_blocks=f_kw["max_blocks"], block_k=bk)
        row["frontier_kept_pairs"] = int(kept.sum()) * csr.run_width(bk) * bq
        row["frontier_items"] = items(kept, csr.SEG_RUNS)
    f_call = lambda: frontier_sweep.frontier_sweep(  # noqa: E731
        *f_args, **f_kw)
    row.update(frontier_ms=ms(f_call), frontier_digest=digest(f_call()),
               frontier_split=device_split(f_call))
    snap = serve.build_snapshot(pts, eps, min_pts)
    fresh = repro_torch.synth.load(name, ASSIGN_Q, seed=1, structure_seed=0,
                                   structure_n=n)
    c_args, c_kw = first_call(cross_sweep, "cross_sweep",
                              lambda: serve.assign(snap, fresh))
    q, cp, _, st, nblk, eps2 = c_args
    bk, bq = c_kw["block_k"], c_kw["block_q"]
    row.update(queries=q.shape[0],
               cross_slab_pairs=int(nblk.sum()) * bk * bq)
    if hasattr(csr, "kept_runs_plain"):
        kept = csr.kept_runs_plain(q, cp, st, nblk, eps2,
                                   max_blocks=c_kw["max_blocks"],
                                   block_k=bk)
        row["cross_kept_pairs"] = int(kept.sum()) * csr.run_width(bk) * bq
        row["cross_items"] = items(kept, csr.SEG_RUNS)
    c_call = lambda: cross_sweep.cross_sweep(*c_args, **c_kw)  # noqa: E731
    row.update(cross_ms=ms(c_call), cross_digest=digest(*c_call()),
               cross_split=device_split(c_call))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--runs", default="",
                    help="other run widths G to time, comma-separated "
                    "divisors of block_k")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("csr_sweep_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import build, csr_sweep as csr, ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    for line in build.build(["csr_sweep"])["csr_sweep"].log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(line.strip(), flush=True)

    def ms(fn):
        fn()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    for name, n, eps, min_pts in DATASETS:
        pts = repro_torch.synth.load(name, n, seed=0)
        eng = repro_torch.make_engine(pts, eps)
        res = repro_torch.dbscan(pts, eps, min_pts, eng=eng)
        g, spec = eng.state, eng.meta
        order = g.order.long()
        croot = torch.full((spec.n_cand,), csr.INT_MAX, dtype=torch.int32,
                           device="cuda")
        croot[:spec.n] = ops.fuse_core_root(res.core[order],
                                            res.labels[order])
        st = (g.starts // spec.block_k).to(torch.int32)
        eps2 = float(eps) ** 2
        kw = dict(max_blocks=spec.slab // spec.block_k,
                  block_k=spec.block_k, block_q=spec.chunk)
        slab_pairs = int(g.nblk.sum()) * spec.block_k * spec.chunk
        row = dict(dataset=name, n=n, slab_pairs=slab_pairs,
                   tiles=spec.n_tiles, max_nblk=int(g.nblk.max()))
        if hasattr(csr, "kept_runs_plain"):
            kept = csr.kept_runs_plain(
                g.q_sorted, g.cands, st, g.nblk, eps2,
                max_blocks=kw["max_blocks"], block_k=spec.block_k)
            run = csr.run_width(spec.block_k)
            row.update(G=run, S=csr.SEG_RUNS,
                       kept_pairs=int(kept.sum()) * run * spec.chunk,
                       max_kept_runs=int(kept.sum(1).max()))
        full = lambda: csr.csr_sweep(  # noqa: E731
            g.q_sorted, g.cands, croot, st, g.nblk, eps2, **kw)
        counts = lambda: csr.csr_sweep_counts(  # noqa: E731
            g.q_sorted, g.cands, st, g.nblk, eps2, **kw)
        row.update(csr_sweep_ms=ms(full), csr_sweep_counts_ms=ms(counts),
                   digest=digest(*full()), counts_digest=digest(counts()))
        print(json.dumps(row), flush=True)
        for run in [int(w) for w in args.runs.split(",") if w]:
            if spec.block_k % run:
                raise SystemExit(f"G = {run} does not divide block_k = "
                                 f"{spec.block_k}")
            kept = csr.kept_runs_plain(
                g.q_sorted, g.cands, st, g.nblk, eps2,
                max_blocks=kw["max_blocks"], block_k=spec.block_k, run=run)
            at = dict(torch=torch, build=build, csr=csr, run=run,
                      q=g.q_sorted, cands=g.cands, st=st, nblk=g.nblk,
                      eps2=eps2, **kw)
            full = lambda: launch_at(croot=croot, **at)  # noqa: E731
            counts = lambda: launch_at(croot=None, **at)  # noqa: E731
            print(json.dumps(dict(
                dataset=name, n=n, slab_pairs=slab_pairs, G=run,
                S=csr.SEG_RUNS, kept_pairs=int(kept.sum()) * run * spec.chunk,
                max_kept_runs=int(kept.sum(1).max()), csr_sweep_ms=ms(full),
                csr_sweep_counts_ms=ms(counts), digest=digest(*full()),
                counts_digest=digest(*counts()))), flush=True)
        del eng, res, g
        torch.cuda.empty_cache()
        print(json.dumps(frontier_cross_row(repro_torch, csr, ms, name, n,
                                            eps, min_pts, pts)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
