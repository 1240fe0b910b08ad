#!/usr/bin/env python3
"""Times the grid engine's full-size ``csr_sweep`` and ``csr_sweep_counts``
on the card for a given checkout of the port.

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
their own G. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DATASETS = [("roadnet2d", 435_000, 0.02, 8), ("iono3d", 1_000_000, 2.0, 16)]


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
    counters = torch.empty(2, dtype=torch.int32, device=dev)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
