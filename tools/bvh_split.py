#!/usr/bin/env python3
"""Where one exact wavefront sweep of the ``bvh`` engine spends its time on
the card, for a given checkout of the port.

    python3 tools/bvh_split.py [--src DIR] [--reps 5]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two versions of the port can be measured in one run on one card. For
roadnet2d 435,000 (ε = 0.02) and iono3d 1,000,000 (ε = 2.0), seed 0, it
builds the engine, then prints one JSON line per dataset: the median host
ms of ``sweep_counts`` (ending in a synchronize) over ``--reps`` runs after
a warm-up, and the device time of one more sweep traced by
``torch.profiler``, split (``chip_smoke.profile_split``) into the level
kernel (the fused ``bvh_level``, or ``bvh_batch_sweep`` in a tree from
before it), the gathers and scatters around the per-entry kernel, copies
and fills (the fused loop's bound snapshots, count copies and zeroed
buffers) and the rest. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DATASETS = [("roadnet2d", 435_000, 0.02), ("iono3d", 1_000_000, 2.0)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bvh_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke
    import repro_torch
    from repro_torch.data import synth

    class E:    # what chip_smoke.profile_device reads
        pass
    E.torch = torch
    for name, n, eps in DATASETS:
        pts = torch.as_tensor(synth.load(name, n, seed=0), device="cuda")
        eng = repro_torch.make_engine(pts, eps, engine="bvh")

        def sweep():
            eng.sweep_counts(eng.state)
            torch.cuda.synchronize()
        sweep()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            sweep()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall, rows = chip_smoke.profile_device(E, sweep)
        split = chip_smoke.profile_split(wall, rows) if rows else None
        print(json.dumps(dict(
            src=args.src, dataset=name, n=n, eps=eps,
            capacity=eng.meta.capacity, host_ms=statistics.median(walls),
            host_ms_runs=walls, traced=split, kernels=rows)), flush=True)
        del eng, pts
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
