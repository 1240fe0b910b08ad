#!/usr/bin/env python3
"""One full-size grid-hash sweep on the card, for a given checkout of the
port: its time and a digest of its outputs.

    python3 tools/hash_sweep_time.py [--src DIR] [--reps 5]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two versions of the port can be measured in one run on one card and their
outputs held bit-identical by digest. For roadnet2d 435,000 (ε = 0.02) and
iono3d 1,000,000 (ε = 2.0), seed 0, it builds the ``grid-hash`` engine,
makes a seeded payload (core with probability 1/2, roots uniform), and
prints one JSON line per dataset: the median ms of the engine's sweep over
``--reps`` runs after a warm-up (CUDA events), the median host ms of a
sweep ending in a synchronize, the kernel launches of one sweep by name,
and the SHA-1 of the counts and minroot bytes. Exits 2 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DATASETS = [("roadnet2d", 435_000, 0.02), ("iono3d", 1_000_000, 2.0)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hash_sweep_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.data import synth
    from repro_torch.kernels import gathered_sweep
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for name, n, eps in DATASETS:
        pts = torch.as_tensor(synth.load(name, n, seed=0), device="cuda")
        eng = repro_torch.make_engine(pts, eps, engine="grid-hash")
        rng = np.random.default_rng(0)
        core = torch.as_tensor(rng.uniform(size=n) < 0.5, device="cuda")
        root = torch.as_tensor(rng.integers(0, n, n).astype(np.int32),
                               device="cuda")

        def sweep():
            return eng.sweep(eng.state, core, root)
        sweep()
        torch.cuda.synchronize()
        gathered_sweep.reset_launches()
        out = sweep()
        launches = dict(gathered_sweep.LAUNCHES)
        dev_ms, host_ms = [], []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            sweep()
            b.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(a.elapsed_time(b))
        digest = [hashlib.sha1(x.cpu().numpy().tobytes()).hexdigest()
                  for x in out]
        print(json.dumps(dict(
            src=args.src, card=card, dataset=name, n=n, eps=eps,
            ms=statistics.median(dev_ms), ms_runs=dev_ms,
            host_ms=statistics.median(host_ms), launches=launches,
            counts_sha1=digest[0], minroot_sha1=digest[1])), flush=True)
        del eng, pts
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
