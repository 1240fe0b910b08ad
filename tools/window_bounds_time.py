#!/usr/bin/env python3
"""Times the CSR layout's window bounds on the card for a given checkout of
the port: the ``window_bounds`` kernel and the plain loop over the window's
offsets, on the inputs of the layout of a benchmark configuration.

    python3 tools/window_bounds_time.py [--src DIR] [--reps 5] [--seed N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two versions of the port can be measured on one card in one call (one
process per tree). For each configuration of ``portbench/configs``
(roadnet2d 434,874, iono3d 1,000,000, Porto's taxi2d 2,000,000: the points
of ``portbench/data`` from ``--seed``), it runs the grid plan
(``grid.plan_and_build_csr_grid``) once to take the inputs that the layout
hands ``grid._csr_window_bounds``, then prints one JSON line: for the tree's
``_csr_window_bounds`` (the kernel where the tree has
``kernels/csr_layout.py``, else the plain loop) and, where the tree has
it, for ``csr_layout.window_bounds_plain``: the median card ms over
``--reps`` calls after a warm-up (CUDA events around each call, so the host
path counts where the card waits on it), the median host ms of the call
(its return, after a synchronize, once its work is queued), the launches of
a call and a digest of ``lo`` and ``hi`` (equal digests: bit-identical
outputs across versions and trees). Last, the median ``plan_s`` of the plan
over ``--reps`` plans, in ms. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ("roadnet2d-435k", "iono3d-1m", "porto2d-2m")


def digest(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("window_bounds_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from repro_torch.core import grid
    try:
        from repro_torch.kernels import csr_layout
    except ImportError:       # a tree from before the kernel
        csr_layout = None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if csr_layout is not None:
        from repro_torch.kernels import build
        for line in build.build(["csr_layout"])["csr_layout"].log \
                .splitlines():
            if "registers" in line or "spill" in line:
                print(line.strip(), flush=True)

    def launches():
        return 0 if csr_layout is None else \
            csr_layout.LAUNCHES["window_bounds"]

    def timed(fn):
        """(median card ms, median host ms, launches a call, digest)."""
        out = fn()
        torch.cuda.synchronize()
        card, host = [], []
        before = launches()
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            b.record()
            b.synchronize()
            card.append(a.elapsed_time(b))
        return dict(card_ms=statistics.median(card),
                    host_ms=statistics.median(host),
                    launches=(launches() - before) / args.reps,
                    digest=digest(*out))

    for name in CONFIGS:
        cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                         .read_text())
        gen = importlib.import_module(f"portbench.data.{cfg['dataset']}")
        pts = torch.as_tensor(gen.generate(cfg["n"], args.seed),
                              device="cuda")
        captured, real = [], grid._csr_window_bounds

        def record(*a):
            captured.append(a)
            return real(*a)
        grid._csr_window_bounds = record
        try:
            grid.plan_and_build_csr_grid(pts, cfg["eps"])
        finally:
            grid._csr_window_bounds = real
        codes, cells, dims, bits = captured[0]
        row = dict(config=name, n=cfg["n"], dims=dims, tree=args.src,
                   window_bounds=timed(lambda: grid._csr_window_bounds(
                       codes, cells, dims, bits)))
        if csr_layout is not None:
            row["plain"] = timed(lambda: csr_layout.window_bounds_plain(
                codes, cells, dims, bits))
            row["equal"] = row["plain"]["digest"] == \
                row["window_bounds"]["digest"]
        plans = []
        for _ in range(args.reps + 1):
            t = {}
            grid.plan_and_build_csr_grid(pts, cfg["eps"], timings=t)
            plans.append(t["plan_s"] * 1e3)
        row["plan_ms"] = statistics.median(plans[1:])
        print(json.dumps(row), flush=True)
        del pts, codes, cells, captured
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
