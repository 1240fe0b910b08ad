#!/usr/bin/env python3
"""How long the BVH engines' tree build takes on the card, for a given
checkout of the port.

    python3 tools/bvh_build_time.py [--src DIR] [--reps 5] [--runs 3]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two versions of the port can be measured in one run on one card. For
roadnet2d 435,000 and iono3d 1,000,000 points (seed 0, on the card) it
prints one JSON line per dataset: the median host ms over ``--reps`` runs,
after a warm-up, of the engines' build (``core.bvh._tree``: the
dimension check and ``build_bvh``) and of ``max_leaf_depth``, each ending
in a synchronize; one more build traced by ``torch.profiler`` (its device
ms and device operations, kernels, copies and fills, by name); the depth;
and a SHA-1 of every ``BVH`` field's bytes, so two trees can be held
bit-identical. Then, per dataset and round driver (``device``,
``frontier``), one JSON line of ``--runs`` whole ``bvh`` runs at the
smoke's ε and minPts (``make_engine`` with the calibration cache cleared,
then ``dbscan``, ending in a synchronize): the median host seconds and
phase times, with a SHA-1 of the labels. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DATASETS = [("roadnet2d", 435_000, 0.02, 8), ("iono3d", 1_000_000, 2.0, 16)]


def median_ms(torch, fn, reps: int):
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs), runs, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bvh_build_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke
    import repro_torch
    from repro_torch.core import bvh
    from repro_torch.data import synth

    class E:    # what chip_smoke.profile_device reads
        pass
    E.torch = torch
    for name, n, eps, min_pts in DATASETS:
        pts = torch.as_tensor(synth.load(name, n, seed=0), device="cuda")
        tree_ms, tree_runs, (tree, dims) = median_ms(
            torch, lambda: bvh._tree(pts, None), args.reps)
        depth_ms, depth_runs, depth = median_ms(
            torch, lambda: bvh.max_leaf_depth(tree.left, tree.right),
            args.reps)
        wall, rows = chip_smoke.profile_device(E, lambda: bvh._tree(pts,
                                                                    None))
        digest = hashlib.sha1()
        for f in bvh.BVH._fields:
            digest.update(getattr(tree, f).cpu().numpy().tobytes())
        print(json.dumps(dict(
            src=args.src, dataset=name, n=n, dims=dims,
            tree_host_ms=tree_ms, tree_host_ms_runs=tree_runs,
            traced_host_ms=wall * 1e3,
            device_ms=sum(r[1] for r in rows),
            device_ops=sum(r[2] for r in rows), kernels=rows,
            depth=depth, depth_host_ms=depth_ms,
            depth_host_ms_runs=depth_runs,
            tree_sha1=digest.hexdigest())), flush=True)
        for hook in ("device", "frontier"):
            walls, phases = [], []
            for _ in range(args.runs):
                bvh._SPEC_CACHE.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng = repro_torch.make_engine(pts, eps, engine="bvh")
                res = repro_torch.dbscan(pts, eps, min_pts, eng=eng,
                                         hook_loop=hook)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                phases.append(dict(eng.timings, **res.timings))
            labels = hashlib.sha1(res.labels.cpu().numpy().tobytes())
            print(json.dumps(dict(
                src=args.src, dataset=name, path=f"bvh/{hook}",
                total_s=statistics.median(walls), total_s_runs=walls,
                phases_s={k: statistics.median(p[k] for p in phases)
                          for k in phases[0]},
                n_rounds=res.n_rounds,
                labels_sha1=labels.hexdigest())), flush=True)
            del eng, res
        del tree, pts
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
