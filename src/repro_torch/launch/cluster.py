"""Clustering driver CLI — the paper's workload end-to-end.

    PYTHONPATH=src python -m repro_torch.launch.cluster --dataset taxi2d \
        -n 100000 --eps 0.08 --min-pts 16 [--engine grid|bvh|brute] \
        [--device cuda|cpu]

Prints cluster statistics and the build/sweep time breakdown (paper §V-D).
Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card.
"""
from __future__ import annotations

import argparse
import time

from ..core import engines
from ..core import labels as L
from ..core import neighbors as nb
from ..core.dbscan import dbscan
from ..data import synth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="taxi2d",
                    choices=sorted(synth.DATASETS))
    ap.add_argument("-n", type=int, default=100_000)
    ap.add_argument("--eps", type=float, default=0.08)
    ap.add_argument("--min-pts", type=int, default=16)
    ap.add_argument("--engine", default="grid",
                    choices=list(engines.available_engines()))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = engines.resolve_device(args.device)
    pts = synth.load(args.dataset, args.n, seed=args.seed)
    print(f"dataset={args.dataset} n={args.n} eps={args.eps} "
          f"minPts={args.min_pts} engine={args.engine} device={dev}")

    t0 = time.perf_counter()
    eng = nb.make_engine(pts, args.eps, engine=args.engine, device=dev)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = dbscan(pts, args.eps, args.min_pts, eng=eng)
    lab = res.labels.cpu().numpy()    # a host read: the run has ended
    core = res.core.cpu().numpy()
    t_total = t_build + (time.perf_counter() - t0)

    sizes = L.cluster_sizes(lab)
    print(f"clusters: {len(sizes)}  core: {int(core.sum())}"
          f"  border: {int(((lab >= 0) & ~core).sum())}"
          f"  noise: {int((lab == -1).sum())}")
    if len(sizes):
        print(f"largest clusters: {sorted(sizes.tolist(), reverse=True)[:8]}")
    print(f"stage-2 rounds: {res.n_rounds}")
    print(f"time: total={t_total:.3f}s build={t_build:.3f}s "
          f"(build {100 * t_build / max(t_total, 1e-9):.0f}% — paper §V-D)")
    return res


if __name__ == "__main__":
    main()
