"""Clustering driver CLI — the paper's workload end-to-end.

    PYTHONPATH=src python -m repro_torch.launch.cluster --dataset taxi2d \
        -n 100000 --eps 0.08 --min-pts 16 [--engine grid|bvh|brute] \
        [--distributed] [--device cuda|cpu]

Prints cluster statistics and the build/sweep time breakdown (paper §V-D).
Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card. ``--distributed`` runs the distributed driver over a process group of
the visible cards, one rank a card (NCCL; in this process when there is
one card, else one spawned process a card); with ``--device cpu`` over one
gloo rank.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import engines
from ..core import labels as L
from ..core import neighbors as nb
from ..core.dbscan import DBSCANResult, dbscan
from ..data import synth


def _distributed_rank(group, pts, eps: float, min_pts: int):
    """One rank's run of the distributed driver: (labels, core, n_rounds)
    on the host."""
    from ..distributed.dbscan_dist import dbscan_distributed
    res = dbscan_distributed(pts, eps, min_pts, group)
    return res.labels.cpu(), res.core.cpu(), res.n_rounds


def _distributed(pts, eps: float, min_pts: int, dev) -> DBSCANResult:
    """The distributed driver over a process group of the visible cards
    (one gloo rank on the CPU)."""
    from ..distributed import comm
    size = torch.cuda.device_count() if dev.type == "cuda" else 1
    if size == 1:
        group = comm.ProcessGroup(0, 1, comm.free_address(), dev.type)
        try:
            labels, core, rounds = _distributed_rank(group, pts, eps,
                                                     min_pts)
        finally:
            group.close()
    else:
        labels, core, rounds = comm.spawn(size, _distributed_rank, pts, eps,
                                          min_pts, device="cuda")
    return DBSCANResult(labels=labels, core=core,
                        counts=torch.zeros_like(labels), n_rounds=rounds)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="taxi2d",
                    choices=sorted(synth.DATASETS))
    ap.add_argument("-n", type=int, default=100_000)
    ap.add_argument("--eps", type=float, default=0.08)
    ap.add_argument("--min-pts", type=int, default=16)
    ap.add_argument("--engine", default="grid",
                    choices=list(engines.available_engines()))
    ap.add_argument("--distributed", action="store_true",
                    help="shard over the visible cards (a process group, "
                    "one rank a card; with --device cpu one gloo rank)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = engines.resolve_device(args.device)
    pts = synth.load(args.dataset, args.n, seed=args.seed)
    print(f"dataset={args.dataset} n={args.n} eps={args.eps} "
          f"minPts={args.min_pts} engine={args.engine} device={dev}")

    if args.distributed:
        t0 = time.perf_counter()
        res = _distributed(pts, args.eps, args.min_pts, dev)
        lab, core = res.labels.numpy(), res.core.numpy()
        t_total = time.perf_counter() - t0
        t_build = 0.0
    else:
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
