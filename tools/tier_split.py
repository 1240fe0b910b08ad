#!/usr/bin/env python3
"""Where a sharded tier's ``assign`` spends its host time, on the card.

    python3 tools/tier_split.py [--src DIR] [--reps 5] [--shards 4]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``).
For roadnet2d 435,000 (ε = 0.02, minPts 8) and iono3d 1,000,000 (ε = 2.0,
minPts 16), seed 0, it builds the snapshot on the card, splits it into
``--shards`` shards (``ShardedTier.from_snapshot``, warmed up) and makes
32,768 fresh points of the corpus's world (seed 1). It prints one JSON
line per dataset with the median host ms over ``--reps`` runs (each ending
in a device synchronize) of: the single-session ``assign``; the tier's
``assign``; its routing (``ShardMap.window_shards``) and, beside it, the
parts of the reference's routing (cells, every query's window codes, and
their two bisections of every corpus code, which ``window_shards``
replaced by one bisection of each distinct query cell's window codes
against the distinct occupied codes);
each shard's leg (``assign`` of its routed queries on its snapshot); and
the legs per query. A SHA-1 of the tier's labels, counts and dist bytes
lets two trees be held bit-identical. Exits 2 without a CUDA device.
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
DATASETS = [("roadnet2d", 435_000, 0.02, 8), ("iono3d", 1_000_000, 2.0, 16)]
N_QUERIES = 32_768


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tier_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import serve
    from repro_torch.data import synth
    from repro_torch.serve import shard as shard_mod
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    def host_ms(fn):
        fn()
        out = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    for name, n, eps, min_pts in DATASETS:
        pts = synth.load(name, n, seed=0)
        q = synth.load(name, N_QUERIES, seed=1, structure_seed=0,
                       structure_n=n)
        snap = serve.build_snapshot(pts, eps, min_pts)
        tier = serve.ShardedTier.from_snapshot(snap, n_shards=args.shards)
        tier.warmup()
        smap = tier.map
        row = dict(dataset=name, n=n, shards=tier.n_shards, queries=len(q),
                   card=card)
        row["single_assign_ms"] = host_ms(lambda: serve.assign(snap, q))
        row["tier_assign_ms"] = host_ms(lambda: tier.assign(q))
        row["window_shards_ms"] = host_ms(lambda: smap.window_shards(q))
        cells = smap._cells(q)
        offs = shard_mod._window_offsets(smap.dims)
        cap = (1 << smap.bits) - 2
        nbc = np.clip(cells[None, :, :] + offs[:, None, :], 0, cap)
        if smap.dims == 2:
            nbc[:, :, 2] = 0
        codes = smap._codes_of(nbc.reshape(-1, 3))
        row["routing_parts_ms"] = dict(
            cells=host_ms(lambda: smap._cells(q)),
            window_codes=host_ms(lambda: smap._codes_of(nbc.reshape(-1, 3))),
            bisect_left=host_ms(lambda: np.searchsorted(smap.codes, codes,
                                                        side="left")),
            bisect_right=host_ms(lambda: np.searchsorted(smap.codes, codes,
                                                         side="right")),
            window_codes_n=int(codes.size))
        mask = smap.window_shards(q)
        legs = {}
        for j in range(tier.n_shards):
            idx = np.nonzero(mask[:, j])[0]
            if idx.size:
                sub = q[idx]
                snap_j = tier.parts[j].snapshot
                legs[j] = dict(queries=int(idx.size), ms=host_ms(
                    lambda: serve.assign(snap_j, sub,
                                         scheduler=tier.scheduler)))
        row["legs"] = legs
        row["legs_per_query"] = {int(k): int(v) for k, v in zip(
            *np.unique(mask.sum(axis=1), return_counts=True))}
        r = tier.assign(q)
        h = hashlib.sha1()
        for a in (r.labels, r.counts, r.dist):
            h.update(np.ascontiguousarray(a).tobytes())
        row["answer_sha1"] = h.hexdigest()
        tier.close()
        print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
