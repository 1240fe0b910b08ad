#!/usr/bin/env python3
"""Time the dry run's meta traces with and without the op memo.

    python3 tools/dryrun_memo_time.py [--cells qwen3-8b:train_4k,...]

For each ``arch:shape`` cell (default qwen3-8b at train_4k and
prefill_32k) it builds the cell on the single production mesh and traces
its step on ``meta`` tensors under ``op_costs.OpCosts``: once to warm up
(PyTorch's first call of a meta kernel and the model's own caches), then
memo off and memo on, and prints one JSON line a timed run: the aten
ops, the memo hits, the host seconds and microseconds an op, the FLOP and
byte counts (equal with and without the memo, or it exits 1), and the
host's CPU. Meta tensors live on no device, so this needs no card; the
times are the host's.
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="qwen3-8b:train_4k,"
                    "qwen3-8b:prefill_32k")
    args = ap.parse_args()
    import torch

    from repro_torch.launch import dryrun as D

    host = platform.processor() or platform.machine()
    ok = True
    for cell in args.cells.split(","):
        arch, shape = cell.split(":")
        fn, cargs, _, _ = D.build_cell(arch, shape, D.production_mesh(
            "single"))
        D.trace_cell(fn, cargs)              # warm-up, not printed
        seen = {}
        for memo in (False, True):
            c = D.trace_cell(fn, cargs, memo=memo)
            seen[memo] = (c["flops"], c["bytes"], c["ops"])
            print(json.dumps(dict(
                cell=cell, memo=memo, us_per_op=1e6 * c["seconds"] / c["ops"],
                **c, host=host, threads=torch.get_num_threads())),
                flush=True)
        if seen[True] != seen[False]:
            print(f"{cell}: counts differ with the memo: {seen}",
                  file=sys.stderr)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
