"""The control of ``correct``: the reference computed in bfloat16, the
precision below the float32 that the configurations state, put in the
program's place and judged by the same comparison.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

On the card, at the cell's own size: for each seed it draws the cell's
pooled datasets as a run does, works out the float32 reference and the
bfloat16 control for every (dataset, minPts) of the traffic, and prints
the control's mismatch numbers, then the smallest of each over all of
them. Every one of those has to exceed its limit in some number, or the
comparison could not tell the control from the program.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, device) -> list:
    """[(dataset, minPts, numbers)] of the bfloat16 control against the
    float32 reference, for the cell's pool at ``seed``."""
    import importlib

    import torch

    from portbench import check, harness
    cfg, tr = cell.config, cell.traffic
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    rows = []
    for k, pts in enumerate(harness.make_pool(cfg, tr, seed)):
        for eps in harness.eps_list(cfg, tr):
            exact = ref.neighbour_pairs(pts, eps, cfg["dims"], device=device)
            low = ref.neighbour_pairs(pts, eps, cfg["dims"], device=device,
                                      dtype=torch.bfloat16)
            for m in harness.min_pts_list(cfg, tr):
                want, got = ref.answer(exact, m), ref.answer(low, m)
                rows.append((k, m, check.compare(want, got.counts, got.core,
                                                 got.labels)))
            del exact, low
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    import torch

    from portbench import check, harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    least = dict.fromkeys(check.LIMITS)
    for seed in args.seeds:
        for k, m, numbers in control_numbers(cell, seed, "cuda:0"):
            print(json.dumps({"seed": seed, "dataset": k, "min_pts": m,
                              "control": numbers,
                              "fails": not check.within(numbers)}))
            for name, v in numbers.items():
                least[name] = v if least[name] is None else min(least[name],
                                                                v)
    print(json.dumps({"workload": cell.name, "least": least,
                      "limits": check.LIMITS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
