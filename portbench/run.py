"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``), with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
with the reference beside its limit, which also end standard error.

Exits non-zero and prints no result where torch sees no CUDA device or
fewer than the cell asks for, where the program cannot be imported, or
where ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded
once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _prepare_path_and_caches() -> None:
    # the package is imported as ``portbench`` from the checkout's root; the
    # script's own folder would shadow modules of the standard library
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every kernel cache at a fixed path inside the checkout; repro_torch
    # builds its nvcc libraries into src/repro_torch/build/ itself
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read (exit {out.returncode})"


def _loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_path_and_caches()

    from portbench import harness
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {seen}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (fails here in a checkout without it)

    return measure(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0")


def measure(cell, seed: int, seconds: float, traced: bool, device) -> int:
    """Run the cell on ``device``, build its whole result line, and print
    it, unless the process has loaded a forbidden module by then."""
    import torch

    from portbench import check, harness
    out = harness.run_cell(cell, seed, seconds, traced, device, T_START)
    on_card = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else str(device)
    card = _power_limit() if on_card else "no card"
    line = harness.result(cell, out, traced, kind, card)
    bad = _loaded_forbidden()
    if bad:
        print(f"portbench: loaded in the benchmark's process: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"portbench: {cell.name} seed {seed}: {len(out.calls)} calls "
          f"in {out.window_s:.3f} s, set-up {out.setup_s:.3f} s, reference "
          f"{out.ref_s:.3f} s, {out.compared} compared, card {card}",
          file=sys.stderr)
    for name, lim in check.LIMITS.items():
        print(f"check {name} {out.checks[name]} limit {lim}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
