"""Training driver CLI (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --reduced --steps 200 --batch 8 \\
        --seq 128 --ckpt-dir /tmp/ck [--device cpu]

Runs on the card (``--device cuda``, the default; it raises without one)
or, asked for, on the CPU. ``--reduced`` selects the smoke-scale config.
The trainer checkpoints every ``--ckpt-every`` steps and resumes
automatically from ``--ckpt-dir`` (fault-tolerant restart); the straggler
watchdog feeds ``distributed.elastic.StragglerPolicy``. ``--microbatch``
is parsed and not used, as in the reference (whose ``train_loop`` builds
its step without it).
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ALL
from ..core.engines import resolve_device
from ..data.pipeline import token_batches
from ..distributed.elastic import StragglerPolicy
from ..train import optimizer as opt_mod
from ..train.trainer import TrainerConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ALL))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ALL[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    ocfg = opt_mod.AdamWConfig(lr=args.lr, total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    batches = token_batches(cfg, args.batch, args.seq, seed=args.seed,
                            device=dev)
    policy = StragglerPolicy()

    state, history = train_loop(cfg, tcfg, ocfg, batches, seed=args.seed,
                                device=dev)
    last = history[-1] if history else {}
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    action = policy.decide(int(last.get("slow_steps", 0)), n_devices)
    if action:
        print(f"[elastic] policy suggests: {action}")
    if history:
        print(f"final loss: {last['loss']:.4f} after {len(history)} steps")
    else:
        print(f"final loss: none (the checkpoint is at step {args.steps}; "
              "no step to run)")
    return state, history


if __name__ == "__main__":
    main()
