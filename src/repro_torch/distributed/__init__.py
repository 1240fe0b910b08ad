"""Distributed runtime of the port: ``dbscan_dist`` (the distributed
DBSCAN driver: quantile slabs, an all_to_all, ε-halo permutes, local
sweeps through the local-engine registry, label rounds, regrow on
overflow), ``comm`` (its collectives over a group of D ranks: threads on
one device, or a ``torch.distributed`` process group), ``checkpoint``
(atomic, keep-K, namespaced checkpoints, which the serving tier publishes
its snapshots through) and :func:`shard_devices`, the sharded tier's
placement."""
from __future__ import annotations


def shard_devices(n_shards: int, devices=None) -> list:
    """Round-robin device placement for serving shards.

    Shard ``j`` lives on device ``j % D``: the sharded tier moves each
    shard's frozen snapshot (and its replicas) onto its slot, so on a
    multi-card host the per-shard ``cross_sweep`` legs run on distinct
    cards, while one card degenerates gracefully (shards still isolate
    plans, deltas, WALs and checkpoint namespaces). ``devices=None`` means
    every visible CUDA device, and raises when there is none: the tier
    passes its snapshot's device explicitly when that is the CPU.
    """
    import torch
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "shard_devices: no CUDA device is available; pass devices="
                "[torch.device('cpu')] to place shards on the CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not devs:
        raise ValueError("shard_devices: empty device list")
    return [devs[j % len(devs)] for j in range(n_shards)]
