"""The card's roofline model, the ring-model collective traffic and the
dry run's record (the port of ``repro.launch.analysis``).

Hardware model: published figures for one NVIDIA H100 80GB HBM3 (SXM,
700 W), not measurements:

  PEAK_FLOPS = 989e12  dense bf16 on the tensor cores (H100 SXM)
  HBM_BW     = 3.35e12 bytes/s of HBM3 (H100 SXM)
  LINK_BW    = 50e9    bytes/s: one 400 Gb/s NDR InfiniBand port per GPU.
               Every ``data`` or ``model`` group of the production meshes
               spans 16 positions, so every group crosses more than one
               8-GPU NVLink node, and that port is its bottleneck.

The reference reads FLOPs, bytes and collectives off a compiled XLA
executable. PyTorch has none, so :func:`analyze` builds the record from
numbers: the counts of an eager trace (``op_costs``), the layout of each
device's arguments (``dryrun``) and the collectives the program issues.
It keeps the reference's keys where they mean the same (``terms``,
``bottleneck``, ``useful_flops_ratio``, ``roofline_fraction``,
``collectives``, ``collective_traffic_per_dev``, ``memory.*``);
``hlo_*`` become ``flops_total`` and ``bytes_total``, and the per-device
values are their even split over ``n_devices``. It drops ``xla_raw_*``
(there is no XLA) and ``dynamic_whiles``: an eager trace runs every
iteration of every loop, so nothing is undercounted, and a loop whose
trip count depends on the data needs a host read, which fails on
``meta`` and shows up as the cell's ``error``.

Roofline terms (seconds), from per-device quantities:
  compute    = flops_per_dev / PEAK_FLOPS
  memory     = bytes_per_dev / HBM_BW
  collective = link_traffic_per_dev / LINK_BW, with ring-model traffic
               (:func:`ring_traffic`).
"""
from __future__ import annotations

from typing import Dict, Optional

PEAK_FLOPS = 989e12      # bf16 dense, FLOP/s, NVIDIA H100 SXM (published)
HBM_BW = 3.35e12         # bytes/s, NVIDIA H100 SXM HBM3 (published)
LINK_BW = 50e9           # bytes/s, one 400 Gb/s NDR InfiniBand port a GPU

# the port's collective names (``distributed.comm``) → the ring model's ops
COMM_OPS = {"psum": "all-reduce", "pmin": "all-reduce",
            "pmax": "all-reduce", "all_to_all": "all-to-all",
            "ppermute": "collective-permute"}


def ring_traffic(op: str, result_bytes: float, g: int):
    """(operand bytes, link traffic bytes) of one collective whose
    per-device result is ``result_bytes``, over a group of ``g``:

      all-gather      operand N/g,  traffic N·(g−1)/g
      reduce-scatter  operand N·g,  traffic N·(g−1)
      all-reduce      operand N,    traffic 2·N·(g−1)/g
      all-to-all, collective-permute: operand N, traffic N
    """
    g = max(int(g), 1)
    n = float(result_bytes)
    if op == "all-gather":
        return n / g, n / g * (g - 1)
    if op == "reduce-scatter":
        return n * g, n * (g - 1)
    if op == "all-reduce":
        return n, 2.0 * n * (g - 1) / g
    if op in ("all-to-all", "collective-permute"):
        return n, n
    raise ValueError(f"unknown collective {op!r}")


def comm_collectives(sent: Dict[str, float],
                     g: int) -> Dict[str, Dict[str, float]]:
    """The record's ``collectives`` from the bytes one rank put into each
    of the port's collectives (``psum``, ``all_to_all``, ...; the port
    counts bytes, not calls): for these ops the result is as large as the
    operand, so ``sent`` is N."""
    stats: Dict[str, Dict[str, float]] = {}
    for name, nbytes in sent.items():
        op = COMM_OPS[name]
        operand, traffic = ring_traffic(op, nbytes, g)
        s = stats.setdefault(op, {"operand_bytes": 0.0, "result_bytes": 0.0,
                                  "traffic_bytes": 0.0})
        s["operand_bytes"] += operand
        s["result_bytes"] += float(nbytes)
        s["traffic_bytes"] += traffic
    return stats


def analyze(costs: Dict, *, n_devices: int, model_flops: float = 0.0,
            memory: Optional[Dict] = None,
            collectives: Optional[Dict] = None) -> Dict:
    """The roofline record of one cell.

    ``costs`` holds the whole program's ``flops`` and ``bytes``;
    ``memory`` the per-device layout (``argument_bytes``,
    ``output_bytes``, ``alias_bytes``, ``temp_bytes``, the last possibly
    None); ``collectives`` per collective op a device's
    ``operand_bytes``, ``result_bytes`` and ``traffic_bytes``."""
    rec: Dict = {"n_devices": n_devices}
    flops_total = float(costs["flops"])
    bytes_total = float(costs["bytes"])
    rec["flops_total"] = flops_total
    rec["bytes_total"] = bytes_total
    rec["flops_per_dev"] = flops_total / n_devices
    rec["bytes_per_dev"] = bytes_total / n_devices
    rec["per_dev_note"] = ("per-device FLOPs and bytes are the even split "
                           "of the whole program's over n_devices")
    if memory is not None:
        mem = dict(memory)
        mem["peak_per_dev"] = (mem["argument_bytes"] + mem["output_bytes"]
                               + (mem.get("temp_bytes") or 0)
                               - mem["alias_bytes"])
        rec["memory"] = mem
    colls = collectives or {}
    rec["collectives"] = colls
    traffic = sum(s["traffic_bytes"] for s in colls.values())
    rec["collective_traffic_per_dev"] = traffic
    rec["collective_operand_per_dev"] = sum(
        s["operand_bytes"] for s in colls.values())
    rec["terms"] = {
        "compute_s": rec["flops_per_dev"] / PEAK_FLOPS,
        "memory_s": rec["bytes_per_dev"] / HBM_BW,
        "collective_s": traffic / LINK_BW,
    }
    rec["bottleneck"] = max(rec["terms"], key=rec["terms"].get)
    if model_flops:
        rec["model_flops"] = model_flops
        rec["useful_flops_ratio"] = model_flops / max(flops_total, 1.0)
        bound = max(rec["terms"].values())
        ideal = model_flops / (n_devices * PEAK_FLOPS)
        rec["roofline_fraction"] = ideal / max(bound, 1e-30)
    return rec
