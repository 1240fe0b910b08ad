"""The least time the work of stage 1 could take on one NVIDIA H100.

Stage 1 counts, for every point, its ε-neighbours. Whatever implements
it, the inputs need a d² test of every ε-neighbour pair (self pairs
included, Σ counts, taken from the reference) and a read of every point
and a write of every count. So its least time is the larger of

  * pairs × 10 FP32 operations (3 subtractions, 3 multiplications, 2
    additions, a comparison, a count) at the FP32 peak, and
  * n × (12 + 4) bytes (the point's three float32 coordinates read once,
    its int32 count written once) at the HBM peak.

Peaks: NVIDIA's data sheet for the H100 SXM5 80 GB, dense, no sparsity:
67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s HBM3. Both assume
the card's full power limit of 700 W; a run prints the card's limit
beside its numbers (``nvidia-smi``), and a share below that limit reads
low.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12        # H100 SXM5, FP32 non-tensor, at 700 W
PEAK_HBM_BYTES_S = 3.35e12     # H100 SXM5 80 GB HBM3, at 700 W
POWER_LIMIT_W = 700.0          # the limit the peaks assume
FLOPS_PER_PAIR = 10
BYTES_PER_POINT = 12 + 4


def stage1_flops(pairs: int) -> float:
    return float(pairs) * FLOPS_PER_PAIR


def stage1_bytes(n: int) -> float:
    return float(n) * BYTES_PER_POINT


def stage1_least_s(pairs: int, n: int) -> float:
    """The larger of the compute and the memory term, in seconds."""
    return max(stage1_flops(pairs) / PEAK_FP32_FLOPS,
               stage1_bytes(n) / PEAK_HBM_BYTES_S)
