"""The least time stage 1's slab sweep could take on one NVIDIA H100 for
the pairs it keeps.

The grid engine's counts-only sweep (``csr_sweep_kernel<kCounts>``) tests
every pair of the candidate runs its cull keeps: kept runs × G columns ×
block_q query rows, padding rows included, which the program reports as
``DBSCANResult.timings["stage1_kept_pairs"]``. Each pair costs 9 FP32-pipe
instructions (3 subtractions, 3 multiplications, 2 additions, a
comparison; the kernels are built so that none is fused). The least time
is those instructions at the issue rate of the FP32 pipe: 132 SMs × 128
lanes × 1,980 MHz (the H100 SXM5's boost clock, at its full power limit of
700 W; a run prints the card's limit beside its numbers). This is the
issue-rate bound of the port's kernel table (PERF.md).

Beside ``roofline.stage1_least_s``, which counts the ε-pairs the answer
needs, it tells a loose cull (many kept pairs per ε-pair) from a slow
sweep (a low share of its own kept pairs' bound).
"""
from __future__ import annotations

SMS = 132
LANES_PER_SM = 128             # FP32 lanes
CLOCK_HZ = 1.98e9              # boost clock, at 700 W
FP32_RATE = SMS * LANES_PER_SM * CLOCK_HZ   # FP32 instructions a second
INSTRUCTIONS_PER_PAIR = 9


def sweep_instructions(pairs: int) -> float:
    return float(pairs) * INSTRUCTIONS_PER_PAIR


def sweep_least_s(pairs: int) -> float:
    """The kept pairs' instructions at the issue rate, in seconds."""
    return sweep_instructions(pairs) / FP32_RATE
