"""The comparison that decides ``correct``.

Each compared call's outputs are held to the reference's answer for the
same points and minPts, layer by layer:

  * ``count_mismatch``: points whose ε-neighbour count differs (stage 1);
  * ``core_mismatch``: points whose core flag differs (stage 1);
  * ``partition_mismatch``: reference core points whose cluster differs,
    as a partition, whatever ids name the clusters (stage 2);
  * ``label_mismatch``: points whose final label differs, border
    attachment and noise included (the answer handed back).

The configuration promises an exact answer, so every limit is 0.
"""
from __future__ import annotations

import torch

LIMITS = {"count_mismatch": 0, "core_mismatch": 0, "partition_mismatch": 0,
          "label_mismatch": 0}


def _canonical(labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Name each point of ``idx`` by the smallest index in ``idx`` that
    carries its label."""
    uniq, inv = torch.unique(labels[idx], return_inverse=True)
    first = torch.full((uniq.numel(),), labels.numel(), dtype=idx.dtype)
    first.scatter_reduce_(0, inv, idx, "amin", include_self=True)
    return first[inv]


def compare(ref, counts: torch.Tensor, core: torch.Tensor,
            labels: torch.Tensor) -> dict:
    """Mismatch counts of one call's (counts, core, labels), all on the
    host, against the reference's answer ``ref`` (counts, core, labels)."""
    rc, rk, rl = (t.cpu() for t in (ref.counts, ref.core, ref.labels))
    counts, core, labels = counts.cpu(), core.cpu(), labels.cpu()
    idx = torch.nonzero(rk).flatten()
    return {
        "count_mismatch": int((counts.to(torch.int64) != rc).sum()),
        "core_mismatch": int((core != rk).sum()),
        "partition_mismatch": int((_canonical(labels, idx)
                                   != _canonical(rl, idx)).sum()),
        "label_mismatch": int((labels.to(torch.int64) != rl).sum()),
    }


def within(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
