"""Data pipelines (the port of ``repro.data.pipeline``).

``token_batches`` — deterministic synthetic LM token stream (a generator
seeded from (seed, step) a step, so a restart regenerates the exact
stream — the property the exact-resume checkpoint test relies on).

``point_stream`` — chunked point-cloud feeder for the clustering driver
(reads generator-backed chunks; a real deployment maps this to sharded
parquet/TFRecord readers with per-host offsets).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.engines import resolve_device
from ..models import model as M


def _seed(seed: int, step: int, spawn: int = 0) -> int:
    """A 32-bit generator seed from ``(seed, step)``; ``spawn=1`` is the
    stream's fixed support and cycle, apart from every step's."""
    return int(np.random.SeedSequence([seed, step], spawn_key=(spawn,))
               .generate_state(1)[0])


def token_batches(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                  start_step: int = 0, *, device=None):
    """Learnable synthetic LM stream on ``device`` (default ``cuda``): a
    fixed (per-seed) permutation cycle over a small token subset —
    next-token is a deterministic bigram map, so the loss demonstrably
    falls well below the vocab entropy within tens of steps. 5% noise
    keeps the floor non-zero.

    The reference draws with ``jax.random``; the port draws with
    ``torch.Generator``s on the device, so the bits differ and the stream
    keeps the reference's contract: 64 distinct tokens below ``vocab`` and
    a cycle (a permutation of the 64) fixed by ``seed``; step ``k`` drawn
    from a generator seeded from ``(seed, k)``, so ``start_step=k`` yields
    exactly the k-th batch of a stream started at 0; a random phase a
    row, ``toks = support[cycle[(phase + pos) % 64]]`` over ``seq + 1``
    positions, each replaced by ``(tok + 1) % vocab`` with probability
    0.05; ``tokens = toks[:, :seq]``, ``labels = toks[:, 1:]`` (int32);
    the arch's other inputs from ``models.model.synth_batch`` with the
    step's seed, where the key is absent."""
    dev = resolve_device(device)
    v = cfg.vocab
    g = torch.Generator(device=dev)
    g.manual_seed(_seed(seed, 0, spawn=1))
    support = torch.randperm(v, generator=g, device=dev)[:64]
    cycle = torch.randperm(64, generator=g, device=dev)
    pos = torch.arange(seq + 1, device=dev)[None, :]
    step = start_step
    while True:
        step_seed = _seed(seed, step)
        g.manual_seed(step_seed)
        phase = torch.randint(0, 64, (batch, 1), generator=g, device=dev)
        toks = support[cycle[(phase + pos) % 64]]
        noise = torch.rand(toks.shape, generator=g, device=dev) < 0.05
        toks = torch.where(noise, (toks + 1) % v, toks).to(torch.int32)
        batch_d = {"tokens": toks[:, :seq], "labels": toks[:, 1:]}
        extras = M.synth_batch(cfg, batch, seq, step_seed, device=dev)
        for k in extras:
            if k not in batch_d:
                batch_d[k] = extras[k]
        yield batch_d
        step += 1


def point_stream(name: str, total: int, chunk: int, seed: int = 0):
    """Stream ``total`` points of dataset ``name`` in ``chunk``-sized pieces.

    Each chunk's *samples* are generated lazily from a per-chunk seed
    (derived from ``(seed, chunk_index)`` via ``SeedSequence``), so peak
    memory is O(chunk) regardless of ``total``. The dataset's *global
    structure* (taxi hubs, road-graph nodes) is pinned to ``seed`` and
    sized by the stream ``total`` for every chunk (``synth``'s
    ``structure_seed``/``structure_n`` split), so all chunks sample one
    world — the same world a ``total``-sized corpus built with
    ``synth.load(name, total, seed=seed)`` samples. The stream is
    deterministic in ``(name, total, chunk, seed)``: a restarted consumer
    replays the exact same chunks, the same ones as the JAX reference's
    ``repro.data.pipeline.point_stream``. The trailing remainder chunk
    carries ``total % chunk`` points (never zero-length).
    """
    from . import synth
    if total <= 0 or chunk <= 0:
        return
    for idx, i in enumerate(range(0, total, chunk)):
        m = min(chunk, total - i)
        chunk_seed = int(np.random.SeedSequence([seed, idx])
                         .generate_state(1)[0])
        yield synth.load(name, m, seed=chunk_seed, structure_seed=seed,
                         structure_n=total)
