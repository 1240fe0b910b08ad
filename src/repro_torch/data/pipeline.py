"""Data pipelines: ``point_stream``, the chunked point-cloud feeder of the
clustering driver (reads generator-backed chunks; a real deployment maps
this to sharded parquet/TFRecord readers with per-host offsets)."""
from __future__ import annotations

import numpy as np


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
