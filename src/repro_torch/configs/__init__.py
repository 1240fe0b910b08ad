"""Config registry: ``get(name)`` / ``ALL`` — one module per assigned arch.

Sources are public literature; see each module's docstring for the citation
tag from the assignment. A copy of the JAX package's registry: the port
imports nothing of that package.
"""
from __future__ import annotations

from .base import ArchConfig, ShapeConfig, SHAPES, shape_applicable  # noqa
from . import (granite_moe_1b_a400m, h2o_danube_1_8b, hymba_1_5b,
               moonshot_v1_16b_a3b, qwen2_vl_72b, qwen3_8b, stablelm_12b,
               starcoder2_3b, whisper_large_v3, xlstm_1_3b)

ALL = {m.CONFIG.name: m.CONFIG for m in (
    stablelm_12b, h2o_danube_1_8b, starcoder2_3b, qwen3_8b,
    moonshot_v1_16b_a3b, granite_moe_1b_a400m, qwen2_vl_72b, hymba_1_5b,
    whisper_large_v3, xlstm_1_3b)}


def get(name: str) -> ArchConfig:
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALL)}")
    return ALL[name]
