"""Logical-axis → mesh-axis sharding rules (the port of
``repro.models.sharding``, without ``constrain``).

Every parameter/activation dimension carries a *logical* axis name
(``param_axes``); rules map those to mesh axes. The production mapping:

  batch   → ("pod", "data")   pure DP across pods, DP within pod
  embed   → "data"            FSDP / ZeRO-3: params + optimizer state sharded
  heads/kv/ff/vocab/experts → "model"   tensor / expert parallelism

A spec is a tuple with one entry a dimension: a mesh axis name, a tuple
of them, or ``None`` (the dimension is whole). PyTorch has no GSPMD to
place tensors by a spec, so the port computes what a spec means:
``shard_index`` gives the block of a tensor that one mesh position holds,
with ``jax.sharding.NamedSharding``'s layout, and ``place`` cuts a tensor
into those blocks on the mesh's devices (a :class:`Sharded`). The
reference's ``constrain`` (an activation-sharding hint to GSPMD) has no
counterpart: the port's model code calls nothing in its place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch


def default_rules(mesh) -> dict:
    axes = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in axes) or (None,)
    return {
        "batch": batch if len(batch) > 1 else batch[0],
        "embed": "data" if "data" in axes else None,
        "heads": "model" if "model" in axes else None,
        "kv": "model" if "model" in axes else None,
        "ff": "model" if "model" in axes else None,
        "vocab": "model" if "model" in axes else None,
        "experts": "model" if "model" in axes else None,
        "expert_embed": "data" if "data" in axes else None,
        "seq": None, "hd": None, "layers": None, "state": None,
        "cap": None, None: None,
    }


def serve_rules(mesh) -> dict:
    """Inference sharding: TP-only parameters (no FSDP d-shard).

    Training wants ZeRO-3 (optimizer state dominates, gradients amortize
    the gathers); serving has no optimizer state, and a d-dim shard over
    `data` makes every layer all-reduce its activations. TP-only weights
    trade replicated-across-data memory for collapsing that term.
    """
    rules = default_rules(mesh)
    rules["embed"] = None
    return rules


def spec_for(axes: tuple, rules: dict) -> tuple:
    return tuple(rules.get(a) for a in axes)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(mesh, shape: tuple, spec: tuple) -> tuple:
    """Drop mesh axes from dims they don't evenly divide.

    Odd vocab sizes (49155, 51866, 32001) and small head counts (kv=2..8
    vs model=16) fall back to replication on that dim — recorded, not
    fatal.
    """
    out = []
    for i in range(len(shape)):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(None)
            continue
        n = math.prod(mesh.shape[a] for a in _axes(entry))
        out.append(entry if shape[i] % n == 0 else None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a leaf of a tree, as jax's ``NamedSharding``)."""
    mesh: Any
    spec: tuple


def sharding_for(mesh, axes: tuple, rules: Optional[dict] = None,
                 shape: Optional[tuple] = None) -> NamedSharding:
    rules = rules or default_rules(mesh)
    spec = spec_for(axes, rules)
    if shape is not None:
        spec = sanitize_spec(mesh, shape, spec)
    return NamedSharding(mesh, spec)


def _map_axes(fn, tree):
    """``fn`` over a tree whose leaves are tuples of logical axes."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v) for v in tree]
    return fn(tree)


def tree_shardings(mesh, axes_tree, rules: Optional[dict] = None):
    rules = rules or default_rules(mesh)
    return _map_axes(lambda axes: sharding_for(mesh, axes, rules), axes_tree)


def shard_index(shape: tuple, sharding: NamedSharding, position) -> tuple:
    """The block of a ``shape`` tensor that mesh ``position`` (a flat
    row-major index or a tuple of coordinates) holds: one slice a dim.

    A dim mapped to axes ``(a1, a2)`` splits into ``size(a1)·size(a2)``
    blocks of ``ceil(dim / n)`` (the last ones shorter or empty where
    ``n`` does not divide the dim), and the position holds block
    ``coord(a1)·size(a2) + coord(a2)``; a dim mapped to nothing is whole.
    """
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    coords = mesh.coords(position)
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(slice(0, dim))
            continue
        n, k = 1, 0
        for a in _axes(entry):
            n *= mesh.shape[a]
            k = k * mesh.shape[a] + coords[a]
        b = -(-dim // n)
        out.append(slice(min(k * b, dim), min((k + 1) * b, dim)))
    return tuple(out)


class Sharded:
    """A tensor cut into the blocks of a :class:`NamedSharding`:
    ``blocks[i]`` is flat mesh position ``i``'s block, on its device."""

    def __init__(self, sharding: NamedSharding, shape: tuple, blocks: list):
        self.sharding, self.shape, self.blocks = sharding, tuple(shape), blocks

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    def full(self) -> torch.Tensor:
        """The whole tensor, on the first position's device."""
        first = self.blocks[0]
        out = torch.empty(self.shape, dtype=first.dtype, device=first.device)
        for i, blk in enumerate(self.blocks):
            out[shard_index(self.shape, self.sharding, i)] = blk.to(
                first.device)
        return out


def place(x, sharding: NamedSharding) -> Sharded:
    """Cut ``x`` (a tensor or numpy array) into ``sharding``'s blocks, each
    copied to its position's device."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
    else:
        x = torch.from_numpy(np.array(x, order="C"))
    mesh = sharding.mesh
    blocks = [x[shard_index(x.shape, sharding, i)].to(
        mesh.devices[i], copy=True) for i in range(mesh.size)]
    return Sharded(sharding, x.shape, blocks)
