"""Unified model API over the zoo (the port of ``repro.models.model``):
defs, init, steps and input specs per arch, and ``LM``, the module that
owns a model's parameters.

``input_specs(cfg, shape)`` says what each (arch × workload-shape) cell
consumes, as meta tensors (shapes and dtypes without storage);
``synth_batch`` makes matching random inputs.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..core.engines import resolve_device
from . import encdec, transformer
from . import layers as ll
from .transformer import PD, tree_leaves


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.block == "encdec"


def model_defs(cfg: ArchConfig):
    return encdec.model_defs(cfg) if is_encdec(cfg) else \
        transformer.model_defs(cfg)


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None):
    """Random f32 parameters on ``device`` (default ``cuda``)."""
    return transformer.init_params(cfg, seed, defs=model_defs(cfg),
                                   device=device)


def param_axes(cfg: ArchConfig):
    return transformer.param_axes(cfg, defs=model_defs(cfg))


def param_shapes(cfg: ArchConfig):
    return transformer.param_shapes(cfg, defs=model_defs(cfg))


def params_from_jax(cfg: ArchConfig, tree, *, device=None):
    """The port's parameter tree from the reference's, given as numpy
    arrays (``jax.tree.map(np.asarray, params)``), on ``device`` (default
    ``cuda``). Every key, shape and dtype (f32) is checked against
    ``model_defs(cfg)``; a mismatch raises ``ValueError``."""
    dev = resolve_device(device)

    def conv(defs, node, path):
        if isinstance(defs, PD):
            a = np.asarray(node)
            if a.shape != tuple(defs.shape) or a.dtype != np.float32:
                raise ValueError(
                    f"{'/'.join(path)}: {a.dtype}{list(a.shape)}, expected "
                    f"float32{list(defs.shape)}")
            return torch.from_numpy(np.array(a, copy=True)).to(dev)
        if not isinstance(node, dict) or set(node) != set(defs):
            have = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {have}, "
                             f"expected {sorted(defs)}")
        return {k: conv(defs[k], node[k], path + (k,)) for k in defs}

    return conv(model_defs(cfg), tree, ())


def forward(cfg: ArchConfig, params, batch):
    if is_encdec(cfg):
        return encdec.forward(cfg, params, batch)
    return transformer.forward(cfg, params, batch)


def loss_fn(cfg: ArchConfig, params, batch):
    logits, _, aux = forward(cfg, params, batch)
    loss = ll.cross_entropy(logits, batch["labels"])
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def prefill(cfg: ArchConfig, params, batch, cache_len: int):
    if is_encdec(cfg):
        return encdec.prefill(cfg, params, batch, cache_len)
    return transformer.prefill(cfg, params, batch, cache_len)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """One decode step; updates attention caches in place (see
    ``transformer.decode_step``)."""
    if is_encdec(cfg):
        return encdec.decode_step(cfg, params, cache, tokens, pos)
    return transformer.decode_step(cfg, params, cache, tokens, pos)


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, *,
               device=None):
    if is_encdec(cfg):
        return encdec.init_cache(cfg, batch_size, cache_len,
                                 encdec.enc_seq_len(cache_len), device=device)
    return transformer.init_cache(cfg, batch_size, cache_len, device=device)


class LM(torch.nn.Module):
    """A model of the zoo that owns its parameters (registered under their
    tree paths joined by "/", without gradients) and serves through
    ``forward``, ``prefill`` and ``decode_step``, on the device its
    parameters live on."""

    def __init__(self, cfg: ArchConfig, params):
        super().__init__()
        self.cfg = cfg
        self._paths = []
        for path, leaf in tree_leaves(params):
            self.register_parameter(
                "/".join(path), torch.nn.Parameter(leaf, requires_grad=False))
            self._paths.append(path)

    @property
    def params(self) -> dict:
        out: dict = {}
        for path in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, "/".join(path))
        return out

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, batch):
        return forward(self.cfg, self.params, batch)

    def prefill(self, batch, cache_len: int):
        return prefill(self.cfg, self.params, batch, cache_len)

    def decode_step(self, cache, tokens, pos):
        return decode_step(self.cfg, self.params, cache, tokens, pos)

    def init_cache(self, batch_size: int, cache_len: int):
        return init_cache(self.cfg, batch_size, cache_len, device=self.device)


# ------------------------------------------------------------ input specs --


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ArchConfig, B: int, S: int, *, train: bool) -> Dict:
    specs: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if train:
        specs["labels"] = _meta((B, S), torch.int32)
    if cfg.frontend == "vision":
        specs["patch_embeds"] = _meta((B, max(S // 4, 8), cfg.d_model),
                                      torch.float32)
        specs["pos3"] = _meta((B, S, 3), torch.int32)
    if is_encdec(cfg):
        specs["frames"] = _meta((B, encdec.enc_seq_len(S), cfg.d_model),
                                torch.float32)
    return specs


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    """Meta-tensor stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": _batch_specs(cfg, B, S, train=True)}
    if shape.kind == "prefill":
        return {"batch": _batch_specs(cfg, B, S, train=False)}
    if shape.kind == "decode":
        return {"cache": init_cache(cfg, B, S, device="meta"),
                "tokens": _meta((B, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)


def synth_batch(cfg: ArchConfig, B: int, S: int, seed: int = 0, *,
                train: bool = True, device=None):
    """Random inputs matching ``_batch_specs``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def ints(shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             dtype=torch.int32, device=dev)

    def normal(shape):
        return 0.02 * torch.randn(shape, generator=gen, dtype=torch.float32,
                                  device=dev)

    batch = {"tokens": ints((B, S))}
    if train:
        batch["labels"] = ints((B, S))
    if cfg.frontend == "vision":
        batch["patch_embeds"] = normal((B, max(S // 4, 8), cfg.d_model))
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        batch["pos3"] = torch.stack([pos, pos, pos], dim=-1)
    if is_encdec(cfg):
        batch["frames"] = normal((B, encdec.enc_seq_len(S), cfg.d_model))
    return batch


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params,
    D = the tokens the cell processes (decode: one a sequence)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
