"""AdamW (hand-rolled) + global-norm clipping + cosine schedule (the port
of ``repro.train.optimizer``).

Optimizer state mirrors the parameter tree, so its sharding specs follow
the parameters (data-FSDP × model-TP). Every number is f32 and each
element gets the reference's formula in its order: powers, the schedule
and the bias corrections in f32 tensors (a Python float is rounded to f32
once, as JAX rounds a weakly typed constant), weight decay inside the lr
product on the old parameter — not ``torch.optim.AdamW``, which decays
with a separate ``p *= 1 - lr·wd``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..distributed.checkpoint import tree_flatten

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def _zeros(params):
    leaves, rebuild = tree_flatten(params)
    return rebuild([torch.zeros_like(p, dtype=_F32) for p in leaves])


def init(params) -> OptState:
    """Zero moments (f32) and step 0 (int32), on the parameters' device."""
    dev = tree_flatten(params)[0][0].device
    return OptState(m=_zeros(params), v=_zeros(params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to f32, on ``like``'s device: filled there (no copy
    from the host, which would wait for the device)."""
    return torch.full((), x, dtype=_F32, device=like.device)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then cosine decay to ``min_lr_frac·lr``
    at ``total_steps``; f32, on ``step``'s device."""
    step = torch.as_tensor(step).to(_F32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves, in flatten order, of each leaf's f32 Σx²)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in tree_flatten(tree)[0]))


def apply(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step. Returns (params, state, {"grad_norm", "lr"}) with
    ``grad_norm`` the norm before clipping.

    The update is written in place, under ``torch.no_grad()``: the
    returned ``params`` and the moments of the returned state are the
    tensors passed in, updated (the counterpart of the reference's donated
    state). ``state.step`` is replaced, not written."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        # a Python number over a tensor is a reciprocal then a product in
        # PyTorch: divide f32 tensors, as the reference does
        scale = torch.clamp_max(_f32(cfg.clip_norm, gnorm)
                                / torch.clamp_min(gnorm, 1e-9), 1.0)
        step = state.step + 1
        lr = schedule(cfg, step)
        step_f = step.to(_F32)
        b1c = 1 - _f32(cfg.b1, step) ** step_f
        b2c = 1 - _f32(cfg.b2, step) ** step_f
        ps = tree_flatten(params)[0]
        gs, ms, vs = (tree_flatten(t)[0] for t in (grads, state.m, state.v))
        for p, g, m, v in zip(ps, gs, ms, vs):
            g = g.to(_F32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            den = torch.sqrt(v / b2c).add_(cfg.eps)
            upd = (m / b1c).div_(den).add_(cfg.weight_decay * p)
            p.sub_(lr * upd)
    return params, OptState(state.m, state.v, step), \
        {"grad_norm": gnorm, "lr": lr}
