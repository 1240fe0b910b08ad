"""Training loop: the train step (eager autograd, microbatch gradient
accumulation), checkpoint/restart, and straggler-aware step timing (the
port of ``repro.train.trainer``).

The step function updates the state in place (the counterpart of the
reference's donated state); everything operational (checkpoint cadence,
restart, timing watchdog) lives out here so a node failure loses at most
``ckpt_every`` steps. Straggler mitigation at framework level: step-time
EWMA plus a slow-step counter — the launcher (launch/train.py) reads it
and can trigger an elastic reshard (distributed/elastic.py) when a host
degrades.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.engines import resolve_device
from ..distributed import checkpoint as ckpt
from ..distributed.checkpoint import tree_flatten
from ..models import model as model_mod
from . import optimizer as opt_mod


class TrainState(NamedTuple):
    params: Any
    opt: opt_mod.OptState


def make_train_step(cfg: ArchConfig, ocfg: opt_mod.AdamWConfig,
                    microbatch: int = 0) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``, eager PyTorch.

    The parameters are the state's own tensors: the step sets them to
    require grad, runs the backward pass into their ``.grad`` and applies
    AdamW in place. ``microbatch > 1`` splits the batch along dim 0 into
    that many accumulation chunks (sequential grad accumulation — the
    standard memory/throughput knob): the chunks' gradients are summed in
    order and divided by ``microbatch`` once, and the metrics are then
    the loss and the optimizer's only.
    """

    accumulate = microbatch and microbatch > 1

    def step(state: TrainState, batch):
        params, rebuild = tree_flatten(state.params)
        for p in params:
            p.requires_grad_(True)
            p.grad = None
        if accumulate:
            lsum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            for i in range(microbatch):
                chunk = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                      + v.shape[1:])[i]
                         for k, v in batch.items()}
                li, _ = model_mod.loss_fn(cfg, state.params, chunk)
                li.backward()            # .grad accumulates g1 + g2 + …
                lsum = lsum + li.detach()
            lval = lsum / microbatch
            metrics = {}
        else:
            lval, metrics = model_mod.loss_fn(cfg, state.params, batch)
            lval.backward()
            lval = lval.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if accumulate:
            grads = [g / microbatch for g in grads]
        new_params, opt_state, om = opt_mod.apply(ocfg, state.params,
                                                  rebuild(grads), state.opt)
        for p in params:
            p.grad = None
        return TrainState(new_params, opt_state), \
            {"loss": lval, **metrics, **om}

    return step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0   # step slower than EWMA×f counts as slow


def _to_device(tree, like, dev):
    """``tree``'s leaves (tensors or numpy arrays) as tensors on ``dev``
    with the dtypes of ``like``'s leaves (the same structure)."""
    leaves, rebuild = tree_flatten(tree)
    return rebuild([(x if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.array(x))).to(dev, l.dtype)
                    for x, l in zip(leaves, tree_flatten(like)[0])])


def state_from_jax(cfg: ArchConfig, state, *, device=None) -> TrainState:
    """The port's ``TrainState`` from the reference's, given as numpy
    arrays (``jax.tree.map(np.asarray, state)``), on ``device`` (default
    ``cuda``): the parameters and both moments through ``params_from_jax``
    (every key, shape and dtype checked), ``step`` as an int32 scalar."""
    dev = resolve_device(device)
    params, (m, v, step) = state
    step = np.asarray(step)
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt step: {step.dtype}{list(step.shape)}, "
                         "expected a scalar int32")
    def conv(tree):
        return model_mod.params_from_jax(cfg, tree, device=dev)

    return TrainState(conv(params), opt_mod.OptState(
        conv(m), conv(v), torch.tensor(int(step), dtype=torch.int32,
                                       device=dev)))


def train_loop(cfg: ArchConfig, tcfg: TrainerConfig,
               ocfg: opt_mod.AdamWConfig, batch_iter, *,
               state: Optional[TrainState] = None, seed: int = 0,
               step_fn=None, log=print, device=None):
    """Run/resume a training job on ``device`` (default ``cuda``; a given
    ``state`` is moved there, and updated in place where it already lives
    there); returns (state, history).

    Each step reads its metrics to the host once (one host sync a step).
    A checkpoint restores as numpy arrays, which go back on the device
    with the state's dtypes."""
    dev = resolve_device(device)
    if state is None:
        params = model_mod.init_params(cfg, seed, device=dev)
        state = TrainState(params, opt_mod.init(params))
    else:
        state = _to_device(state, state, dev)
    start_step = 0
    if tcfg.ckpt_dir and ckpt.latest_step(tcfg.ckpt_dir) is not None:
        restored, meta = ckpt.restore(tcfg.ckpt_dir, state)
        state = _to_device(restored, state, dev)
        start_step = meta["step"]
        log(f"[trainer] resumed from step {start_step}")
    step_fn = step_fn or make_train_step(cfg, ocfg)

    history = []
    ewma = None
    slow_steps = 0
    for i in range(start_step, tcfg.total_steps):
        batch = next(batch_iter)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        vals = torch.stack([v.to(torch.float32).reshape(())
                            for v in metrics.values()]).tolist()
        metrics = dict(zip(metrics, vals))
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > tcfg.straggler_factor * ewma and i > start_step + 3:
            slow_steps += 1  # surfaced to the launcher for elastic action
        metrics.update(step=i + 1, dt=dt, slow_steps=slow_steps)
        history.append(metrics)
        if (i + 1) % tcfg.log_every == 0:
            log(f"[trainer] step {i+1} loss={metrics['loss']:.4f} "
                f"dt={dt*1e3:.1f}ms")
        if tcfg.ckpt_dir and (i + 1) % tcfg.ckpt_every == 0:
            ckpt.save(tcfg.ckpt_dir, i + 1, state, keep=tcfg.keep,
                      meta={"slow_steps": slow_steps})
    if tcfg.ckpt_dir:
        ckpt.save(tcfg.ckpt_dir, tcfg.total_steps, state, keep=tcfg.keep)
    return state, history
