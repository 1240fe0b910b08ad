"""Elastic scaling + straggler mitigation policy (the port of
``repro.distributed.elastic``).

  1. checkpoints are mesh-agnostic (unsharded payload; see checkpoint.py),
     so a restart may use any surviving device count;
  2. ``plan_mesh`` picks the best (data, model) factorization for the
     surviving devices, preferring to shrink the data axis (pure-DP loss)
     before touching model parallelism (which changes per-device layouts);
  3. ``reshard_state`` = restore(ckpt, shardings-for-new-mesh): the loader
     cuts every leaf into the new mesh's blocks on its devices;
  4. stragglers: the trainer reports a slow-step counter (EWMA watchdog,
     train/trainer.py); ``StragglerPolicy`` converts it into an action —
     first exclude the slow host (elastic restart on fewer nodes), since at
     synchronous scale one slow host rate-limits the fleet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..launch.mesh import make_mesh
from ..models import sharding as sh
from . import checkpoint as ckpt


def plan_mesh(n_devices: int, *, prefer_model: int = 16):
    """Best (data, model) mesh for a surviving device count."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return (n_devices // model, model), ("data", "model")


def reshard_state(ckpt_dir: str, state_like, new_mesh, axes_tree=None,
                  step: Optional[int] = None):
    """Restore a checkpoint onto a (possibly different) mesh: with
    ``axes_tree`` (logical axes a leaf, the structure of ``state_like``)
    each leaf comes back as a ``models.sharding.Sharded`` on ``new_mesh``
    under ``default_rules``; without it, as the saved numpy array."""
    shardings = None if axes_tree is None else \
        sh.tree_shardings(new_mesh, axes_tree, sh.default_rules(new_mesh))
    return ckpt.restore(ckpt_dir, state_like, step=step,
                        shardings=shardings)


@dataclasses.dataclass
class StragglerPolicy:
    """Turns trainer slow-step telemetry into elastic actions."""
    slow_steps_budget: int = 5       # tolerated before acting
    min_devices: int = 2

    def decide(self, slow_steps: int, n_devices: int) -> Optional[dict]:
        if slow_steps < self.slow_steps_budget:
            return None
        if n_devices // 2 >= self.min_devices:
            shape, axes = plan_mesh(n_devices // 2)
            return {"action": "shrink", "mesh_shape": shape,
                    "mesh_axes": axes,
                    "reason": f"{slow_steps} straggler steps"}
        return {"action": "restart", "reason": "no capacity to shrink"}


def elastic_restart(ckpt_dir: str, state_like, n_devices: int,
                    axes_tree=None, *, devices=None):
    """One-call elastic resume: plan mesh for the surviving devices (the
    first ``n_devices`` of ``devices``, default every visible card),
    restore + reshard, return (mesh, state, meta)."""
    shape, axes = plan_mesh(n_devices)
    mesh = make_mesh(shape, axes, devices)
    state, meta = reshard_state(ckpt_dir, state_like, mesh, axes_tree)
    return mesh, state, meta
