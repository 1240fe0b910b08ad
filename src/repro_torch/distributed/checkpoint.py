"""Fault-tolerant checkpointing: atomic, keep-K, pinned, namespaced.

  * atomic: write to ``step_XXXX.tmp*`` then rename — a crash mid-write can
    never corrupt the restore point;
  * keep-K: bounded disk; the newest complete checkpoint wins on restore,
    and ``pin`` protects steps a live WAL watermark still references;
  * host-agnostic payload: the leaves of a tree are saved as host numpy
    arrays (``arrays.npz``, ``leaf_0`` … ``leaf_{k-1}``) beside
    ``meta.json`` (step, leaf count, a description of the tree and a user
    dict).

The on-disk format is the JAX reference's (``repro.distributed.
checkpoint``), so checkpoints written by either package load in the other:
both read leaves by index and neither parses the ``treedef`` string (this
module writes its own description there). A tree is flattened the way
``jax.tree`` flattens the structures the serving tier and the trainer
save: a leaf is a tensor, array or scalar (a ``models.sharding.Sharded``
is saved whole); dicts go in sorted key order, lists and tuples in
order (a NamedTuple restores as its own type, any other tuple as a plain
tuple), and an object with
``tree_flatten()`` / ``tree_unflatten(aux, children)``
(``serve.ClusterSnapshot``) by those.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import Sharded, place


def _flatten(tree) -> Tuple[list, Callable[[list], Any], str]:
    """(leaves, rebuild from a list of leaves, description)."""
    if hasattr(tree, "tree_flatten"):
        children, aux = tree.tree_flatten()
        leaves, rebuild, desc = _flatten(list(children))
        return (leaves,
                lambda xs: type(tree).tree_unflatten(aux, rebuild(xs)),
                f"{type(tree).__name__}{desc}")
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return _join(parts, lambda out: dict(zip(keys, out)),
                     "{" + ", ".join(f"{k!r}: {p[2]}"
                                     for k, p in zip(keys, parts)) + "}")
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        desc = "(" + ", ".join(p[2] for p in parts) + ")"
        if isinstance(tree, list):
            return _join(parts, list, desc)
        if hasattr(tree, "_fields"):     # a NamedTuple keeps its type
            return _join(parts, lambda out: type(tree)(*out),
                         type(tree).__name__ + desc)
        return _join(parts, tuple, desc)
    return [tree], lambda xs: xs[0], "*"


def _join(parts, make, desc):
    """The leaves of ``parts`` in order, and a rebuild that hands each
    part its own run of leaves and ``make`` the rebuilt parts."""
    sizes = [len(p[0]) for p in parts]

    def rebuild(xs):
        out, i = [], 0
        for (_, rb, _), k in zip(parts, sizes):
            out.append(rb(xs[i:i + k]))
            i += k
        return make(out)

    return [x for p in parts for x in p[0]], rebuild, desc


def tree_flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """(leaves in the checkpoint's order, rebuild from a list of leaves):
    the order ``jax.tree.flatten`` gives the same structure."""
    leaves, rebuild, _ = _flatten(tree)
    return leaves, rebuild


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, Sharded):
        x = x.full()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def namespace_dir(ckpt_dir: str, namespace: Optional[str] = None) -> str:
    """Root directory holding one namespace's ``step_*`` dirs.

    A ``namespace`` (e.g. a serving shard id) gets its own subdirectory of
    step dirs, so keep-K GC and watermark pins are scoped per namespace —
    one writer's GC can never delete another's pinned baseline. ``None``
    is the legacy layout: steps directly under ``ckpt_dir``.
    """
    if namespace is None:
        return ckpt_dir
    ns = str(namespace)
    if (not ns or os.sep in ns or (os.altsep and os.altsep in ns)
            or ns in (".", "..") or ns.startswith("step_")):
        raise ValueError(f"invalid checkpoint namespace {namespace!r}: "
                         "must be a single path component, not step_*")
    return os.path.join(ckpt_dir, ns)


def save(ckpt_dir: str, step: int, tree, *, meta: Optional[dict] = None,
         keep: int = 3, pin=(), namespace: Optional[str] = None) -> str:
    """Atomically publish ``tree`` as ``step``, then keep-K GC.

    ``pin`` is a collection of step numbers the GC must never delete even
    when they fall outside the newest ``keep`` — the serving tier passes
    the steps its live WAL watermarks reference, so a recovery baseline
    is never orphaned by a later publish.

    ``namespace`` scopes the step sequence (and its keep-K GC / pins) to
    a subdirectory.
    """
    ckpt_dir = namespace_dir(ckpt_dir, namespace)
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, _, desc = _flatten(tree)
    name = f"step_{step:010d}"
    final = os.path.join(ckpt_dir, name)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=name + ".tmp")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(leaves),
                       "treedef": desc, "meta": meta or {}}, f)
        if os.path.exists(final):
            # step already published (e.g. resumed run re-crossing a
            # checkpoint boundary) — idempotent, keep the existing one
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep, pin=pin)
    return final


def _gc(ckpt_dir: str, keep: int, *, pin=()):
    """Delete all but the newest ``keep`` steps, skipping ``pin``ned ones
    (steps a live WAL watermark still references — deleting one would
    orphan the change log's recovery baseline). Runs inside one namespace
    root only — sibling namespaces are invisible to it by construction."""
    pinned = {int(s) for s in pin}
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep]:
        if int(d.split("_")[1]) in pinned:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def available_steps(ckpt_dir: str, *,
                    namespace: Optional[str] = None) -> list:
    """Published step numbers, ascending. Only completed (atomically
    renamed) step dirs count — ``*.tmp*`` crash leftovers never do. A
    *published-then-damaged* step still appears here; readers that must
    survive bit-rot walk this list newest-first and fall back (the
    snapshot loader's posture)."""
    ckpt_dir = namespace_dir(ckpt_dir, namespace)
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and ".tmp" not in d)


def latest_step(ckpt_dir: str, *,
                namespace: Optional[str] = None) -> Optional[int]:
    steps = available_steps(ckpt_dir, namespace=namespace)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
            shardings=None, namespace: Optional[str] = None):
    """Restore into the structure of ``tree_like``: its leaves are
    replaced, in flattening order, by the saved numpy arrays ``leaf_0`` …
    Returns ``(tree, meta)`` with ``meta`` the whole ``meta.json``.

    ``shardings`` (a tree of ``models.sharding.NamedSharding``, one a
    leaf, in the same order) places each leaf on a mesh: it comes back as
    a ``models.sharding.Sharded``, its blocks on the mesh's devices. This
    is where elastic resharding onto a new mesh happens."""
    ckpt_dir = namespace_dir(ckpt_dir, namespace)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    leaves_like, rebuild, _ = _flatten(tree_like)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(leaves_like))]
    if shardings is not None:
        sh_leaves = tree_flatten(shardings)[0]
        if len(sh_leaves) != len(leaves):
            raise ValueError(f"{len(sh_leaves)} shardings for "
                             f"{len(leaves)} leaves")
        leaves = [place(x, s) for x, s in zip(leaves, sh_leaves)]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return rebuild(leaves), meta
