"""Cluster snapshots: a built, labeled index frozen for online serving.

A :class:`ClusterSnapshot` is the cell-sorted CSR layout of a clustered
corpus plus its DBSCAN outputs, as tensors on one device, so that it can

  * answer cross-corpus queries (``serve.assign`` — the ``cross_sweep``
    kernel walks the frozen slabs),
  * absorb streamed points (``serve.ServeSession.ingest``), and
  * survive process death: save/load goes through ``distributed.
    checkpoint``'s atomic-rename machinery, so a crash mid-write can never
    corrupt a published snapshot and the newest intact one wins on load.

Snapshots are interchangeable with the JAX reference's
(``repro.serve.snapshot``): the same eight arrays in the same order
(``leaf_0`` … ``leaf_7``), the same ``meta.json`` keys, and a plan whose
fields are the reference's ``CSRGridSpec``'s.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
import zipfile
from typing import Any

import numpy as np
import torch

from ..core import engines
from ..core import grid as grid_mod
from ..core import neighbors as nb
from ..core.dbscan import dbscan
from ..distributed import checkpoint as ckpt
from . import resilience

INT_MAX = nb.INT_MAX

SNAPSHOT_FORMAT = 1

# Grown cross-query slab capacities keyed by the snapshot's (hashable)
# plan; a regrow sticks so steady-state serving pays it once, not per
# call. Keying by spec rather than object identity means the entry
# survives reload of the same snapshot and can never alias an unrelated
# one (a different corpus has a different plan); at worst two same-plan
# snapshots share a grown slab, which only ever over-provisions (the
# effective slab is clamped to n_cand).
_SLAB_CACHE: dict = {}

# dtypes of the eight arrays, in checkpoint leaf order
_FIELDS = (("points", torch.float32), ("labels", torch.int32),
           ("core", torch.bool), ("counts", torch.int32),
           ("order", torch.int32), ("cands", torch.float32),
           ("codes", torch.int32), ("croot_sorted", torch.int32))


@dataclasses.dataclass(frozen=True)
class ClusterSnapshot:
    """A frozen, clustered, queryable index, as tensors on one device.

    Layout invariant: ``cands``/``codes``/``croot_sorted`` are in Morton-
    sorted order (position s = s-th smallest cell code); ``points`` /
    ``labels`` / ``core`` / ``counts`` are in original corpus order with
    ``order`` mapping sorted position -> original index.
    """
    points: Any        # (n, 3) f32 corpus, original order
    labels: Any        # (n,) i32 cluster labels (min core index), -1 noise
    core: Any          # (n,) bool
    counts: Any        # (n,) i32 stage-1 ε-neighbor counts
    order: Any         # (n,) i32 sorted position -> original index
    cands: Any         # (3, n_cand) f32 cell-sorted planar corpus, +BIG pad
    codes: Any         # (n,) i32 sorted Morton cell codes (bisect target)
    croot_sorted: Any  # (n_cand,) i32 label if core else INT32_MAX (sorted)
    spec: grid_mod.CSRGridSpec  # static plan
    engine: str = "grid"
    eps: float = 0.0
    min_pts: int = 0

    def tree_flatten(self):
        """(the eight arrays in checkpoint leaf order, the static rest)."""
        children = tuple(getattr(self, f) for f, _ in _FIELDS)
        return children, (self.spec, self.engine, self.eps, self.min_pts)

    @classmethod
    def tree_unflatten(cls, aux, children):
        spec, engine, eps, min_pts = aux
        return cls(*children, spec=spec, engine=engine, eps=eps,
                   min_pts=min_pts)

    @property
    def n(self) -> int:
        return self.spec.n

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def slab(self) -> int:
        """Effective cross-query slab capacity: the plan's, or the grown
        value a previous overflow-regrow stuck for this plan."""
        return _SLAB_CACHE.get(self.spec, self.spec.slab)

    def to(self, device) -> "ClusterSnapshot":
        """The same snapshot with every tensor on ``device`` (the sharded
        tier's placement of a shard or replica on its card)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f, _ in _FIELDS})

    def note_slab(self, slab: int) -> None:
        """Stick a regrown slab capacity for this snapshot's plan."""
        _SLAB_CACHE[self.spec] = slab

    def n_clusters(self) -> int:
        lab = self.labels
        return int(lab[lab >= 0].unique().numel())


def build_snapshot(points, eps: float, min_pts: int, *,
                   engine: str = "grid", spec=None,
                   device=None) -> ClusterSnapshot:
    """Cluster ``points`` on ``device`` (``None`` means ``cuda``) and
    freeze the result for serving.

    The engine is vetted through the registry *before* its build runs:
    only engines advertising the ``query`` capability can answer
    cross-corpus queries, and rejecting a mismatch here costs a dict
    lookup instead of a full structure build. The clustering runs the
    frontier round driver, as compactions re-cluster the concatenated
    corpus through this call.
    """
    entry = engines.get_engine_spec(engine)
    if "query" not in entry.capabilities:
        raise ValueError(
            f"engine {engine!r} does not provide the cross-corpus 'query' "
            "capability required for serving; registered engines that do: "
            + ", ".join(sorted(
                n for n in engines.available_engines()
                if "query" in engines.get_engine_spec(n).capabilities)))
    dev = engines.resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    eng = nb.make_engine(points, eps, engine=engine, spec=spec, device=dev)
    res = dbscan(points, eps, min_pts, eng=eng, hook_loop="frontier")
    g = eng.state  # CSRGrid: the frozen sorted layout
    cspec: grid_mod.CSRGridSpec = eng.meta
    n = cspec.n
    order = g.order.long()
    croot_sorted = torch.full((cspec.n_cand,), INT_MAX, dtype=torch.int32,
                              device=dev)
    croot_sorted[:n] = torch.where(res.core[order], res.labels[order],
                                   INT_MAX)
    return ClusterSnapshot(
        points=points, labels=res.labels, core=res.core, counts=res.counts,
        order=g.order, cands=g.cands, codes=g.codes,
        croot_sorted=croot_sorted, spec=cspec, engine=engine,
        eps=float(eps), min_pts=int(min_pts))


def _spec_to_meta(spec: grid_mod.CSRGridSpec) -> dict:
    d = dataclasses.asdict(spec)
    d["origin"] = list(d["origin"])
    return d


def _spec_from_meta(d: dict) -> grid_mod.CSRGridSpec:
    d = dict(d)
    d["origin"] = tuple(float(v) for v in d["origin"])
    return grid_mod.CSRGridSpec(**d)


def save_snapshot(snapshot: ClusterSnapshot, ckpt_dir: str, *,
                  step: int = 0, keep: int = 3,
                  wal_offset: int | None = None, pin=(),
                  namespace: str | None = None) -> str:
    """Publish a snapshot atomically (checkpoint machinery: tmp dir +
    rename, keep-K gc). ``step`` versions successive snapshots — ingest
    compactions bump it, and the newest complete one wins on load.

    ``wal_offset`` (durable sessions) embeds the snapshot's own change-log
    watermark in its meta: every WAL record below it is folded into this
    corpus, so recovery replays exactly the suffix — the offset rides the
    atomic rename, making the watermark crash-consistent even when the
    WAL's own WATERMARK record never lands. ``pin`` forwards
    watermark-referenced steps to the keep-K GC. ``namespace`` (e.g. a
    shard id) scopes the step sequence to its own subdirectory.
    """
    meta = {
        "kind": "cluster_snapshot",
        "format": SNAPSHOT_FORMAT,
        "engine": snapshot.engine,
        "eps": snapshot.eps,
        "min_pts": snapshot.min_pts,
        "spec": _spec_to_meta(snapshot.spec),
    }
    if wal_offset is not None:
        meta["wal_offset"] = int(wal_offset)
    return ckpt.save(ckpt_dir, step, snapshot, meta=meta, keep=keep,
                     pin=pin, namespace=namespace)


def published_wal_offsets(ckpt_dir: str, *,
                          namespace: str | None = None) -> dict:
    """``{step: wal_offset}`` of every published snapshot whose meta is
    readable and carries a watermark. The minimum over the *newest
    keep-K* of these is the WAL GC bound — the log always covers every
    keep-K baseline's replay suffix (unreadable metas are skipped: their
    step can't baseline a recovery anyway)."""
    root = ckpt.namespace_dir(ckpt_dir, namespace)
    out = {}
    for s in ckpt.available_steps(root):
        try:
            path = os.path.join(root, f"step_{s:010d}", "meta.json")
            with open(path) as f:
                meta = json.load(f)["meta"]
        except (OSError, ValueError, KeyError):
            continue
        if "wal_offset" in meta:
            out[s] = int(meta["wal_offset"])
    return out


def _load_snapshot_step(ckpt_dir: str, step: int, dev) -> tuple:
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)["meta"]
    if meta.get("kind") != "cluster_snapshot":
        raise ValueError(f"{path} is not a cluster snapshot checkpoint")
    if meta.get("format", 0) > SNAPSHOT_FORMAT:
        raise resilience.SnapshotFormatError(
            f"snapshot format {meta['format']} is newer than this build "
            f"supports ({SNAPSHOT_FORMAT})")
    spec = _spec_from_meta(meta["spec"])
    # skeleton with the right leaf count; restore fills the arrays
    skeleton = ClusterSnapshot(
        *(None for _ in _FIELDS), spec=spec, engine=meta["engine"],
        eps=float(meta["eps"]), min_pts=int(meta["min_pts"]))
    restored, full_meta = ckpt.restore(ckpt_dir, skeleton, step=step)
    arrays = {f: torch.as_tensor(np.array(getattr(restored, f)),
                                 dtype=dtype, device=dev)
              for f, dtype in _FIELDS}
    meta = dict(meta)
    meta["step"] = int(full_meta.get("step", step))
    return dataclasses.replace(restored, **arrays), meta


def load_snapshot(ckpt_dir: str, *, step: int | None = None,
                  with_meta: bool = False, namespace: str | None = None,
                  device=None):
    """Load the newest *intact* snapshot (or a specific ``step``) onto
    ``device`` (``None`` means ``cuda``).

    Incomplete ``*.tmp*`` leftovers from a crash mid-write are never
    considered — the atomic-rename contract of the checkpoint layer. What
    the rename cannot rule out is damage *after* publish (bit-rot, a
    truncating copy, fs corruption): a published step that fails to read
    back — truncated/garbage arrays, unparsable metadata, missing files —
    is skipped with a warning and the next-newest keep-K step is tried.
    Only when no intact version exists does the load raise. Pinning an
    explicit ``step=`` disables the fallback: the caller asked for that
    exact version, so corruption there is an error. A snapshot written by
    a *newer format* raises :class:`~repro_torch.serve.resilience.
    SnapshotFormatError` without fallback — it is intact, just
    unsupported.

    With ``with_meta=True`` returns ``(snapshot, meta)`` where ``meta``
    carries ``step`` and (for durable sessions) ``wal_offset`` — what
    :meth:`ServeSession.recover` needs to pick its replay suffix.
    """
    dev = engines.resolve_device(device)
    ckpt_dir = ckpt.namespace_dir(ckpt_dir, namespace)
    if step is not None:
        snap, meta = _load_snapshot_step(ckpt_dir, step, dev)
        return (snap, meta) if with_meta else snap
    steps = ckpt.available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no snapshots in {ckpt_dir}")
    errors = []
    for s in reversed(steps):
        try:
            snap, meta = _load_snapshot_step(ckpt_dir, s, dev)
            return (snap, meta) if with_meta else snap
        except resilience.SnapshotFormatError:
            raise
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            errors.append(f"step {s}: {type(e).__name__}: {e}")
            warnings.warn(
                f"snapshot step {s} in {ckpt_dir} is unreadable "
                f"({type(e).__name__}: {e}); falling back to the "
                "next-newest intact version", RuntimeWarning)
    raise resilience.ServeError(
        f"no intact snapshot in {ckpt_dir}: " + "; ".join(errors))
