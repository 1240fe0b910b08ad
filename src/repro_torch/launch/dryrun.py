"""Multi-pod dry run: every (architecture × input shape) cell traced on
``meta`` tensors against the production meshes, with the roofline inputs
(the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with GSPMD on 512 placeholder
host devices. PyTorch has no partitioner and no compiler to ask, so each
cell here is three computations:

  (a) the layout: every argument leaf's sanitized spec on the production
      mesh (``launch.mesh.make_production_mesh`` over 512 ``meta``
      placeholders, 16×16 or 2×16×16) and, from ``models.sharding.
      shard_index``, each position's block: the bytes of the arguments,
      outputs and donated (in-place) state of the fullest device, and the
      dims that fell back to replication;
  (b) the step traced once on ``meta`` at the cell's global shape under
      ``op_costs.OpCosts``: executed product FLOPs and the eager program's
      bytes (the same for both meshes: only the layout differs);
  (c) ``analysis.analyze``: the three roofline terms against the card.

The model step runs no tensor or FSDP parallelism in the port, so it
issues no collective and its collective term is 0; without a partitioner
the port cannot size one device's temporaries, so ``temp_bytes`` is null
and the record's peak is a floor.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--archs a,b|all] [--shapes s,t|all] [--mesh single|multi|both]
        [--out results/dryrun_torch] [--force] [--list] [--paper]
        [--device cuda|cpu]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``; a failure writes
``status: error`` with its traceback, and the run then exits 1.
``--paper`` also runs the paper's distributed DBSCAN cells
(:func:`run_paper_cell`) on the card (``--device cuda``, the default; it
raises without one) or, asked for, on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any

import numpy as np
import torch

from ..configs import ALL, SHAPES, shape_applicable
from ..core.dbscan import dbscan
from ..core.engines import resolve_device
from ..core.labels import equivalent
from ..data import synth
from ..distributed import dbscan_dist as dd
from ..distributed.checkpoint import tree_flatten
from ..distributed.comm import ThreadGroup
from ..models import model as M
from ..models import sharding as sh
from ..models.transformer import tree_map
from ..train import optimizer as opt_mod
from ..train.trainer import TrainState, make_train_step
from . import analysis, op_costs
from .mesh import make_production_mesh

N_PLACEHOLDERS = 512
TEMP_NOTE = ("null: without a partitioner the port cannot size one "
             "device's temporaries, so peak_per_dev is a floor")
COLLECTIVE_NOTE = ("the port's model step issues no collective (no tensor "
                   "or FSDP parallelism), so the collective term is 0")


@dataclasses.dataclass(frozen=True)
class Struct:
    """A leaf without storage and its layout: the counterpart of a
    ``jax.ShapeDtypeStruct`` with a sharding. ``wanted`` is the spec the
    rules asked for, before dims that the mesh does not divide fell back
    to replication."""
    shape: tuple
    dtype: torch.dtype
    sharding: sh.NamedSharding
    wanted: tuple

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def production_mesh(mesh_kind: str):
    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                devices=["meta"] * N_PLACEHOLDERS)


def _map(fn, tree):
    leaves, rebuild = tree_flatten(tree)
    return rebuild([fn(x) for x in leaves])


def _batch_axes(mesh, b: int):
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if b % size == 0:
        return tuple(axes) if len(axes) > 1 else axes[0]
    if "data" in mesh.axis_names and b % mesh.shape["data"] == 0:
        return "data"
    return None


def _struct(mesh, shape, dtype, spec) -> Struct:
    shape = tuple(shape)
    return Struct(shape, dtype, sh.NamedSharding(
        mesh, sh.sanitize_spec(mesh, shape, spec)), tuple(spec))


def _with_sharding(tree, mesh, spec_fn):
    return _map(lambda s: _struct(mesh, s.shape, s.dtype, spec_fn(s)), tree)


def _param_structs(cfg, mesh, *, serve: bool = False):
    rules = sh.serve_rules(mesh) if serve else sh.default_rules(mesh)
    return tree_map(lambda pd: _struct(mesh, pd.shape, torch.float32,
                                       sh.spec_for(pd.axes, rules)),
                    M.model_defs(cfg))


def _batch_structs(cfg, specs, mesh, b):
    ba = _batch_axes(mesh, b)
    return _with_sharding(specs, mesh,
                          lambda s: (ba,) + (None,) * (len(s.shape) - 1))


def _cache_structs(cache_shapes, mesh, b, cfg):
    ba = _batch_axes(mesh, b)
    model_ax = "model" if "model" in mesh.axis_names else None
    model_size = mesh.shape.get("model", 1)

    def spec_fn(s):
        nd = len(s.shape)
        spec = [None] * nd
        if cfg.block == "xlstm":
            # (n_super, n_m, B, H, dk, dv) / (n_super, 3, B, d)
            if nd >= 3:
                spec[2] = ba
            if nd == 6:      # matrix state: shard dv over model
                spec[5] = model_ax
            return tuple(spec)
        # (L, B, T, KV, hd) / (L, B, T) / (L, B, d, N)
        if nd >= 2:
            spec[1] = ba
        if nd == 5:
            # KV heads over model when it divides them, else the time axis
            if s.shape[3] % model_size == 0:
                spec[3] = model_ax
            elif s.shape[2] % model_size == 0:
                spec[2] = model_ax
        if nd == 4:
            spec[2] = model_ax   # ssm inner width
        return tuple(spec)

    return _with_sharding(cache_shapes, mesh, spec_fn)


def _scalar(mesh, dtype) -> Struct:
    return _struct(mesh, (), dtype, ())


def build_cell(arch: str, shape_name: str, mesh):
    """Returns (fn, args tuple of Struct trees, model_flops, kw).

    ``fn`` takes the arguments as meta tensors (``Struct.meta``) and runs
    the cell's step. ``kw["outputs"]`` lays out the step's outputs (the
    state or cache it returns keeps its input layout; a logits output
    follows the batch); ``kw["donate_argnums"]`` names the arguments the
    step updates in place, the counterpart of the reference's donation.
    """
    cfg = ALL[arch]
    shape = SHAPES[shape_name]
    mf = M.model_flops(cfg, shape)
    specs = M.input_specs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    ba = _batch_axes(mesh, B)
    logits = _struct(mesh, (B, 1, cfg.vocab), torch.float32, (ba, None, None))

    if shape.kind == "train":
        params = _param_structs(cfg, mesh)
        opt = opt_mod.OptState(m=params, v=params,
                               step=_scalar(mesh, torch.int32))
        state = TrainState(params=params, opt=opt)
        batch = _batch_structs(cfg, specs["batch"], mesh, B)
        step = make_train_step(cfg, opt_mod.AdamWConfig())
        metrics = {k: _scalar(mesh, torch.float32)
                   for k in ("loss", "ce", "aux", "grad_norm", "lr")}
        return step, (state, batch), mf, dict(outputs=(state, metrics),
                                              donate_argnums=(0,))

    if shape.kind == "prefill":
        params = _param_structs(cfg, mesh, serve=True)
        batch = _batch_structs(cfg, specs["batch"], mesh, B)
        cache = _cache_structs(M.init_cache(cfg, B, S, device="meta"),
                               mesh, B, cfg)

        def fn(p, b):
            return M.prefill(cfg, p, b, cache_len=S)

        return fn, (params, batch), mf, dict(outputs=(logits, cache),
                                             donate_argnums=())

    # decode
    params = _param_structs(cfg, mesh, serve=True)
    cache = _cache_structs(specs["cache"], mesh, B, cfg)
    tokens = _struct(mesh, (B, 1), torch.int32, (ba, None))
    pos = _scalar(mesh, torch.int32)

    def fn(p, c, t, q):
        # the port's decode_step takes the position as a host int (the
        # reference traces an int32 scalar); the costs do not depend on it
        return M.decode_step(cfg, p, c, t, S - 1)

    return fn, (params, cache, tokens, pos), mf, dict(
        outputs=(logits, cache), donate_argnums=(1,))


def _named_leaves(tree, path=""):
    """(path, leaf) pairs in ``tree_flatten``'s order: dict keys sorted,
    NamedTuple fields by name, sequence items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from _named_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _block_bytes(s: Struct, mesh, memo: dict) -> np.ndarray:
    """Bytes of ``s``'s block at every mesh position."""
    key = (s.shape, s.dtype, s.sharding.spec)
    if key not in memo:
        item = torch.empty((), dtype=s.dtype).element_size()
        memo[key] = np.array([
            item * int(np.prod([sl.stop - sl.start for sl in
                                sh.shard_index(s.shape, s.sharding, i)]))
            for i in range(mesh.size)], dtype=np.int64)
    return memo[key]


def _per_device(tree, mesh, memo) -> np.ndarray:
    out = np.zeros(mesh.size, dtype=np.int64)
    for _, s in _named_leaves(tree):
        out += _block_bytes(s, mesh, memo)
    return out


def cell_layout(mesh, args, kw) -> dict:
    """Each device's argument, output and donated bytes (the fullest
    position's), and the dims that fell back to replication."""
    memo: dict = {}
    arg = _per_device(args, mesh, memo)
    out = _per_device(kw["outputs"], mesh, memo)
    alias = _per_device([args[i] for i in kw["donate_argnums"]], mesh, memo)
    replicated = []
    for path, s in _named_leaves(args):
        for d, (want, got) in enumerate(zip(s.wanted, s.sharding.spec)):
            if want is not None and got is None:
                replicated.append(f"args{path} dim {d} ({s.shape[d]}) "
                                  f"over {want}")
    return {"memory": {"argument_bytes": int(arg.max()),
                       "output_bytes": int(out.max()),
                       "alias_bytes": int(alias.max()),
                       "temp_bytes": None, "temp_note": TEMP_NOTE},
            "replicated_dims": replicated}


def trace_cell(fn, args, memo: bool = True) -> dict:
    """The step run once on ``meta`` under ``OpCosts`` (``memo=False``
    runs every op's meta kernel; the counts are the same)."""
    metas = tuple(_map(Struct.meta, a) for a in args)
    with op_costs.OpCosts(memo=memo) as c:
        fn(*metas)
    return c.as_dict()


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, traces: dict | None = None) -> dict:
    """One cell's record, written to ``out_dir`` (read back unless
    ``force``). ``traces`` keeps each (arch, shape)'s costs across the
    meshes."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = ALL[arch]
    shape = SHAPES[shape_name]
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count()}
    skip = shape_applicable(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        _write(path, rec)
        return rec
    try:
        mesh = production_mesh(mesh_kind)
        fn, args, mf, kw = build_cell(arch, shape_name, mesh)
        layout = cell_layout(mesh, args, kw)
        traces = {} if traces is None else traces
        costs = traces.get((arch, shape_name))
        if costs is None:
            costs = traces[(arch, shape_name)] = trace_cell(fn, args)
        rec.update(status="ok", trace=costs, trace_device="meta",
                   replicated_dims=layout["replicated_dims"],
                   collective_note=COLLECTIVE_NOTE,
                   **analysis.analyze(costs, n_devices=mesh.size,
                                      model_flops=mf,
                                      memory=layout["memory"],
                                      collectives={}))
    except Exception as e:   # noqa: BLE001  (recorded: the cell's result)
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(path, rec)
    return rec


def _write(path, rec):
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f, indent=1, default=str)
    os.replace(path + ".tmp", path)


def iter_cells(archs, shapes, mesh_kinds):
    for a in archs:
        for s in shapes:
            for mk in mesh_kinds:
                yield a, s, mk


# ---- the paper's own workload: distributed DBSCAN on the production mesh --

PAPER_SHAPES = {"cluster_64m": 1 << 26, "cluster_1b": 1 << 30}
PAPER_EPS = 1e-3
PAPER_MIN_PTS = 100
PAPER_RANKS = 4
PAPER_DIST = dict(send_factor=2.0, halo_factor=0.05, query_chunk=4096)


def paper_points(total: int, n: int) -> np.ndarray:
    """``data.synth.iono3d(total, seed=0)``, shifted to the origin and
    scaled uniformly so that its density is that of ``n`` points in the
    unit cube."""
    pts = synth.iono3d(total, seed=0).astype(np.float64)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    scale = (total / (n * float(np.prod(hi - lo)))) ** (1.0 / 3.0)
    return ((pts - lo) * scale).astype(np.float32)


def clustering_eps(n: int, neighbours: float = PAPER_MIN_PTS) -> float:
    """The ε at which a point of the uniform density of ``n`` points in
    the unit cube has ``neighbours`` expected neighbours, n·(4/3)π·ε³ =
    ``neighbours``. At the paper's ε = 1e-3 a point has 0.28 (2^26) or
    4.5 (2^30) of them, so every point is noise; at this ε with minPts
    neighbours, points are core and form clusters."""
    return float((3.0 * neighbours / (4.0 * np.pi * n)) ** (1.0 / 3.0))


def run_paper_cell(shape_name: str, mesh_kind: str, out_dir: str,
                   force: bool = False, device=None,
                   eps: float | None = None) -> dict:
    """The paper's distributed DBSCAN at one production device's share.

    The reference compiles ``make_distributed_dbscan`` for n points on the
    production mesh without data. The port cannot compile without data,
    so it runs ``dbscan_distributed`` with the reference's configuration
    on a ``ThreadGroup`` of ``PAPER_RANKS`` ranks on ``device`` (``None``
    means ``cuda``; it raises without a card), each rank holding
    n / mesh.size points, and holds its answer to single-rank ``dbscan``
    of the same points (core equal, and ``core.labels.equivalent``: the
    same noise and core partition). ``eps`` (default ``PAPER_EPS``) may be
    another radius, as ``clustering_eps`` gives. A run that the driver's
    f32 global ids cannot carry (``MAX_POINTS``) is skipped."""
    eps = PAPER_EPS if eps is None else eps
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rt-dbscan__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    n = PAPER_SHAPES[shape_name]
    mesh = production_mesh(mesh_kind)
    per_rank = n // mesh.size
    total = PAPER_RANKS * per_rank
    rec: dict[str, Any] = {
        "arch": "rt-dbscan", "shape": shape_name, "mesh": mesh_kind,
        "kind": "cluster", "n_points": n, "n_devices": mesh.size,
        "ranks": PAPER_RANKS, "points_per_rank": per_rank,
        "points_run": total, "eps": eps, "min_pts": PAPER_MIN_PTS,
        "dist_config": PAPER_DIST}
    if total >= dd.MAX_POINTS:
        rec.update(status="skipped", reason=(
            f"{PAPER_RANKS} ranks × {per_rank:,} points = {total:,} ≥ "
            f"MAX_POINTS = {dd.MAX_POINTS:,} (distributed/dbscan_dist.py: "
            "global ids ride the all_to_all as f32, exact only below "
            "2^24)"))
        _write(path, rec)
        return rec
    try:
        dev = resolve_device(device)
        rec["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else str(dev))
        pts = paper_points(total, n)
        cfg = dd.DistConfig(**PAPER_DIST)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = dd.dbscan_distributed(pts, eps, PAPER_MIN_PTS,
                                    ThreadGroup(PAPER_RANKS, dev), cfg=cfg)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        single = dbscan(pts, eps, PAPER_MIN_PTS, device=dev)
        core = single.core.cpu().numpy()
        if not (np.array_equal(res.core.cpu().numpy(), core)
                and equivalent(res.labels.cpu().numpy(),
                               single.labels.cpu().numpy(), core)):
            raise RuntimeError("distributed != single-rank dbscan: core, "
                               "noise or core partition differs")
        tm = res.timings
        sent = {k: v / PAPER_RANKS for k, v in tm["sent"].items()}
        colls = analysis.comm_collectives(sent, PAPER_RANKS)
        traffic = sum(s["traffic_bytes"] for s in colls.values())
        labels = res.labels.cpu().numpy()
        rec.update(
            status="ok", wall_s=wall, regrows=tm["regrows"],
            attempts_s=tm["attempts_s"],
            steps_s={k: v for k, v in tm.items() if isinstance(v, float)},
            local_rounds=tm["local_rounds"], label_rounds=res.n_rounds,
            sent_per_rank=sent, collectives=colls,
            collective_traffic_per_dev=traffic,
            collective_s=traffic / analysis.LINK_BW,
            collective_note=(f"ring model over g = {PAPER_RANKS} ranks "
                             "(analysis.ring_traffic), from the bytes a "
                             "rank put into each collective"),
            peak_memory_bytes=peak,
            clusters=int(len(np.unique(labels[labels >= 0]))),
            noise=int((labels == -1).sum()),
            core=int(res.core.sum()), matches_single=True)
    except Exception as e:   # noqa: BLE001  (recorded: the cell's result)
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(path, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="all")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--paper", action="store_true",
                    help="also run the paper's distributed DBSCAN cells")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the paper cells")
    args = ap.parse_args(argv)

    archs = sorted(ALL) if args.archs == "all" else args.archs.split(",")
    shapes = list(SHAPES) if args.shapes == "all" else args.shapes.split(",")
    mesh_kinds = {"single": ["single"], "multi": ["multi"],
                  "both": ["single", "multi"]}[args.mesh]
    cells = list(iter_cells(archs, shapes, mesh_kinds))
    if args.list:
        for c in cells:
            print(*c)
        return
    n_ok = n_err = n_skip = 0
    traces: dict = {}
    t_start = time.time()
    for i, (a, s, mk) in enumerate(cells):
        t0 = time.time()
        rec = run_cell(a, s, mk, args.out, force=args.force, traces=traces)
        dt = time.time() - t0
        st = rec["status"]
        n_ok += st == "ok"
        n_err += st == "error"
        n_skip += st == "skipped"
        msg = rec.get("error", "") if st == "error" else \
            (rec.get("bottleneck", "") if st == "ok" else "skip")
        print(f"[{i+1}/{len(cells)}] {a} × {s} × {mk}: {st} ({dt:.1f}s) {msg}",
              flush=True)
    if args.paper:
        for s in PAPER_SHAPES:
            for mk in mesh_kinds:
                t0 = time.time()
                rec = run_paper_cell(s, mk, args.out, force=args.force,
                                     device=args.device)
                st = rec["status"]
                n_ok += st == "ok"
                n_err += st == "error"
                n_skip += st == "skipped"
                print(f"rt-dbscan × {s} × {mk}: {st} "
                      f"({time.time() - t0:.1f}s) "
                      f"{rec.get('error', rec.get('reason', ''))}",
                      flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err} "
          f"({time.time() - t_start:.1f}s)")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
