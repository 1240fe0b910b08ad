#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on the card and exits non-zero on any failure.
Paths: batch DBSCAN on the grid engine with the ``device`` round driver
(the main path) and with the ``frontier`` driver, on the ``grid-hash``
engine and on the ``brute`` engine; and single-session serving
(``serve``: ``build_snapshot``, ``assign``, ``ServeSession.ingest`` with
compaction, snapshot save and load). Phases:

  1. environment: the card's name and power limit (nvidia-smi);
  2. build: every kernel source in src/repro_torch/csrc, one nvcc each,
     started together;
  3. kernel parity, each kernel against its plain PyTorch version on the
     card, integer outputs bit-identical: the reference's ragged shape
     sweeps, pairs at exactly d² = ε² (and the float below), tiles with
     nblk = 0, frontier slots with n_active = 0, 1 and T under the park
     contract, windows with invalid and duplicate-masked cells, and 64
     seeded tiles (chunks) of the full-size roadnet2d layouts (for
     cross_sweep, of the layout of an assign of 32,768 fresh points; its
     float output mind2 bit-identical too);
  4. whole path at n = 20,000 (roadnet2d, iono3d), every path:
     device="cpu" with the plain versions against the card with the
     kernels, bit-identical labels, core, counts, n_rounds and frontier
     histogram; ``find_neighbors`` of every engine at n = 4,000, cpu
     against cuda; serving at n = 20,000 roadnet2d (build_snapshot, assign
     of 4,096 fresh points, 4 ingests of 1,024, a forced compaction), cpu
     against cuda: labels, counts and dist bit-identical;
  5. whole path at full size (roadnet2d 435,000 at ε = 0.02, minPts = 8;
     iono3d 1,000,000 at ε = 2.0, minPts = 16), every path: kernel launch
     counts set to 0 before and read after each run, labels, core and
     counts identical across the four paths and n_rounds equal between the
     device and frontier drivers, DBSCAN invariants, counts at 4,096
     seeded points against a brute-force count over the whole corpus,
     phase times, the frontier histogram and pair tests per sweep; the
     serve path on both corpora: build_snapshot, assign of 32,768 fresh
     points (4,096 of them against a brute-force predict over the whole
     corpus), 2,048-point ingests until the session compacts (labels
     identical to dbscan on the concatenation), save and load, assign
     again (identical);
  6. kernel times at the full-size shapes of each kernel's path (median of
     5 launches, CUDA events), beside the plain version's time and the
     least time the card could take (bound).

Before the last line it prints one ``{"kernels": [...]}`` JSON line; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
run from a directory without the repo's ``src/repro_torch``, it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): FP32 outside
# the tensor cores and HBM3 bandwidth.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Operations per (query, candidate) pair: 3 FSUB + 3 FMUL + 3 FADD + compare.
OPS_PER_PAIR = 10
INT_MAX = np.iinfo(np.int32).max

FULL = [("roadnet2d", 435_000, 0.02, 8), ("iono3d", 1_000_000, 2.0, 16)]
REDUCED_N = 20_000
NEIGHBORS_N = 4_000
SHAPES = [(1, 8, 1, 1), (4, 64, 8, 3), (3, 256, 6, 6), (7, 32, 16, 2)]
PAIR_SHAPES = [(1, 1), (7, 513), (256, 512), (100, 1000), (513, 257)]
WINDOW_SHAPES = [(1, 1), (128, 512), (130, 100), (3, 700)]
EQ_BELOW = (9 / 64, float(np.nextafter(np.float32(9 / 64), np.float32(0))))
SUBSET = 64      # tiles (chunks) of the full-size layouts for plain versions

# dbscan options of each path, and the kernels the path must launch
PATHS = {
    "grid/device": (dict(engine="grid", hook_loop="device"),
                    ("csr_sweep_counts", "csr_sweep")),
    "grid/frontier": (dict(engine="grid", hook_loop="frontier"),
                      ("csr_sweep_counts", "frontier_sweep")),
    "grid-hash": (dict(engine="grid-hash"), ("gathered_sweep",)),
    "brute": (dict(engine="brute"), ("pairwise_sweep",)),
}
# serving: build_snapshot (csr_sweep_counts, frontier_sweep), assign
# (cross_sweep), ingest (cross_sweep, pairwise_sweep), compaction (a
# build_snapshot)
SERVE_KERNELS = ("csr_sweep_counts", "frontier_sweep", "cross_sweep",
                 "pairwise_sweep")
ASSIGN_Q = 32_768     # fresh points per assign at full size (largest bucket)
INGEST_CHUNK = 2_048  # points per ingest at full size
DELTA_CAP = 16_384    # the session's delta_capacity at full size
REDUCED_SERVE = (4_096, 4, 1_024)  # assign points, ingests, points each
PREDICT_CHECK = 4_096  # assigned points held against brute-force predict
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "csr_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                  "src/repro/kernels/csr_sweep.py:146"),
    "csr_sweep_counts": ("src/repro_torch/csrc/csr_sweep.cu",
                         "src/repro/kernels/csr_sweep.py:102"),
    "frontier_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                       "src/repro/kernels/frontier_sweep.py:65"),
    "pairwise_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                       "src/repro/kernels/pairwise_sweep.py:68"),
    "gathered_sweep": ("src/repro_torch/csrc/gathered_sweep.cu",
                       "src/repro/kernels/gathered_sweep.py:55"),
    "cross_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                    "src/repro/kernels/cross_sweep.py:94"),
}


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


class Env:
    """Imports of the port, made after the CUDA and checkout checks."""

    def __init__(self):
        import torch

        import repro_torch
        from repro_torch import serve
        from repro_torch.core import neighbors
        from repro_torch.kernels import (build, cross_sweep, csr_sweep,
                                         frontier_sweep, gathered_sweep, ops,
                                         pairwise_sweep, ref)
        from repro_torch.serve import snapshot
        self.torch, self.repro_torch = torch, repro_torch
        self.build, self.ops, self.ref = build, ops, ref
        self.csr, self.frontier = csr_sweep, frontier_sweep
        self.pairwise, self.gathered = pairwise_sweep, gathered_sweep
        self.cross, self.serve, self.snapshot = cross_sweep, serve, snapshot
        self.nb = neighbors
        self.modules = (csr_sweep, frontier_sweep, pairwise_sweep,
                        gathered_sweep, cross_sweep)
        self.dev = torch.device("cuda")

    def reset_launches(self) -> None:
        for m in self.modules:
            m.reset_launches()

    def launches(self) -> dict:
        return {k: v for m in self.modules for k, v in m.LAUNCHES.items()}

    def tensor(self, x):
        return x if isinstance(x, self.torch.Tensor) \
            else self.torch.as_tensor(x, device=self.dev)


def same(E, kernel: str, k, p) -> None:
    """Kernel output ``k`` must equal plain output ``p`` bit for bit."""
    E.torch.cuda.synchronize()
    check(k.shape == p.shape and E.torch.equal(k, p),
          f"{kernel}: kernel != plain version ("
          f"{int((k != p).sum()) if k.shape == p.shape else 'shape'} of "
          f"{k.numel()} rows differ)")


# --------------------------------------------------------------------------
# phase 3: kernel parity


def _mk_slab(T, block_q, nc_blocks, slab_blocks, bk, seed=4):
    """The reference's ragged shape sweep (tests/test_kernels.py)."""
    nc = nc_blocks * bk
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (T * block_q, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (nc, 3)).astype(np.float32)
    croot = rng.integers(0, 9999, nc).astype(np.int32)
    croot[rng.uniform(size=nc) < 0.5] = INT_MAX
    starts_blk = rng.integers(0, nc_blocks - slab_blocks + 1, T) \
        .astype(np.int32)
    nblk = rng.integers(0, slab_blocks + 1, T).astype(np.int32)
    return q, np.ascontiguousarray(c.T), croot, starts_blk, nblk


def _lattice(T, block_q, nc_blocks, bk, seed):
    """Points on the 1/8 lattice, candidates at d² ∈ {8, 9, 10}/64 of
    queries: every d² is exact in f32, many sit at exactly 9/64."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-16, 17, (T * block_q, 3)).astype(np.float32) / 8
    offs = np.array([(2, 2, 0), (2, 0, 2), (0, 2, 2), (3, 0, 0), (0, 0, 3),
                     (2, 2, 1), (1, 2, 2), (3, 1, 0), (0, 1, 3)], np.float32)
    offs = offs * rng.choice([-1, 1], (len(offs), 3))
    nc = nc_blocks * bk
    c = q[rng.integers(0, len(q), nc)] + offs[rng.integers(0, len(offs), nc)] / 8
    croot = rng.integers(0, 9999, nc).astype(np.int32)
    croot[rng.uniform(size=nc) < 0.3] = INT_MAX
    return (q, np.ascontiguousarray(c.T.astype(np.float32)), croot,
            np.zeros(T, np.int32), np.full(T, nc_blocks, np.int32))


def _park(live, T):
    """The reference's park contract: live tile ids first, then the last
    live id (0 when none) repeated."""
    live = [int(x) for x in live]
    return np.array(live + [live[-1] if live else 0] * (T - len(live)),
                    np.int32)


def compare_csr(E, arrays, eps2, *, max_blocks, block_q, block_k):
    """csr_sweep and csr_sweep_counts against their plain versions on the
    same tensors; returns the kernel's counts and minroot."""
    q, cp, croot, st, nb = (E.tensor(x) for x in arrays)
    kw = dict(max_blocks=max_blocks, block_k=block_k)
    k_counts, k_min = E.csr.csr_sweep(q, cp, croot, st, nb, eps2,
                                      block_q=block_q, **kw)
    k_cnt_only = E.csr.csr_sweep_counts(q, cp, st, nb, eps2, block_q=block_q,
                                        **kw)
    p_counts, p_min = E.csr.csr_sweep_plain(q, cp, croot, st, nb, eps2, **kw)
    p_cnt_only = E.csr.csr_sweep_counts_plain(q, cp, st, nb, eps2, **kw)
    same(E, "csr_sweep counts", k_counts, p_counts)
    same(E, "csr_sweep minroot", k_min, p_min)
    same(E, "csr_sweep_counts", k_cnt_only, p_cnt_only)
    return k_counts, k_min


def compare_frontier(E, arrays, active, n_active, eps2, *, max_blocks,
                     block_q, block_k):
    q, cp, croot, st, nb = (E.tensor(x) for x in arrays)
    act = E.tensor(np.asarray(active, np.int32))
    na = E.tensor(np.array([n_active], np.int32))
    kw = dict(max_blocks=max_blocks, block_k=block_k)
    k = E.frontier.frontier_sweep(q, cp, croot, st, nb, act, na, eps2,
                                  block_q=block_q, **kw)
    p = E.frontier.frontier_sweep_plain(q, cp, croot, st, nb, act, na, eps2,
                                        **kw)
    same(E, "frontier_sweep", k, p)
    return k


def compare_pairwise(E, q, cp, croot, eps2):
    q, cp, croot = (E.tensor(x) for x in (q, cp, croot))
    k = E.pairwise.pairwise_sweep(q, cp, croot, eps2)
    p = E.pairwise.pairwise_sweep_plain(q, cp, croot, eps2)
    same(E, "pairwise_sweep counts", k[0], p[0])
    same(E, "pairwise_sweep minroot", k[1], p[1])
    return k


def compare_gathered(E, q, cp, croot, eps2):
    q, cp, croot = (E.tensor(x) for x in (q, cp, croot))
    k = E.gathered.gathered_sweep(q, cp, croot, eps2)
    p = E.gathered.gathered_sweep_plain(q, cp, croot, eps2)
    same(E, "gathered_sweep counts", k[0], p[0])
    same(E, "gathered_sweep minroot", k[1], p[1])
    return k


def compare_cross(E, arrays, eps2, *, max_blocks, block_q, block_k):
    """cross_sweep against its plain version on the same tensors, all three
    outputs (mind2, a float, included) bit for bit; returns the kernel's."""
    q, cp, croot, st, nb = (E.tensor(x) for x in arrays)
    kw = dict(max_blocks=max_blocks, block_k=block_k)
    k = E.cross.cross_sweep(q, cp, croot, st, nb, eps2, block_q=block_q,
                            **kw)
    p = E.cross.cross_sweep_plain(q, cp, croot, st, nb, eps2, **kw)
    for what, a, b in zip(("counts", "minroot", "mind2"), k, p):
        same(E, f"cross_sweep {what}", a, b)
    return k


def _windows(E, seed, b, k, *, lattice=False):
    """Seeded windows (the reference's test inputs) as kernel inputs on the
    card, with the numpy arrays they came from."""
    rng = np.random.default_rng(seed)
    if lattice:
        q = rng.integers(-8, 9, (b, 3)).astype(np.float32) / 8
        c = (q[:, None, :] + rng.integers(-3, 4, (b, k, 3)) / 8) \
            .astype(np.float32)
    else:
        q = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
        c = rng.uniform(-1, 1, (b, k, 3)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) < 0.8
    core = rng.uniform(size=(b, k)) < 0.5
    root = rng.integers(0, 9999, (b, k)).astype(np.int32)
    arrays = (q, c, valid, core, root)
    return E.ops.gathered_sweep_args(*(E.tensor(x) for x in arrays)), arrays


def parity_csr(E, road):
    t = E.torch
    bk = 128
    for T, bq, ncb, sb in SHAPES:
        compare_csr(E, _mk_slab(T, bq, ncb, sb, bk), 0.4, max_blocks=sb,
                    block_q=bq, block_k=bk)
    for T, bq, ncb in ((2, 32, 2), (3, 256, 4)):
        arrays = _lattice(T, bq, ncb, bk, seed=T)
        d2 = ((arrays[0][:, None, :] - arrays[1].T[None]) ** 2).sum(-1)
        check((d2 == np.float32(9 / 64)).any(), "no pair at d² = ε²")
        for eps2 in EQ_BELOW:
            counts, _ = compare_csr(E, arrays, eps2, max_blocks=ncb,
                                    block_q=bq, block_k=bk)
            check(int(counts.sum()) == int((d2 <= np.float32(eps2)).sum()),
                  "boundary counts differ from a numpy count")
    T, bq = 5, 32
    q, cp, croot, st, _ = _mk_slab(T, bq, 4, 2, bk, seed=9)
    nblk = np.array([0, 2, 0, 1, 0], np.int32)
    counts, k_min = compare_csr(E, (q, cp, croot, st, nblk), 0.4,
                                max_blocks=2, block_q=bq, block_k=bk)
    rows = t.as_tensor(np.repeat(nblk == 0, bq), device=E.dev)
    check(bool((counts[rows] == 0).all()) and
          bool((k_min[rows] == INT_MAX).all()),
          "nblk = 0 tiles must give count 0 and minroot INT32_MAX")
    compare_csr(E, road["csr_args"], road["eps2"], **road["csr_kw"])
    log(f"  csr_sweep, csr_sweep_counts: shape sweep, d² = ε² and the "
        f"float below, nblk = 0, roadnet2d {SUBSET} tiles (max nblk "
        f"{road['max_nblk']}): bit-identical")


def parity_frontier(E, road):
    bk = 128
    for T, bq, ncb, sb in SHAPES:
        arrays = _mk_slab(T, bq, ncb, sb, bk)
        rng = np.random.default_rng(T)
        for n_active in sorted({0, 1, T // 2, T}):
            live = np.sort(rng.choice(T, n_active, replace=False))
            out = compare_frontier(E, arrays, _park(live, T), n_active, 0.4,
                                   max_blocks=sb, block_q=bq, block_k=bk)
            check(bool((out[n_active * bq:] == INT_MAX).all()),
                  "parked frontier slots must hold INT32_MAX")
    T, bq, ncb = 4, 32, 3
    q, cp, croot, st, _ = _lattice(T, bq, ncb, bk, seed=8)
    nblk = np.array([ncb, 0, ncb, 1], np.int32)
    for eps2 in EQ_BELOW:
        out = compare_frontier(E, (q, cp, croot, st, nblk), [3, 1, 0, 0], 3,
                               eps2, max_blocks=ncb, block_q=bq, block_k=bk)
        check(bool((out[bq:2 * bq] == INT_MAX).all()),
              "a live slot of an nblk = 0 tile must hold INT32_MAX")
    compare_frontier(E, *road["frontier_args"], road["eps2"],
                     **road["csr_kw"])
    log(f"  frontier_sweep: shape sweep with n_active = 0, 1, T/2, T (park "
        f"contract), d² = ε² and the float below with an nblk = 0 tile, "
        f"roadnet2d {SUBSET} active tiles: bit-identical")


def parity_pairwise(E, road):
    for nq, nc in PAIR_SHAPES:
        rng = np.random.default_rng(0)
        q = rng.uniform(-1, 1, (nq, 3)).astype(np.float32)
        c = rng.uniform(-1, 1, (nc, 3)).astype(np.float32)
        core = rng.uniform(size=nc) < 0.5
        root = rng.integers(0, max(nc, 1), nc).astype(np.int32)
        compare_pairwise(E, *E.ops.pairwise_sweep_args(
            *(E.tensor(x) for x in (q, c, core, root))), 0.3)
    q, cp, croot, _, _ = _lattice(2, 64, 2, 128, seed=5)
    d2 = ((q[:, None, :] - cp.T[None]) ** 2).sum(-1)
    check((d2 == np.float32(9 / 64)).any(), "no pair at d² = ε²")
    args = E.ops.pairwise_sweep_args(*(E.tensor(x) for x in (
        q, np.ascontiguousarray(cp.T), croot != INT_MAX, croot)))
    for eps2 in EQ_BELOW:
        counts, _ = compare_pairwise(E, *args, eps2)
        check(int(counts[:len(q)].sum()) ==
              int((d2 <= np.float32(eps2)).sum()),
              "boundary counts differ from a numpy count")
    compare_pairwise(E, *road["pairwise_args"], road["eps2"])
    log(f"  pairwise_sweep: shape sweep, d² = ε² and the float below, "
        f"roadnet2d {SUBSET} query tiles x all candidates: bit-identical")


def parity_gathered(E, road):
    for b, k in WINDOW_SHAPES:
        compare_gathered(E, *_windows(E, 1, b, k)[0], 0.2)
    args, (q, c, valid, _, _) = _windows(E, 2, 130, 300, lattice=True)
    d2 = ((q[:, None, :] - c) ** 2).sum(-1)
    check(((d2 == np.float32(9 / 64)) & valid).any(), "no pair at d² = ε²")
    for eps2 in EQ_BELOW:
        counts, _ = compare_gathered(E, *args, eps2)
        check(int(counts[:len(q)].sum()) ==
              int(((d2 <= np.float32(eps2)) & valid).sum()),
              "boundary counts differ from a numpy count")
    # the second half of each window repeats the first (an aliased bucket)
    # and is masked invalid: each candidate counts once
    _, (q, c, valid, core, root) = _windows(E, 3, 64, 256)
    c[:, 128:], core[:, 128:], root[:, 128:] = \
        c[:, :128], core[:, :128], root[:, :128]
    valid[:, 128:] = False
    full = compare_gathered(E, *E.ops.gathered_sweep_args(
        *(E.tensor(x) for x in (q, c, valid, core, root))), 0.5)
    half = compare_gathered(E, *E.ops.gathered_sweep_args(
        E.tensor(q), *(E.tensor(np.ascontiguousarray(x[:, :128]))
                       for x in (c, valid, core, root))), 0.5)
    check(E.torch.equal(full[0], half[0]) and E.torch.equal(full[1], half[1]),
          "duplicate-masked cells changed the gathered sweep")
    for args in road["gathered_args"]:
        compare_gathered(E, *args, road["eps2"])
    log(f"  gathered_sweep: shape sweep, d² = ε² and the float below, "
        f"invalid and duplicate-masked cells, roadnet2d {SUBSET} chunks of "
        f"{road['chunk']} queries x {road['window']} window: bit-identical")


def parity_cross(E, road):
    bk = 128
    for T, bq, ncb, sb in SHAPES:
        q, cp, croot, st, nb = _mk_slab(T, bq, ncb, sb, bk, seed=11)
        compare_cross(E, (q, cp, croot[None, :], st, nb), 0.4, max_blocks=sb,
                      block_q=bq, block_k=bk)
    for T, bq, ncb in ((2, 32, 2), (3, 256, 4)):
        q, cp, croot, st, nb = _lattice(T, bq, ncb, bk, seed=T)
        d2 = ((q[:, None, :] - cp.T[None]) ** 2).sum(-1)
        check((d2 == np.float32(9 / 64)).any(), "no pair at d² = ε²")
        for eps2 in EQ_BELOW:
            counts, _, mind2 = compare_cross(
                E, (q, cp, croot[None, :], st, nb), eps2, max_blocks=ncb,
                block_q=bq, block_k=bk)
            hit = d2 <= np.float32(eps2)
            exp = np.where(hit & (croot != INT_MAX)[None], d2, np.inf) \
                .min(1).astype(np.float32)
            check(int(counts.sum()) == int(hit.sum()) and
                  np.array_equal(mind2.cpu().numpy(), exp),
                  "boundary counts or mind2 differ from numpy")
    T, bq = 5, 32
    q, cp, croot, st, _ = _mk_slab(T, bq, 4, 2, bk, seed=9)
    nblk = np.array([0, 2, 0, 1, 0], np.int32)
    counts, k_min, k_d2 = compare_cross(E, (q, cp, croot[None, :], st, nblk),
                                        0.4, max_blocks=2, block_q=bq,
                                        block_k=bk)
    rows = E.torch.as_tensor(np.repeat(nblk == 0, bq), device=E.dev)
    check(bool((counts[rows] == 0).all()) and
          bool((k_min[rows] == INT_MAX).all()) and
          bool(E.torch.isposinf(k_d2[rows]).all()),
          "nblk = 0 tiles must give 0, INT32_MAX and +inf")
    args, kw, max_nblk = road["cross"]
    compare_cross(E, args, road["eps2"], **kw)
    log(f"  cross_sweep: shape sweep, d² = ε² and the float below, nblk = 0, "
        f"roadnet2d assign of {ASSIGN_Q} fresh points, {SUBSET} of its "
        f"query tiles (max nblk {max_nblk}): counts, minroot and mind2 "
        "bit-identical")


class CallRecorder:
    """Keeps the arguments of every call of ``module.attr`` (references,
    no copies and no launches of its own) while active."""

    def __init__(self, module, attr: str):
        self.module, self.attr, self.calls = module, attr, []
        self.real = getattr(module, attr)

    def __enter__(self):
        def record(*args, **kw):
            self.calls.append((args, kw))
            return self.real(*args, **kw)
        setattr(self.module, self.attr, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


def fresh(E, name, n_corpus, m, seed):
    """``m`` fresh points of the world of the corpus ``synth.load(name,
    n_corpus, seed=0)``: the same road graph (or layer sheets), other
    samples."""
    return E.repro_torch.synth.load(name, m, seed=seed, structure_seed=0,
                                    structure_n=n_corpus)


def tile_subset(E, args, kw, seed):
    """``SUBSET`` seeded query tiles of a recorded slab-sweep call (the
    widest among them), as (q, cands, croot, starts_blk, nblk)."""
    q, cp, croot, st, nb = args[:5]
    bq = kw["block_q"]
    T = st.shape[0]
    nb_np = nb.cpu().numpy()
    widest = int(nb_np.argmax())
    others = np.delete(np.arange(T), widest)
    rng = np.random.default_rng(seed)
    tiles = np.sort(np.append(rng.choice(others, min(SUBSET - 1, len(others)),
                                         replace=False), widest))
    idx = E.torch.as_tensor(tiles, device=q.device)
    return (q.view(T, bq, 3)[idx].reshape(-1, 3).contiguous(), cp, croot,
            st[idx].contiguous(), nb[idx].contiguous()), int(nb_np.max())


def road_layouts(E):
    """Seeded subsets of the full-size roadnet2d layouts, as kernel inputs:
    64 grid tiles (the widest among them), 64 frontier slots, 64 query
    tiles against every candidate, 64 grid-hash chunks."""
    t = E.torch
    name, n, eps, _ = FULL[0]
    pts = E.repro_torch.synth.load(name, n, seed=0)
    eng = E.repro_torch.make_engine(pts, eps)
    g, spec = eng.state, eng.meta
    rng = np.random.default_rng(0)
    nblk_all = g.nblk.cpu().numpy()
    widest = int(nblk_all.argmax())
    others = np.delete(np.arange(spec.n_tiles), widest)
    tiles = np.sort(np.append(rng.choice(others, min(SUBSET - 1, len(others)),
                                         replace=False), widest))
    idx = t.as_tensor(tiles, device=E.dev)
    q = g.q_sorted.view(spec.n_tiles, spec.chunk, 3)[idx].reshape(-1, 3)
    croot = t.as_tensor(rng.integers(0, spec.n, spec.n_cand).astype(np.int32),
                        device=E.dev)
    croot[t.as_tensor(rng.uniform(size=spec.n_cand) < 0.5, device=E.dev)] = \
        INT_MAX
    st = (g.starts // spec.block_k).to(t.int32)
    road = dict(eps2=float(eps) ** 2, max_nblk=int(nblk_all.max()),
                csr_kw=dict(max_blocks=spec.slab // spec.block_k,
                            block_q=spec.chunk, block_k=spec.block_k))
    road["csr_args"] = (q.contiguous(), g.cands, croot, st[idx].contiguous(),
                        g.nblk[idx].contiguous())
    road["frontier_args"] = ((g.q_sorted, g.cands, croot, st, g.nblk),
                             _park(tiles, spec.n_tiles), len(tiles))
    road["pairwise_args"] = (q.contiguous(), g.cands, croot)
    hash_eng = E.repro_torch.make_engine(pts, eps, engine="grid-hash")
    core = t.as_tensor(rng.uniform(size=n) < 0.5, device=E.dev)
    root = t.as_tensor(rng.integers(0, n, n).astype(np.int32), device=E.dev)
    n_chunks = -(-n // 2048)
    pick = set(rng.choice(n_chunks, min(SUBSET, n_chunks),
                          replace=False).tolist())
    road["gathered_args"] = [
        E.ops.gathered_sweep_args(*a)
        for i, a in enumerate(E.nb.hash_window_chunks(hash_eng.state, core,
                                                      root, 2048))
        if i in pick]
    road["chunk"], road["window"] = road["gathered_args"][0][2].shape
    # the cross_sweep call of an assign of fresh points at full size
    snap = E.serve.build_snapshot(pts, eps, FULL[0][3])
    with CallRecorder(E.cross, "cross_sweep") as rec:
        E.serve.assign(snap, fresh(E, name, n, ASSIGN_Q, seed=1))
    args, kw = rec.calls[0]
    sub, max_nblk = tile_subset(E, args, kw, seed=0)
    road["cross"] = (sub, dict(max_blocks=kw["max_blocks"],
                               block_q=kw["block_q"],
                               block_k=kw["block_k"]), max_nblk)
    return road


def phase_parity(E):
    road = road_layouts(E)
    parity_csr(E, road)
    parity_frontier(E, road)
    parity_pairwise(E, road)
    parity_gathered(E, road)
    parity_cross(E, road)


# --------------------------------------------------------------------------
# phases 4 and 5: the whole path


def hist_txt(res) -> str:
    """The frontier histogram of a result, for the log ("" without one)."""
    if res.frontier_tiles is None:
        return ""
    return f", frontier tiles {res.frontier_tiles[:res.n_rounds].tolist()}"


def n_clusters(labels) -> int:
    return int(labels[labels >= 0].unique().numel())


def assert_same_result(E, a, b, what: str, rounds: bool = True) -> None:
    for f in ("labels", "core", "counts"):
        check(E.torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()),
              f"{what}: {f} differ")
    if rounds:
        check(a.n_rounds == b.n_rounds,
              f"{what}: n_rounds {a.n_rounds} != {b.n_rounds}")
        fa, fb = a.frontier_tiles, b.frontier_tiles
        check((fa is None) == (fb is None) and
              (fa is None or E.torch.equal(fa.cpu(), fb.cpu())),
              f"{what}: frontier_tiles differ")


def phase_reduced(E):
    phase_reduced_serve(E)
    for name, _, eps, min_pts in FULL:
        pts = E.repro_torch.synth.load(name, REDUCED_N, seed=0)
        first = None
        for path, (kw, _) in PATHS.items():
            t0 = time.perf_counter()
            cpu = E.repro_torch.dbscan(pts, eps, min_pts, device="cpu", **kw)
            t1 = time.perf_counter()
            gpu = E.repro_torch.dbscan(pts, eps, min_pts, **kw)
            E.torch.cuda.synchronize()
            t2 = time.perf_counter()
            assert_same_result(E, cpu, gpu, f"{name} n={REDUCED_N} {path} "
                               "cpu vs cuda")
            if first is None:
                first = gpu
            assert_same_result(E, first, gpu, f"{name} n={REDUCED_N} {path} "
                               "vs grid/device", rounds=False)
            log(f"  {name} n={REDUCED_N} {path}: bit-identical, n_rounds "
                f"{gpu.n_rounds}{hist_txt(gpu)}, clusters {n_clusters(gpu.labels)}, "
                f"noise {int((gpu.labels == -1).sum())}; cpu {t1 - t0:.2f} s,"
                f" cuda {t2 - t1:.2f} s")
        pts = pts[:NEIGHBORS_N]
        lists = {}
        for engine in ("grid", "grid-hash", "brute"):
            cpu = E.repro_torch.find_neighbors(pts, eps, 32, engine=engine,
                                               device="cpu")
            gpu = E.repro_torch.find_neighbors(pts, eps, 32, engine=engine)
            for a, b in zip(cpu, gpu):
                check(E.torch.equal(a, b.cpu()), f"{name} find_neighbors "
                      f"{engine}: cpu and cuda differ")
            lists[engine] = cpu
        for engine, (idx, cnt) in lists.items():
            check(E.torch.equal(idx, lists["grid"][0]) and
                  E.torch.equal(cnt, lists["grid"][1]),
                  f"{name} find_neighbors: {engine} != grid")
        log(f"  {name} n={NEIGHBORS_N} find_neighbors (k_max 32), grid / "
            f"grid-hash / brute: cpu = cuda, engines agree; mean count "
            f"{float(lists['grid'][1].float().mean()):.2f}")


def serve_run(E, pts, q, chunks, eps, min_pts, device=None):
    """The serve path at reduced size on one device: build_snapshot,
    assign, ingests, a forced compaction. Returns host arrays."""
    E.snapshot._SLAB_CACHE.clear()   # both devices start from the plan
    snap = E.serve.build_snapshot(pts, eps, min_pts, device=device)
    a = E.serve.assign(snap, q)
    sess = E.serve.ServeSession(snap, max_delta_frac=np.inf)
    online = [sess.ingest(c).labels for c in chunks]
    sess.compact(force=True)
    s = sess.snapshot
    return dict(labels=a.labels, counts=a.counts, dist=a.dist,
                online=np.concatenate(online), snap_labels=s.labels.cpu(),
                snap_core=s.core.cpu(), snap_counts=s.counts.cpu(),
                snap_croot=s.croot_sorted.cpu())


def phase_reduced_serve(E):
    name, _, eps, min_pts = FULL[0]
    n_q, n_chunks, m = REDUCED_SERVE
    pts = E.repro_torch.synth.load(name, REDUCED_N, seed=0)
    q = fresh(E, name, REDUCED_N, n_q, seed=1)
    new = fresh(E, name, REDUCED_N, n_chunks * m, seed=2)
    chunks = [new[i:i + m] for i in range(0, len(new), m)]
    t0 = time.perf_counter()
    cpu = serve_run(E, pts, q, chunks, eps, min_pts, device="cpu")
    t1 = time.perf_counter()
    gpu = serve_run(E, pts, q, chunks, eps, min_pts)
    E.torch.cuda.synchronize()
    t2 = time.perf_counter()
    for k, a in cpu.items():
        b = gpu[k]
        ok = E.torch.equal(a, b) if isinstance(a, E.torch.Tensor) \
            else a.dtype == b.dtype and np.array_equal(a, b)
        check(ok, f"{name} n={REDUCED_N} serve: {k} differ cpu vs cuda")
    log(f"  {name} n={REDUCED_N} serve: assign of {n_q} fresh points "
        f"(labels, counts, dist), {n_chunks} ingests of {m} (online "
        f"labels), forced compaction (labels, core, counts, payload): "
        f"bit-identical; {int((cpu['labels'] >= 0).sum())} assigned to a "
        f"cluster, {int(np.isfinite(cpu['dist']).sum())} finite dist; "
        f"cpu {t1 - t0:.2f} s, cuda {t2 - t1:.2f} s")


def brute_counts(E, pts, idx, eps2):
    """ε-neighbour counts of pts[idx] over the whole corpus, on the card,
    with the same unfused d² as the kernels."""
    t = E.torch
    q = pts[idx]
    eps2_t = t.tensor(float(np.float32(eps2)), device=E.dev)
    out = t.zeros(len(idx), dtype=t.int64, device=E.dev)
    for s in range(0, pts.shape[0], 65536):
        d2 = E.ref._dist2(q[:, None, :], pts[None, s:s + 65536, :])
        out += (d2 <= eps2_t).sum(1)
    return out


def brute_predict(E, pts, labels, core, q, eps2):
    """DBSCAN predict of queries ``q`` over the whole corpus on the card,
    with the kernels' unfused d²: min label over the core points within ε
    (-1 when none), ε-neighbour counts, distance to the nearest of those
    core points (+inf when none)."""
    t = E.torch
    eps2_t = t.tensor(float(np.float32(eps2)), device=E.dev)
    lab = t.full((len(q),), INT_MAX, dtype=t.int32, device=E.dev)
    cnt = t.zeros(len(q), dtype=t.int64, device=E.dev)
    md = t.full((len(q),), float("inf"), device=E.dev)
    for s in range(0, pts.shape[0], 32768):
        d2 = E.ref._dist2(q[:, None, :], pts[None, s:s + 32768, :])
        hit = d2 <= eps2_t
        ch = hit & core[None, s:s + 32768]
        cnt += hit.sum(1)
        lab = t.minimum(lab, t.where(ch, labels[None, s:s + 32768],
                                     INT_MAX).amin(1))
        md = t.minimum(md, t.where(ch, d2, float("inf")).amin(1))
    return (t.where(lab != INT_MAX, lab, -1).cpu().numpy(),
            cnt.to(t.int32).cpu().numpy(),
            np.sqrt(md.cpu().numpy(), dtype=np.float32))


def same_answer(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("labels", "counts", "dist"))


def serve_full(E, name, n, eps, min_pts, pts_np):
    """The serve path at full size: build_snapshot, assign of ASSIGN_Q
    fresh points, ingests of INGEST_CHUNK until the session compacts, an
    assign on the compacted snapshot, save and load, the same assign on
    the loaded one. Launch counts cover exactly this; the checks after it
    launch nothing that is counted."""
    t = E.torch
    q_np = fresh(E, name, n, ASSIGN_Q, seed=1)
    new = fresh(E, name, n, DELTA_CAP, seed=2)
    chunks = [new[i:i + INGEST_CHUNK] for i in range(0, DELTA_CAP,
                                                     INGEST_CHUNK)]
    E.snapshot._SLAB_CACHE.clear()
    sched = E.serve.BucketScheduler()
    steps, marks = {}, {}

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        t.cuda.synchronize()
        steps[label] = time.perf_counter() - t0
        return out

    t.cuda.synchronize()
    E.reset_launches()
    t_start = time.perf_counter()
    with CallRecorder(E.cross, "cross_sweep") as rec, \
            tempfile.TemporaryDirectory() as tmp:
        snap = step("build_snapshot", lambda: E.serve.build_snapshot(
            pts_np, eps, min_pts))
        slab_plan = snap.slab
        a = step("assign", lambda: E.serve.assign(snap, q_np,
                                                  scheduler=sched))
        slab_assign, regrows_assign = snap.slab, sched.regrows
        marks["assign"] = len(rec.calls)
        sess = E.serve.ServeSession(snap, delta_capacity=DELTA_CAP,
                                    scheduler=sched)
        ingest_s, n_in = [], 0
        for c in chunks:
            r = step("ingest", lambda: sess.ingest(c))
            ingest_s.append(steps["ingest"])
            n_in += len(c)
            if r.compacted:
                break
        check(r.compacted, f"{name} serve: no compaction after {n_in} "
              f"points (delta_capacity {DELTA_CAP})")
        marks["ingest"] = len(rec.calls)
        m = step("assign_compacted", lambda: E.serve.assign(
            sess.snapshot, q_np, scheduler=sched))
        step("save", lambda: E.serve.save_snapshot(sess.snapshot, tmp,
                                                   step=1))
        loaded = step("load", lambda: E.serve.load_snapshot(tmp))
        m2 = step("assign_loaded", lambda: E.serve.assign(
            loaded, q_np, scheduler=sched))
    wall = time.perf_counter() - t_start
    launches = E.launches()
    check(all(launches[k] > 0 for k in SERVE_KERNELS) and
          all(v == 0 for k, v in launches.items() if k not in SERVE_KERNELS),
          f"{name} serve: launches {launches}, expected exactly "
          f"{SERVE_KERNELS}")
    # checks, outside the counted run
    pts = t.as_tensor(pts_np, device=E.dev)
    k = PREDICT_CHECK
    lab, cnt, dist = brute_predict(E, pts, snap.labels, snap.core,
                                   t.as_tensor(q_np[:k], device=E.dev),
                                   float(eps) ** 2)
    check(np.array_equal(a.labels[:k], lab) and
          np.array_equal(a.counts[:k], cnt) and
          np.array_equal(a.dist[:k], dist),
          f"{name} serve: assign differs from brute-force predict at "
          f"{int((a.labels[:k] != lab).sum())} labels, "
          f"{int((a.counts[:k] != cnt).sum())} counts, "
          f"{int((a.dist[:k] != dist).sum())} dist of {k}")
    concat = np.concatenate([pts_np, new[:n_in]])
    full = E.repro_torch.dbscan(concat, eps, min_pts)
    s = sess.snapshot
    for f in ("labels", "core", "counts"):
        check(t.equal(getattr(s, f), getattr(full, f)),
              f"{name} serve: compacted {f} != dbscan on the concatenation")
    check(same_answer(m, m2), f"{name} serve: assign after save/load "
          "differs")
    log(f"  {name} n={n} serve: launches {launches}")
    log(f"    steps s: build_snapshot {steps['build_snapshot']:.3f}, assign "
        f"{steps['assign']:.3f} (bucket {a.bucket}, slab {slab_plan} -> "
        f"{slab_assign}, regrows {regrows_assign}), ingests "
        f"{[round(x, 4) for x in ingest_s]} (chunks of {INGEST_CHUNK}; the "
        f"last compacts {n + n_in} points), assign on the compacted "
        f"snapshot {steps['assign_compacted']:.3f}, save {steps['save']:.3f}"
        f", load {steps['load']:.3f}, assign on the loaded one "
        f"{steps['assign_loaded']:.3f}; total {wall:.3f}")
    log(f"    assign: {int((a.labels >= 0).sum())} of {ASSIGN_Q} joined a "
        f"cluster; {k} held against brute-force predict (labels, counts, "
        f"dist): identical; compacted labels, core, counts = dbscan on the "
        f"concatenation; save/load: identical answers; slab regrows in all "
        f"{sched.regrows}, program keys {sched.recompiles}")
    return dict(launches=launches, rec=rec, marks=marks, steps=steps,
                ingest_s=ingest_s, wall=wall, eps2=float(eps) ** 2,
                bucket=a.bucket, slab=(slab_plan, slab_assign),
                regrows=sched.regrows)


class FrontierRecorder(CallRecorder):
    """Records every frontier_sweep call, to count the live pair tests of
    each round and to time the kernel on the main path's own inputs."""

    def __init__(self, E):
        super().__init__(E.frontier, "frontier_sweep")

    def live_pairs(self):
        """Per call: (live tiles, pair tests of the live tiles)."""
        out = []
        for args, kw in self.calls:
            nblk, active, n_active = args[4], args[5], args[6]
            na = int(n_active[0])
            blocks = int(nblk[active[:na].long()].sum())
            out.append((na, blocks * kw["block_k"] * kw["block_q"]))
        return out


def check_invariants(E, res, pts_np, eps, min_pts, name):
    t = E.torch
    labels, core, counts = res.labels, res.core, res.counts
    check(t.equal(core, counts >= min_pts), f"{name}: core != counts >= "
          "min_pts")
    lab_core = labels[core].long()
    check(bool(core[lab_core].all()) and
          bool((labels[lab_core] == lab_core).all()),
          f"{name}: a core label is not a core point labelled itself")
    border = labels[(~core) & (labels >= 0)].long()
    check(bool(core[border].all()),
          f"{name}: a border label is not a core label")
    pts = t.as_tensor(pts_np, device=E.dev)
    idx = t.as_tensor(np.random.default_rng(1).choice(
        len(pts_np), min(4096, len(pts_np)), replace=False), device=E.dev)
    bc = brute_counts(E, pts, idx, float(eps) ** 2)
    check(t.equal(bc, counts[idx].long()),
          f"{name}: counts differ from brute force at "
          f"{int((bc != counts[idx]).sum())} of {len(idx)} points")


def pair_tests(E, path, eng, rec=None):
    """Pair tests of one sweep of the path's kernel (for the frontier
    driver: of each call, live tiles only)."""
    spec = eng.meta
    if path in ("grid/device", "grid/frontier"):
        full = int(eng.state.nblk.sum()) * spec.block_k * spec.chunk
        if path == "grid/device":
            return full, f"{full:.3e}"
        per = rec.live_pairs()
        return full, (f"{full:.3e} full; frontier calls (live tiles, pair "
                      f"tests): {[(a, f'{b:.3e}') for a, b in per]}, total "
                      f"{sum(b for _, b in per):.3e}")
    n = eng.state.shape[0] if path == "brute" else eng.state.points.shape[0]
    if path == "brute":
        pairs = -(-n // 256) * 256 * (-(-n // 512) * 512)
        return pairs, f"{pairs:.3e} (padded {n} x {n})"
    width = spec.n_offsets * spec.capacity
    k_pad = -(-width // 512) * 512
    pairs = -(-n // 2048) * 2048 * k_pad
    return pairs, (f"{pairs:.3e} ({-(-n // 2048)} chunks x 2048 x {k_pad}; "
                   f"window {spec.n_offsets} x {spec.capacity} = {width}; "
                   f"H {spec.table_size})")


def phase_full(E):
    t = E.torch
    runs = {}
    for name, n, eps, min_pts in FULL:
        pts_np = E.repro_torch.synth.load(name, n, seed=0)
        runs[name] = {}
        ref = None
        for path, (kw, kernels) in PATHS.items():
            rec = FrontierRecorder(E)
            t.cuda.synchronize()
            E.reset_launches()
            t0 = time.perf_counter()
            with rec:
                eng = E.repro_torch.make_engine(pts_np, eps,
                                                engine=kw["engine"])
                res = E.repro_torch.dbscan(pts_np, eps, min_pts, eng=eng,
                                           hook_loop=kw.get("hook_loop",
                                                            "device"))
                t.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = E.launches()
            check(all(launches[k] > 0 for k in kernels) and
                  all(v == 0 for k, v in launches.items()
                      if k not in kernels),
                  f"{name} {path}: launches {launches}, expected exactly "
                  f"{kernels}")
            if ref is None:
                check_invariants(E, res, pts_np, eps, min_pts, name)
                ref = res
            else:
                assert_same_result(E, ref, res, f"{name} {path} vs "
                                   "grid/device", rounds=False)
            if path == "grid/frontier":
                check(res.n_rounds == ref.n_rounds,
                      f"{name}: n_rounds {res.n_rounds} (frontier) != "
                      f"{ref.n_rounds} (device)")
            pairs, pairs_txt = pair_tests(E, path, eng, rec)
            tm = dict(eng.timings, **res.timings)
            log(f"  {name} n={n} eps={eps} min_pts={min_pts} {path}: "
                f"launches {launches}")
            log(f"    phases s: plan {tm['plan_s']:.3f}, build "
                f"{tm['build_s'] - tm['plan_s']:.3f}, stage1 "
                f"{tm['stage1_s']:.3f}, stage2 {tm['stage2_s']:.3f}, border "
                f"{tm['border_s']:.3f}; total {wall:.3f}"
                if "plan_s" in tm else
                f"    phases s: build {tm['build_s']:.3f}, stage1 "
                f"{tm['stage1_s']:.3f}, stage2 {tm['stage2_s']:.3f}, border "
                f"{tm['border_s']:.3f}; total {wall:.3f}")
            log(f"    n_rounds {res.n_rounds}{hist_txt(res)}, clusters "
                f"{n_clusters(res.labels)}, noise "
                f"{int((res.labels == -1).sum())}, core {int(res.core.sum())}")
            log(f"    pair tests per sweep {pairs_txt}")
            runs[name][path] = dict(eng=eng, res=res, launches=launches,
                                    pairs=pairs, rec=rec, wall=wall,
                                    eps2=float(eps) ** 2)
        log(f"    {name}: labels, core and counts identical across "
            f"{list(PATHS)}; invariants and 4096 brute-force counts: ok")
        runs[name]["serve"] = serve_full(E, name, n, eps, min_pts, pts_np)
    return runs


# --------------------------------------------------------------------------
# phase 6: kernel times at the full-size shapes of each kernel's path


def cuda_ms(E, fn, reps: int = 5) -> float:
    """Median ms of ``fn`` over ``reps`` launches after one warm-up, timed
    by CUDA events."""
    fn()
    return statistics.median(timed_once(E, fn)[0] for _ in range(reps))


def timed_once(E, fn):
    """(ms, result) of one call of ``fn``, timed by CUDA events."""
    t = E.torch
    a = t.cuda.Event(enable_timing=True)
    b = t.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def bound(pairs: int, nbytes: int) -> tuple[float, str]:
    """Least time on the card, ms: the larger of the operations over the
    FP32 peak and the bytes (each input read once, each output written
    once) over the memory rate."""
    t_ops = pairs * OPS_PER_PAIR / PEAK_FP32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(k, p) -> int:
    k = k if isinstance(k, tuple) else (k,)
    p = p if isinstance(p, tuple) else (p,)
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(k, p))


def row(kernel, launches, ms, plain_ms, b, err, **extra):
    check(err == 0, f"{kernel}: kernel != plain (max abs err {err})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                max_abs_err=err, launches=launches, **extra)


def times_csr(E, name, run):
    t = E.torch
    g, spec, res = run["eng"].state, run["eng"].meta, run["res"]
    order = g.order.long()
    croot = t.full((spec.n_cand,), INT_MAX, dtype=t.int32, device=E.dev)
    croot[:spec.n] = E.ops.fuse_core_root(res.core[order], res.labels[order])
    st = (g.starts // spec.block_k).to(t.int32)
    eps2 = run["eps2"]
    kw = dict(max_blocks=spec.slab // spec.block_k, block_k=spec.block_k)
    T, bq, nc = spec.n_tiles, spec.chunk, spec.n_cand
    nbytes = T * bq * 12 + nc * 12 + T * 8 + T * bq * 4
    calls = {
        "csr_sweep": (
            lambda: E.csr.csr_sweep(g.q_sorted, g.cands, croot, st, g.nblk,
                                    eps2, block_q=bq, **kw),
            lambda: E.csr.csr_sweep_plain(g.q_sorted, g.cands, croot, st,
                                          g.nblk, eps2, **kw),
            nbytes + nc * 4 + T * bq * 4),
        "csr_sweep_counts": (
            lambda: E.csr.csr_sweep_counts(g.q_sorted, g.cands, st, g.nblk,
                                           eps2, block_q=bq, **kw),
            lambda: E.csr.csr_sweep_counts_plain(g.q_sorted, g.cands, st,
                                                 g.nblk, eps2, **kw),
            nbytes),
    }
    out = {}
    for kname, (kern, plain, nb) in calls.items():
        ms = cuda_ms(E, kern)
        # the plain version takes seconds here: one timed call at the full
        # shapes, which is also the call the kernel is compared with
        plain_ms, p_out = timed_once(E, plain)
        err = max_err(kern(), p_out)
        launches = sum(r["launches"][kname] for r in
                       (run, E.runs[name]["grid/frontier"]))
        out[kname] = row(kname, launches, ms, plain_ms,
                         bound(run["pairs"], nb), err,
                         plain_shapes="full", pair_tests=run["pairs"])
    return out


def times_frontier(E, name, run):
    """frontier_sweep on the main path's own round-1 inputs (the widest
    frontier), plain on its first 64 live slots."""
    rec = run["rec"]
    (args, kw), (na1, pairs1) = rec.calls[0], rec.live_pairs()[0]
    q, cp, croot, st, nblk, active, n_active, eps2 = args
    kern = lambda: E.frontier.frontier_sweep(*args, **kw)  # noqa: E731
    ms = cuda_ms(E, kern)
    T, bq = st.shape[0], kw["block_q"]
    nbytes = T * bq * 12 + cp.shape[1] * 16 + T * 12 + 4 + T * bq * 4
    sub = min(SUBSET, na1)
    sub_args = (q, cp, croot, st, nblk,
                E.tensor(_park(active[:sub].tolist(), T)),
                E.tensor(np.array([sub], np.int32)), eps2)
    pkw = dict(max_blocks=kw["max_blocks"], block_k=kw["block_k"])
    plain_ms, p_out = timed_once(
        E, lambda: E.frontier.frontier_sweep_plain(*sub_args, **pkw))
    k_sub_ms, k_out = timed_once(
        E, lambda: E.frontier.frontier_sweep(*sub_args, **kw))
    border_ms = cuda_ms(E, lambda: E.frontier.frontier_sweep(
        *rec.calls[-1][0], **rec.calls[-1][1]))
    return row("frontier_sweep", run["launches"]["frontier_sweep"], ms,
               plain_ms, bound(pairs1, nbytes), max_err(k_out, p_out),
               plain_shapes=f"{sub} of round 1's {na1} live tiles",
               ms_on_plain_shapes=k_sub_ms, live_tiles=na1,
               pair_tests=pairs1, tiles=T, border_ms=border_ms,
               border_live_tiles=rec.live_pairs()[-1][0])


def times_pairwise(E, name, run):
    """pairwise_sweep at the brute engine's sweep shapes, plain on 64 query
    tiles against every candidate."""
    res, pts = run["res"], run["eng"].state
    q, cp, croot = E.ops.pairwise_sweep_args(pts, pts, res.core, res.labels)
    eps2 = run["eps2"]
    ms = cuda_ms(E, lambda: E.pairwise.pairwise_sweep(q, cp, croot, eps2))
    nq, nc = q.shape[0], cp.shape[1]
    nbytes = nq * 12 + nc * 16 + nq * 8
    rows = E.torch.as_tensor(np.sort(np.random.default_rng(2).choice(
        nq // 256, min(SUBSET, nq // 256), replace=False)), device=E.dev)
    q_sub = q.view(-1, 256, 3)[rows].reshape(-1, 3).contiguous()
    plain_ms, p_out = timed_once(
        E, lambda: E.pairwise.pairwise_sweep_plain(q_sub, cp, croot, eps2))
    k_sub_ms, k_out = timed_once(
        E, lambda: E.pairwise.pairwise_sweep(q_sub, cp, croot, eps2))
    return row("pairwise_sweep", run["launches"]["pairwise_sweep"], ms,
               plain_ms, bound(nq * nc, nbytes), max_err(k_out, p_out),
               plain_shapes=f"{SUBSET} query tiles of 256 x {nc} candidates",
               ms_on_plain_shapes=k_sub_ms, pair_tests=nq * nc,
               shape=[nq, nc])


def times_gathered(E, name, run, grid_run):
    """gathered_sweep per chunk at the grid-hash engine's chunk shapes,
    plain on 64 chunks; and one whole grid-hash sweep (gathers included)
    beside one whole CSR sweep."""
    eng, res = run["eng"], run["res"]
    eps2 = run["eps2"]
    n_chunks = -(-eng.state.points.shape[0] // 2048)
    pick = set(np.random.default_rng(3).choice(
        n_chunks, min(SUBSET, n_chunks), replace=False).tolist())
    plain_ms, kern_ms, err, ms = [], [], 0, None
    # one chunk's window at a time: all of them at once would not fit
    for i, chunk in enumerate(E.nb.hash_window_chunks(
            eng.state, res.core, res.labels, 2048)):
        if i != n_chunks // 2 and i not in pick:
            continue
        args = E.ops.gathered_sweep_args(*chunk)
        if i == n_chunks // 2:
            ms = cuda_ms(E, lambda: E.gathered.gathered_sweep(*args, eps2))
            b, k = args[2].shape
        if i in pick:
            p_ms, p_out = timed_once(
                E, lambda: E.gathered.gathered_sweep_plain(*args, eps2))
            k_ms, k_out = timed_once(
                E, lambda: E.gathered.gathered_sweep(*args, eps2))
            plain_ms.append(p_ms)
            kern_ms.append(k_ms)
            err = max(err, max_err(k_out, p_out))
        del args, chunk
    nbytes = b * 12 + b * k * 16 + b * 8
    sweep_ms = cuda_ms(E, lambda: eng.sweep(eng.state, res.core, res.labels),
                       reps=3)
    g = grid_run["eng"]
    order = g.state.order.long()
    croot = E.ops.fuse_core_root(res.core[order], res.labels[order])
    csr_ms = cuda_ms(E, lambda: g.sweep_sorted(g.state, croot), reps=3)
    return row("gathered_sweep", run["launches"]["gathered_sweep"], ms,
               statistics.mean(plain_ms), bound(b * k, nbytes), err,
               plain_shapes=f"mean over {len(pick)} chunks of {b} x {k}",
               ms_on_plain_shapes=statistics.mean(kern_ms),
               pair_tests=b * k, shape=[b, k], chunks_per_sweep=n_chunks,
               kernel_ms_per_sweep=ms * n_chunks,
               grid_hash_sweep_ms=sweep_ms, csr_sweep_ms=csr_ms)


def slab_pairs(nblk, block_k: int, block_q: int) -> int:
    """Pair tests of one slab sweep: every live block of every tile."""
    return int(nblk.sum()) * block_k * block_q


def times_cross(E, name, run):
    """cross_sweep on the serve path's own inputs: the assign of ASSIGN_Q
    fresh points, and the largest cross query of an ingest (the delta
    against the corpus); plain on SUBSET query tiles of the assign."""
    rec, marks = run["rec"], run["marks"]
    (args, kw) = rec.calls[0]
    ingest_calls = rec.calls[marks["assign"]:marks["ingest"]]
    i_args, i_kw = max(ingest_calls, key=lambda c: c[0][0].shape[0])
    out = {}
    for tag, (a, k) in (("assign", (args, kw)), ("ingest", (i_args, i_kw))):
        q, cp, croot, st, nb, eps2 = a
        T, bq, nc = st.shape[0], k["block_q"], cp.shape[1]
        ms = cuda_ms(E, lambda: E.cross.cross_sweep(*a, **k))
        nbytes = T * bq * 12 + nc * 16 + T * 8 + T * bq * 12
        out[tag] = dict(ms=ms, pairs=slab_pairs(nb, k["block_k"], bq),
                        nbytes=nbytes, queries=T * bq,
                        max_nblk=int(nb.max()), tiles=T)
    sub, _ = tile_subset(E, args, kw, seed=1)
    pkw = dict(max_blocks=kw["max_blocks"], block_k=kw["block_k"])
    plain_ms, p_out = timed_once(
        E, lambda: E.cross.cross_sweep_plain(*sub, args[5], **pkw))
    k_sub_ms, k_out = timed_once(
        E, lambda: E.cross.cross_sweep(*sub, args[5], block_q=kw["block_q"],
                                       **pkw))
    d2_err = float((k_out[2] - p_out[2]).abs().nan_to_num(0.0).max())
    check(E.torch.equal(k_out[2], p_out[2]), f"cross_sweep mind2: kernel != "
          f"plain (max abs err {d2_err})")
    err = max(max_err(k_out[:2], p_out[:2]), d2_err)
    a, i = out["assign"], out["ingest"]
    return row("cross_sweep", run["launches"]["cross_sweep"], a["ms"],
               plain_ms, bound(a["pairs"], a["nbytes"]), err,
               plain_shapes=f"{SUBSET} query tiles of the assign",
               ms_on_plain_shapes=k_sub_ms, pair_tests=a["pairs"],
               queries=a["queries"], max_nblk=a["max_nblk"],
               ingest_ms=i["ms"], ingest_queries=i["queries"],
               ingest_pair_tests=i["pairs"],
               ingest_bound_ms=bound(i["pairs"], i["nbytes"])[0])


def phase_times(E, runs):
    E.runs = runs
    per = {k: {} for k in KERNELS}
    for name, r in runs.items():
        per_ds = times_csr(E, name, r["grid/device"])
        per_ds["frontier_sweep"] = times_frontier(E, name, r["grid/frontier"])
        per_ds["pairwise_sweep"] = times_pairwise(E, name, r["brute"])
        per_ds["gathered_sweep"] = times_gathered(E, name, r["grid-hash"],
                                                  r["grid/device"])
        per_ds["cross_sweep"] = times_cross(E, name, r["serve"])
        for kname, d in per_ds.items():
            # launches: every counted path run of this dataset
            by_path = {p: pr["launches"][kname] for p, pr in r.items()
                       if pr["launches"][kname]}
            d["launches_by_path"] = by_path
            d["launches"] = sum(by_path.values())
            per[kname][name] = d
            log(f"  {kname} @ {name}: {d['ms']:.3f} ms (bound "
                f"{d['bound_ms']:.3f} ms by {d['bound_by']}, "
                f"{d['bound_ms'] / d['ms']:.1%} of bound; plain "
                f"{d['plain_ms']:.1f} ms on {d['plain_shapes']} shapes"
                + (f", kernel {d['ms_on_plain_shapes']:.3f} ms there"
                   if "ms_on_plain_shapes" in d else "") + ")")
        g = per_ds["gathered_sweep"]
        f = per_ds["frontier_sweep"]
        log(f"    frontier round 1: {f['live_tiles']} of {f['tiles']} tiles "
            f"live; border call {f['border_ms']:.3f} ms with "
            f"{f['border_live_tiles']} live tiles")
        log(f"    one sweep @ {name}: grid-hash {g['grid_hash_sweep_ms']:.3f}"
            f" ms ({g['chunks_per_sweep']} chunks, kernel "
            f"{g['kernel_ms_per_sweep']:.3f} ms of it), CSR grid "
            f"{g['csr_sweep_ms']:.3f} ms")
        c = per_ds["cross_sweep"]
        log(f"    cross_sweep @ {name}: assign of {c['queries']} queries "
            f"{c['ms']:.3f} ms ({c['pair_tests']:.3e} pair tests, max nblk "
            f"{c['max_nblk']}); ingest cross query of {c['ingest_queries']} "
            f"{c['ingest_ms']:.3f} ms (bound {c['ingest_bound_ms']:.3f} ms, "
            f"{c['ingest_pair_tests']:.3e} pair tests); launches by path "
            f"{c['launches_by_path']}")
    return per


def kernels_line(per) -> dict:
    """The kernels JSON: per-call numbers at the roadnet2d full-size shapes,
    launches summed over every full-size path run on both datasets (per
    path under ``per_dataset``), every dataset under ``per_dataset``."""
    out = []
    for kname, rows in per.items():
        head = rows[FULL[0][0]]
        out.append(dict(
            name=kname, route="cuda", source=KERNELS[kname][0],
            replaces=KERNELS[kname][1],
            launches=sum(r["launches"] for r in rows.values()),
            max_abs_err=max(r["max_abs_err"] for r in rows.values()),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, parity="bit-identical", shapes=FULL[0][0],
            per_dataset=rows))
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    phases = {}

    def timed(label, fn, *args):
        log(f"[{label}]")
        t0 = time.perf_counter()
        out = fn(*args)
        phases[label] = time.perf_counter() - t0
        log(f"  ({phases[label]:.1f} s)")
        return out

    smi = card_line()
    log(f"[environment] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(smi)
    E = Env()

    def build():
        for name, built in E.build.build(E.build.sources()).items():
            log(f"  {name}: {built.path.name}")
            for line in built.log.splitlines():
                if "registers" in line or "spill" in line \
                        or "Compiling entry" in line:
                    log(f"    {line.strip()}")
    timed("build", build)
    timed("kernel parity", phase_parity, E)
    timed("whole path, reduced size", phase_reduced, E)
    runs = timed("whole path, full size", phase_full, E)
    per = timed("kernel times", phase_times, E, runs)

    log("phases s: " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
        + f"; total {time.perf_counter() - t_start:.1f}")
    log(smi)
    print(json.dumps(kernels_line(per)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
