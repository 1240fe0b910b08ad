#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on the card and exits non-zero on any failure.
Paths: batch DBSCAN on the grid engine with the ``device`` round driver
(the main path) and with the ``frontier`` driver, on the ``grid-hash``
engine (``hash_sweep``), on the ``brute`` engine, on the wavefront BVH
engine (``bvh``, ``bvh_level``) with the ``device`` and ``frontier``
drivers, on the stack BVH engine
(``bvh-stack``) and through the FDBSCAN baseline with its early exit
(``fdbscan``); single-session serving (``serve``: ``build_snapshot``,
``assign``, ``ServeSession.ingest`` with compaction, snapshot save and
load); the sharded serving tier (``tier``: ``ShardedTier``, its assign,
ingest, compaction, partial gathers, recovery and hedged legs); the
paper's fig. 4 systems (DClust, grid, FDBSCAN, G-DBSCAN, brute); and the
distributed driver on thread ranks of the card and through the CLI's
``--distributed``. Phases:

  1. environment: the card's name and power limit (nvidia-smi);
  2. build: every kernel source in src/repro_torch/csrc, one nvcc each,
     started together;
  3. kernel parity, each kernel against its plain PyTorch version on the
     card, integer outputs bit-identical: the reference's ragged shape
     sweeps, pairs at exactly d² = ε² (and the float below), tiles with
     nblk = 0, frontier slots with n_active = 0, 1 and T under the park
     contract, windows with invalid and duplicate-masked cells; for the
     four slab sweeps that skip runs (csr_sweep, csr_sweep_counts,
     frontier_sweep, cross_sweep) also layouts built to be culled (lattice
     clusters at box gaps of exactly ε and one f32 step either side, 2-D
     and 3-D, a heavy tile split over work items, +1e30 tail runs; for the
     frontier the heavy tile live and parked, for the cross query tiles of
     +1e30 padding rows), frontier_sweep and cross_sweep called once each
     under torch.cuda.set_sync_debug_mode("error") (a host read of
     n_active or of the work-item count fails the run), and for the csr
     sweeps 64 seeded tiles of the full-size iono3d layout; and 64 seeded
     tiles (chunks) of the
     full-size roadnet2d layouts (the grid's with the widest slab and the
     most kept runs among them; for
     cross_sweep, of the layout of an assign of 32,768 fresh points; its
     float output mind2 bit-identical too); morton_encode on 2-D and 3-D
     codes, the top and over-the-mask values, ragged n; bvh_batch_sweep on
     the reference's ragged sweep (both prune dtypes, bf16 boxes stored
     bf16 and widened, both payload modes, payload inputs absent without),
     pairs at d² = ε², queries a fraction of a bf16 ulp either side of a
     box edge, dead entries, and 64 seeded slices of the widest level of
     the full-size roadnet2d exact traversal (gathered_sweep and
     bvh_batch_sweep and morton_encode no longer run on any path: each is
     the A side of the
     kernel that replaced it); hash_sweep against its plain version and
     the gathered_sweep path on grid-hash engines at n = 20,000
     (roadnet2d, iono3d, skewed2d), on a table of 64 buckets (aliased
     windows) and on 2-D and 3-D 1/8 lattices at d² = ε² and the float
     below; bvh_level at n = 20,000 (D = 2 and 3): exact, terminated,
     overflowing and stop-at-overflow traversals with bf16 and f32 boxes,
     every level against bvh_level_plain (counts, minroot, the next
     frontier, live counts, overflow, histogram) and every traversal
     against the bvh_batch_sweep loop; then the LBVH build: build_bvh and
     max_leaf_depth on the card (one launch each of lbvh_keys, lbvh_nodes,
     lbvh_refit, lbvh_depth) against the plain versions on the same
     tensors, every BVH field bitwise (int32 views: -0.0 and +0.0
     differ), on edge cases (n = 2, 3, 5, 1,023, 4,097 at D = 2, 3, 4 and
     2-D in (n, 3); all points equal, duplicates, +1e30 sentinels under a
     lo/hi override, signed zeros) and at full size (roadnet2d 435,000,
     iono3d 1,000,000), with the engines' build time on the host and one
     build's kernel launches and device operations (torch.profiler);
  4. whole path at n = 20,000 (roadnet2d, iono3d at the full-size ε and
     minPts, where it is all noise, and iono3d at ε = 4.0, minPts = 16,
     where it clusters and hooks), every path:
     device="cpu" with the plain versions against the card with the
     kernels, bit-identical labels, core, counts, n_rounds and frontier
     histogram; ``find_neighbors`` of every engine at n = 4,000, cpu
     against cuda; serving at n = 20,000 roadnet2d (build_snapshot, assign
     of 4,096 fresh points, 4 ingests of 1,024, a forced compaction), cpu
     against cuda: labels, counts and dist bit-identical; the calibrated
     WavefrontSpec of the bvh engine equal on cpu and cuda;
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
     again (identical). The bvh paths also print the calibrated spec
     (probes, capacity, peak), the level histogram of the exact sweep and
     the ms of bvh_level inside each sweep (CUDA events);
     fdbscan's stage-1 counts are clipped at minPts, so its counts are held
     to min(counts, minPts). After each dataset's runs, outside them: every
     hash_sweep call of the grid-hash run against its plain version and
     the gathered_sweep path, and an exact and a terminated traversal with
     the run's final payload, every level against bvh_level_plain and the
     outputs against the bvh_batch_sweep loop. After each dataset's serve
     run, the sharded tier on its snapshot (4 shards, a replica of shard
     0, warmup): an assign of the same 32,768 fresh points, labels,
     counts and dist bit-identical to the single-session assign; the same
     2,048-point ingests until the tier compacts once, its labels and
     core reassembled from the shards bit-identical to dbscan on the
     corpus plus the folded chunks in arrival order, and an assign then
     equal to the single-session assign on that corpus; shard 1's only
     copy forced down, the partial assign equal to the restriction of the
     merge to the live shards; recover_shard(1), the answers
     bit-identical again; a hedged leg on shard 0 (its primary suspect)
     with the bits of an unhedged one; each step's host seconds, the legs
     per query and the phase's launches by kernel (exactly the serve
     path's four kernels);
  5b. the paper's fig. 4 systems at benchmarks/figures.py:57's full size
     (roadnet2d 16,384, minPts 8, ε 0.01, 0.02, 0.04): DClust, grid,
     FDBSCAN, G-DBSCAN and brute, each launching exactly its kernels
     (G-DBSCAN none), core equal across systems, labels equivalent to
     grid's, DClust's rounds at least grid's, each system's seconds;
  5c. the distributed driver (``dbscan_distributed``) on 4 thread ranks of
     the card at full size (roadnet2d 435,000, iono3d 1,000,000) with the
     local engines grid, csr and bvh: launch counts set to 0 before and
     read after each run (exactly the engine's kernels), labels, core and
     n_rounds identical across the engines, core equal to grid/device's,
     the noise set and the core partition equal after canonical
     relabelling, every core label its cluster's least core id and every
     border label the least label of its core neighbours (one csr_sweep
     payload on the single-device engine); each engine's kernels held to
     their plain versions at the run's own shapes (hash_sweep on 65,536
     of its queries, csr_sweep on 64 tiles, build_bvh field by field and
     every bvh_level of a sweep); each run's host seconds per step,
     attempts and regrows, bytes put into each collective, peak device
     memory and launches. Then at iono3d 20,000, ε = 4.0, minPts 16 (it
     clusters and hooks; brute runs there only, all pairs over buffers
     1.25 n wide a rank): every engine on the card against the CPU plain
     versions (labels, core, n_rounds); neighbor_buckets of ±1e30 and
     ±3e9 rows, card against CPU; the CLI's ``--distributed`` (a one-rank
     NCCL process group) against one thread rank;
  6. kernel times at the full-size shapes of each kernel's path (median of
     5 launches, CUDA events), beside the plain version's time and the
     least time the card could take (bound; for the four slab sweeps that
     skip runs at the pair tests of the runs their skip keeps, with the
     slab's pair tests, the kept ones and their share printed, and beside
     them the kept pairs' time at the unfused FP32 issue rate; for the csr
     sweeps also the operations bound at the slab's pairs and at what
     G = 64 would keep; for pairwise_sweep its FP32 issue-rate floor over
     every pair); the LBVH kernels (lbvh_keys, lbvh_nodes, lbvh_refit,
     lbvh_depth) on the bvh build's own input, lbvh_keys also held to
     morton_encode_plain of the quantized cells, and morton_encode on
     those cells (lbvh_keys' A side); hash_sweep
     on one sweep of the grid-hash run (its bounds: its inputs read once
     and its occupied pairs; beside them the padded windows' bytes, the
     slots as read and the issue rate), with gathered_sweep per chunk
     and the gathered_sweep path's whole sweep beside it; bvh_level at
     the widest level of the exact sweep and per level (median of 5
     sweeps), the exact sweep's host time, torch.profiler split, blocking
     host reads (torch.cuda's sync debug mode) and waits for an earlier
     level's count, its bytes bound and the per-entry kernel's, with
     bvh_batch_sweep at the widest level and its whole level loop beside
     it. Rows 6, 7 and 8 of the kernels line (lbvh_keys, bvh_level,
     hash_sweep) carry those A-side numbers under ``previous``. A
     kernel's ``launches`` sum every counted path run of phases 5, 5b and
     5c (the tier, fig. 4 and the distributed runs included).

Before the last line it prints one ``{"kernels": [...]}`` JSON line; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
run from a directory without the repo's ``src/repro_torch``, it exits 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
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
# FP32-pipe instructions of a pair (-fmad=false: 3 FSUB, 3 FMUL, 2 FADD,
# compare), issued one a lane a clock (the 67e12 above counts an FMA as two
# operations).
FP32_INSTR_PER_PAIR = 9
INT_MAX = np.iinfo(np.int32).max

FULL = [("roadnet2d", 435_000, 0.02, 8), ("iono3d", 1_000_000, 2.0, 16)]
REDUCED_N = 20_000
# (dataset, ε, minPts) of the reduced phase: the full-size settings, and
# iono3d at an ε where n = 20,000 clusters (at ε = 2.0 it is all noise), so
# that the hooking rounds run there too
REDUCED = [(name, eps, min_pts) for name, _, eps, min_pts in FULL] + \
    [("iono3d", 4.0, 16)]
NEIGHBORS_N = 4_000
SHAPES = [(1, 8, 1, 1), (4, 64, 8, 3), (3, 256, 6, 6), (7, 32, 16, 2)]
PAIR_SHAPES = [(1, 1), (7, 513), (256, 512), (100, 1000), (513, 257)]
WINDOW_SHAPES = [(1, 1), (128, 512), (130, 100), (3, 700)]
EQ_BELOW = (9 / 64, float(np.nextafter(np.float32(9 / 64), np.float32(0))))
SUBSET = 64      # tiles (chunks) of the full-size layouts for plain versions

# dbscan options of each path (``early_exit``: the FDBSCAN baseline's run
# instead of dbscan), and the kernels the path must launch
LBVH_BUILD = ("lbvh_keys", "lbvh_nodes", "lbvh_refit")
BVH_KERNELS = LBVH_BUILD + ("bvh_level",)
STACK_KERNELS = LBVH_BUILD + ("lbvh_depth",)
PATHS = {
    "grid/device": (dict(engine="grid", hook_loop="device"),
                    ("csr_sweep_counts", "csr_sweep")),
    "grid/frontier": (dict(engine="grid", hook_loop="frontier"),
                      ("csr_sweep_counts", "frontier_sweep")),
    "grid-hash": (dict(engine="grid-hash"), ("hash_sweep",)),
    "brute": (dict(engine="brute"), ("pairwise_sweep",)),
    "bvh/device": (dict(engine="bvh", hook_loop="device"), BVH_KERNELS),
    "bvh/frontier": (dict(engine="bvh", hook_loop="frontier"), BVH_KERNELS),
    "bvh-stack": (dict(engine="bvh-stack"), STACK_KERNELS),
    "fdbscan": (dict(engine="bvh-stack", early_exit=True), STACK_KERNELS),
}
ENTRIES_PER_SLICE = 2_048   # bvh_batch_sweep parity: entries per slice
LEVEL_REPS = 5              # exact sweeps timed per level (median)
# (dataset, n, ε, dims) of the reduced parity of hash_sweep and bvh_level
# (skewed2d: one dense blob beside a sparse field)
REDUCED_FUSED = [("roadnet2d", 20_000, 0.02, 2), ("iono3d", 20_000, 4.0, 3),
                 ("skewed2d", 20_000, 0.02, 2)]
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
# the sharded tier at full size: shards of the serve path's snapshot, each
# shard's delta capacity a quarter of the session's (so the same ingests
# fill one shard's buffer and the tier compacts once), shard 1 forced down
TIER_SHARDS = 4
TIER_DOWN = 1
# the paper's fig. 4 (benchmarks/figures.py:57 at its full size): one
# dataset and n, an ε sweep, the systems and the kernels each launches
FIG4 = ("roadnet2d", 16_384, 8, (0.01, 0.02, 0.04))
FIG4_SYSTEMS = {"dclust": ("csr_sweep",),
                "grid": ("csr_sweep_counts", "csr_sweep"),
                "fdbscan": STACK_KERNELS, "gdbscan": (),
                "brute": ("pairwise_sweep",)}
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "csr_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                  "src/repro/kernels/csr_sweep.py:146"),
    "csr_sweep_counts": ("src/repro_torch/csrc/csr_sweep.cu",
                         "src/repro/kernels/csr_sweep.py:102"),
    "frontier_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                       "src/repro/kernels/frontier_sweep.py:65"),
    "pairwise_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                       "src/repro/kernels/pairwise_sweep.py:68"),
    "hash_sweep": ("src/repro_torch/csrc/gathered_sweep.cu",
                   "src/repro/kernels/gathered_sweep.py:55"),
    "cross_sweep": ("src/repro_torch/csrc/csr_sweep.cu",
                    "src/repro/kernels/cross_sweep.py:94"),
    "lbvh_keys": ("src/repro_torch/csrc/lbvh.cu",
                  "src/repro/kernels/morton.py:50"),
    # counterparts of jnp code of the reference, not of TPU kernels
    "lbvh_nodes": ("src/repro_torch/csrc/lbvh.cu",
                   "src/repro/core/bvh.py:99"),
    "lbvh_refit": ("src/repro_torch/csrc/lbvh.cu",
                   "src/repro/core/bvh.py:99"),
    "lbvh_depth": ("src/repro_torch/csrc/lbvh.cu",
                   "src/repro/core/bvh.py:196"),
    "bvh_level": ("src/repro_torch/csrc/bvh_sweep.cu",
                  "src/repro/kernels/bvh_sweep.py:79"),
}
# the kernels that the redesigned rows 6, 7 and 8 replaced on every path,
# with their sources; their parity phases and times stay, as each new
# kernel's A side
PREVIOUS = {
    "hash_sweep": ("gathered_sweep", "src/repro_torch/csrc/gathered_sweep.cu"),
    "bvh_level": ("bvh_batch_sweep", "src/repro_torch/csrc/bvh_sweep.cu"),
    "lbvh_keys": ("morton_encode", "src/repro_torch/csrc/bvh_sweep.cu"),
}
# edge cases of the LBVH build parity (besides the full-size builds)
LBVH_EDGE_N = (2, 3, 5, 1_023, 4_097)
# the distributed driver: thread ranks on the card, the local engines run at
# full size and the kernels each launches; brute (all pairs over buffers
# 1.25 n wide a rank) runs at DIST_REDUCED only, where every engine is also
# held to the CPU plain versions. max_regrows: the reference's default is
# 3; the smoke passes more and prints each run's regrows (csr at iono3d 1M
# takes 6: its slab and every buffer double each time), so that a run that
# needs more doublings is reported, not failed (no default of DistConfig
# changes)
DIST_RANKS = 4
DIST_ENGINES = ("grid", "csr", "bvh")
# brute's run and the CPU comparison: the reduced phase's hooking case
# (roadnet2d 20,000 regrows the grid engine to C = 512, and the plain
# version's padded 27 x C windows then take over ten minutes on the CPU)
DIST_REDUCED = ("iono3d", 20_000, 4.0, 16)
DIST_CPU_THREADS = 2   # torch threads of each CPU rank thread
DIST_REGROWS = 6
DIST_SUBSET = 65_536   # queries of a full-size hash_sweep held to plain
DIST_KERNELS = {"grid": ("hash_sweep",), "csr": ("csr_sweep",),
                "bvh": BVH_KERNELS, "brute": ("pairwise_sweep",)}
DIST_STEPS = ("cuts", "all_to_all", "halo", "local_build", "stage1",
              "components", "label_rounds", "border", "return")


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


def fp32_issue_rate(E):
    """(unfused FP32 instructions a second, max SM clock in MHz): the
    card's SMs x 128 lanes x its max SM clock as nvidia-smi reads it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = E.torch.cuda.get_device_properties(E.dev).multi_processor_count
    return sms * 128 * mhz * 1e6, mhz


class Env:
    """Imports of the port, made after the CUDA and checkout checks."""

    def __init__(self):
        import torch

        import repro_torch
        from repro_torch import serve
        from repro_torch.baselines import dclust, fdbscan, gdbscan
        from repro_torch.core import bvh, grid, labels, neighbors
        from repro_torch.distributed import comm, dbscan_dist
        from repro_torch.kernels import (build, bvh_sweep, cross_sweep,
                                         csr_sweep, frontier_sweep,
                                         gathered_sweep, lbvh, morton, ops,
                                         pairwise_sweep, ref)
        from repro_torch.launch import cluster
        from repro_torch.serve import snapshot
        self.torch, self.repro_torch = torch, repro_torch
        self.dd, self.comm, self.cluster = dbscan_dist, comm, cluster
        self.build, self.ops, self.ref = build, ops, ref
        self.csr, self.frontier = csr_sweep, frontier_sweep
        self.pairwise, self.gathered = pairwise_sweep, gathered_sweep
        self.cross, self.serve, self.snapshot = cross_sweep, serve, snapshot
        self.nb, self.bvh, self.fdbscan = neighbors, bvh, fdbscan
        self.dclust, self.gdbscan, self.labels = dclust, gdbscan, labels
        self.grid = grid
        self.bvhk, self.morton, self.lbvh = bvh_sweep, morton, lbvh
        self.modules = (csr_sweep, frontier_sweep, pairwise_sweep,
                        gathered_sweep, cross_sweep, morton, bvh_sweep, lbvh)
        self.dev = torch.device("cuda")

    def reset_launches(self) -> None:
        for m in self.modules:
            m.reset_launches()

    def launches(self) -> dict:
        return {k: v for m in self.modules for k, v in m.LAUNCHES.items()}

    def tensor(self, x):
        return x if x is None or isinstance(x, self.torch.Tensor) \
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


def _cube(rng, n, dims, at):
    """n points on the 1/8 lattice in ``at`` + [0, 1/2]^dims (z = 0 in
    2-D), the cube's two corners among them."""
    p = rng.integers(0, 5, (n, 3)).astype(np.float32) / 8
    p[0], p[1] = 0, 0.5
    if dims == 2:
        p[:, 2] = 0
    return (p + np.asarray(at, np.float32)).astype(np.float32)


def _culled(dims, block_q, block_k, run, seed):
    """Query tiles and candidate runs (a block each, every G-column run of
    it pinned to the block's lowest x) built to be culled at ε = 3/8, and
    the kind of each run. Tiles 0-3 are
    lattice cubes of side 1/2, 4 apart along x; next to tile i lie its runs
    "own" (overlapping), "edge" (box gap exactly ε along x, its corner
    exactly ε from the tile's), "edge-" and "edge+" (that gap one f32 step
    smaller and larger) and "far"; then 30 "filler" runs at y = 10 and 3
    runs of +1e30 padding. Tile i's slab covers the runs of tiles i-1 ..
    i+1 (tile 3's reaches the end, padding included); tile 4 spans every
    run, a heavy tile that keeps more runs than one work item holds; tiles
    5 and 6 have nblk = 0. tests/test_torch_csr_cull.py's culled_layout."""
    rng = np.random.default_rng(seed)
    kinds, runs, tiles = [], [], []
    for i in range(4):
        tiles.append(_cube(rng, block_q, dims, (4.0 * i, 0, 0)))
        edge = np.float32(4.0 * i) + np.float32(0.5 + 3 / 8)
        for kind, x0 in (("own", np.float32(4.0 * i)), ("edge", edge),
                         ("edge-", np.nextafter(edge, np.float32(-np.inf))),
                         ("edge+", np.nextafter(edge, np.float32(np.inf))),
                         ("far", np.float32(4.0 * i + 2))):
            c = _cube(rng, block_k, dims, (0, 0, 0))
            c[:, 0] += x0
            c[::run, 0] = x0
            kinds.append(kind)
            runs.append(c)
    for k in range(30):
        kinds.append("filler")
        runs.append(_cube(rng, block_k, dims, (0.5 * k, 10, 0)))
    for _ in range(3):
        kinds.append("padding")
        runs.append(np.full((block_k, 3), 1e30, np.float32))
    lo = np.min([r.min(0) for r in runs[:-3]], axis=0)
    hi = np.max([r.max(0) for r in runs[:-3]], axis=0)
    heavy = (lo + rng.integers(0, 9, (block_q, 3)) / 8 *
             (hi - lo)).astype(np.float32)
    heavy[0], heavy[1] = lo, hi
    q = np.concatenate(tiles + [heavy] +
                       [_cube(rng, block_q, dims, (1, 1, 0))] * 2)
    n_runs = len(runs)
    starts = np.array([0, 0, 5, 10, 0, 3, 0], np.int32)
    nblk = np.array([10, 15, 15, n_runs - 10, n_runs, 0, 0], np.int32)
    cands = np.ascontiguousarray(np.concatenate(runs).T)
    croot = rng.integers(0, 9999, cands.shape[1]).astype(np.int32)
    croot[rng.uniform(size=cands.shape[1]) < 0.3] = INT_MAX
    return (q, cands, croot, starts, nblk), kinds


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


def parity_csr_small(E):
    """The shape sweep, pairs at d² = ε² and the float below, nblk = 0
    tiles, and layouts built to be culled (2-D and 3-D, G = 128 and 512):
    box gaps of exactly ε and one f32 step either side, slabs mixing kept
    and skipped runs, a heavy tile split over work items, nblk = 0 tiles
    beside +1e30 tail runs."""
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
    for dims, bq, bk, arrays, kinds, kept in _culled_cases(E):
        per = bk // E.csr.run_width(bk)
        nb3 = int(arrays[4][3]) * per
        check(kept[:4].any() and not kept[:4].all() and
              kept[4].sum() > E.csr.SEG_RUNS and
              not kept[3, nb3 - 3 * per:nb3].any() and
              not kept[4, -3 * per:].any() and not kept[5:].any(),
              f"culled layout {dims}-D, block_k {bk}: kept runs "
              f"{kept.sum(1).tolist()}")
        for eps2 in EQ_BELOW:
            counts, _ = compare_csr(E, arrays, eps2, max_blocks=len(kinds),
                                    block_q=bq, block_k=bk)
            check(int(counts[:bq].sum()) > 0, "culled layout: no hit")


def parity_csr(E, road):
    parity_csr_small(E)
    compare_csr(E, road["csr_args"], road["eps2"], **road["csr_kw"])
    args, eps2, kw, info = road["iono_csr"]
    compare_csr(E, args, eps2, **kw)
    log(f"  csr_sweep, csr_sweep_counts: shape sweep, d² = ε² and the "
        f"float below, nblk = 0, culled layouts (2-D, 3-D; G 128, 512), "
        f"roadnet2d {SUBSET} tiles (max nblk {road['max_nblk']}, max kept "
        f"runs {road['max_kept']}), iono3d {SUBSET} tiles (max nblk "
        f"{info['max_nblk']}, max kept runs {info['max_kept']}): "
        f"bit-identical")


def _culled_cases(E):
    """The culled layouts of parity_csr_small (2-D and 3-D; G = 128 and
    512), each with its block sizes, its kinds of runs and its kept-run
    mask over every tile (csr_sweep.kept_runs_plain at ε² = 9/64)."""
    for dims in (2, 3):
        for bq, bk in ((32, 128), (64, 512)):
            G = E.csr.run_width(bk)
            arrays, kinds = _culled(dims, bq, bk, G, seed=dims)
            kept = E.csr.kept_runs_plain(
                *(E.tensor(arrays[i]) for i in (0, 1, 3, 4)), EQ_BELOW[0],
                max_blocks=len(kinds), block_k=bk).cpu().numpy()
            yield dims, bq, bk, arrays, kinds, kept


def parity_frontier_small(E):
    """The shape sweep with n_active = 0, 1, T/2, T under the park
    contract, pairs at d² = ε² and the float below with an nblk = 0 tile,
    and the culled layouts with their heavy tile live or parked; one call
    under torch.cuda.set_sync_debug_mode("error")."""
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
    kept_slots = []
    for dims, bq, bk, arrays, kinds, kept in _culled_cases(E):
        T = len(arrays[3])
        # the heavy tile (4) first, lattice tiles out of order, the nblk =
        # 0 tiles last; every prefix is a live set
        order = [4, 2, 0, 3, 1, 5, 6]
        for n_active in sorted({0, 1, T // 2, T}):
            active = _park(order[:n_active], T)
            k_rows = E.frontier.kept_runs_plain(
                *(E.tensor(arrays[i]) for i in (0, 1, 3, 4)),
                E.tensor(active), E.tensor(np.array([n_active], np.int32)),
                EQ_BELOW[0], max_blocks=len(kinds), block_k=bk)
            check(np.array_equal(k_rows.cpu().numpy()[:n_active],
                                 kept[order[:n_active]]) and
                  not bool(k_rows[n_active:].any()),
                  "frontier kept runs != the csr kept runs of the live tiles")
            kept_slots.append(int(k_rows.sum()))
            for eps2 in EQ_BELOW:
                out = compare_frontier(E, arrays, active, n_active, eps2,
                                       max_blocks=len(kinds), block_q=bq,
                                       block_k=bk)
                check(bool((out[n_active * bq:] == INT_MAX).all()),
                      "parked frontier slots must hold INT32_MAX")
                check(n_active == 0 or bool((out[:bq] != INT_MAX).any()),
                      "culled layout: the heavy tile found no core hit")
    # n_active read on the device: a host read in the wrapper raises here
    q, cp, croot, st, nb = (E.tensor(x) for x in arrays)
    act = E.tensor(_park(order[:3], T))
    na = E.tensor(np.array([3], np.int32))
    E.torch.cuda.synchronize()
    E.torch.cuda.set_sync_debug_mode("error")
    try:
        k = E.frontier.frontier_sweep(q, cp, croot, st, nb, act, na,
                                      EQ_BELOW[0], max_blocks=len(kinds),
                                      block_q=bq, block_k=bk)
    finally:
        E.torch.cuda.set_sync_debug_mode(0)
    same(E, "frontier_sweep (sync debug)", k, E.frontier.frontier_sweep_plain(
        q, cp, croot, st, nb, act, na, EQ_BELOW[0], max_blocks=len(kinds),
        block_k=bk))
    return kept_slots


def parity_frontier(E, road):
    kept_slots = parity_frontier_small(E)
    compare_frontier(E, *road["frontier_args"], road["eps2"],
                     **road["csr_kw"])
    log(f"  frontier_sweep: shape sweep with n_active = 0, 1, T/2, T (park "
        f"contract), d² = ε² and the float below with an nblk = 0 tile, "
        f"culled layouts (2-D, 3-D; G 128, 512; heavy tile live and parked, "
        f"kept runs per call {kept_slots}), one call under sync debug "
        f"mode \"error\", roadnet2d {SUBSET} active tiles: bit-identical")


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


def _with_padding_tiles(arrays, block_q, n_real):
    """``arrays`` (a culled layout) with two query tiles more whose slab is
    every run: one of ``block_q - n_real`` +1e30 padding rows after
    ``n_real`` rows of tile 0 (the last tile of a padded bucket), and one
    of padding rows alone."""
    q, cp, croot, st, nb = arrays
    tail = np.full((2 * block_q, 3), 1e30, np.float32)
    tail[:n_real] = q[:n_real]
    n_blocks = np.int32(max(nb))
    return (np.concatenate([q, tail]), cp, croot,
            np.concatenate([st, [0, 0]]).astype(np.int32),
            np.concatenate([nb, [n_blocks, n_blocks]]).astype(np.int32))


def parity_cross_small(E):
    """The shape sweep, pairs at d² = ε² and the float below (against
    numpy too), nblk = 0 tiles, and the culled layouts with two tiles of
    +1e30 padding rows more; one call under
    torch.cuda.set_sync_debug_mode("error"). Returns the runs the padding
    tiles keep, per layout."""
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
    pad_kept = []
    for dims, bq, bk, arrays, kinds, _ in _culled_cases(E):
        arrays = _with_padding_tiles(arrays, bq, bq // 2)
        q, cp, croot, st, nb = arrays
        kept = E.csr.kept_runs_plain(
            *(E.tensor(arrays[i]) for i in (0, 1, 3, 4)), EQ_BELOW[0],
            max_blocks=len(kinds), block_k=bk).cpu().numpy()
        pad_kept.append(kept[-2:].sum(1).tolist())
        for eps2 in EQ_BELOW:
            counts, _, mind2 = compare_cross(
                E, (q, cp, croot[None, :], st, nb), eps2,
                max_blocks=len(kinds), block_q=bq, block_k=bk)
            check(int(counts[:bq].sum()) > 0 and
                  bool(E.torch.isfinite(mind2[:bq]).any()),
                  "culled layout: no core hit in tile 0")
    # one call under sync debug mode: a host read in the wrapper raises
    args = [E.tensor(x) for x in (q, cp, croot[None, :], st, nb)]
    E.torch.cuda.synchronize()
    E.torch.cuda.set_sync_debug_mode("error")
    try:
        k = E.cross.cross_sweep(*args, EQ_BELOW[0], max_blocks=len(kinds),
                                block_q=bq, block_k=bk)
    finally:
        E.torch.cuda.set_sync_debug_mode(0)
    p = E.cross.cross_sweep_plain(*args, EQ_BELOW[0], max_blocks=len(kinds),
                                  block_k=bk)
    for what, a, b in zip(("counts", "minroot", "mind2"), k, p):
        same(E, f"cross_sweep {what} (sync debug)", a, b)
    return pad_kept


def parity_cross(E, road):
    pad_kept = parity_cross_small(E)
    args, kw, max_nblk = road["cross"]
    compare_cross(E, args, road["eps2"], **kw)
    log(f"  cross_sweep: shape sweep, d² = ε² and the float below, nblk = 0, "
        f"culled layouts (2-D, 3-D; G 128, 512) with a tile half of +1e30 "
        f"padding rows and one of padding alone (kept runs per layout "
        f"{pad_kept}), one call under sync debug mode \"error\", roadnet2d "
        f"assign of {ASSIGN_Q} fresh points, {SUBSET} of its query tiles "
        f"(max nblk {max_nblk}): counts, minroot and mind2 bit-identical")


def compare_bvh(E, args, eps2, **kw):
    """bvh_batch_sweep against its plain version on the same tensors, all
    three outputs bit for bit; returns the kernel's."""
    args = [E.tensor(x) for x in args]
    k = E.bvhk.bvh_batch_sweep(*args, eps2, **kw)
    p = E.bvhk.bvh_batch_sweep_plain(*args, eps2, **kw)
    for what, a, b in zip(("hit", "minroot", "push"), k, p):
        same(E, f"bvh_batch_sweep {what}", a, b)
    return k


def _bvh_entries(e, dims, seed=6, B=8):
    """The reference's ragged shape sweep (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (e, B, dims)).astype(np.float32)
    a = rng.uniform(-1, 1, (e, dims)).astype(np.float32)
    b = a + rng.uniform(0, 0.5, (e, dims)).astype(np.float32)
    leaf = (rng.uniform(size=e) < 0.5).astype(np.int32)
    dlo = (np.minimum(a, b) - 0.25).astype(np.float32)
    dhi = (np.maximum(a, b) + 0.25).astype(np.float32)
    return [q, dlo, dhi, a, rng.integers(0, 9999, e).astype(np.int32),
            rng.integers(0, 9999, e).astype(np.int32), leaf,
            rng.integers(0, 9999, (e, B)).astype(np.int32)]


def parity_morton(E):
    rng = np.random.default_rng(7)
    for dims, hi in ((2, 1 << 15), (3, 1 << 10)):
        for n in (1, 5, 1_023, 1_000_003):
            c = rng.integers(0, hi, (n, 3)).astype(np.int32)
            edge = np.array([[hi - 1] * 3, [0, 0, 0], [hi, hi + 1, 3 * hi],
                             [-1, -hi, 5], [hi - 1, 0, hi - 1]], np.int32)
            c[:min(n, 5)] = edge[:min(n, 5)]
            t = E.tensor(c)
            same(E, f"morton_encode {dims}D n={n}",
                 E.morton.morton_encode(t, dims=dims),
                 E.morton.morton_encode_plain(t, dims=dims))
    log("  morton_encode: 2-D and 3-D codes, n = 1, 5, 1,023, 1,000,003, "
        "top, zero, over-the-mask and negative coordinates: bit-identical")


def parity_bvh(E, road):
    t = E.torch
    for e in (1, 5, 129, 256, 300):
        for dims in (3, 6):
            args = _bvh_entries(e, dims)
            for bf16 in (False, True):
                boxes = [(args[1], args[2])]
                if bf16:    # bf16 boxes, stored bf16 (as the engine keeps
                    # them) and widened to f32
                    lo = E.bvh._bf16_directed(E.tensor(args[1]), up=False)
                    hi = E.bvh._bf16_directed(E.tensor(args[2]), up=True)
                    boxes = [(lo, hi), (lo.float(), hi.float())]
                for lo, hi in boxes:
                    for payload in (False, True):
                        a = [args[0], lo, hi, *args[3:]]
                        if not payload:     # as the engine passes them
                            a[5] = a[7] = None
                        compare_bvh(E, a, 0.0625, bf16_prune=bf16,
                                    prune_payload=payload)
    # leaf points on the 1/8 lattice at d² ∈ {8, 9, 10}/64 of their queries
    rng = np.random.default_rng(5)
    e, B = 300, 8
    q = rng.integers(-16, 17, (e, B, 3)).astype(np.float32) / 8
    offs = np.array([(2, 2, 0), (2, 0, 2), (0, 2, 2), (3, 0, 0), (0, 0, 3),
                     (2, 2, 1), (1, 2, 2), (3, 1, 0)], np.float32) / 8
    pt = (q[:, 0] + offs[rng.integers(0, len(offs), e)]).astype(np.float32)
    q[:, 1:] = q[:, :1] + rng.integers(-1, 2, (e, B - 1, 3)) / 8
    q = q.astype(np.float32)
    d2 = ((q - pt[:, None]) ** 2).sum(-1)
    check((d2 == np.float32(9 / 64)).sum() > 10, "no pair at d² = ε²")
    args = [q, pt - 1, pt + 1, pt, np.arange(e, dtype=np.int32),
            np.zeros(e, np.int32), np.ones(e, np.int32),
            np.zeros((e, B), np.int32)]
    for eps2 in EQ_BELOW:
        for bf16 in (False, True):
            hit, _, _ = compare_bvh(E, args, eps2, bf16_prune=bf16)
            check(int(hit.sum()) == int((d2 <= np.float32(eps2)).sum()),
                  "boundary hits differ from a numpy count")
    # queries a fraction of a bf16 ulp either side of a bf16 box edge
    e = 64
    lo = t.as_tensor(rng.uniform(-2, 2, (e, 3)).astype(np.float32)) \
        .to(t.bfloat16).float().numpy()
    hi = lo + np.float32(0.5)
    ulp = np.ldexp(np.float32(1), np.frexp(lo[:, 0])[1] - 8) \
        .astype(np.float32)
    off = np.array([-1, -0.5, -0.25, 0, 0.25, 0.5, 1, 2], np.float32)[
        np.arange(e) % 8]
    q = np.repeat(((lo + hi) / 2)[:, None, :], B, axis=1).astype(np.float32)
    q[:, :, 0] = (lo[:, 0] + off * ulp)[:, None]
    args = [q, lo, hi, lo, np.arange(e, dtype=np.int32),
            np.zeros(e, np.int32), np.zeros(e, np.int32),
            np.ones((e, B), np.int32)]
    pushes = {bf16: compare_bvh(E, args, 0.01, bf16_prune=bf16)[2]
              .cpu().numpy().astype(bool) for bf16 in (False, True)}
    check(np.array_equal(pushes[False], off >= 0) and
          pushes[True].sum() > pushes[False].sum() and
          (pushes[True] >= pushes[False]).all(),
          "the prune one bf16 ulp from a box edge is not as expected")
    # dead entries: box lo +BIG, hi -BIG, query -BIG, payload MAX, leaf 0
    args = _bvh_entries(40, 3, seed=9)
    dead = np.arange(40) % 3 == 0
    args[0][dead], args[1][dead], args[2][dead] = -1e30, 1e30, -1e30
    args[4][dead], args[5][dead], args[6][dead] = INT_MAX, INT_MAX, 0
    for payload in (False, True):
        hit, mr, push = compare_bvh(E, args, 0.0625, prune_payload=payload)
        rows = t.as_tensor(dead, device=E.dev)
        check(not bool(hit[rows].any()) and not bool(push[rows].any()) and
              bool((mr[rows] == INT_MAX).all()),
              "a dead entry hit or pushed")
    # 64 seeded slices of the widest level of the full-size exact sweep
    level, live, calls = road["bvh_batch_level"]
    kw = calls[0][1]
    args = [None if calls[0][0][i] is None else
            t.cat([a[i] for a, _ in calls]) for i in range(8)] + \
        [calls[0][0][8]]
    n_e = args[0].shape[0]
    w = min(ENTRIES_PER_SLICE, n_e)
    starts = np.sort(np.random.default_rng(0).choice(
        n_e - w + 1, min(SUBSET, n_e - w + 1), replace=False))
    idx = t.as_tensor((starts[:, None] + np.arange(w)[None]).reshape(-1),
                      device=E.dev)
    compare_bvh(E, [None if a is None else a[idx].contiguous()
                    for a in args[:8]], args[8], **kw)
    log(f"  bvh_batch_sweep: shape sweep (E = 1, 5, 129, 256, 300; D = 3, "
        f"6; both prune dtypes, bf16 boxes stored bf16 and widened to f32; "
        f"both payload modes), d² = ε² and the float "
        f"below, queries within a bf16 ulp of a box edge, dead entries, "
        f"roadnet2d {len(starts)} slices of {w} entries of level {level} "
        f"(the widest: {live} live entries, {n_e} kernel entries) of the "
        "exact traversal: bit-identical")


def hash_args(eng, core, root):
    """hash_sweep's inputs for a grid-hash engine and a payload."""
    st, g = eng.state, eng.state.grid
    return (st.points, g.order, st.buckets, st.cell_valid, g.points, g.index,
            st.occupancy, core, root)


def hash_sweep_a(E, args, eps2):
    """The A side of hash_sweep: its plain version's padded windows through
    the gathered_sweep kernel (the grid-hash sweep before hash_sweep)."""
    return E.gathered.sweep_windows(E.gathered.gathered_sweep, *args, eps2)


def compare_hash(E, args, eps2, what: str):
    """hash_sweep against its plain version and its A side on the same
    tensors, both outputs bit for bit; returns the kernel's."""
    k = E.gathered.hash_sweep(*args, eps2)
    p = E.gathered.hash_sweep_plain(*args, eps2)
    a = hash_sweep_a(E, args, eps2)
    for i, w in enumerate(("counts", "minroot")):
        same(E, f"hash_sweep {w} ({what})", k[i], p[i])
        same(E, f"hash_sweep {w} vs the gathered_sweep path ({what})", k[i],
             a[i])
    return k


def _payload(E, n, seed):
    """A seeded payload: core (n,) bool, root (n,) int32."""
    rng = np.random.default_rng(seed)
    return (E.tensor(rng.uniform(size=n) < 0.5),
            E.tensor(rng.integers(0, n, n).astype(np.int32)))


def parity_hash(E):
    """hash_sweep on the reduced datasets, on a table of 64 buckets (every
    window aliased), and on 1/8 lattices at d² = ε² and the float below."""
    t = E.torch
    for name, n, eps, _ in REDUCED_FUSED:
        pts = E.tensor(E.repro_torch.synth.load(name, n, seed=0))
        eng = E.repro_torch.make_engine(pts, eps, engine="grid-hash")
        compare_hash(E, hash_args(eng, *_payload(E, n, 1)), float(eps) ** 2,
                     f"{name} n={n}")
    pts = E.repro_torch.synth.load("roadnet2d", 2_000, seed=1)
    spec = E.grid.plan_grid(pts, 0.05, dims=2, max_table_size=64)
    eng = E.repro_torch.make_engine(pts, 0.05, engine="grid-hash", spec=spec)
    aliased = int((~eng.state.cell_valid).sum())
    check(aliased > 0, "no aliased bucket in a table of 64")
    compare_hash(E, hash_args(eng, *_payload(E, 2_000, 2)), 0.05 ** 2,
                 "H = 64")
    rng = np.random.default_rng(3)
    for dims in (2, 3):
        q = rng.integers(0, 33, (3_000, 3)).astype(np.float32) / 8
        if dims == 2:
            q[:, 2] = 0
        eng = E.repro_torch.make_engine(q, 3 / 8, engine="grid-hash",
                                        dims=dims)
        d2 = ((q[:300, None, :] - q[None, :, :]) ** 2).sum(-1)
        check((d2 == np.float32(9 / 64)).any(), "no pair at d² = ε²")
        for eps2 in EQ_BELOW:
            k = compare_hash(E, hash_args(eng, *_payload(E, 3_000, 4)), eps2,
                             f"{dims}-D lattice, ε² = {eps2}")
            check(t.equal(k[0][:300].cpu(), t.as_tensor(
                (d2 <= np.float32(eps2)).sum(1).astype(np.int32))),
                "lattice counts differ from a numpy count")
    log(f"  hash_sweep: {', '.join(f'{a} n={b}' for a, b, _, _ in REDUCED_FUSED)}"
        f", a table of 64 buckets ({aliased} aliased window cells), 2-D and "
        "3-D 1/8 lattices at d² = ε² and the float below: bit-identical to "
        "the plain version and to the gathered_sweep path")


class LevelChecker:
    """While active, every bvh_level launch also runs the plain version on
    a copy of the state it was given, and the two must agree bit for bit:
    counts, minroot, the next frontier (its entries that the level wrote),
    the live counts, the overflow flag and the histogram. Per level it
    records the live parents, the distinct query blocks they read, their
    leaf and internal children and the pushes (for the bytes bound), and
    the plain version's ms (CUDA events)."""

    def __init__(self, E):
        self.E, self.levels = E, []

    def __enter__(self):
        E, t = self.E, self.E.torch
        self.real = E.bvhk.bvh_level

        def level(inputs, state, lvl, eps2, **kw):
            plain = E.bvhk.LevelState._make(
                None if x is None else x.clone() for x in state)
            n_live = int(state.nlive[lvl])
            n_int = inputs.pts.shape[0] - 1
            fn = state.fn[lvl % 2, :n_live].long()
            leaves = int((inputs.left[fn] >= n_int).sum()
                         + (inputs.right[fn] >= n_int).sum())
            blocks = state.fb[lvl % 2, :n_live].unique().numel()
            self.real(inputs, state, lvl, eps2, **kw)
            a, b = (t.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            E.bvhk.bvh_level_plain(inputs, plain, lvl, eps2, **kw)
            b.record()
            nxt = int(plain.nlive[lvl + 1])
            wrote = state.fb.shape[1] if kw.get("stop_on_overflow") and \
                bool(plain.overflow[0]) and nxt == 0 else nxt
            dst = (lvl + 1) % 2
            outs = {f: (getattr(state, f), getattr(plain, f)) for f in
                    ("counts", "minroot", "nlive", "overflow", "hist")}
            outs.update({f: (getattr(state, f)[dst, :wrote],
                             getattr(plain, f)[dst, :wrote])
                         for f in ("fb", "fn")})
            err = max_err(*zip(*outs.values()))
            for f, (k, p) in outs.items():
                same(E, f"bvh_level {f} (level {lvl})", k, p)
            if n_live:
                self.levels.append(dict(
                    level=lvl, parents=n_live, blocks=blocks, leaves=leaves,
                    internal=2 * n_live - leaves, pushes=nxt,
                    plain_ms=a.elapsed_time(b), err=err))

        E.bvhk.bvh_level = level
        return self

    def __exit__(self, *exc):
        self.E.bvhk.bvh_level = self.real


def level_bytes(lv, *, batch, dims, box_bytes, payload: bool,
                per_entry_queries: bool = False) -> int:
    """Bytes one fused level must move: per parent entry its frontier ids
    (8) and its children's ids (8); each distinct query block it reads
    once (4·B·D), and in payload mode its bounds (4·B); per internal child
    its box (2·box_bytes·D) and in payload mode its payload min (4); per
    leaf child its point and payload (4·D + 4); 8 per push written. With
    ``per_entry_queries`` the query block (and bounds) count once per
    parent entry instead, as the per-entry kernel reads them."""
    per_block = 4 * batch * dims + (4 * batch if payload else 0)
    reads = lv["parents"] if per_entry_queries else lv["blocks"]
    per_internal = 2 * box_bytes * dims + (4 if payload else 0)
    return (16 * lv["parents"] + reads * per_block
            + lv["internal"] * per_internal
            + lv["leaves"] * (4 * dims + 4) + 8 * lv["pushes"])


def check_fused_sweep(E, tree, croot, what: str, **kw):
    """One traversal by the fused level, every level held to its plain
    version (LevelChecker), and its outputs to the per-entry kernel's
    level loop (the A side): counts, minroot, overflow and histogram.
    Returns the checker's levels."""
    with LevelChecker(E) as chk:
        f = E.bvh.wavefront_sweep_fused(tree, tree.pts_sorted, croot, **kw)
    a = E.bvh.wavefront_sweep_plain(tree, tree.pts_sorted, croot, **kw)
    for w, x, y in zip(("counts", "minroot", "hist"), (f[0], f[1], f[3]),
                       (a[0], a[1], a[3])):
        same(E, f"bvh_level traversal {w} vs the bvh_batch_sweep loop "
             f"({what})", x, y)
    check(f[2] == a[2], f"bvh_level traversal overflow {f[2]} != {a[2]} "
          f"({what})")
    return chk.levels, f[2]


def bvh_cases(E, eng, croot, bound):
    """(label, keywords) of the traversals held to the A side on a built
    bvh engine: exact, terminated, an overflowing capacity, and a probe
    that stops at the overflow."""
    spec = eng.meta
    kw = dict(eps=spec.eps, eps2=spec.eps ** 2, capacity=spec.capacity,
              tile=spec.tile, batch=spec.batch, prune_dtype=spec.prune_dtype,
              max_levels=spec.max_levels)
    small = max(spec.capacity // 4 // spec.tile, 1) * spec.tile
    return [("exact", kw), ("terminated", dict(kw, bound=bound)),
            ("capacity / 4", dict(kw, capacity=small)),
            ("probe at capacity / 4", dict(kw, capacity=small,
                                           stop_on_overflow=True))]


def parity_bvh_level(E):
    """The fused traversal on the reduced datasets (D = 2 and 3), each level
    against bvh_level_plain and the whole against the bvh_batch_sweep
    loop: exact, terminated, overflowing and stopping at the overflow,
    with bf16 and f32 prune boxes."""
    done = []
    for name, n, eps, dims in REDUCED_FUSED[:2]:
        pts = E.tensor(E.repro_torch.synth.load(name, n, seed=0))
        E.bvh._SPEC_CACHE.clear()
        eng = E.repro_torch.make_engine(pts, eps, engine="bvh")
        core, root = _payload(E, n, 5)
        croot = E.ops.fuse_core_root(core, root)
        bound = E.tensor(np.random.default_rng(6).integers(
            0, n, n).astype(np.int32))
        for label, kw in bvh_cases(E, eng, croot, bound):
            for prune in ("bf16", "f32"):
                levels, ovf = check_fused_sweep(
                    E, eng.state.bvh, croot, f"{name} {label} {prune}",
                    **dict(kw, prune_dtype=prune))
                done.append((name, label, prune, len(levels), ovf))
        check(any(o for *_, o in done), "no traversal overflowed")
    log(f"  bvh_level: {REDUCED_FUSED[0][0]} and {REDUCED_FUSED[1][0]} "
        f"n={REDUCED_FUSED[0][1]} (D = 2, 3), exact, terminated, capacity / 4"
        f" and a probe stopping there, bf16 and f32 boxes; every level "
        f"(counts, minroot, frontier, live counts, overflow, histogram) "
        f"bit-identical to bvh_level_plain, every traversal to the "
        f"bvh_batch_sweep loop: (dataset, case, prune, levels, overflow) "
        f"{done}")


class CallRecorder:
    """Keeps the arguments of the calls of ``module.attr`` (references, no
    copies and no launches of its own) while active: of every call, or of
    the calls whose index (0 for the first) ``keep`` accepts."""

    def __init__(self, module, attr: str, keep=None):
        self.module, self.attr, self.calls = module, attr, []
        self.keep, self.seen = keep, 0
        self.real = getattr(module, attr)

    def __enter__(self):
        def record(*args, **kw):
            if self.keep is None or self.keep(self.seen):
                self.calls.append((args, kw))
            self.seen += 1
            return self.real(*args, **kw)
        setattr(self.module, self.attr, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


class BVHRecorder:
    """While active, records the work of a BVH path: each wavefront sweep
    (host seconds ending in a synchronize, whether it is a calibration
    probe, its level histogram, and per bvh_level launch a pair of CUDA
    events around it), and the build's lbvh_keys input. The events and the
    synchronizes launch no kernel."""

    def __init__(self, E):
        self.E, self.sweeps = E, []
        self.keys_rec = CallRecorder(E.lbvh, "lbvh_keys",
                                     keep=lambda i: i == 0)

    def __enter__(self):
        E, t = self.E, self.E.torch
        self.real = (E.bvh.wavefront_sweep, E.bvhk.bvh_level)
        real_sweep, real_kernel = self.real

        def sweep(*args, **kw):
            rec = dict(probe=bool(kw.get("stop_on_overflow")), calls=[])
            self.sweeps.append(rec)
            t0 = time.perf_counter()
            out = real_sweep(*args, **kw)
            t.cuda.synchronize()
            rec["wall"] = time.perf_counter() - t0
            rec["hist"] = out[3].cpu().numpy()
            # one launch a level, and at most one more that finds the
            # live count 0 and returns at once
            levels = int((rec["hist"] >= 0).sum())
            check(levels <= len(rec["calls"]) <= levels + 1,
                  f"{len(rec['calls'])} bvh_level launches for {levels} "
                  "levels")
            return out

        def kernel(*args, **kw):
            ev = (t.cuda.Event(enable_timing=True),
                  t.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real_kernel(*args, **kw)
            ev[1].record()
            self.sweeps[-1]["calls"].append(ev)
            return out

        E.bvh.wavefront_sweep, E.bvhk.bvh_level = sweep, kernel
        self.keys_rec.__enter__()
        return self

    def __exit__(self, *exc):
        self.keys_rec.__exit__(*exc)
        self.E.bvh.wavefront_sweep, self.E.bvhk.bvh_level = self.real

    @property
    def keys(self):
        """(args, kw) of the run's first lbvh_keys call."""
        return self.keys_rec.calls[0]

    @property
    def probes(self) -> int:
        return sum(r["probe"] for r in self.sweeps)

    def exact_levels(self) -> list:
        """Live entries per level of the first sweep that is not a probe."""
        h = next(r["hist"] for r in self.sweeps if not r["probe"])
        return h[h >= 0].tolist()

    def per_sweep(self) -> list:
        """Per sweep that is not a probe: host seconds, bvh_level ms (CUDA
        events), launches, parent entries, levels."""
        out = []
        for r in self.sweeps:
            if r["probe"]:
                continue
            live = r["hist"][r["hist"] >= 0]
            out.append(dict(
                wall=r["wall"], launches=len(r["calls"]),
                kernel_ms=sum(a.elapsed_time(b) for a, b in r["calls"]),
                entries=int(live.sum()), levels=len(live)))
        return out


def widest_level_calls(E, run_plain, kw):
    """Runs ``run_plain`` (one exact sweep by the per-entry kernel's level
    loop, ``wavefront_sweep_plain`` with keywords ``kw``) twice: once to
    find its widest level, then keeping the (args, kw) of each
    bvh_batch_sweep launch of that level. Returns (level, live entries,
    launches)."""
    hist = run_plain()[3].cpu().numpy()
    live = hist[hist >= 0]
    tile = min(kw.get("tile", 8192), kw["capacity"])
    step = max(tile, (E.bvh._LEVEL_ENTRIES // tile) * tile)
    per_level = [-(-int(f) // step) for f in live]
    level = int(np.argmax(live))
    first = sum(per_level[:level])
    want = range(first, first + per_level[level])
    with CallRecorder(E.bvhk, "bvh_batch_sweep",
                      keep=want.__contains__) as kept:
        run_plain()
    check(kept.seen == sum(per_level),
          f"{kept.seen} bvh_batch_sweep launches for levels {live.tolist()}"
          f" at {step} entries a launch")
    return level, int(live[level]), kept.calls


def fresh(E, name, n_corpus, m, seed):
    """``m`` fresh points of the world of the corpus ``synth.load(name,
    n_corpus, seed=0)``: the same road graph (or layer sheets), other
    samples."""
    return E.repro_torch.synth.load(name, m, seed=seed, structure_seed=0,
                                    structure_n=n_corpus)


def tile_subset(E, args, kw, seed, also=()):
    """``SUBSET`` seeded query tiles of a slab-sweep call's inputs (the
    widest and the tiles ``also`` among them), as (q, cands, croot,
    starts_blk, nblk), with the widest nblk and the tile ids."""
    q, cp, croot, st, nb = args[:5]
    bq = kw["block_q"]
    T = st.shape[0]
    nb_np = nb.cpu().numpy()
    must = sorted({int(nb_np.argmax()), *(int(t) for t in also)})
    others = np.setdiff1d(np.arange(T), must)
    rng = np.random.default_rng(seed)
    tiles = np.sort(np.concatenate([must, rng.choice(
        others, min(SUBSET - len(must), len(others)), replace=False)]))
    idx = E.torch.as_tensor(tiles, device=q.device)
    return (q.view(T, bq, 3)[idx].reshape(-1, 3).contiguous(), cp, croot,
            st[idx].contiguous(), nb[idx].contiguous()), int(nb_np.max()), \
        tiles


def grid_subset(E, eng, eps2, seed):
    """``SUBSET`` tiles of a grid engine's slab sweep with a seeded payload
    (the widest slab and the most kept runs among them), their kw, the
    tile ids, and the widest nblk and most kept runs of the whole grid."""
    t = E.torch
    g, spec = eng.state, eng.meta
    rng = np.random.default_rng(seed)
    croot = t.as_tensor(rng.integers(0, spec.n, spec.n_cand).astype(np.int32),
                        device=E.dev)
    croot[t.as_tensor(rng.uniform(size=spec.n_cand) < 0.5, device=E.dev)] = \
        INT_MAX
    kw = dict(max_blocks=spec.slab // spec.block_k, block_q=spec.chunk,
              block_k=spec.block_k)
    full = (g.q_sorted, g.cands, croot, (g.starts // spec.block_k).to(
        t.int32), g.nblk)
    n_kept = E.csr.kept_runs_plain(
        *full[:2], *full[3:], eps2, max_blocks=kw["max_blocks"],
        block_k=spec.block_k).sum(1)
    sub, max_nblk, tiles = tile_subset(E, full, kw, seed,
                                       also=[int(n_kept.argmax())])
    return sub, kw, tiles, full, dict(max_nblk=max_nblk,
                                      max_kept=int(n_kept.max()))


def road_layouts(E):
    """Seeded subsets of the full-size roadnet2d layouts, as kernel inputs:
    64 grid tiles (the widest slab and the most kept runs among them), 64
    frontier slots, 64 query tiles against every candidate, 64 grid-hash
    chunks; and 64 grid tiles of the full-size iono3d layout."""
    t = E.torch
    name, n, eps, _ = FULL[0]
    pts = E.repro_torch.synth.load(name, n, seed=0)
    eng = E.repro_torch.make_engine(pts, eps)
    road = dict(eps2=float(eps) ** 2)
    road["csr_args"], road["csr_kw"], tiles, full, info = grid_subset(
        E, eng, road["eps2"], seed=0)
    road.update(info)
    q, cands, croot = road["csr_args"][:3]
    road["frontier_args"] = (full, _park(tiles, eng.meta.n_tiles),
                             len(tiles))
    road["pairwise_args"] = (q, cands, croot)
    rng = np.random.default_rng(0)
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
    sub, max_nblk, _ = tile_subset(E, args, kw, seed=0)
    road["cross"] = (sub, dict(max_blocks=kw["max_blocks"],
                               block_q=kw["block_q"],
                               block_k=kw["block_k"]), max_nblk)
    # SUBSET tiles of the full-size iono3d grid
    i_name, i_n, i_eps, _ = FULL[1]
    i_eng = E.repro_torch.make_engine(
        E.repro_torch.synth.load(i_name, i_n, seed=0), i_eps)
    i_args, i_kw, _, _, i_info = grid_subset(E, i_eng, float(i_eps) ** 2,
                                             seed=1)
    road["iono_csr"] = (i_args, float(i_eps) ** 2, i_kw, i_info)
    del i_eng
    # the widest level of the exact wavefront traversal (no payload) by the
    # per-entry kernel's level loop
    tree = E.bvh.build_bvh(E.tensor(pts), dims=2)
    payload = t.full((n,), INT_MAX, dtype=t.int32, device=E.dev)
    kw = dict(eps=eps, eps2=float(eps) ** 2, capacity=1 << 30)
    road["bvh_batch_level"] = widest_level_calls(
        E, lambda: E.bvh.wavefront_sweep_plain(tree, tree.pts_sorted, payload,
                                               **kw), kw)
    return road


def phase_parity(E):
    road = road_layouts(E)
    parity_csr(E, road)
    parity_frontier(E, road)
    parity_pairwise(E, road)
    parity_gathered(E, road)
    parity_cross(E, road)
    parity_morton(E)
    parity_bvh(E, road)
    parity_hash(E)
    parity_bvh_level(E)


# --------------------------------------------------------------------------
# the LBVH build: the card's build against its plain versions


def same_bits(E, what: str, k, p) -> None:
    """``same`` on the bits of a float output: -0.0 and +0.0 differ."""
    t = E.torch
    if k.dtype == t.float32:
        k, p = k.view(t.int32), p.view(t.int32)
    same(E, what, k, p)


def lbvh_extent(E, pts, lo, hi):
    """build_bvh's quantization extent: the override, else the points'."""
    t = E.torch
    if lo is None or hi is None:
        amin, amax = t.aminmax(pts, dim=0)
    return (amin if lo is None else t.as_tensor(lo, device=pts.device),
            amax if hi is None else t.as_tensor(hi, device=pts.device))


def plain_build(E, pts, dims, lo, hi):
    """build_bvh by the plain versions of its kernels, on the same tensors:
    ({BVH field: tensor}, the plain Nodes)."""
    L = E.lbvh
    lo_t, hi_t = lbvh_extent(E, pts, lo, hi)
    codes = L.lbvh_keys_plain(pts, lo_t, hi_t, dims=min(dims, 3))
    codes, order = E.torch.sort(codes, stable=True)
    nodes = L.lbvh_nodes_plain(codes)
    fit = L.lbvh_refit_plain(pts, order, nodes)
    return dict(nodes._asdict(), **fit._asdict()), nodes


def check_build(E, pts, dims, lo, hi, what: str):
    """build_bvh and max_leaf_depth of ``pts`` on the card, one launch of
    each LBVH kernel, every BVH field bitwise and the depth equal to the
    plain versions' on the same tensors. Returns the depth."""
    E.lbvh.reset_launches()
    tree = E.bvh.build_bvh(pts, dims=dims, lo=lo, hi=hi)
    depth = E.bvh.max_leaf_depth(tree.left, tree.right)
    check(set(E.lbvh.LAUNCHES.values()) == {1},
          f"{what}: LBVH launches {E.lbvh.LAUNCHES}")
    plain, nodes = plain_build(E, pts, dims, lo, hi)
    for f in E.bvh.BVH._fields:
        same_bits(E, f"{what} {f}", getattr(tree, f), plain[f])
    want = int(E.lbvh.lbvh_depth_plain(nodes.left, nodes.right)[0])
    check(depth == want, f"{what}: max_leaf_depth {depth} != plain {want}")
    return depth


def lbvh_edge_cases():
    """(what, points, dims, lo, hi) of the build parity's edge cases."""
    rng = np.random.default_rng(18)
    out = []
    for n in LBVH_EDGE_N:
        for d, dims in ((3, 3), (3, 2), (2, 2), (4, 4)):
            p = rng.uniform(-1, 1, (n, d)).astype(np.float32)
            if dims < d:
                p[:, 2] = 0          # 2-D data in (n, 3)
            out.append((f"n={n} D={d} dims={dims}", p, dims, None, None))
    m = 1_023
    out.append(("all equal", np.tile(np.float32([[0.25, -3.0, 7.5]]),
                                     (m, 1)), 3, None, None))
    out.append(("duplicates", rng.uniform(-1, 1, (50, 3)).astype(
        np.float32)[rng.integers(0, 50, 4_097)], 3, None, None))
    sent = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    lo, hi = sent[:900].min(0), sent[:900].max(0)
    sent[900:] = 1e30
    out.append(("+1e30 sentinels, lo/hi override", sent, 3, lo, hi))
    zeros = np.stack(
        [rng.choice(np.float32([-0.0, 0.0, 1, 2]), m),
         rng.choice(np.float32([-0.0, 0.0, -1, -2]), m),
         rng.choice(np.float32([-0.0, 0.0]), m)], axis=1)
    out.append(("signed zeros", zeros, 3, None, None))
    out.append(("signed zeros 2-D", np.ascontiguousarray(zeros[:, :2]), 2,
                None, None))
    return out


def host_ms(E, fn, reps: int = 5):
    """(median, all) host ms of ``fn`` ending in a synchronize, over
    ``reps`` calls after a warm-up."""
    fn()
    E.torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        E.torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs), runs


def phase_lbvh(E):
    t = E.torch
    cases = lbvh_edge_cases()
    for what, p, dims, lo, hi in cases:
        check_build(E, E.tensor(p), dims, lo, hi, f"LBVH {what}")
    log(f"  build_bvh and max_leaf_depth: {len(cases)} edge cases (n = "
        f"{', '.join(map(str, LBVH_EDGE_N))} at D = 2, 3, 4 and 2-D in "
        "(n, 3); all points equal, duplicates, +1e30 sentinels under a "
        "lo/hi override, signed zeros), every BVH field bitwise and the "
        "depth equal to the plain versions'")
    E.lbvh_stats = {}
    for name, n, _, _ in FULL:
        pts = t.as_tensor(E.repro_torch.synth.load(name, n, seed=0),
                          device=E.dev)
        dims = E.bvh._infer_dims(pts)
        depth = check_build(E, pts, dims, None, None, f"LBVH {name} n={n}")
        tree_ms, tree_runs = host_ms(E, lambda: E.bvh._tree(pts, None))
        tree = E.bvh.build_bvh(pts, dims=dims)
        depth_ms, _ = host_ms(
            E, lambda: E.bvh.max_leaf_depth(tree.left, tree.right))
        plain_ms, _ = host_ms(E, lambda: plain_build(E, pts, dims, None,
                                                     None), reps=1)
        _, rows = profile_device(E, lambda: E.bvh.build_bvh(pts, dims=dims))
        short = [(r[0].replace("void ", "")
                  .replace("(anonymous namespace)::", "")
                  .split("(")[0].split("<")[0].strip(), round(r[1], 4), r[2])
                 for r in rows]
        kern = sum(r[2] for r in rows
                   if not r[0].startswith(("Memcpy", "Memset")))
        ops = sum(r[2] for r in rows)
        sort_ops = sum(c for k, _, c in short
                       if "RadixSort" in k or "reverse_indices" in k
                       or k.startswith(("Memcpy DtoD", "Memset")))
        E.lbvh_stats[name] = dict(tree_ms=tree_ms, kernels=kern, ops=ops)
        log(f"  {name} n={n} dims={dims}: build_bvh on the card = the plain "
            f"versions, every field bitwise; max_leaf_depth {depth} = plain."
            f" The engines' build (_tree) {tree_ms:.3f} ms on the host "
            f"(median of 5: {[round(x, 3) for x in tree_runs]}), "
            f"max_leaf_depth {depth_ms:.3f} ms, the plain build "
            f"{plain_ms:.1f} ms. One build_bvh (torch.profiler): {kern} "
            f"kernel launches, {ops} device operations (the sort "
            f"{sort_ops}), {sum(r[1] for r in rows):.3f} ms of device time")
        log(f"    device operations of one build (name, ms, count): "
            + json.dumps(short))


# --------------------------------------------------------------------------
# phases 4 and 5: the whole path


def hist_txt(res) -> str:
    """The frontier histogram of a result, for the log ("" without one)."""
    if res.frontier_tiles is None:
        return ""
    return f", frontier tiles {res.frontier_tiles[:res.n_rounds].tolist()}"


def n_clusters(labels) -> int:
    return int(labels[labels >= 0].unique().numel())


def assert_same_result(E, a, b, what: str, rounds: bool = True,
                       clip: int | None = None) -> None:
    """``b`` equal to ``a``; with ``clip``, ``b``'s counts are ``a``'s
    clipped at ``clip`` (FDBSCAN's early-exit stage 1)."""
    for f in ("labels", "core", "counts"):
        x = getattr(a, f).cpu()
        if f == "counts" and clip is not None:
            x = x.clamp(max=clip)
        check(E.torch.equal(x, getattr(b, f).cpu()), f"{what}: {f} differ")
    if rounds:
        check(a.n_rounds == b.n_rounds,
              f"{what}: n_rounds {a.n_rounds} != {b.n_rounds}")
        fa, fb = a.frontier_tiles, b.frontier_tiles
        check((fa is None) == (fb is None) and
              (fa is None or E.torch.equal(fa.cpu(), fb.cpu())),
              f"{what}: frontier_tiles differ")


def run_path(E, kw, pts, eps, min_pts, device=None):
    """(engine, result) of one path through the entry points a user calls
    (``make_engine`` then ``dbscan``; for FDBSCAN ``fdbscan.run``, whose
    engines stay inside it: engine None)."""
    if kw.get("early_exit"):
        return None, E.fdbscan.run(pts, eps, min_pts, early_exit=True,
                                   device=device)
    eng = E.repro_torch.make_engine(pts, eps, engine=kw["engine"],
                                    device=device)
    return eng, E.repro_torch.dbscan(pts, eps, min_pts, eng=eng,
                                     hook_loop=kw.get("hook_loop", "device"))


def phase_reduced(E):
    phase_reduced_serve(E)
    for name, eps, min_pts in REDUCED:
        pts = E.repro_torch.synth.load(name, REDUCED_N, seed=0)
        first = None
        for path, (kw, _) in PATHS.items():
            E.bvh._SPEC_CACHE.clear()     # each build calibrates its own
            t0 = time.perf_counter()
            c_eng, cpu = run_path(E, kw, pts, eps, min_pts, device="cpu")
            t1 = time.perf_counter()
            E.bvh._SPEC_CACHE.clear()
            g_eng, gpu = run_path(E, kw, pts, eps, min_pts)
            E.torch.cuda.synchronize()
            t2 = time.perf_counter()
            what = f"{name} n={REDUCED_N} eps={eps} {path}"
            assert_same_result(E, cpu, gpu, f"{what} cpu vs cuda")
            spec = ""
            if kw["engine"] == "bvh":
                check(c_eng.meta == g_eng.meta, f"{what}: WavefrontSpec "
                      f"{c_eng.meta} (cpu) != {g_eng.meta} (cuda)")
                spec = (f", spec capacity {g_eng.meta.capacity} peak "
                        f"{g_eng.meta.peak} equal")
            if first is None:
                first = gpu
            assert_same_result(E, first, gpu, f"{what} vs grid/device",
                               rounds=False,
                               clip=min_pts if kw.get("early_exit") else None)
            log(f"  {what}: bit-identical, n_rounds "
                f"{gpu.n_rounds}{hist_txt(gpu)}{spec}, clusters "
                f"{n_clusters(gpu.labels)}, noise "
                f"{int((gpu.labels == -1).sum())}; cpu {t1 - t0:.2f} s,"
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
        log(f"  {name} n={NEIGHBORS_N} eps={eps} find_neighbors (k_max 32), "
            f"grid / "
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
                regrows=sched.regrows, snap=snap, q=q_np, chunks=chunks,
                answer=a)


def tier_global(E, tier):
    """The tier's labels and core in canonical corpus order, reassembled
    from its shards through their label tables."""
    n = sum(p.n for p in tier.parts)
    lab = np.full(n, -2, np.int64)
    core = np.zeros(n, bool)
    for p in tier.parts:
        loc = p.snapshot.labels.cpu().numpy()
        g = np.full(len(loc), -1, np.int64)
        if p.label_table.size:
            m = loc >= 0
            g[m] = p.label_table.astype(np.int64)[loc[m]]
        lab[p.orig_index] = g
        core[p.orig_index] = p.snapshot.core.cpu().numpy()
    check((lab != -2).all(), "tier: shard rows do not partition the corpus")
    return lab, core


def restricted_merge(E, tier, q, alive):
    """The full merge minus the missing shards: per-shard single-snapshot
    assigns of the routed queries and the router's remap and merge."""
    mask = tier.map.window_shards(q)
    big = np.iinfo(np.int64).max
    counts = np.zeros(len(q), np.int32)
    merged = np.full(len(q), big, np.int64)
    dist = np.full(len(q), np.inf, np.float32)
    for j in alive:
        idx = np.nonzero(mask[:, j])[0]
        if idx.size == 0:
            continue
        r = E.serve.assign(tier.parts[j].snapshot, q[idx])
        table = tier.parts[j].label_table.astype(np.int64)
        glab = (np.where(r.labels >= 0, table[np.clip(r.labels, 0, None)],
                         big) if table.size else np.full(idx.size, big))
        merged[idx] = np.minimum(merged[idx], glab)
        counts[idx] += r.counts
        dist[idx] = np.minimum(dist[idx], r.dist)
    labels = np.where(merged != big, merged, -1).astype(np.int32)
    return labels, counts, dist


def tier_full(E, name, n, eps, min_pts, pts_np, sv):
    """The sharded tier at full size, on the serve path's snapshot: split
    into TIER_SHARDS shards, a replica of shard 0, warmup; an assign of the
    serve path's fresh points (bit-identical to the single-session assign);
    the serve path's ingests until the tier compacts once; shard TIER_DOWN
    forced down (a partial assign, the exact restriction to the live
    shards), recovered (bit-identical again); a hedged leg on shard 0 (the
    same bits as an unhedged one). Launch counts cover exactly this; the
    checks after it launch nothing that is counted."""
    t = E.torch
    snap, q_np, single = sv["snap"], sv["q"], sv["answer"]
    steps = {}

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        t.cuda.synchronize()
        steps[label] = time.perf_counter() - t0
        return out

    t.cuda.synchronize()
    E.reset_launches()
    t_start = time.perf_counter()
    tier = step("split", lambda: E.serve.ShardedTier.from_snapshot(
        snap, n_shards=TIER_SHARDS, delta_capacity=DELTA_CAP // TIER_SHARDS,
        max_delta_frac=np.inf, auto_recover=False))
    try:
        check(tier.n_shards == TIER_SHARDS,
              f"{name} tier: {tier.n_shards} shards, not {TIER_SHARDS}")
        step("replicate", lambda: tier.replicate(0, 1))
        step("warmup", lambda: tier.warmup())
        tier.scheduler.reset_stats()
        full = step("assign", lambda: tier.assign(q_np))
        routed = dict(sorted(tier.scheduler.routed.items()))
        ingest_s, k = [], 0
        for c in sv["chunks"]:
            res = step("ingest", lambda: tier.ingest(c))
            ingest_s.append(steps["ingest"])
            k += 1
            if tier.n_compactions:
                break
        check(tier.n_compactions == 1, f"{name} tier: {tier.n_compactions} "
              f"compactions after {k} ingests")
        folded = tier.n_baseline - n
        after = step("assign_compacted", lambda: tier.assign(q_np))
        tier.health.force_down((TIER_DOWN, 0))
        part = step("assign_partial", lambda: tier.assign(q_np))
        ok = step("recover_shard", lambda: tier.recover_shard(TIER_DOWN))
        back = step("assign_recovered", lambda: tier.assign(q_np))
        aimed = q_np[tier.map.window_shards(q_np)[:, 0]]
        plain = step("assign_unhedged", lambda: tier.assign(aimed))
        tier.health.record_failure((0, 0))          # the primary: suspect
        h0 = tier.scheduler.hedges
        for _ in range(2):       # the turn reaches the primary within two
            hedged = step("assign_hedged", lambda: tier.assign(aimed))
            if tier.scheduler.hedges > h0:
                break
        wall = time.perf_counter() - t_start
        launches = E.launches()
    finally:
        tier.close()
    check(all(launches[k2] > 0 for k2 in SERVE_KERNELS) and
          all(v == 0 for k2, v in launches.items() if k2 not in SERVE_KERNELS),
          f"{name} tier: launches {launches}, expected exactly "
          f"{SERVE_KERNELS}")
    # checks, outside the counted run
    check(not full.partial and same_answer(full, single),
          f"{name} tier: assign differs from the single-session assign")
    corpus = np.concatenate([pts_np] + sv["chunks"][:k])[:n + folded]
    check(folded > 0 and np.array_equal(tier._corpus, corpus),
          f"{name} tier: the compacted corpus is not the corpus plus the "
          "chunks in arrival order")
    ref = E.repro_torch.dbscan(corpus, eps, min_pts)
    lab, core = tier_global(E, tier)
    check(np.array_equal(lab, ref.labels.cpu().numpy()) and
          np.array_equal(core, ref.core.cpu().numpy()),
          f"{name} tier: compacted labels/core != dbscan on the corpus plus "
          f"{folded} ingested points")
    one = E.serve.assign(E.serve.build_snapshot(corpus, eps, min_pts), q_np)
    check(same_answer(after, one), f"{name} tier: assign after compaction "
          "differs from the single-session assign on the same corpus")
    alive = [j for j in range(tier.n_shards) if j != TIER_DOWN]
    r_lab, r_cnt, r_dist = restricted_merge(E, tier, q_np, alive)
    check(part.partial and part.shards[TIER_DOWN].missing and
          np.array_equal(part.labels, r_lab) and
          np.array_equal(part.counts, r_cnt) and
          np.array_equal(part.dist, r_dist) and
          (part.counts <= after.counts).all(),
          f"{name} tier: the partial assign is not the restriction to the "
          f"live shards {alive}")
    check(ok and not back.partial and same_answer(back, after),
          f"{name} tier: after recover_shard({TIER_DOWN}) the answers differ")
    check(tier.scheduler.hedges > h0 and hedged.shards[0].hedged and
          same_answer(hedged, plain),
          f"{name} tier: the hedged leg differs from the unhedged one")
    log(f"  {name} n={n} tier ({tier.n_shards} shards, a replica of shard "
        f"0): launches {launches}")
    log(f"    steps s: split {steps['split']:.3f}, replicate "
        f"{steps['replicate']:.3f}, warmup {steps['warmup']:.3f}, assign "
        f"{steps['assign']:.3f} (single session {sv['steps']['assign']:.3f}"
        f"), ingests {[round(x, 4) for x in ingest_s]} (chunks of "
        f"{INGEST_CHUNK}; the tier compacted {n + folded} points), assign "
        f"on the compacted tier {steps['assign_compacted']:.3f}, partial "
        f"{steps['assign_partial']:.3f}, recover_shard "
        f"{steps['recover_shard']:.3f}, recovered "
        f"{steps['assign_recovered']:.3f}, {len(aimed)} queries of shard 0 "
        f"unhedged {steps['assign_unhedged']:.3f} / hedged "
        f"{steps['assign_hedged']:.3f}; total {wall:.3f}")
    log(f"    legs per query {routed} (of {len(q_np)}); assign = the single-"
        f"session assign; compacted labels and core = dbscan on the corpus "
        f"plus {folded} ingested points; the partial assign (shard "
        f"{TIER_DOWN} down, {int((part.counts < after.counts).sum())} "
        f"queries lost neighbours) = the restriction to shards {alive}; "
        f"recovered and hedged answers identical")
    return dict(launches=launches, steps=steps, ingest_s=ingest_s,
                wall=wall, routed=routed, folded=folded)


def run_fig4(E, system, pts, eps, min_pts):
    if system == "dclust":
        return E.dclust.run(pts, eps, min_pts)
    if system == "gdbscan":
        return E.gdbscan.run(pts, eps, min_pts)
    if system == "fdbscan":
        return E.fdbscan.run(pts, eps, min_pts)
    return E.repro_torch.dbscan(pts, eps, min_pts, engine=system)


def phase_fig4(E):
    """The paper's fig. 4 systems on the card at their full size: each
    system's kernels launched and no other, core equal across systems,
    labels equivalent to grid's (border ties may differ), DClust's label
    propagation taking at least grid's hooking rounds; host seconds a
    run."""
    t = E.torch
    name, n, min_pts, epss = FIG4
    pts = E.repro_torch.synth.load(name, n, seed=0)
    total = {k: 0 for k in E.launches()}
    for eps in epss:
        res, secs = {}, {}
        for system, kernels in FIG4_SYSTEMS.items():
            E.bvh._SPEC_CACHE.clear()
            t.cuda.synchronize()
            E.reset_launches()
            t0 = time.perf_counter()
            res[system] = run_fig4(E, system, pts, eps, min_pts)
            t.cuda.synchronize()
            secs[system] = time.perf_counter() - t0
            launches = E.launches()
            check(all(launches[k] > 0 for k in kernels) and
                  all(v == 0 for k, v in launches.items() if k not in kernels),
                  f"fig4 eps={eps} {system}: launches {launches}, expected "
                  f"exactly {kernels}")
            for k, v in launches.items():
                total[k] += v
        base = res["grid"]
        core = base.core.cpu().numpy()
        for system, r in res.items():
            check(t.equal(r.core.cpu(), base.core.cpu()),
                  f"fig4 eps={eps} {system}: core != grid's")
            check(E.labels.equivalent(r.labels.cpu().numpy(),
                                      base.labels.cpu().numpy(), core,
                                      points=pts, eps=eps),
                  f"fig4 eps={eps} {system}: labels not equivalent to grid's")
        check(res["dclust"].n_rounds >= base.n_rounds,
              f"fig4 eps={eps}: dclust {res['dclust'].n_rounds} rounds < "
              f"grid's {base.n_rounds}")
        log(f"  {name} n={n} eps={eps} min_pts={min_pts}: seconds "
            + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
            + f"; rounds dclust {res['dclust'].n_rounds}, gdbscan "
            f"{res['gdbscan'].n_rounds}, grid {base.n_rounds}; clusters "
            f"{n_clusters(base.labels)}, core {int(core.sum())}; core equal,"
            f" labels equivalent")
    return dict(launches=total)


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
    st = eng.state
    pairs = int((st.occupancy[st.buckets.long()] * st.cell_valid).sum(
        dtype=E.torch.int64))
    width = spec.n_offsets * spec.capacity
    return pairs, (f"{pairs:.3e} occupied ({pairs / n:.1f} a query; the "
                   f"padded window {spec.n_offsets} x {spec.capacity} = "
                   f"{width} a query; H {spec.table_size})")


def log_bvh_run(E, res, eng, rec, wall, min_pts):
    """The phase times and BVH telemetry of one bvh, bvh-stack or fdbscan
    run."""
    tm = dict(eng.timings if eng is not None else {}, **res.timings)
    build = (f"build {tm['build_s']:.3f} (tree {tm['tree_s']:.3f}, "
             f"calibration {tm['calibrate_s']:.3f}, {rec.probes} probes), "
             if "tree_s" in tm else
             f"build {tm['build_s']:.3f}, " if "build_s" in tm else
             "builds and stage 1 with early exit in stage1, ")
    log(f"    phases s: {build}stage1 {tm['stage1_s']:.3f}, stage2 "
        f"{tm['stage2_s']:.3f}, border {tm['border_s']:.3f}; total "
        f"{wall:.3f}")
    log(f"    n_rounds {res.n_rounds}{hist_txt(res)}, clusters "
        f"{n_clusters(res.labels)}, noise {int((res.labels == -1).sum())}, "
        f"core {int(res.core.sum())}")
    if eng is None or eng.name != "bvh":
        if eng is not None:
            log(f"    stack depth {eng.meta['depth']} of {eng.meta['stack']}"
                " slots")
        return
    spec, per = eng.meta, rec.per_sweep()
    k_ms = sum(p["kernel_ms"] for p in per)
    sw_s = sum(p["wall"] for p in per)
    log(f"    spec: capacity {spec.capacity}, tile {spec.tile}, peak "
        f"{spec.peak}, batch {spec.batch}, prune {spec.prune_dtype}; exact "
        f"sweep levels {rec.exact_levels()}")
    log(f"    {len(per)} sweeps: {sw_s:.3f} s, bvh_level "
        f"{k_ms:.3f} ms of it ({k_ms / 1e3 / sw_s:.1%}), "
        f"{sum(p['launches'] for p in per)} launches, "
        f"{sum(p['entries'] for p in per)} parent entries; per sweep (s, "
        f"kernel ms, parent entries, levels): "
        f"{[(round(p['wall'], 4), round(p['kernel_ms'], 3), p['entries'], p['levels']) for p in per]}")


def parity_full(E, name, runs):
    """Outside the counted runs: every hash_sweep call of the grid-hash run
    against its plain version and the gathered_sweep path; and an exact
    and a terminated traversal of the bvh/device engine, with the run's
    final payload, every level against bvh_level_plain and the whole
    against the bvh_batch_sweep loop."""
    calls = runs["grid-hash"]["rec"].calls
    check(len(calls) == runs["grid-hash"]["launches"]["hash_sweep"],
          f"{len(calls)} hash_sweep calls recorded")
    for i, (args, kw) in enumerate(calls):
        compare_hash(E, args[:9], args[9], f"{name} sweep {i}")
    run = runs["bvh/device"]
    eng, res = run["eng"], run["res"]
    order = eng.order.long()
    croot = E.ops.fuse_core_root(res.core[order], res.labels[order])
    cases = bvh_cases(E, eng, croot, croot)[:2]
    levels = {}
    for label, kw in cases:
        levels[label], ovf = check_fused_sweep(
            E, eng.state.bvh, croot, f"{name} {label}", **kw)
        check(not ovf, f"{name} {label}: overflow at the calibrated capacity")
    run["levels"] = levels
    log(f"    {name}: hash_sweep of all {len(calls)} grid-hash sweeps "
        f"bit-identical to the plain version and the gathered_sweep path; "
        f"bvh_level: an exact and a terminated traversal ("
        f"{len(levels['exact'])} and {len(levels['terminated'])} levels), "
        "every level bit-identical to bvh_level_plain, the outputs to the "
        "bvh_batch_sweep loop")


def phase_full(E):
    t = E.torch
    runs = {}
    for name, n, eps, min_pts in FULL:
        pts_np = E.repro_torch.synth.load(name, n, seed=0)
        runs[name] = {}
        ref = None
        for path, (kw, kernels) in PATHS.items():
            is_bvh = kw["engine"].startswith("bvh")
            rec = BVHRecorder(E) if is_bvh else \
                CallRecorder(E.gathered, "hash_sweep") \
                if path == "grid-hash" else FrontierRecorder(E)
            E.bvh._SPEC_CACHE.clear()     # each bvh build calibrates anew
            t.cuda.synchronize()
            E.reset_launches()
            t0 = time.perf_counter()
            with rec:
                eng, res = run_path(E, kw, pts_np, eps, min_pts)
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
                assert_same_result(
                    E, ref, res, f"{name} {path} vs grid/device",
                    rounds=False,
                    clip=min_pts if kw.get("early_exit") else None)
            if path in ("grid/frontier", "bvh/frontier"):
                base = runs[name][path.replace("frontier", "device")]["res"]
                check(res.n_rounds == base.n_rounds,
                      f"{name} {path}: n_rounds {res.n_rounds} != "
                      f"{base.n_rounds} (device driver)")
            log(f"  {name} n={n} eps={eps} min_pts={min_pts} {path}: "
                f"launches {launches}")
            pairs = None
            if is_bvh:
                log_bvh_run(E, res, eng, rec, wall, min_pts)
            else:
                pairs, pairs_txt = pair_tests(E, path, eng, rec)
                tm = dict(eng.timings, **res.timings)
                log(f"    phases s: plan {tm['plan_s']:.3f}, build "
                    f"{tm['build_s'] - tm['plan_s']:.3f}, stage1 "
                    f"{tm['stage1_s']:.3f}, stage2 {tm['stage2_s']:.3f}, "
                    f"border {tm['border_s']:.3f}; total {wall:.3f}"
                    if "plan_s" in tm else
                    f"    phases s: build {tm['build_s']:.3f}, stage1 "
                    f"{tm['stage1_s']:.3f}, stage2 {tm['stage2_s']:.3f}, "
                    f"border {tm['border_s']:.3f}; total {wall:.3f}")
                log(f"    n_rounds {res.n_rounds}{hist_txt(res)}, clusters "
                    f"{n_clusters(res.labels)}, noise "
                    f"{int((res.labels == -1).sum())}, core "
                    f"{int(res.core.sum())}")
                log(f"    pair tests per sweep {pairs_txt}")
            runs[name][path] = dict(eng=eng, res=res, launches=launches,
                                    pairs=pairs, rec=rec, wall=wall,
                                    eps2=float(eps) ** 2)
        log(f"    {name}: labels and core identical across {list(PATHS)}, "
            f"counts too (fdbscan's clipped at min_pts); invariants and 4096"
            f" brute-force counts: ok")
        parity_full(E, name, runs[name])
        runs[name]["serve"] = serve_full(E, name, n, eps, min_pts, pts_np)
        runs[name]["tier"] = tier_full(E, name, n, eps, min_pts, pts_np,
                                       runs[name]["serve"])
    return runs


# --------------------------------------------------------------------------
# phase 5c: the distributed driver (D ranks as threads on the card)


class LastCall(CallRecorder):
    """Keeps the arguments of the last call of ``module.attr`` only."""

    def __enter__(self):
        def record(*args, **kw):
            self.calls[:] = [(args, kw)]
            self.seen += 1
            return self.real(*args, **kw)
        setattr(self.module, self.attr, record)
        return self


def dist_run(E, pts, eps, min_pts, engine, device, max_regrows=DIST_REGROWS):
    """dbscan_distributed on DIST_RANKS thread ranks of ``device``."""
    return E.dd.dbscan_distributed(
        pts, eps, min_pts, E.comm.ThreadGroup(DIST_RANKS, device),
        cfg=E.dd.DistConfig(local_engine=engine), max_regrows=max_regrows)


def canon(labels):
    """Labels renumbered by first appearance (-1 kept)."""
    lab = labels.cpu().numpy()
    uniq, first, inv = np.unique(lab, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    out = rank[inv]
    out[lab == -1] = -1
    return out


def check_dist_answer(E, res, single, eng, what):
    """``res`` (distributed) against the single-device ``dbscan`` result
    ``single`` on the same points: core equal, noise set and core
    partition equal after canonical relabelling, every label of a core
    point the least id of a core point of its cluster, and every border
    label the least distributed label of its core ε-neighbours (one
    csr_sweep payload on the single-device engine ``eng``)."""
    t = E.torch
    core = single.core
    check(t.equal(res.core, core), f"{what}: core != single-device dbscan's")
    a, b = canon(res.labels), canon(single.labels)
    check(((a == -1) == (b == -1)).all(), f"{what}: noise set differs")
    c = core.cpu().numpy()
    check((a[c] == b[c]).all(), f"{what}: core partition differs")
    lab = res.labels
    first = t.full_like(lab, INT_MAX).scatter_reduce(
        0, lab.clamp(min=0).long(), t.arange(len(lab), dtype=t.int32,
                                             device=lab.device)
        .masked_fill(~core, INT_MAX), "amin", include_self=True)
    check(t.equal(lab[core], first[lab[core].long()]),
          f"{what}: a core label is not its cluster's least core id")
    _, m = eng.sweep(eng.state, core, lab)
    border = (~core) & (lab >= 0)
    check(t.equal(lab[border], m[border]),
          f"{what}: a border label is not the least label of its core "
          "neighbours")
    check(bool((m[lab == -1] == INT_MAX).all()),
          f"{what}: a noise point has a core neighbour")
    return int(border.sum())


def dist_parity(E, rec, engine, what):
    """The kernels of a local engine, held to their plain versions at the
    shapes the distributed run gave them (its last call)."""
    t = E.torch
    if engine == "grid":
        (q, _order, bk, cv, gp, gi, occ, core, root, eps2), kw = \
            rec["grid"].calls[0]
        idx = t.as_tensor(np.sort(np.random.default_rng(7).choice(
            q.shape[0], min(DIST_SUBSET, q.shape[0]), replace=False)),
            device=q.device)
        args = (q[idx].contiguous(), t.arange(len(idx), dtype=t.int32,
                                               device=q.device),
                bk[idx].contiguous(), cv[idx].contiguous(), gp, gi, occ,
                core, root)
        k = E.gathered.hash_sweep(*args, eps2)
        p = E.gathered.hash_sweep_plain(*args, eps2)
        for i, w in enumerate(("counts", "minroot")):
            same(E, f"hash_sweep {w} ({what})", k[i], p[i])
        return f"hash_sweep on {len(idx)} of {q.shape[0]} queries"
    if engine == "csr":
        args, kw = rec["csr"].calls[0]
        sub, max_nblk, tiles = tile_subset(E, args, kw, seed=7)
        compare_csr(E, sub, args[5], **kw)
        return (f"csr_sweep on {len(tiles)} of {args[3].shape[0]} tiles "
                f"(widest nblk {max_nblk})")
    if engine == "bvh":
        (pts,), kw = rec["build"].calls[0]
        check_build(E, pts, 3, kw["lo"], kw["hi"], f"{what} build_bvh")
        (tree, queries, croot), skw = rec["sweep"].calls[0]
        skw = {k: v for k, v in skw.items() if k != "stop_on_overflow"}
        with LevelChecker(E) as chk:
            E.bvh.wavefront_sweep_fused(tree, queries, croot, **skw)
        return (f"build_bvh of {pts.shape[0]} candidates; bvh_level on "
                f"{len(chk.levels)} levels")
    args, kw = rec["brute"].calls[0]
    compare_pairwise(E, *args[:3], args[3])
    return f"pairwise_sweep {tuple(args[0].shape)} x {tuple(args[1].shape)}"


def dist_recorders(E):
    return {"grid": LastCall(E.gathered, "hash_sweep"),
            "csr": LastCall(E.csr, "csr_sweep"),
            "build": LastCall(E.bvh, "build_bvh"),
            "sweep": LastCall(E.bvh, "wavefront_sweep"),
            "brute": LastCall(E.pairwise, "pairwise_sweep")}


def log_dist(E, what, res, wall, launches):
    tm = res.timings
    steps = ", ".join(f"{k} {tm[k]:.4f}" for k in DIST_STEPS)
    log(f"  {what}: {wall:.3f} s, regrows {tm['regrows']}, n_rounds "
        f"{res.n_rounds}, local rounds {tm['local_rounds']} (rank 0), "
        f"clusters {n_clusters(res.labels)}, core {int(res.core.sum())}, "
        f"noise {int((res.labels == -1).sum())}")
    log(f"    steps s (rank 0, each ended by a synchronize): {steps}; "
        "attempts s " + ", ".join(f"{a:.3f}" for a in tm["attempts_s"]))
    log(f"    bytes put into each collective (all ranks): "
        + json.dumps(tm["sent"]) + f"; peak device memory "
        f"{E.torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"    launches {launches}")


def log_dist_profile(E, what, wall, rows):
    """The device's busy share of a traced distributed run, and its
    largest device operations."""
    if not rows:
        log(f"    {what}, torch.profiler: no device time in the trace (not "
            "measured)")
        return
    busy = sum(r[1] for r in rows)
    ours = sum(ms for key, ms, _ in rows
               if any(k in key for k in E.launches()))
    log(f"    {what}, torch.profiler (a run after the counted one): host "
        f"{wall:.3f} s, device busy {busy:.1f} ms ({busy / 1e3 / wall:.1%}),"
        f" the port's kernels {ours:.1f} ms; largest (name, ms, launches): "
        + json.dumps([(k[:60], round(ms, 3), c) for k, ms, c in rows[:8]]))


def phase_distributed(E, runs):
    """The distributed driver on DIST_RANKS thread ranks of the card at full
    size (grid, csr, bvh) and brute at DIST_REDUCED (all pairs over buffers
    1.25 n wide a rank), launches counted per run; the local engines'
    kernels held to their plain versions at the run's shapes; labels, core
    and rounds identical across engines, the answer against the
    single-device dbscan; at DIST_REDUCED the card against the CPU plain
    versions for every engine, and a one-rank NCCL process group (the
    CLI's path) against one thread rank. Each step's host seconds."""
    t = E.torch
    for name, n, eps, min_pts in FULL:
        t_ds = time.perf_counter()
        pts = E.repro_torch.synth.load(name, n, seed=0)
        eng = E.repro_torch.make_engine(pts, eps, engine="grid")
        single = E.repro_torch.dbscan(pts, eps, min_pts, eng=eng)
        first = None
        for engine in DIST_ENGINES:
            kernels = DIST_KERNELS[engine]
            rec = dist_recorders(E)
            t.cuda.synchronize()
            t.cuda.reset_peak_memory_stats()
            E.reset_launches()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for r in rec.values():
                    stack.enter_context(r)
                res = dist_run(E, pts, eps, min_pts, engine, E.dev)
                t.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = E.launches()
            check(all(launches[k] > 0 for k in kernels) and
                  all(v == 0 for k, v in launches.items() if k not in kernels),
                  f"{name} dist/{engine}: launches {launches}, expected "
                  f"exactly {kernels}")
            log_dist(E, f"{name} n={n} dist/{engine} D={DIST_RANKS}", res,
                     wall, launches)
            runs[name][f"dist/{engine}"] = dict(launches=launches, res=res,
                                                wall=wall)
            log(f"    held to plain: "
                + dist_parity(E, rec, engine, f"{name} dist/{engine}"))
            if first is None:
                first = res
                n_border = check_dist_answer(E, res, single, eng,
                                             f"{name} dist/{engine}")
                log(f"    core, noise and core partition equal to "
                    f"grid/device's; {n_border} border labels the least "
                    "label of their core neighbours")
                log_dist_profile(E, f"{name} dist/{engine}", *profile_device(
                    E, lambda: dist_run(E, pts, eps, min_pts, engine,
                                        E.dev)))
            else:
                for f in ("labels", "core"):
                    check(t.equal(getattr(first, f), getattr(res, f)),
                          f"{name} dist/{engine}: {f} != dist/"
                          f"{DIST_ENGINES[0]}'s")
                check(res.n_rounds == first.n_rounds,
                      f"{name} dist/{engine}: n_rounds {res.n_rounds} != "
                      f"{first.n_rounds}")
        log(f"    {name}: labels, core and n_rounds identical across "
            f"{list(DIST_ENGINES)} ({time.perf_counter() - t_ds:.1f} s with "
            "the parity checks)")
    t0 = time.perf_counter()
    dist_reduced(E, runs)
    log(f"  (reduced size, cpu comparison and CLI: "
        f"{time.perf_counter() - t0:.1f} s)")


def dist_reduced(E, runs):
    """At DIST_REDUCED: every local engine on the card (brute's launches
    counted: its only run) against the CPU plain versions, the
    neighbor_buckets rows of +BIG queries on the card against the CPU's,
    and a one-rank NCCL process group through the CLI against one thread
    rank."""
    t = E.torch
    name, n, eps, min_pts = DIST_REDUCED
    what = f"{name} n={n} eps={eps}"
    pts = E.repro_torch.synth.load(name, n, seed=0)
    for engine in DIST_ENGINES + ("brute",):
        rec = dist_recorders(E)
        t.cuda.synchronize()
        E.reset_launches()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for r in rec.values():
                stack.enter_context(r)
            res = dist_run(E, pts, eps, min_pts, engine, E.dev)
            t.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = E.launches()
        kernels = DIST_KERNELS[engine]
        check(all(launches[k] > 0 for k in kernels) and
              all(v == 0 for k, v in launches.items() if k not in kernels),
              f"{what} dist/{engine}: launches {launches}")
        if engine == "brute":
            runs[name][f"dist/brute n={n}"] = dict(launches=launches,
                                                    res=res, wall=wall)
            log(f"  brute runs at n = {n:,} only: all pairs over buffers "
                "1.25 n wide a rank")
        log_dist(E, f"{what} dist/{engine} D={DIST_RANKS}", res, wall,
                 launches)
        log("    held to plain: " + dist_parity(E, rec, engine,
                                                f"{what} dist/{engine}"))
        threads = t.get_num_threads()
        t.set_num_threads(DIST_CPU_THREADS)
        t0 = time.perf_counter()
        try:
            cpu = dist_run(E, pts, eps, min_pts, engine, "cpu")
        finally:
            t.set_num_threads(threads)
        for f in ("labels", "core"):
            check(t.equal(getattr(res, f).cpu(), getattr(cpu, f)),
                  f"{what} dist/{engine}: card {f} != cpu's")
        check(res.n_rounds == cpu.n_rounds,
              f"{what} dist/{engine}: n_rounds card {res.n_rounds} != cpu "
              f"{cpu.n_rounds}")
        log(f"    card == cpu plain versions (labels, core, n_rounds "
            f"{res.n_rounds}); the cpu run {time.perf_counter() - t0:.1f} s "
            f"({DIST_RANKS} rank threads x {DIST_CPU_THREADS} torch threads)")
    far = np.array([[1e30, 0, 0], [-1e30, 1e30, 3e9], [1e30] * 3,
                    [-3e9, 2.2e9, -1e30], [0.5, -0.25, 0.125]], np.float32)
    for dims, side, table in ((3, 0.02, 64), (2, 1.0, 1 << 17)):
        spec = E.grid.GridSpec(side=side, origin=(0.0, 0.0, 0.0),
                               table_size=table, capacity=32, dims=dims)
        kb, kv = E.grid.neighbor_buckets(E.tensor(far), spec)
        pb, pv = E.grid.neighbor_buckets(t.as_tensor(far), spec)
        check(t.equal(kb.cpu(), pb) and t.equal(kv.cpu(), pv),
              f"neighbor_buckets of +BIG rows: card != cpu (dims {dims})")
    log("  neighbor_buckets of +-1e30 / +-3e9 rows: card == cpu")
    one = E.dd.dbscan_distributed(pts, eps, min_pts, E.comm.ThreadGroup(
        1, E.dev))
    t0 = time.perf_counter()
    cli = E.cluster.main(["--dataset", name, "-n", str(n), "--eps",
                          str(eps), "--min-pts", str(min_pts),
                          "--distributed"])
    wall = time.perf_counter() - t0
    for f in ("labels", "core"):
        check(t.equal(getattr(cli, f).cpu(), getattr(one, f).cpu()),
              f"CLI --distributed (one NCCL rank): {f} != one thread rank's")
    check(cli.n_rounds == one.n_rounds, "CLI --distributed: n_rounds differ")
    log(f"  CLI --distributed (a one-rank NCCL process group) == one thread "
        f"rank: n_rounds {cli.n_rounds}, {wall:.3f} s")


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
    return dict(kernel=kernel, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], max_abs_err=err, launches=launches, **extra)


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
    kept = E.csr.kept_runs_plain(g.q_sorted, g.cands, st, g.nblk, eps2,
                                 **kw)
    G = E.csr.run_width(spec.block_k)
    S = E.csr.SEG_RUNS
    kept_pairs = int(kept.sum()) * G * bq
    # what a finer G would keep: the kept-pairs bound depends on G
    kept64 = int(E.csr.kept_runs_plain(g.q_sorted, g.cands, st, g.nblk, eps2,
                                       run=64, **kw).sum()) * 64 * bq
    rate, mhz = fp32_issue_rate(E)

    def ops_ms(pairs):
        return pairs * OPS_PER_PAIR / PEAK_FP32_OPS * 1e3
    log(f"  {name}: slab pair tests {run['pairs']:.4e}, kept pair tests "
        f"{kept_pairs:.4e} ({kept_pairs / run['pairs']:.2%}); G {G}, S {S}; "
        f"kept runs per tile: mean {float(kept.sum(1).float().mean()):.1f}, "
        f"max {int(kept.sum(1).max())}; G 64 would keep {kept64:.4e}")
    log(f"  {name}: operations bound (10 a pair at 67 TFLOP/s): kept pairs "
        f"{ops_ms(kept_pairs):.3f} ms, at G 64 {ops_ms(kept64):.3f} ms, slab "
        f"{ops_ms(run['pairs']):.3f} ms; kept pairs at the unfused FP32 "
        f"issue rate ({FP32_INSTR_PER_PAIR} a pair, {rate:.4e}/s at a max "
        f"SM clock of {mhz:.0f} MHz): "
        f"{kept_pairs * FP32_INSTR_PER_PAIR / rate * 1e3:.3f} ms")
    out = {}
    for kname, (kern, plain, nb) in calls.items():
        # the wrapper's three launches: boxes, cull and sweep
        ms = cuda_ms(E, kern)
        # the plain version takes seconds here: one timed call at the full
        # shapes, which is also the call the kernel is compared with
        plain_ms, p_out = timed_once(E, plain)
        err = max_err(kern(), p_out)
        launches = sum(r["launches"][kname] for r in
                       (run, E.runs[name]["grid/frontier"]))
        out[kname] = row(kname, launches, ms, plain_ms,
                         bound(kept_pairs, nb), err,
                         plain_shapes="full", pair_tests=run["pairs"],
                         kept_pair_tests=kept_pairs, G=G, S=S)
    return out


def kept_bounds(E, name, what, kept_pairs, pairs):
    """Logs a sweep's kept pair tests, their share of its slab's, and the
    least time of the kept pairs at the operations count (10 a pair at 67
    TFLOP/s) and at the unfused FP32 issue rate."""
    rate, mhz = fp32_issue_rate(E)
    log(f"  {name} {what}: slab pair tests {pairs:.4e}, kept pair tests "
        f"{kept_pairs:.4e} ({kept_pairs / max(pairs, 1):.2%}); kept pairs "
        f"{kept_pairs * OPS_PER_PAIR / PEAK_FP32_OPS * 1e3:.4f} ms at 67 "
        f"TFLOP/s (10 a pair), "
        f"{kept_pairs * FP32_INSTR_PER_PAIR / rate * 1e3:.4f} ms at the "
        f"FP32 issue rate ({FP32_INSTR_PER_PAIR} a pair, {rate:.4e}/s at "
        f"{mhz:.0f} MHz)")


def times_frontier(E, name, run):
    """frontier_sweep on the main path's own round-1 inputs (the widest
    frontier), plain on its first 64 live slots; bound at the pairs of the
    runs its skip keeps."""
    rec = run["rec"]
    (args, kw), (na1, pairs1) = rec.calls[0], rec.live_pairs()[0]
    q, cp, croot, st, nblk, active, n_active, eps2 = args
    kern = lambda: E.frontier.frontier_sweep(*args, **kw)  # noqa: E731
    ms = cuda_ms(E, kern)
    T, bq = st.shape[0], kw["block_q"]
    nbytes = T * bq * 12 + cp.shape[1] * 16 + T * 12 + 4 + T * bq * 4
    pkw = dict(max_blocks=kw["max_blocks"], block_k=kw["block_k"])
    kept = E.frontier.kept_runs_plain(q, cp, st, nblk, active, n_active, eps2,
                                      **pkw)
    G = E.csr.run_width(kw["block_k"])
    kept_pairs = int(kept.sum()) * G * bq
    kept_bounds(E, name, "frontier_sweep round 1", kept_pairs, pairs1)
    sub = min(SUBSET, na1)
    sub_args = (q, cp, croot, st, nblk,
                E.tensor(_park(active[:sub].tolist(), T)),
                E.tensor(np.array([sub], np.int32)), eps2)
    plain_ms, p_out = timed_once(
        E, lambda: E.frontier.frontier_sweep_plain(*sub_args, **pkw))
    k_sub_ms, k_out = timed_once(
        E, lambda: E.frontier.frontier_sweep(*sub_args, **kw))
    border_ms = cuda_ms(E, lambda: E.frontier.frontier_sweep(
        *rec.calls[-1][0], **rec.calls[-1][1]))
    return row("frontier_sweep", run["launches"]["frontier_sweep"], ms,
               plain_ms, bound(kept_pairs, nbytes), max_err(k_out, p_out),
               plain_shapes=f"{sub} of round 1's {na1} live tiles",
               ms_on_plain_shapes=k_sub_ms, live_tiles=na1,
               pair_tests=pairs1, kept_pair_tests=kept_pairs, G=G,
               S=E.csr.SEG_RUNS, tiles=T, border_ms=border_ms,
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
    rate, mhz = fp32_issue_rate(E)
    floor_ms = nq * nc * FP32_INSTR_PER_PAIR / rate * 1e3
    log(f"  {name} pairwise_sweep: {nq * nc:.4e} pair tests (brute: every "
        f"pair, nothing to skip); FP32 issue-rate floor {floor_ms:.3f} ms "
        f"({FP32_INSTR_PER_PAIR} a pair, {rate:.4e}/s at {mhz:.0f} MHz); the "
        f"kernel at {floor_ms / ms:.1%} of that floor")
    return row("pairwise_sweep", run["launches"]["pairwise_sweep"], ms,
               plain_ms, bound(nq * nc, nbytes), max_err(k_out, p_out),
               plain_shapes=f"{SUBSET} query tiles of 256 x {nc} candidates",
               ms_on_plain_shapes=k_sub_ms, pair_tests=nq * nc,
               shape=[nq, nc])


def times_gathered(E, name, args):
    """gathered_sweep (the A side of hash_sweep) per chunk of the grid-hash
    sweep ``args`` (hash_sweep's inputs), plain on 64 chunks."""
    eps2 = args[9]
    n_chunks = -(-args[0].shape[0] // 2048)
    pick = set(np.random.default_rng(3).choice(
        n_chunks, min(SUBSET, n_chunks), replace=False).tolist())
    plain_ms, kern_ms, err, ms = [], [], 0, None
    # one chunk's window at a time: all of them at once would not fit
    for i, w in enumerate(E.gathered.hash_windows(args[0], *args[2:6],
                                                  *args[7:9], 2048)):
        if i != n_chunks // 2 and i not in pick:
            continue
        cargs = E.gathered.window_args(*w)
        if i == n_chunks // 2:
            ms = cuda_ms(E, lambda: E.gathered.gathered_sweep(*cargs, eps2))
            b, k = cargs[2].shape
        if i in pick:
            p_ms, p_out = timed_once(
                E, lambda: E.gathered.gathered_sweep_plain(*cargs, eps2))
            k_ms, k_out = timed_once(
                E, lambda: E.gathered.gathered_sweep(*cargs, eps2))
            plain_ms.append(p_ms)
            kern_ms.append(k_ms)
            err = max(err, max_err(k_out, p_out))
        del cargs, w
    nbytes = b * 12 + b * k * 16 + b * 8
    a_ms = cuda_ms(E, lambda: hash_sweep_a(E, args[:9], eps2), reps=3)
    return row("gathered_sweep", 0, ms, statistics.mean(plain_ms),
               bound(b * k, nbytes), err,
               plain_shapes=f"mean over {len(pick)} chunks of {b} x {k}",
               ms_on_plain_shapes=statistics.mean(kern_ms),
               pair_tests=b * k, shape=[b, k], chunks_per_sweep=n_chunks,
               sweep_ms=a_ms)


def times_hash(E, name, run, grid_run):
    """hash_sweep on one sweep of the grid-hash run with its final payload,
    beside the plain version (the padded windows, chunk by chunk) on the
    same inputs, and the bounds: the bytes of its inputs read once and its
    occupied pairs at 10 operations each (the row's bound), the padded
    windows' bytes (the gathered_sweep path's), the occupied slots' bytes
    as read, and the occupied pairs at the unfused FP32 issue rate; beside
    it gathered_sweep (the A side, the kernel hash_sweep replaced) and one
    whole sweep of the engine and of the CSR grid."""
    t = E.torch
    eng, res = run["eng"], run["res"]
    eps2 = run["eps2"]
    args = hash_args(eng, res.core, res.labels)
    ms = cuda_ms(E, lambda: E.gathered.hash_sweep(*args, eps2))
    # the visiting order sets which queries share a warp: in the identity
    # order a warp's queries lie in 32 unrelated windows
    ident = (args[0], t.arange(args[0].shape[0], dtype=t.int32,
                               device=E.dev), *args[2:])
    ident_ms = cuda_ms(E, lambda: E.gathered.hash_sweep(*ident, eps2))
    plain_ms, p_out = timed_once(
        E, lambda: E.gathered.hash_sweep_plain(*args, eps2))
    k_out = E.gathered.hash_sweep(*args, eps2)
    err = max_err(k_out, p_out)
    hits = int(k_out[0].sum(dtype=t.int64))
    del p_out, k_out
    st, spec = eng.state, eng.meta
    n, n_off = st.buckets.shape
    H, C = spec.table_size, spec.capacity
    occ_win = st.occupancy[st.buckets.long()] * st.cell_valid
    pairs = int(occ_win.sum(dtype=t.int64))
    # queries, order, buckets, cell_valid, occupancy, the occupied slots
    # (point, index) and the payload once; counts and minroot written
    nbytes = n * (12 + 4 + 5 * n_off + 12 + 4 + 5 + 8) + 4 * H
    k_pad = -(-(n_off * C) // 512) * 512
    chunks = -(-n // 2048)
    padded = chunks * (2048 * 12 + 2048 * k_pad * 16 + 2048 * 8)
    rate, mhz = fp32_issue_rate(E)
    issue_ms = pairs * FP32_INSTR_PER_PAIR / rate * 1e3
    sweep_ms = cuda_ms(E, lambda: eng.sweep(eng.state, res.core, res.labels),
                       reps=3)
    g = grid_run["eng"]
    order = g.state.order.long()
    croot = E.ops.fuse_core_root(res.core[order], res.labels[order])
    csr_ms = cuda_ms(E, lambda: g.sweep_sorted(g.state, croot), reps=3)
    prev = times_gathered(E, name, args + (eps2,))
    log(f"  {name} hash_sweep: {pairs:.4e} occupied pairs ({pairs / n:.1f} a "
        f"query; the padded windows {chunks * 2048 * k_pad:.4e}), "
        f"{hits:.4e} hits; bounds: inputs once "
        f"{nbytes / PEAK_BYTES * 1e3:.4f} ms, occupied pairs at 67 TFLOP/s "
        f"{pairs * OPS_PER_PAIR / PEAK_FP32_OPS * 1e3:.4f} ms, at the FP32 "
        f"issue rate ({FP32_INSTR_PER_PAIR} a pair, {rate:.4e}/s at "
        f"{mhz:.0f} MHz) {issue_ms:.4f} ms, the slots as read (12 B a pair) "
        f"{pairs * 12 / PEAK_BYTES * 1e3:.4f} ms, the padded windows "
        f"{padded / PEAK_BYTES * 1e3:.4f} ms; hash_sweep {ms:.4f} ms in the "
        f"bucket-major order, {ident_ms:.4f} ms in the identity order")
    return row("hash_sweep", run["launches"]["hash_sweep"], ms, plain_ms,
               bound(pairs, nbytes), err, plain_shapes="full (one sweep)",
               occupied_pairs=pairs, hits=hits, queries=n, window=n_off,
               table=[H, C], padded_pairs=chunks * 2048 * k_pad,
               grid_hash_sweep_ms=sweep_ms, csr_sweep_ms=csr_ms,
               identity_order_ms=ident_ms, previous=prev)


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
        kept = E.csr.kept_runs_plain(q, cp, st, nb, eps2,
                                     max_blocks=k["max_blocks"],
                                     block_k=k["block_k"])
        G = E.csr.run_width(k["block_k"])
        pairs = slab_pairs(nb, k["block_k"], bq)
        kept_pairs = int(kept.sum()) * G * bq
        kept_bounds(E, name, f"cross_sweep ({tag}, {T * bq} queries)",
                    kept_pairs, pairs)
        # tiles with +1e30 padding rows: their box reaches 1e30
        padded = (q.view(T, bq, 3) == 1e30).all(-1).any(-1).nonzero()[:, 0]
        runs = kept.sum(1)
        log(f"    kept runs per tile: mean {float(runs.float().mean()):.1f}, "
            f"max {int(runs.max())}; tiles with padding rows "
            f"{padded.numel()}, their kept runs {runs[padded].tolist()}")
        out[tag] = dict(ms=ms, pairs=pairs, kept_pairs=kept_pairs, G=G,
                        nbytes=nbytes, queries=T * bq,
                        max_nblk=int(nb.max()), tiles=T)
    sub, _, _ = tile_subset(E, args, kw, seed=1)
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
    log(f"  {name} cross_sweep: ingest cross query bound "
        f"{bound(i['kept_pairs'], i['nbytes'])[0]:.4f} ms")
    return row("cross_sweep", run["launches"]["cross_sweep"], a["ms"],
               plain_ms, bound(a["kept_pairs"], a["nbytes"]), err,
               plain_shapes=f"{SUBSET} query tiles of the assign",
               ms_on_plain_shapes=k_sub_ms, pair_tests=a["pairs"],
               kept_pair_tests=a["kept_pairs"], G=a["G"], S=E.csr.SEG_RUNS,
               queries=a["queries"], max_nblk=a["max_nblk"],
               ingest_ms=i["ms"], ingest_queries=i["queries"],
               ingest_pair_tests=i["pairs"],
               ingest_kept_pair_tests=i["kept_pairs"])


def sweep_bytes(calls) -> int:
    """Bytes the bvh_batch_sweep launches ``calls`` must move: each tensor
    passed read once, at its stored width (bf16 boxes 2 B a coordinate;
    nmin and bound only in payload mode, where they are passed), and hit,
    minroot (E, B) and push (E,) int32 written."""
    total = 0
    for args, _ in calls:
        e, b, _ = args[0].shape
        total += e * (8 * b + 4) + sum(
            x.numel() * x.element_size() for x in args
            if hasattr(x, "element_size"))
    return total


def quantized(E, pts, lo, hi):
    """The (n, 3) int32 cells of the build's quantization (the plain
    version's arithmetic): morton_encode's input, as before the build's
    keys became one kernel."""
    t = E.torch
    top = t.full((), 1023.0, dtype=t.float32, device=pts.device)
    scale = t.where(hi > lo, top / (hi - lo), 0.0)
    q = t.clamp((pts - lo) * scale, 0, 1023).to(t.int32)
    q = E.ops.pad_to(q, 3, 1, 0) if q.shape[1] < 3 else q[:, :3]
    return q.contiguous()


def times_morton(E, coords, dims):
    """morton_encode (lbvh_keys' A side) on the build's quantized cells;
    plain on the same."""
    n = coords.shape[0]
    ms = cuda_ms(E, lambda: E.morton.morton_encode(coords, dims=dims))
    plain_ms, p_out = timed_once(
        E, lambda: E.morton.morton_encode_plain(coords, dims=dims))
    err = max_err(E.morton.morton_encode(coords, dims=dims), p_out)
    return row("morton_encode", 0, ms, plain_ms, bound(0, 16 * n), err,
               plain_shapes="full", points=n, dims=dims)


def lbvh_bytes(n: int, d: int) -> dict:
    """Bytes each LBVH kernel must move at n points of D coordinates, each
    input read once and each output written once (lbvh_refit's arrival
    counters, and lo / hi, read once)."""
    nl = n - 1
    nodes_out = 16 * nl + 4 * (2 * n - 1) + 4 * nl
    return {
        "lbvh_keys": n * (4 * d + 4) + 8 * d,
        "lbvh_nodes": 4 * n + nodes_out,
        "lbvh_refit": (4 * n * d + 8 * n + 8 * nl + 4 * (2 * n - 1) + 4 * nl
                       + 4 * n * d + 4 * n + 8 * d * nl),
        "lbvh_depth": 8 * nl + 4,
    }


def bits(E, out) -> tuple:
    """The outputs with float tensors as their int32 bits."""
    t = E.torch
    return tuple(x.view(t.int32) if x.dtype == t.float32 else x
                 for x in out)


def cuda_ms_after(E, prep, fn, reps: int = 5) -> float:
    """cuda_ms with ``prep()`` before each launch, outside the timed span."""
    prep()
    fn()
    runs = []
    for _ in range(reps):
        prep()
        runs.append(timed_once(E, fn)[0])
    return statistics.median(runs)


def times_lbvh(E, name, run, stack_run):
    """The LBVH kernels on the bvh/device run's build input (its
    lbvh_keys call), each beside its plain version on the same inputs;
    lbvh_keys also held to morton_encode_plain of the quantized cells, and
    morton_encode timed on those (its A side); lbvh_depth's launches are
    the bvh-stack run's."""
    t, L = E.torch, E.lbvh
    (pts, lo, hi), kw = run["rec"].keys
    n, d = pts.shape
    nb = lbvh_bytes(n, d)
    out = {}
    codes = L.lbvh_keys(pts, lo, hi, **kw)
    q = quantized(E, pts, lo, hi)
    same(E, f"lbvh_keys @ {name} vs morton_encode_plain of the cells",
         codes, E.morton.morton_encode_plain(q, dims=kw["dims"]))
    ms = cuda_ms(E, lambda: L.lbvh_keys(pts, lo, hi, **kw))
    plain_ms, p = timed_once(E, lambda: L.lbvh_keys_plain(pts, lo, hi, **kw))
    out["lbvh_keys"] = row(
        "lbvh_keys", run["launches"]["lbvh_keys"], ms, plain_ms,
        bound(0, nb["lbvh_keys"]), max_err(codes, p), plain_shapes="full",
        points=n, dims=kw["dims"],
        previous=times_morton(E, q, kw["dims"]))
    sorted_codes, order = t.sort(codes, stable=True)
    nodes = L.lbvh_nodes(sorted_codes)
    ms = cuda_ms(E, lambda: L.lbvh_nodes(sorted_codes))
    plain_ms, pn = timed_once(E, lambda: L.lbvh_nodes_plain(sorted_codes))
    out["lbvh_nodes"] = row(
        "lbvh_nodes", run["launches"]["lbvh_nodes"], ms, plain_ms,
        bound(0, nb["lbvh_nodes"]), max_err(tuple(nodes), tuple(pn)),
        plain_shapes="full", points=n)
    ms = cuda_ms_after(E, nodes.arrivals.zero_,
                       lambda: L.lbvh_refit(pts, order, nodes))
    nodes.arrivals.zero_()
    fit = L.lbvh_refit(pts, order, nodes)
    plain_ms, pf = timed_once(E, lambda: L.lbvh_refit_plain(pts, order, pn))
    out["lbvh_refit"] = row(
        "lbvh_refit", run["launches"]["lbvh_refit"], ms, plain_ms,
        bound(0, nb["lbvh_refit"]), max_err(bits(E, fit), bits(E, pf)),
        plain_shapes="full", points=n)
    ms = cuda_ms(E, lambda: L.lbvh_depth(nodes.left, nodes.right))
    plain_ms, pd = timed_once(
        E, lambda: L.lbvh_depth_plain(nodes.left, nodes.right))
    out["lbvh_depth"] = row(
        "lbvh_depth", stack_run["launches"]["lbvh_depth"], ms, plain_ms,
        bound(0, nb["lbvh_depth"]),
        max_err(L.lbvh_depth(nodes.left, nodes.right), pd),
        plain_shapes="full", points=n, depth=int(pd[0]))
    return out


def profile_device(E, fn):
    """Device time of one call of ``fn`` by kernel name, from a
    torch.profiler trace, beside the host seconds of the call (ending in a
    synchronize): (wall s, [(name, device ms, launches)] largest first).
    The list is empty when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t = E.torch
    fn()
    t.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        t.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return wall, sorted(rows, key=lambda r: -r[1])


# substrings of the device kernels of a wavefront sweep, by part: ours
# (the fused level, or the per-entry kernel), the gathers that feed the
# per-entry kernel, the scatters of its results, and copies and fills (the
# fused loop's bound snapshots and count copies, the buffers it zeroes)
SWEEP_PARTS = {"kernel": ("bvh_level", "bvh_batch_sweep"),
               "gather": ("gather_kernel", "index_elementwise"),
               "scatter": ("indexFunc", "scatter_gather"),
               "copy": ("Memcpy", "Memset", "FillFunctor")}


def profile_split(wall, rows) -> dict:
    """Device ms of a traced sweep by part (SWEEP_PARTS, the rest as
    "other"), its busy ms and its busy share of the host time ``wall``."""
    out = dict(host_s=wall, busy_ms=sum(r[1] for r in rows))
    for k, names in SWEEP_PARTS.items():
        out[f"{k}_ms"] = sum(ms for key, ms, _ in rows
                             if any(n in key for n in names))
    out["other_ms"] = out["busy_ms"] - sum(out[f"{k}_ms"]
                                           for k in SWEEP_PARTS)
    out["busy_share"] = out["busy_ms"] / 1e3 / wall
    return out


def log_profile(E, what, name, wall, rows):
    """Logs a traced sweep's split; returns it (None without device time)."""
    if not rows:
        log(f"    bvh {what} @ {name}, torch.profiler: no device time in "
            "the trace (not measured)")
        return None
    v = profile_split(wall, rows)
    log(f"    bvh {what} @ {name}, torch.profiler: host {wall * 1e3:.3f} ms,"
        f" device busy {v['busy_ms']:.3f} ms ({v['busy_share']:.1%}): "
        f"kernel {v['kernel_ms']:.3f}, gathers {v['gather_ms']:.3f}, "
        f"scatters {v['scatter_ms']:.3f}, copies and fills "
        f"{v['copy_ms']:.3f}, other {v['other_ms']:.3f} ms")
    log(f"    bvh {what} @ {name}, device kernels (name, ms, launches): "
        + json.dumps(rows))
    return v


def count_host_reads(E, fn):
    """(blocking host reads, waits for an earlier level's count) of one
    call of ``fn``: the reads (file:line of each) are the synchronizing
    operations that
    torch.cuda's sync debug mode reports (a read of a device value, a
    nonzero, a copy from pageable memory); the waits are those of the
    fused loop's count reader (bvh._LevelCounts.waits), which the mode
    does not see."""
    import warnings
    t = E.torch
    readers = []
    real = E.bvh._LevelCounts

    class Counting(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            readers.append(self)

    t.cuda.synchronize()
    E.bvh._LevelCounts = Counting
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                t.cuda.set_sync_debug_mode("default")
    finally:
        E.bvh._LevelCounts = real
    t.cuda.synchronize()
    reads = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return reads, sum(r.waits for r in readers)


class LaunchEvents(CallRecorder):
    """While active, a pair of CUDA events around every call of
    ``module.attr`` (launching nothing of their own)."""

    def __init__(self, E, module, attr: str):
        super().__init__(module, attr)
        self.torch = E.torch

    def __enter__(self):
        def timed(*args, **kw):
            ev = (self.torch.cuda.Event(enable_timing=True),
                  self.torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = self.real(*args, **kw)
            ev[1].record()
            self.calls.append((args, ev))
            return out
        setattr(self.module, self.attr, timed)
        return self

    def ms(self) -> list:
        return [a.elapsed_time(b) for _, (a, b) in self.calls]


def exact_kw(spec) -> dict:
    """wavefront_sweep's keywords of an engine's exact sweep."""
    return dict(eps=spec.eps, eps2=spec.eps ** 2, capacity=spec.capacity,
                tile=spec.tile, batch=spec.batch,
                prune_dtype=spec.prune_dtype, max_levels=spec.max_levels)


def times_bvh(E, name, run):
    """bvh_batch_sweep (the A side of bvh_level, the kernel it replaced) over
    the launches of the widest level of the exact sweep by its level loop
    (``wavefront_sweep_plain``, payload-free as ``sweep_counts``), beside
    its plain version on the same inputs; and that whole sweep: its
    kernel time (CUDA events), host seconds, blocking host reads and
    torch.profiler split."""
    t = E.torch
    eng = run["eng"]
    tree = eng.state.bvh
    kw = exact_kw(eng.meta)
    payload = t.full((tree.pts_sorted.shape[0],), INT_MAX, dtype=t.int32,
                     device=E.dev)

    def sweep():
        return E.bvh.wavefront_sweep_plain(tree, tree.pts_sorted, payload,
                                           **kw)
    level, live, calls = widest_level_calls(E, sweep, kw)
    _, b, d = calls[0][0][0].shape
    e = sum(a[0].shape[0] for a, _ in calls)
    nbytes = sweep_bytes(calls)
    ms = cuda_ms(E, lambda: [E.bvhk.bvh_batch_sweep(*a, **k)
                             for a, k in calls])
    plain_ms, p_out = timed_once(E, lambda: [
        E.bvhk.bvh_batch_sweep_plain(*a, **k) for a, k in calls])
    err = max(max_err(E.bvhk.bvh_batch_sweep(*a, **k), p)
              for (a, k), p in zip(calls, p_out))
    n_launches = len(calls)
    del calls, p_out
    t.cuda.synchronize()
    with LaunchEvents(E, E.bvhk, "bvh_batch_sweep") as ev:
        t0 = time.perf_counter()
        sweep()
        t.cuda.synchronize()
        wall = time.perf_counter() - t0
    entries = sum(a[0].shape[0] for a, _ in ev.calls)
    reads, _ = count_host_reads(E, sweep)
    prof = log_profile(E, "exact sweep, bvh_batch_sweep loop", name,
                       *profile_device(E, sweep))
    log(f"    bvh_batch_sweep @ {name}: {nbytes / e:.1f} B an entry at the "
        f"widest level; the exact sweep's {entries} entries at that rate: "
        f"bound {entries * nbytes / e / PEAK_BYTES * 1e3:.3f} ms")
    return row("bvh_batch_sweep", 0, ms, plain_ms, bound(e * b, nbytes), err,
               plain_shapes="full (the widest level)", level=level,
               live_entries=live, entries=e, level_launches=n_launches,
               batch=b, dims=d, exact_sweep_kernel_ms=sum(ev.ms()),
               exact_sweep_launches=len(ev.calls), exact_sweep_s=wall,
               exact_sweep_entries=entries,
               exact_sweep_host_reads=len(reads), profile=prof)


def times_bvh_level(E, name, run):
    """bvh_level at the widest level of the bvh/device engine's exact sweep
    (``sweep_counts``; median of LEVEL_REPS sweeps, CUDA events), beside
    its plain version at that level (timed in the full-size parity, on the
    same inputs), and the bytes bound of the level (``level_bytes``, this
    run's distinct query blocks, leaf / internal split and pushes); the
    whole exact sweep: the level kernels' sum, its host and traced device
    time and split, its blocking host reads and count waits; the run's
    sweeps; and the per-entry kernel's numbers beside (times_bvh). Logged,
    not in the row: the sweep's bound with each level's query blocks read
    once (the row's convention), with the query block read once per
    parent entry, and at the per-entry kernel's 196 B a child."""
    t = E.torch
    eng, rec = run["eng"], run["rec"]
    spec = eng.meta
    d = eng.state.bvh.pts_sorted.shape[1]
    levels = run["levels"]["exact"]
    box = 2 if spec.prune_dtype == "bf16" else 4
    nbytes = [level_bytes(lv, batch=spec.batch, dims=d, box_bytes=box,
                          payload=False) for lv in levels]
    nbytes_pe = [level_bytes(lv, batch=spec.batch, dims=d, box_bytes=box,
                             payload=False, per_entry_queries=True)
                 for lv in levels]

    def sweep():
        eng.sweep_counts(eng.state)
    sweep()
    per_level = []
    for _ in range(LEVEL_REPS):
        t.cuda.synchronize()
        with LaunchEvents(E, E.bvhk, "bvh_level") as ev:
            sweep()
            t.cuda.synchronize()
        ms = ev.ms()
        check(len(levels) <= len(ms) <= len(levels) + 1,
              f"{len(ms)} bvh_level launches for {len(levels)} levels")
        per_level.append(ms[:len(levels)])
    med = [statistics.median(x) for x in zip(*per_level)]
    w = int(np.argmax([lv["parents"] for lv in levels]))
    t.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    t.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads, waits = count_host_reads(E, sweep)
    prof = log_profile(E, "exact sweep, fused", name,
                       *profile_device(E, sweep))
    children = 2 * sum(lv["parents"] for lv in levels)
    per_entry = 8 * spec.batch + 4 + 4 * spec.batch * d + 2 * box * d \
        + 4 * d + 8
    prev = times_bvh(E, name, run)
    per = rec.per_sweep()
    def ms_of(nb):
        return nb / PEAK_BYTES * 1e3
    lw = levels[w]
    log(f"    bvh_level @ {name}: exact sweep {len(levels)} levels, widest "
        f"{w} ({lw['parents']} parents on {lw['blocks']} query blocks, "
        f"{lw['leaves']} leaf and {lw['internal']} internal children, "
        f"{lw['pushes']} pushes); level ms (median of {LEVEL_REPS}) "
        f"{[round(x, 4) for x in med]}; blocking host reads {len(reads)} "
        f"({reads}), waits for an earlier level's count {waits} (the "
        f"per-entry loop: {prev['exact_sweep_host_reads']} reads)")
    log(f"    bvh_level bounds @ {name}: widest level, query blocks read "
        f"once {nbytes[w] / lw['parents']:.1f} B a parent entry, "
        f"{ms_of(nbytes[w]):.4f} ms (the row's bound); query block once "
        f"per parent entry {nbytes_pe[w] / lw['parents']:.1f} B, "
        f"{ms_of(nbytes_pe[w]):.4f} ms; exact sweep ({children // 2} "
        f"parents, {sum(med):.3f} ms of kernel): blocks once a level "
        f"{ms_of(sum(nbytes)):.3f} ms, once per entry "
        f"{ms_of(sum(nbytes_pe)):.3f} ms, the per-entry kernel's "
        f"{per_entry} B a child {ms_of(children * per_entry):.3f} ms")
    return row("bvh_level", run["launches"]["bvh_level"], med[w],
               lw["plain_ms"], (ms_of(nbytes[w]), "bytes"),
               max(lv["err"] for lv in levels),
               plain_shapes="full (the widest level)", level=w,
               live_entries=lw["parents"], query_blocks=lw["blocks"],
               batch=spec.batch, dims=d, exact_sweep_levels=len(levels),
               exact_sweep_level_ms=med, exact_sweep_kernel_ms=sum(med),
               exact_sweep_launches=len(per_level[0]),
               exact_sweep_s=wall, exact_sweep_parents=children // 2,
               exact_sweep_host_reads=len(reads),
               exact_sweep_count_waits=waits,
               profile=prof, run_sweeps=len(per),
               run_kernel_ms=sum(p["kernel_ms"] for p in per),
               run_sweeps_s=sum(p["wall"] for p in per),
               run_launches=sum(p["launches"] for p in per),
               run_parents=sum(p["entries"] for p in per), previous=prev)


def phase_times(E, runs):
    E.runs = runs
    per = {k: {} for k in KERNELS}
    for name, r in runs.items():
        per_ds = times_csr(E, name, r["grid/device"])
        per_ds["frontier_sweep"] = times_frontier(E, name, r["grid/frontier"])
        per_ds["pairwise_sweep"] = times_pairwise(E, name, r["brute"])
        per_ds["hash_sweep"] = times_hash(E, name, r["grid-hash"],
                                          r["grid/device"])
        per_ds["cross_sweep"] = times_cross(E, name, r["serve"])
        per_ds.update(times_lbvh(E, name, r["bvh/device"], r["bvh-stack"]))
        per_ds["bvh_level"] = times_bvh_level(E, name, r["bvh/device"])
        for kname, d in per_ds.items():
            # launches: every counted path run of this dataset
            by_path = {p: pr["launches"][kname] for p, pr in r.items()
                       if pr["launches"][kname]}
            d["launches_by_path"] = by_path
            d["launches"] = sum(by_path.values())
            per[kname][name] = d
            for v in (d, d.get("previous")):
                if v is None:
                    continue
                log(f"  {v['kernel']} @ {name}: {v['ms']:.3f} ms (bound "
                    f"{v['bound_ms']:.3f} ms by {v['bound_by']}, "
                    f"{v['bound_ms'] / v['ms']:.1%} of bound; plain "
                    f"{v['plain_ms']:.1f} ms on {v['plain_shapes']} shapes"
                    + (f", kernel {v['ms_on_plain_shapes']:.3f} ms there"
                       if "ms_on_plain_shapes" in v else "") + ")")
        g = per_ds["hash_sweep"]
        f = per_ds["frontier_sweep"]
        log(f"    frontier round 1: {f['live_tiles']} of {f['tiles']} tiles "
            f"live; border call {f['border_ms']:.3f} ms with "
            f"{f['border_live_tiles']} live tiles")
        gp = g["previous"]
        log(f"    one sweep @ {name}: hash_sweep {g['ms']:.3f} ms in one "
            f"launch ({g['launches']} launches in the run: "
            f"{g['launches_by_path']}); the engine's whole sweep "
            f"{g['grid_hash_sweep_ms']:.3f} ms; the gathered_sweep path "
            f"{gp['sweep_ms']:.3f} ms ({gp['chunks_per_sweep']} chunks, "
            f"kernel {gp['ms'] * gp['chunks_per_sweep']:.3f} ms of it at "
            f"its time a chunk); CSR grid "
            f"{g['csr_sweep_ms']:.3f} ms")
        c = per_ds["cross_sweep"]
        log(f"    cross_sweep @ {name}: assign of {c['queries']} queries "
            f"{c['ms']:.3f} ms ({c['pair_tests']:.3e} slab pair tests, "
            f"{c['kept_pair_tests']:.3e} kept, max nblk {c['max_nblk']}); "
            f"ingest cross query of {c['ingest_queries']} "
            f"{c['ingest_ms']:.3f} ms ("
            f"{c['ingest_pair_tests']:.3e} slab pair tests, "
            f"{c['ingest_kept_pair_tests']:.3e} kept); launches by path "
            f"{c['launches_by_path']}")
        v = per_ds["bvh_level"]
        vp = v["previous"]
        log(f"    bvh_level @ {name}: widest level {v['level']} of the exact "
            f"sweep, {v['live_entries']} live parents, {v['ms']:.3f} ms; "
            f"exact sweep {v['exact_sweep_s'] * 1e3:.3f} ms on the host, "
            f"{v['exact_sweep_kernel_ms']:.3f} ms of kernel in "
            f"{v['exact_sweep_launches']} launches; blocking host reads "
            f"{v['exact_sweep_host_reads']}, count waits "
            f"{v['exact_sweep_count_waits']}; the bvh_batch_sweep loop: "
            f"{vp['exact_sweep_s'] * 1e3:.3f} ms on the host, "
            f"{vp['exact_sweep_kernel_ms']:.3f} ms of kernel in "
            f"{vp['exact_sweep_launches']} launches, "
            f"{vp['exact_sweep_host_reads']} blocking host reads; bvh/device "
            f"run: {v['run_sweeps']} sweeps, {v['run_sweeps_s']:.3f} s, "
            f"kernel {v['run_kernel_ms']:.3f} ms in {v['run_launches']} "
            f"launches, {v['run_parents']} parent entries; launches by path "
            f"{v['launches_by_path']}")
        b = E.lbvh_stats[name]
        log(f"    LBVH build @ {name}: {per_ds['lbvh_keys']['points']} points;"
            f" the engines' build {b['tree_ms']:.3f} ms on the host, "
            f"{b['kernels']} kernel launches and {b['ops']} device "
            f"operations a build_bvh; kernel ms keys / nodes / refit / "
            f"depth " + " / ".join(
                f"{per_ds[k]['ms']:.4f}" for k in
                ("lbvh_keys", "lbvh_nodes", "lbvh_refit", "lbvh_depth"))
            + "; launches by path " + json.dumps(
                {k: per_ds[k]["launches_by_path"] for k in
                 ("lbvh_keys", "lbvh_depth")}))
    return per


def kernels_line(per) -> dict:
    """The kernels JSON: per-call numbers at the roadnet2d full-size shapes,
    launches summed over every full-size path run on both datasets (per
    path under ``per_dataset``), every dataset under ``per_dataset``. Rows
    6, 7 and 8 carry the kernel they replaced on the paths under
    ``previous`` (its own numbers of this run)."""
    out = []
    for kname, rows in per.items():
        head = rows[FULL[0][0]]
        entry = dict(
            name=kname, route="cuda", source=KERNELS[kname][0],
            replaces=KERNELS[kname][1],
            launches=sum(r["launches"] for r in rows.values()),
            max_abs_err=max(r["max_abs_err"] for r in rows.values()),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, parity="bit-identical", shapes=FULL[0][0],
            per_dataset=rows)
        if kname in PREVIOUS:
            prev = {ds: r["previous"] for ds, r in rows.items()}
            entry["previous"] = dict(
                name=PREVIOUS[kname][0], source=PREVIOUS[kname][1],
                launches=0, ms=prev[FULL[0][0]]["ms"],
                plain_ms=prev[FULL[0][0]]["plain_ms"],
                bound_ms=prev[FULL[0][0]]["bound_ms"],
                bound_by=prev[FULL[0][0]]["bound_by"],
                max_abs_err=max(r["max_abs_err"] for r in prev.values()),
                library_ms=None)
        out.append(entry)
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
    timed("LBVH build parity", phase_lbvh, E)
    timed("whole path, reduced size", phase_reduced, E)
    runs = timed("whole path, full size", phase_full, E)
    timed("distributed", phase_distributed, E, runs)
    runs[FIG4[0]]["fig4"] = timed("fig. 4 systems", phase_fig4, E)
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
