#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, batch DBSCAN on the grid engine, on the card
and exits non-zero on any failure. Phases:

  1. environment: the card's name and power limit (nvidia-smi);
  2. build: every kernel source in src/repro_torch/csrc, one nvcc each,
     started together;
  3. kernel parity, kernel against its plain PyTorch version on the card,
     integer outputs bit-identical: the reference's ragged shape sweep,
     pairs at exactly d² = ε², tiles with nblk = 0, and 64 seeded tiles of
     the full-size roadnet2d layout (the largest-nblk tile among them);
  4. whole path at n = 20,000 (roadnet2d, iono3d): device="cpu" with the
     plain versions against device="cuda" with the kernels, bit-identical
     labels, core, counts and n_rounds;
  5. whole path at full size (roadnet2d 435,000 at ε = 0.02, minPts = 8;
     iono3d 1,000,000 at ε = 2.0, minPts = 16): kernel launch counts read
     around each run, DBSCAN invariants, and counts at 4,096 seeded points
     against a brute-force count over the whole corpus;
  6. kernel times at the full-size shapes (CUDA events), beside the plain
     version's time on the same inputs and the least time the card could
     take (bound).

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
SHAPES = [(1, 8, 1, 1), (4, 64, 8, 3), (3, 256, 6, 6), (7, 32, 16, 2)]


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


class Env:
    """Imports of the port, made after the CUDA and checkout checks."""

    def __init__(self):
        import torch

        import repro_torch
        from repro_torch.kernels import build, csr_sweep, ops, ref
        self.torch, self.repro_torch = torch, repro_torch
        self.build, self.csr, self.ops, self.ref = build, csr_sweep, ops, ref
        self.dev = torch.device("cuda")


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


def compare_kernels(E, arrays, eps2, *, max_blocks, block_q, block_k):
    """Both kernels against their plain versions on the card, on the same
    tensors. Fails on any difference; returns the kernel's counts and
    minroot."""
    t = E.torch
    q, cp, croot, st, nb = (x if isinstance(x, t.Tensor)
                            else t.as_tensor(x, device=E.dev) for x in arrays)
    kw = dict(max_blocks=max_blocks, block_k=block_k)
    k_counts, k_min = E.csr.csr_sweep(q, cp, croot, st, nb, eps2,
                                      block_q=block_q, **kw)
    k_cnt_only = E.csr.csr_sweep_counts(q, cp, st, nb, eps2, block_q=block_q,
                                        **kw)
    p_counts, p_min = E.csr.csr_sweep_plain(q, cp, croot, st, nb, eps2, **kw)
    p_cnt_only = E.csr.csr_sweep_counts_plain(q, cp, st, nb, eps2, **kw)
    t.cuda.synchronize()
    for name, k, p in (("csr_sweep counts", k_counts, p_counts),
                       ("csr_sweep minroot", k_min, p_min),
                       ("csr_sweep_counts", k_cnt_only, p_cnt_only)):
        check(t.equal(k, p), f"{name}: kernel != plain version "
              f"({int((k != p).sum())} of {k.numel()} rows differ)")
    return k_counts, k_min


def phase_parity(E, road_eng):
    t = E.torch
    bk = 128
    for shape in SHAPES:
        T, bq, ncb, sb = shape
        compare_kernels(E, _mk_slab(T, bq, ncb, sb, bk), 0.4, max_blocks=sb,
                        block_q=bq, block_k=bk)
    log(f"  shape sweep {SHAPES}: bit-identical")

    for T, bq, ncb in ((2, 32, 2), (3, 256, 4)):
        arrays = _lattice(T, bq, ncb, bk, seed=T)
        d2 = ((arrays[0][:, None, :] - arrays[1].T[None]) ** 2).sum(-1)
        check((d2 == np.float32(9 / 64)).any(), "no pair at d² = ε²")
        for eps2 in (9 / 64, float(np.nextafter(np.float32(9 / 64),
                                                np.float32(0)))):
            counts, _ = compare_kernels(E, arrays, eps2, max_blocks=ncb,
                                        block_q=bq, block_k=bk)
            check(int(counts.sum()) == int((d2 <= np.float32(eps2)).sum()),
                  "boundary counts differ from a numpy count")
    log("  pairs at d² = ε² (ε² = 9/64 and the float below): bit-identical")

    T, bq = 5, 32
    q, cp, croot, st, _ = _mk_slab(T, bq, 4, 2, bk, seed=9)
    nblk = np.array([0, 2, 0, 1, 0], np.int32)
    counts, k_min = compare_kernels(E, (q, cp, croot, st, nblk), 0.4,
                                    max_blocks=2, block_q=bq, block_k=bk)
    rows = t.as_tensor(np.repeat(nblk == 0, bq), device=E.dev)
    check(bool((counts[rows] == 0).all()) and
          bool((k_min[rows] == INT_MAX).all()),
          "nblk = 0 tiles must give count 0 and minroot INT32_MAX")
    log("  nblk = 0 tiles: bit-identical, 0 / INT32_MAX")

    # 64 seeded tiles of the full-size roadnet2d layout, among them the
    # tile with the largest nblk
    g, spec = road_eng.state, road_eng.meta
    nblk_all = g.nblk.cpu().numpy()
    rng = np.random.default_rng(0)
    widest = int(nblk_all.argmax())
    others = np.delete(np.arange(spec.n_tiles), widest)
    tiles = np.sort(np.append(rng.choice(others, min(63, len(others)),
                                         replace=False), widest))
    idx = t.as_tensor(tiles, device=E.dev)
    q = g.q_sorted.view(spec.n_tiles, spec.chunk, 3)[idx].reshape(-1, 3)
    croot = t.as_tensor(rng.integers(0, spec.n, spec.n_cand).astype(np.int32),
                        device=E.dev)
    croot[t.as_tensor(rng.uniform(size=spec.n_cand) < 0.5, device=E.dev)] = \
        INT_MAX
    st = (g.starts[idx] // spec.block_k).to(t.int32)
    eps2 = float(FULL[0][2]) ** 2
    compare_kernels(E, (q.contiguous(), g.cands, croot, st,
                        g.nblk[idx].contiguous()), eps2,
                    max_blocks=spec.slab // spec.block_k,
                    block_q=spec.chunk, block_k=spec.block_k)
    log(f"  roadnet2d full layout, {len(tiles)} tiles (max nblk "
        f"{int(nblk_all.max())} of {spec.slab // spec.block_k}): "
        "bit-identical")


# --------------------------------------------------------------------------
# phases 4 and 5: the whole path


def phase_reduced(E):
    for name, _, eps, min_pts in FULL:
        pts = E.repro_torch.synth.load(name, REDUCED_N, seed=0)
        t0 = time.perf_counter()
        cpu = E.repro_torch.dbscan(pts, eps, min_pts, device="cpu")
        t1 = time.perf_counter()
        gpu = E.repro_torch.dbscan(pts, eps, min_pts)
        t2 = time.perf_counter()
        for f in ("labels", "core", "counts"):
            check(E.torch.equal(getattr(cpu, f), getattr(gpu, f).cpu()),
                  f"{name} n={REDUCED_N}: {f} differ between cpu and cuda")
        check(cpu.n_rounds == gpu.n_rounds,
              f"{name} n={REDUCED_N}: n_rounds {cpu.n_rounds} (cpu) != "
              f"{gpu.n_rounds} (cuda)")
        log(f"  {name} n={REDUCED_N}: bit-identical, n_rounds "
            f"{gpu.n_rounds}, clusters {n_clusters(gpu.labels)}, noise "
            f"{int((gpu.labels == -1).sum())}; cpu {t1 - t0:.2f} s, "
            f"cuda {t2 - t1:.2f} s")


def n_clusters(labels) -> int:
    return int(labels[labels >= 0].unique().numel())


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


def phase_full(E):
    t = E.torch
    runs = {}
    for name, n, eps, min_pts in FULL:
        pts_np = E.repro_torch.synth.load(name, n, seed=0)
        t.cuda.synchronize()
        E.csr.reset_launches()
        t0 = time.perf_counter()
        eng = E.repro_torch.make_engine(pts_np, eps)
        res = E.repro_torch.dbscan(pts_np, eps, min_pts, eng=eng)
        t.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(E.csr.LAUNCHES)
        check(all(v > 0 for v in launches.values()),
              f"{name}: a kernel of the main path never launched: {launches}")

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
        idx = t.as_tensor(np.random.default_rng(1).choice(n, 4096,
                                                          replace=False),
                          device=E.dev)
        bc = brute_counts(E, pts, idx, float(eps) ** 2)
        check(t.equal(bc, counts[idx].long()),
              f"{name}: counts differ from brute force at "
              f"{int((bc != counts[idx]).sum())} of 4096 points")

        spec, nblk = eng.meta, eng.state.nblk
        pairs = int(nblk.sum()) * spec.block_k * spec.chunk
        tm = dict(eng.timings, **res.timings)
        log(f"  {name} n={n} eps={eps} min_pts={min_pts}: launches "
            f"{launches}")
        log(f"    phases s: plan {tm['plan_s']:.3f}, build "
            f"{tm['build_s'] - tm['plan_s']:.3f}, stage1 "
            f"{tm['stage1_s']:.3f}, stage2 {tm['stage2_s']:.3f}, border "
            f"{tm['border_s']:.3f}; total {wall:.3f}")
        log(f"    n_rounds {res.n_rounds}, clusters {n_clusters(labels)}, "
            f"noise {int((labels == -1).sum())}, core {int(core.sum())}")
        log(f"    tiles {spec.n_tiles}, slab {spec.slab // spec.block_k} "
            f"blocks, nblk mean {float(nblk.float().mean()):.1f} / max "
            f"{int(nblk.max())}, pair tests per sweep {pairs:.3e}")
        log("    invariants and 4096 brute-force counts: ok")
        runs[name] = dict(eng=eng, res=res, launches=launches, pairs=pairs,
                          eps2=float(eps) ** 2)
    return runs


# --------------------------------------------------------------------------
# phase 6: kernel times at the main-path shapes


def cuda_ms(E, fn, reps: int) -> float:
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


def bound_ms(spec, pairs: int, payload: bool) -> tuple[float, str]:
    """Least time on the card: the larger of ops over the FP32 peak and the
    bytes each input read once and each output written once move."""
    T, bq, nc = spec.n_tiles, spec.chunk, spec.n_cand
    nbytes = T * bq * 12 + nc * 12 + T * 8 + T * bq * 4
    if payload:
        nbytes += nc * 4 + T * bq * 4
    t_ops = pairs * OPS_PER_PAIR / PEAK_FP32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_times(E, runs):
    t = E.torch
    per = {"csr_sweep": {}, "csr_sweep_counts": {}}
    for name, run in runs.items():
        g, spec, res = run["eng"].state, run["eng"].meta, run["res"]
        order = g.order.long()
        croot = t.full((spec.n_cand,), INT_MAX, dtype=t.int32, device=E.dev)
        croot[:spec.n] = E.ops.fuse_core_root(res.core[order],
                                              res.labels[order])
        st = (g.starts // spec.block_k).to(t.int32)
        eps2 = run["eps2"]
        kw = dict(max_blocks=spec.slab // spec.block_k, block_k=spec.block_k)
        calls = {
            "csr_sweep": (
                lambda: E.csr.csr_sweep(g.q_sorted, g.cands, croot, st,
                                        g.nblk, eps2, block_q=spec.chunk,
                                        **kw),
                lambda: E.csr.csr_sweep_plain(g.q_sorted, g.cands, croot, st,
                                              g.nblk, eps2, **kw)),
            "csr_sweep_counts": (
                lambda: (E.csr.csr_sweep_counts(g.q_sorted, g.cands, st,
                                                g.nblk, eps2,
                                                block_q=spec.chunk, **kw),),
                lambda: (E.csr.csr_sweep_counts_plain(g.q_sorted, g.cands,
                                                      st, g.nblk, eps2,
                                                      **kw),)),
        }
        for kname, (kern, plain) in calls.items():
            ms = cuda_ms(E, kern, reps=5)
            # the plain version takes seconds here: one timed call, which
            # is also the call the kernel is compared with
            plain_ms, p_out = timed_once(E, plain)
            k_out = kern()
            t.cuda.synchronize()
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(k_out, p_out))
            check(err == 0, f"{kname} at {name} full size: kernel != plain "
                  f"(max abs err {err})")
            b_ms, b_by = bound_ms(spec, run["pairs"], kname == "csr_sweep")
            per[kname][name] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, launches=run["launches"][kname],
                pair_tests=run["pairs"], tiles=spec.n_tiles,
                max_blocks=spec.slab // spec.block_k)
            log(f"  {kname} @ {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, "
                f"bound {b_ms:.3f} ms by {b_by}, "
                f"{b_ms / ms:.1%} of bound)")
    return per


REPLACES = {"csr_sweep": "src/repro/kernels/csr_sweep.py:146",
            "csr_sweep_counts": "src/repro/kernels/csr_sweep.py:102"}


def kernels_line(per) -> dict:
    """The kernels JSON: per-call numbers at the roadnet2d full-size shapes,
    launches summed over both full-size runs, every dataset under
    ``per_dataset``."""
    out = []
    for kname, rows in per.items():
        head = rows[FULL[0][0]]
        out.append(dict(
            name=kname, route="cuda", source="src/repro_torch/csrc/csr_sweep.cu",
            replaces=REPLACES[kname],
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[environment] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(smi)
    E = Env()

    def build():
        for name, built in E.build.build(E.build.sources()).items():
            log(f"  {name}: {built.path.name}")
            for line in built.log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {line.strip()}")
    timed("build", build)

    def parity():
        pts = E.repro_torch.synth.load(FULL[0][0], FULL[0][1], seed=0)
        road_eng = E.repro_torch.make_engine(pts, FULL[0][2])
        phase_parity(E, road_eng)
    timed("kernel parity", parity)
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
