"""One level of the batched wavefront BVH traversal: the ``bvh`` engine's
inner loop, as the reference's per-entry kernel (``bvh_batch_sweep``) and
as the fused level the engine runs on the card (``bvh_level``).

The traversal (``core/bvh.py``, ``wavefront_sweep``) keeps a frontier of
(query block, node) entries and expands every live entry into its two
children each level. This function takes the E children of a level, each
carrying B queries, through the two-phase test:

  * **prune** — a column (entry, query) is ``inside`` when every coordinate
    of the query lies in the pre-dilated box ``[dlo, dhi]``; with
    ``bf16_prune`` the query is rounded to the nearest bf16 first (the
    boxes are then outward-rounded bf16 values, so the prune admits a
    superset of the f32 prune);
  * **refine** — ``hit`` = leaf and the exact f32 d² ≤ ε² (``ref._dist2``'s
    arithmetic), whatever the prune dtype; ``minroot`` = ``croot`` if hit,
    else INT32_MAX;
  * **push** — an internal child with at least one useful column: inside,
    and in payload mode (``prune_payload``) ``nmin < bound`` — its subtree's
    min payload can still lower the column's running bound.

``bvh_level`` runs that test for one whole level of a traversal on the
tree's own arrays (:class:`LevelInputs`): it reads the frontier of
(query block, node) parent entries and its live count from a
:class:`LevelState`, expands every live entry into its two children,
adds the leaf hits to the counts and the min-root rows, and writes the
pushed children, in the order of the level's child list and at most
``capacity`` of them, as the next frontier, with its count, the overflow
flag and the level histogram. Nothing is read on the host.

Each function has three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/bvh_sweep.cu``: ``bvh_batch_sweep_kernel``, one thread per entry;
``bvh_level_kernel``, a persistent grid with an ordered compaction), its
wrapper, and the plain PyTorch version. CPU tensors go to the plain
version; CUDA tensors launch the kernel or raise. The outputs of the two
are bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .csr_sweep import _cuda_or_raise, _eps2_f32
from .ref import INT_MAX, _dist2, eps2_tensor

# Launches since the last reset_launches(); the plain versions never count.
LAUNCHES = {"bvh_batch_sweep": 0, "bvh_level": 0}

MAX_DIMS = 8     # the kernel's template range of D
# child positions of one work unit of bvh_level_kernel (kUnit: 256 threads
# x 4): the level state holds one scan status word per unit
LEVEL_UNIT = 1024
# levels a traversal's status words can tell apart: they carry level + 1 in
# 8 bits, and a level past this would wait for a status it can never see
MAX_KERNEL_LEVELS = 255


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_BOX_DTYPES = (torch.float32, torch.bfloat16)


def _check(queries, dlo, dhi, pt, croot, nmin, leaf, bound, prune_payload):
    if prune_payload and (nmin is None or bound is None):
        raise ValueError("prune_payload needs nmin and bound")
    named = (("queries", queries, torch.float32), ("dlo", dlo, _BOX_DTYPES),
             ("dhi", dhi, dlo.dtype), ("pt", pt, torch.float32),
             ("croot", croot, torch.int32), ("nmin", nmin, torch.int32),
             ("leaf", leaf, torch.int32), ("bound", bound, torch.int32))
    for name, x, dtype in named:
        if x is None:
            continue
        if x.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on "
                             f"{queries.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.dim() != 3:
        raise ValueError(f"queries {tuple(queries.shape)} must be (E, B, D)")
    e, b, d = queries.shape
    for name, x, shape in (("dlo", dlo, (e, d)), ("dhi", dhi, (e, d)),
                           ("pt", pt, (e, d)), ("croot", croot, (e,)),
                           ("nmin", nmin, (e,)), ("leaf", leaf, (e,)),
                           ("bound", bound, (e, b))):
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
    if not 1 <= d <= MAX_DIMS or b < 1:
        raise ValueError(f"queries {tuple(queries.shape)}: need B >= 1 and "
                         f"1 <= D <= {MAX_DIMS}")
    if e >= 2**31:
        raise ValueError(f"{e} entries: over the kernel's int32 count")


def bvh_batch_sweep_plain(queries, dlo, dhi, pt, croot, nmin, leaf, bound,
                          eps2, *, bf16_prune: bool = True,
                          prune_payload: bool = False):
    """Plain PyTorch version of :func:`bvh_batch_sweep` (any device)."""
    qp = queries.to(torch.bfloat16).to(torch.float32) if bf16_prune \
        else queries
    lo, hi = dlo.to(torch.float32), dhi.to(torch.float32)
    inside = ((qp >= lo[:, None, :]) & (qp <= hi[:, None, :])).all(dim=-1)
    lf = (leaf != 0)[:, None]
    hit = lf & (_dist2(queries, pt[:, None, :])
                <= eps2_tensor(eps2, queries.device))
    minroot = torch.where(hit, croot[:, None], INT_MAX).to(torch.int32)
    useful = inside & (nmin[:, None] < bound) if prune_payload else inside
    push = ~lf[:, 0] & useful.any(dim=1)
    return hit.to(torch.int32), minroot, push.to(torch.int32)


def bvh_batch_sweep(queries, dlo, dhi, pt, croot, nmin, leaf, bound, eps2,
                    *, bf16_prune: bool = True, prune_payload: bool = False):
    """Batched prune/refine over one level of (query block, node) entries.

    queries (E, B, D) f32  — B queries per entry; dead entries at −BIG
    dlo/dhi (E, D) f32 or bf16 — pre-dilated prune box (bf16 values when
                             ``bf16_prune``), widened to f32 in the
                             kernel; dead entries +BIG / −BIG
    pt      (E, D) f32     — leaf point (internal entries: don't-care)
    croot   (E,) int32     — leaf payload: root if core else INT32_MAX
    nmin    (E,) int32     — subtree min payload (payload mode only:
                             None otherwise, and so is ``bound``)
    leaf    (E,) int32     — 1 iff the child is a leaf
    bound   (E, B) int32   — per-column running min-root bound
    eps2    float          — ε², rounded once to f32
    Dead entries need only one of their two encodings: box +BIG / −BIG,
    or queries at −BIG (outside every finite box, d² overflows to ∞).
    All contiguous. Returns hit (E, B) int32 ∈ {0, 1}, minroot (E, B)
    int32, push (E,) int32 ∈ {0, 1}.
    """
    _check(queries, dlo, dhi, pt, croot, nmin, leaf, bound, prune_payload)
    kw = dict(bf16_prune=bf16_prune, prune_payload=prune_payload)
    if queries.device.type == "cpu":
        return bvh_batch_sweep_plain(queries, dlo, dhi, pt, croot, nmin, leaf,
                                     bound, eps2, **kw)
    _cuda_or_raise(queries, "bvh_batch_sweep")
    e, b, d = queries.shape
    hit = torch.empty((e, b), dtype=torch.int32, device=queries.device)
    minroot = torch.empty_like(hit)
    push = torch.empty(e, dtype=torch.int32, device=queries.device)
    if e == 0:
        return hit, minroot, push
    build.launch("bvh_sweep", "bvh_batch_sweep_launch", "ppppppppfiiiiiippp",
                 "bvh_batch_sweep", queries.device, queries, dlo, dhi, pt,
                 croot, nmin, leaf, bound, _eps2_f32(eps2), e, b, d,
                 int(dlo.dtype == torch.bfloat16), int(bf16_prune),
                 int(prune_payload), hit, minroot, push)
    build.count(LAUNCHES, "bvh_batch_sweep")
    return hit, minroot, push


class LevelInputs(NamedTuple):
    """The arrays a traversal's levels read (all on one device)."""
    left: torch.Tensor        # (n-1,) int32 child ids (leaf i: n-1+i)
    right: torch.Tensor       # (n-1,) int32
    node_lo: torch.Tensor     # (2n-1, D) f32 or bf16 dilated prune boxes
    node_hi: torch.Tensor     # (2n-1, D), the dtype of node_lo
    pts: torch.Tensor         # (n, D) f32 leaf points
    croot_leaf: torch.Tensor  # (n,) int32 leaf payload
    node_min: torch.Tensor | None  # (2n-1,) int32 subtree payload min
    #                                (payload mode only)
    qblocks: torch.Tensor     # (nb+1, B, D) f32 query blocks


class LevelState(NamedTuple):
    """The device state of one traversal, updated in place by its levels.
    Level l reads the frontier from row l % 2 of ``fb`` / ``fn`` and writes
    the next into row (l+1) % 2."""
    fb: torch.Tensor          # (2, C) int32 frontier query blocks
    fn: torch.Tensor          # (2, C) int32 frontier node ids
    nlive: torch.Tensor       # (L+1,) int32 live entries entering level l
    counts: torch.Tensor      # (nb+1, B) int32, hits added
    minroot: torch.Tensor     # (nb+1, B) int32, payloads min'ed
    bound: torch.Tensor | None  # (nb+1, B) int32 copy of minroot taken
    #                             before each level (payload mode only)
    overflow: torch.Tensor    # (1,) int32, set when a level drops pushes
    hist: torch.Tensor        # (L,) int32 nlive of each level run, else -1
    status: torch.Tensor      # (units,) int64 scan status, zeroed
    tickets: torch.Tensor     # (L,) int32 unit tickets, zeroed


def new_level_state(counts, minroot, *, capacity: int, levels: int,
                    prune_payload: bool) -> LevelState:
    """A :class:`LevelState` for a traversal of at most ``levels`` levels
    with ``capacity`` frontier slots, over the given ``counts`` and
    ``minroot``; the frontier and ``nlive[0]`` are the caller's to set."""
    dev = counts.device
    i32 = dict(dtype=torch.int32, device=dev)
    return LevelState(
        fb=torch.empty((2, capacity), **i32),
        fn=torch.empty((2, capacity), **i32),
        nlive=torch.zeros(levels + 1, **i32), counts=counts, minroot=minroot,
        bound=torch.empty_like(minroot) if prune_payload else None,
        overflow=torch.zeros(1, **i32), hist=torch.full((levels,), -1, **i32),
        status=torch.zeros(-(-2 * capacity // LEVEL_UNIT), dtype=torch.int64,
                           device=dev),
        tickets=torch.zeros(levels, **i32))


def check_level_arrays(inputs: LevelInputs, state: LevelState, *,
                       prune_payload: bool) -> None:
    """Raises unless the arrays of a traversal fit :func:`bvh_level`: their
    dtypes, devices, layouts and shapes. The levels of a traversal share
    the arrays, so its driver checks them once, before the first level
    (a level's host time is most of a small level's time)."""
    dev = inputs.pts.device
    n, d = inputs.pts.shape
    nb1, b = state.counts.shape
    C = state.fb.shape[1]
    levels = state.hist.shape[0]
    shapes = {"left": (n - 1,), "right": (n - 1,), "node_lo": (2 * n - 1, d),
              "node_hi": (2 * n - 1, d), "croot_leaf": (n,),
              "node_min": (2 * n - 1,), "qblocks": (nb1, b, d),
              "fb": (2, C), "fn": (2, C), "nlive": (levels + 1,),
              "minroot": (nb1, b), "bound": (nb1, b), "overflow": (1,),
              "status": (-(-2 * C // LEVEL_UNIT),), "tickets": (levels,)}
    dtypes = {"node_lo": _BOX_DTYPES, "node_hi": (inputs.node_lo.dtype,),
              "pts": (torch.float32,), "qblocks": (torch.float32,),
              "status": (torch.int64,)}
    for name, x in (*inputs._asdict().items(), *state._asdict().items()):
        if x is None:
            if name in ("node_min", "bound") and not prune_payload:
                continue
            raise ValueError(f"{name} is None (payload mode needs node_min "
                             "and bound)")
        if x.dtype not in dtypes.get(name, (torch.int32,)):
            raise TypeError(f"{name} has dtype {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, pts on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in shapes and tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(x.shape)} != {shapes[name]}")
    if not 1 <= d <= MAX_DIMS or n < 2:
        raise ValueError(f"need 1 <= D <= {MAX_DIMS} and n >= 2; got D = "
                         f"{d}, n = {n}")
    if levels > MAX_KERNEL_LEVELS:
        raise ValueError(f"{levels} levels; the level kernel tells at most "
                         f"{MAX_KERNEL_LEVELS} apart")


def _check_level(state: LevelState, level: int, tile: int):
    levels, C = state.hist.shape[0], state.fb.shape[1]
    if not 0 <= level < min(levels, MAX_KERNEL_LEVELS):
        raise ValueError(f"level {level} outside [0, "
                         f"{min(levels, MAX_KERNEL_LEVELS)})")
    if tile < 1 or C % tile or 2 * C >= 2**31:
        raise ValueError(f"capacity {C} must be a positive multiple of the "
                         f"tile {tile}, with 2 * capacity under 2^31")


def bvh_level_plain(inputs: LevelInputs, state: LevelState, level: int,
                    eps2, *, tile: int, bf16_prune: bool = True,
                    prune_payload: bool = False,
                    stop_on_overflow: bool = False) -> None:
    """Plain PyTorch version of :func:`bvh_level` (any device): the level's
    children laid out by their positions, :func:`bvh_batch_sweep_plain`
    over them, the hits scattered and the pushes compacted in order."""
    n_live = int(state.nlive[level])
    if n_live == 0:
        return
    state.hist[level] = n_live
    src, dst = level % 2, (level + 1) % 2
    C = state.fb.shape[1]
    batch = state.counts.shape[1]
    n_int = inputs.pts.shape[0] - 1
    e = torch.arange(n_live, device=state.fb.device)
    pos = (e // tile) * (2 * tile) + e % tile
    fb = state.fb[src, :n_live].long()
    fn = state.fn[src, :n_live].long()
    at = torch.argsort(torch.cat([pos, pos + tile]))   # position order
    cb = torch.cat([fb, fb])[at]
    cn = torch.cat([inputs.left[fn], inputs.right[fn]]).long()[at]
    is_leaf = cn >= n_int
    leaf_id = (cn - n_int).clamp(0, n_int)
    nm, bnd = (inputs.node_min[cn], state.bound[cb]) if prune_payload \
        else (None, None)
    hit, mr, push = bvh_batch_sweep_plain(
        inputs.qblocks[cb], inputs.node_lo[cn], inputs.node_hi[cn],
        inputs.pts[leaf_id], inputs.croot_leaf[leaf_id], nm,
        is_leaf.to(torch.int32), bnd, eps2, bf16_prune=bf16_prune,
        prune_payload=prune_payload)
    state.counts.index_add_(0, cb, hit)
    state.minroot.scatter_reduce_(0, cb[:, None].expand(-1, batch), mr,
                                  "amin")
    keep = push.nonzero().squeeze(1)
    m = min(keep.numel(), C)
    state.fb[dst, :m] = cb[keep[:m]].to(torch.int32)
    state.fn[dst, :m] = cn[keep[:m]].to(torch.int32)
    over = keep.numel() > C
    if over:
        state.overflow.fill_(1)
    state.nlive[level + 1] = 0 if over and stop_on_overflow else m


def bvh_level(inputs: LevelInputs, state: LevelState, level: int, eps2, *,
              tile: int, bf16_prune: bool = True,
              prune_payload: bool = False,
              stop_on_overflow: bool = False) -> None:
    """Level ``level`` of a wavefront traversal, in place on ``state``.

    Parent entry e < nlive[level] of frontier row level % 2 expands into
    its left and right children, at positions (e // tile)·2·tile +
    side·tile + e % tile. A leaf child adds its hits (exact f32 d² ≤ ε²)
    to ``counts`` and its payload to ``minroot`` at the block's rows; an
    internal child is pushed when some column is inside its prune box
    (the query rounded to bf16 first when ``bf16_prune``) and, with
    ``prune_payload``, its subtree's payload min lies under the column's
    ``bound``. The pushes go, in position order and at most C of them,
    to row (level+1) % 2, their count to ``nlive[level+1]`` (0 after an
    overflow with ``stop_on_overflow``); more than C set ``overflow``;
    ``hist[level]`` gets ``nlive[level]``. A level whose live count is 0
    changes nothing. ``tile`` divides C; ``status`` and ``tickets`` are
    zero before a traversal's first level. The arrays are the caller's to
    check, once a traversal, with :func:`check_level_arrays`; a level
    checks only its scalars.
    """
    _check_level(state, level, tile)
    kw = dict(tile=tile, bf16_prune=bf16_prune, prune_payload=prune_payload,
              stop_on_overflow=stop_on_overflow)
    dev = inputs.pts.device
    if dev.type == "cpu":
        bvh_level_plain(inputs, state, level, eps2, **kw)
        return
    _cuda_or_raise(inputs.pts, "bvh_level")
    n, d = inputs.pts.shape
    src, dst = level % 2, (level + 1) % 2
    build.launch(
        "bvh_sweep", "bvh_level_launch", "pppippppppppp" "fiiiiiiiii"
        "pppppppp", "bvh_level", dev, state.fb[src], state.fn[src],
        state.nlive, level, inputs.left, inputs.right, inputs.node_lo,
        inputs.node_hi, inputs.pts, inputs.croot_leaf, inputs.node_min,
        state.bound, inputs.qblocks, _eps2_f32(eps2), n, d,
        state.counts.shape[1], tile, state.fb.shape[1],
        int(inputs.node_lo.dtype == torch.bfloat16), int(bf16_prune),
        int(prune_payload), int(stop_on_overflow), state.counts,
        state.minroot, state.fb[dst], state.fn[dst], state.overflow,
        state.hist, state.status, state.tickets)
    build.count(LAUNCHES, "bvh_level")
