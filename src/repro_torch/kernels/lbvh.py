"""The LBVH build of the BVH engines: Morton keys, Karras's radix tree, the
node boxes and the tree depth.

``core/bvh.py``'s ``build_bvh`` is, on the card, aminmax → ``lbvh_keys`` →
``torch.sort`` → ``lbvh_nodes`` → ``lbvh_refit``:

  * ``lbvh_keys`` — f32 points (n, D) and the quantization extent lo, hi
    (D,) → int32 Morton codes (n,): per axis ``clamp((p − lo) · scale, 0,
    1023)`` cast to int32, ``scale = 1023 / (hi − lo)`` where hi > lo,
    else 0, then ``morton_encode`` of the first three axes (missing axes
    0; 15 bits of x and y when ``dims == 2``, else 10 bits of x, y, z). It
    is the redesigned ``morton_encode``: quantization and interleave in one
    pass over the points.
  * ``lbvh_nodes`` — sorted codes (n,) → :class:`Nodes`: Karras (2012)'s
    construction of the n − 1 internal nodes (children, leaf ranges), the
    parent of every node and the refit's arrival counters, set to 0.
  * ``lbvh_refit`` — points, the sort's permutation and the nodes →
    :class:`Refit`: the sorted points, the permutation as int32 and every
    internal node's box (min and max over its leaves, with −0 below +0).
  * ``lbvh_depth`` — left, right → the depth of the deepest leaf (the root
    at 0), ``max_leaf_depth``'s value, as a (1,) int32 tensor.

Each has three parts, as in ``csr_sweep.py``: the CUDA kernel
(``csrc/lbvh.cu``), its wrapper, and the plain PyTorch version, which is
the eager translation of the reference's jitted ``build_bvh`` and
``max_leaf_depth`` (``src/repro/core/bvh.py``). CPU tensors go to the plain
version; CUDA tensors launch the kernel or raise. The outputs of the two
are bit-identical.

Signed zeros: a box coordinate is a min or max over its leaves' points, and
where −0.0 and +0.0 meet ``torch.minimum`` returns its first argument, so
the result would depend on the order of the reduction. Both versions take
−0 below +0 (the min keeps −0, the max +0), as the reference's
``jnp.minimum`` / ``jnp.maximum`` do, so any order gives the reference's
bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build
from .csr_sweep import _cuda_or_raise
from .ref import morton_encode_ref, pad_to

# Launches since the last reset_launches(); the plain versions never count.
LAUNCHES = {"lbvh_keys": 0, "lbvh_nodes": 0, "lbvh_refit": 0,
            "lbvh_depth": 0}

MAX_DIMS = 8        # lbvh_refit_kernel's template range of D
MAX_POINTS = 1 << 30   # int32 node ids and 30-bit keys (the reference's n)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Nodes(NamedTuple):
    left: torch.Tensor      # (n-1,) int32 child node ids (leaf i: n-1+i)
    right: torch.Tensor     # (n-1,) int32
    first: torch.Tensor     # (n-1,) int32 leaf range [first, last]
    last: torch.Tensor      # (n-1,) int32
    parent: torch.Tensor    # (2n-1,) int32 parent node id, -1 at the root
    arrivals: torch.Tensor  # (n-1,) int32 zeros: lbvh_refit's counters


class Refit(NamedTuple):
    pts_sorted: torch.Tensor  # (n, D) f32 points in Morton order
    order: torch.Tensor       # (n,) int32 original index per leaf
    box_lo: torch.Tensor      # (n-1, D) f32
    box_hi: torch.Tensor      # (n-1, D) f32


def _check(named, device):
    for name, x, dtype in named:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_n(n: int) -> None:
    if not 2 <= n < MAX_POINTS:
        raise ValueError(f"an LBVH needs 2 <= n < 2**30 points, got {n}")


# --- plain versions ---------------------------------------------------------


def _clz(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of non-negative 32-bit values (32 for 0): ``frexp``
    gives the exponent e with x = m·2^e, m ∈ [0.5, 1), exactly in f64."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent


def _delta_fn(codes, n):
    """δ(i, j): common-prefix length of the augmented keys (code, sorted
    index), −1 for j out of range."""

    def delta(i, j):
        ok = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        x = codes[i] ^ codes[jc]
        d = torch.where(x != 0, _clz(x), 32 + _clz(i ^ jc))
        return torch.where(ok, d, -1)

    return delta


def min_signed_zero(a, b):
    """``torch.minimum`` of finite floats with −0 below +0."""
    i32 = torch.int32
    return torch.where(a == b, (a.view(i32) | b.view(i32)).view(a.dtype),
                       torch.minimum(a, b))


def max_signed_zero(a, b):
    """``torch.maximum`` of finite floats with +0 above −0."""
    i32 = torch.int32
    return torch.where(a == b, (a.view(i32) & b.view(i32)).view(a.dtype),
                       torch.maximum(a, b))


def range_table_query(values, first, last, reduce):
    """``reduce`` (``torch.minimum`` / ``torch.maximum`` or the signed-zero
    versions above) of ``values[first..last]`` per node: the reference's
    sparse table — level k holds the reduction over [i, i + 2^k) (the last
    row repeated past the end) — answered as reduce(tab_k[first],
    tab_k[last − 2^k + 1]) at k = ⌊log₂ span⌋. The levels are built one at
    a time, each answering its own nodes, so only one level is held at
    once."""
    n = values.shape[0]
    levels = max(1, int(np.ceil(np.log2(max(n, 2)))))
    kk = 31 - _clz(last - first + 1)
    a = first.long()
    out = None
    tab = values
    for k in range(levels + 1):
        if k:
            h = 1 << (k - 1)
            tail = tab[-1:].expand((min(h, n),) + tuple(tab.shape[1:]))
            tab = reduce(tab, torch.cat([tab[h:], tail])[:n])
        b = (last - (1 << k) + 1).clamp(min=0).long()
        got = reduce(tab[a], tab[b])
        sel = (kk == k).reshape((-1,) + (1,) * (values.dim() - 1))
        out = got if out is None else torch.where(sel, got, out)
    return out


def lbvh_keys_plain(points, lo, hi, *, dims: int = 3):
    """Plain PyTorch version of :func:`lbvh_keys` (any device)."""
    f32 = torch.float32
    # a tensor numerator: ``1023.0 / t`` would be computed as a reciprocal
    # times 1023, which is not the reference's division
    top = torch.full((), 1023.0, dtype=f32, device=points.device)
    scale = torch.where(hi > lo, top / (hi - lo), 0.0)
    # clip, then cast: saturates before the cast, as the reference does
    q = torch.clamp((points - lo) * scale, 0, 1023).to(torch.int32)
    q3 = pad_to(q, 3, 1, 0) if q.shape[1] < 3 else q[:, :3]
    return morton_encode_ref(q3, dims=dims)


def lbvh_nodes_plain(codes) -> Nodes:
    """Plain PyTorch version of :func:`lbvh_nodes` (any device): the
    reference's node construction for all n − 1 nodes at once, its three
    searches unrolled (31, 31 and 30 steps)."""
    dev = codes.device
    n = codes.shape[0]
    delta = _delta_fn(codes, n)
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.where(delta(i, i + 1) >= delta(i, i - 1), 1, -1)
    dmin = delta(i, i - d)
    # exponential search for the range length upper bound
    lmax = torch.full_like(i, 2)
    for _ in range(31):
        lmax = torch.where(delta(i, i + lmax * d) > dmin, lmax * 2, lmax)
    # binary search the exact length
    l, t = torch.zeros_like(i), lmax >> 1
    for _ in range(31):
        cond = (t >= 1) & (delta(i, i + (l + t) * d) > dmin)
        l, t = torch.where(cond, l + t, l), t >> 1
    j = i + l * d
    dnode = delta(i, j)
    # binary search the split position (n < 2^30: int32 Morton keys)
    s = torch.zeros_like(i)
    done = torch.zeros_like(i, dtype=torch.bool)
    for k in range(1, 31):
        t = (l + (1 << k) - 1) >> k
        cond = ~done & (t >= 1) & (delta(i, i + (s + t) * d) > dnode)
        s = torch.where(cond, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + d.clamp(max=0)
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    left = torch.where(first == gamma, (n - 1) + gamma, gamma)
    right = torch.where(last == gamma + 1, (n - 1) + gamma + 1, gamma + 1)
    parent = torch.full((2 * n - 1,), -1, dtype=torch.int32, device=dev)
    parent[left] = i.to(torch.int32)
    parent[right] = i.to(torch.int32)
    i32 = torch.int32
    return Nodes(left=left.to(i32), right=right.to(i32), first=first.to(i32),
                 last=last.to(i32), parent=parent,
                 arrivals=torch.zeros(n - 1, dtype=i32, device=dev))


def lbvh_refit_plain(points, order, nodes: Nodes) -> Refit:
    """Plain PyTorch version of :func:`lbvh_refit` (any device): the
    reference's sparse table over the sorted points, its min and max taken
    with −0 below +0."""
    pts_sorted = points[order]
    return Refit(
        pts_sorted=pts_sorted, order=order.to(torch.int32),
        box_lo=range_table_query(pts_sorted, nodes.first, nodes.last,
                                 min_signed_zero),
        box_hi=range_table_query(pts_sorted, nodes.first, nodes.last,
                                 max_signed_zero))


def lbvh_depth_plain(left, right):
    """Plain PyTorch version of :func:`lbvh_depth` (any device): the
    reference's ``max_leaf_depth``. Depth propagates down one level per
    iteration; δ-monotonicity bounds Karras depth by 64, so 64 iterations
    always converge."""
    n_int = left.shape[0]
    depth = torch.zeros(n_int, dtype=torch.int32, device=left.device)
    kids = [ch.long() for ch in (left, right)]
    for _ in range(64):
        child_d = depth + 1
        for ch in kids:
            is_int = ch < n_int
            depth = depth.scatter_reduce(
                0, torch.where(is_int, ch, 0),
                torch.where(is_int, child_d, 0), "amax")
    return (depth.max() + 1).reshape(1)


# --- wrappers ---------------------------------------------------------------


def lbvh_keys(points, lo, hi, *, dims: int = 3):
    """points (n, D) f32, lo and hi (D,) f32 → (n,) int32 Morton codes of
    the quantized cells (2-D codes when ``dims == 2``, else 3-D)."""
    if points.dim() != 2 or lo.shape != (points.shape[1],) \
            or hi.shape != lo.shape:
        raise ValueError(f"points {tuple(points.shape)} must be (n, D) and "
                         f"lo {tuple(lo.shape)}, hi {tuple(hi.shape)} (D,)")
    _check((("points", points, torch.float32), ("lo", lo, torch.float32),
            ("hi", hi, torch.float32)), points.device)
    if points.device.type == "cpu":
        return lbvh_keys_plain(points, lo, hi, dims=dims)
    _cuda_or_raise(points, "lbvh_keys")
    n = points.shape[0]
    codes = torch.empty(n, dtype=torch.int32, device=points.device)
    if n == 0:
        return codes
    build.launch("lbvh", "lbvh_keys_launch", "piippip", "lbvh_keys",
                 points.device, points, n, points.shape[1], lo, hi,
                 2 if dims == 2 else 3, codes)
    LAUNCHES["lbvh_keys"] += 1
    return codes


def lbvh_nodes(codes) -> Nodes:
    """codes (n,) int32, sorted ascending, n ≥ 2 → :class:`Nodes`."""
    if codes.dim() != 1:
        raise ValueError(f"codes {tuple(codes.shape)} must be (n,)")
    _check_n(codes.shape[0])
    _check((("codes", codes, torch.int32),), codes.device)
    if codes.device.type == "cpu":
        return lbvh_nodes_plain(codes)
    _cuda_or_raise(codes, "lbvh_nodes")
    n = codes.shape[0]
    nodes = Nodes(*(torch.empty(m, dtype=torch.int32, device=codes.device)
                    for m in (n - 1,) * 4 + (2 * n - 1, n - 1)))
    build.launch("lbvh", "lbvh_nodes_launch", "pipppppp", "lbvh_nodes",
                 codes.device, codes, n, *nodes)
    LAUNCHES["lbvh_nodes"] += 1
    return nodes


def lbvh_refit(points, order, nodes: Nodes) -> Refit:
    """points (n, D) f32, order (n,) int64 (the stable sort's permutation
    of the codes), the :class:`Nodes` of the sorted codes (their arrival
    counters at 0) → :class:`Refit`."""
    n = points.shape[0]
    if points.dim() != 2 or order.shape != (n,) \
            or nodes.parent.shape != (2 * n - 1,):
        raise ValueError(f"points {tuple(points.shape)}, order "
                         f"{tuple(order.shape)} and parent "
                         f"{tuple(nodes.parent.shape)} must be (n, D), (n,) "
                         "and (2n - 1,)")
    _check_n(n)
    _check((("points", points, torch.float32), ("order", order, torch.int64))
           + tuple((name, x, torch.int32) for name, x in nodes._asdict()
                   .items()), points.device)
    if points.device.type == "cpu":
        return lbvh_refit_plain(points, order, nodes)
    _cuda_or_raise(points, "lbvh_refit")
    d = points.shape[1]
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"lbvh_refit's kernel takes 1 <= D <= {MAX_DIMS}, "
                         f"got D = {d}")
    dev = points.device
    out = Refit(pts_sorted=torch.empty_like(points),
                order=torch.empty(n, dtype=torch.int32, device=dev),
                box_lo=torch.empty((n - 1, d), dtype=torch.float32,
                                   device=dev),
                box_hi=torch.empty((n - 1, d), dtype=torch.float32,
                                   device=dev))
    build.launch("lbvh", "lbvh_refit_launch", "ppii" + "p" * 8, "lbvh_refit",
                 dev, points, order, n, d, nodes.left, nodes.right,
                 nodes.parent, nodes.arrivals, *out)
    LAUNCHES["lbvh_refit"] += 1
    return out


def lbvh_depth(left, right):
    """left, right (n − 1,) int32 of a Karras tree → (1,) int32: the depth
    of its deepest leaf, the root at depth 0."""
    if left.dim() != 1 or right.shape != left.shape:
        raise ValueError(f"left {tuple(left.shape)} and right "
                         f"{tuple(right.shape)} must be (n - 1,)")
    n = left.shape[0] + 1
    _check_n(n)
    _check((("left", left, torch.int32), ("right", right, torch.int32)),
           left.device)
    if left.device.type == "cpu":
        return lbvh_depth_plain(left, right)
    _cuda_or_raise(left, "lbvh_depth")
    parent = torch.empty(2 * n - 1, dtype=torch.int32, device=left.device)
    depth = torch.empty(1, dtype=torch.int32, device=left.device)
    build.launch("lbvh", "lbvh_depth_launch", "ppipp", "lbvh_depth",
                 left.device, left, right, n, parent, depth)
    LAUNCHES["lbvh_depth"] += 1
    return depth
