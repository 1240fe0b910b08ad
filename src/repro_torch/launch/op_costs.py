"""Loop-aware cost accounting of an eager PyTorch program (the port of
``repro.launch.hlo_costs``).

The reference walks optimized HLO text and multiplies each ``while`` body
by its trip count, because XLA's ``cost_analysis()`` visits a ``lax.scan``
body once. The port has no HLO: its loops (layers, attention chunks, scan
chunks) run in Python, so every iteration reaches the dispatcher and
:class:`OpCosts`, a ``TorchDispatchMode``, counts each aten op as it runs,
on ``meta`` tensors (shapes without storage) or on real ones. Nothing is
undercounted, so there is no ``dynamic_whiles`` flag: a loop whose trip
count depends on the data reads a tensor on the host, which fails on
``meta`` (:class:`DataDependentError`, naming the op).

  * FLOPs: products and convolutions only, 2·|out|·K, as the reference's
    ``_dot_flops`` counts a ``dot``: the formulas of
    ``torch.utils.flop_counter``'s registry, and for the products it
    leaves out (``mv``, ``addmv``, ``dot``, ``vdot``: a matrix or vector
    by a vector, which XLA lowers to a ``dot`` too) 2·|out|·K here.
    Elementwise work is not counted.
  * Bytes: each aten op's tensor inputs plus its outputs. View and
    metadata ops (an output that aliases an input, ``empty``) cost
    nothing, the eager form of the reference's ``_SKIP_BYTES_OPS``;
    ``_unsafe_view``, the reshape that ``matmul`` ends a folded 3-D
    product with and that a ``reshape`` of a copy ends with, is a view
    whose schema carries no alias annotation, and costs nothing too; an
    input read through a broadcast (stride 0) counts its distinct
    elements. Gather-style ops (``index``, ``index_select``, ``gather``,
    ``embedding``) count the bytes they touch, 2·|out|; scatter-style ops
    (``index_put_``, ``scatter*``, ``index_add``, ``slice_scatter``, ...)
    and ``copy_`` into a slice count 2·|update|, as ``_instr_bytes``
    does. The port does not fuse, so this is the traffic of the program
    the port actually runs, not XLA's count at fusion boundaries: a
    per-layer ``select`` of a stacked weight is a view, and the product
    that consumes it reads only the layer's slice, which the reference's
    ``_fusion_boundary_bytes`` reconstructs by hand.

A full-width trace on ``meta`` repeats the same ops many times (36 layers
× 1,024 attention chunk pairs at a 32K prefill), and PyTorch's meta
kernels run in Python, so the mode memoises: a functional op (no output
aliasing an input, nothing written in place, no ``out=``) whose signature
(op, each tensor's shape, strides and dtype, every other argument) was
seen before, with every output on ``meta``, gets fresh
``torch.empty_strided(..., device="meta")`` outputs of the recorded
shapes and strides and the recorded costs, without running the meta
kernel again. Views, in-place ops and ops on real tensors always run.
"""
from __future__ import annotations

import collections
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding,
           aten.take}
# scatter-style op → index of the update among its positional arguments
_SCATTER = {
    aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
    aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
    aten.scatter_add_: 3, aten.scatter_reduce: 3, aten.scatter_reduce_: 3,
    aten.index_add: 3, aten.index_add_: 3, aten.index_copy: 3,
    aten.index_copy_: 3, aten.slice_scatter: 1, aten.select_scatter: 1,
    aten.diagonal_scatter: 1, aten.as_strided_scatter: 1,
}
# allocations, and the one view whose schema has no alias annotation
# (``_reshape_alias`` and the other views carry one)
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like,
               aten.new_empty, aten.new_empty_strided, aten._unsafe_view}


class DataDependentError(RuntimeError):
    """An op read a tensor's value on the host (``item()``, ``bool()``, a
    data-dependent shape), which a ``meta`` tensor does not have."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _touched(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a broadcast dim, stride 0,
    reads one element)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride:
            n *= size
    return n


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _key_of(x):
    """A hashable signature of an argument: a tensor by its metadata, a
    scalar with its type (1, 1.0 and True compare equal in Python but
    give outputs of other dtypes)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_key_of(v) for v in x)
    return (type(x), x)


def _spec(out):
    """The recorded form of an op's outputs, or None when one is not a
    meta tensor (then the op is not memoised)."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype) \
            if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)):
        specs = tuple(_spec(v) if v is not None else False for v in out)
        return None if any(s is None for s in specs) else \
            (type(out), specs)
    return None


def _build(spec):
    if spec is False:
        return None
    if isinstance(spec[0], type):
        kind, specs = spec
        return kind(_build(s) for s in specs)
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _functional(func) -> bool:
    s = func._schema
    if s.is_mutable or any(r.alias_info is not None for r in s.returns):
        return False
    return not ({torch.Tag.data_dependent_output,
                 torch.Tag.dynamic_output_shape,
                 torch.Tag.nondeterministic_seeded} & set(func.tags))


def _reads_values(func) -> bool:
    """Whether ``func``'s result depends on tensor values, not shapes."""
    return func.overloadpacket in (aten.is_nonzero, aten.item) or bool(
        {torch.Tag.data_dependent_output, torch.Tag.dynamic_output_shape}
        & set(func.tags))


def op_bytes(func, args, kwargs, out) -> float:
    """Memory traffic of one aten op (module docstring)."""
    packet = func.overloadpacket
    if packet in _NO_TRAFFIC:
        return 0.0
    s = func._schema
    if not s.is_mutable and any(r.alias_info is not None for r in s.returns):
        return 0.0                                  # a view
    if packet in _GATHER:
        return 2.0 * sum(_nbytes(t) for t in _tensors(out))
    if packet in _SCATTER:
        i = _SCATTER[packet]
        upd = args[i] if len(args) > i else None
        if isinstance(upd, torch.Tensor):
            return 2.0 * _touched(upd)
        # a scalar written at every index
        idx = args[2] if packet in (aten.scatter, aten.scatter_) else None
        return 2.0 * (idx.numel() * args[0].element_size()
                      if isinstance(idx, torch.Tensor) else 0)
    if packet is aten.copy_:
        return float(_touched(args[1]) + _nbytes(args[0]))
    if packet in (aten.fill_, aten.zero_):
        return float(_nbytes(args[0]))
    total = sum(_touched(t) for t in _tensors(args))
    total += sum(_touched(t) for t in _tensors(list(kwargs.values())))
    return float(total + sum(_nbytes(t) for t in _tensors(out)))


# products ``torch.utils.flop_counter`` does not count: a matrix by a
# vector (``x @ w`` with a 1-D ``w`` dispatches ``mv``), two vectors
_VECTOR = {aten.mv, aten.addmv, aten.dot, aten.vdot}


def op_flops(func, args, kwargs, out) -> float:
    """Product FLOPs of one aten op, 2·|out|·K (module docstring)."""
    packet = func.overloadpacket
    if packet in _VECTOR:
        vec = args[2] if packet is aten.addmv else args[1]
        return 2.0 * max(out.numel(), 1) * vec.shape[0]
    formula = flop_registry.get(packet)
    return float(formula(*args, **kwargs, out_val=out)) if formula else 0.0


class OpCosts(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op run under it::

        with OpCosts() as c:
            loss = step(...)
        c.flops, c.bytes, c.breakdown()

    ``memo=False`` runs every op (the counts are the same; the tests hold
    them so)."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.memo_hits = 0
        self.seconds = 0.0
        self.by_op = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self._memo = {} if memo else None
        self._functional = {}
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        return super().__exit__(*exc)

    def _account(self, func, flops, nbytes):
        self.ops += 1
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op[func.overloadpacket]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if self._memo is not None:
            ok = self._functional.get(func)
            if ok is None:
                ok = self._functional[func] = _functional(func)
            if ok:
                key = (func, _key_of(args), _key_of(tuple(kwargs.items())))
                hit = self._memo.get(key)
                if hit is not None:
                    spec, flops, nbytes = hit
                    self.memo_hits += 1
                    self._account(func, flops, nbytes)
                    return _build(spec)
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if _reads_values(func) and any(
                    t.device.type == "meta" for t in _tensors(args)):
                raise DataDependentError(
                    f"{func} failed on meta tensors ({e}); a value read on "
                    "the host (item(), bool(), a data-dependent shape or "
                    "loop) has no meta counterpart") from e
            raise
        flops = op_flops(func, args, kwargs, out)
        nbytes = op_bytes(func, args, kwargs, out)
        if key is not None:
            spec = _spec(out)
            if spec is not None:
                self._memo[key] = (spec, flops, nbytes)
        self._account(func, flops, nbytes)
        return out

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "memo_hits": self.memo_hits, "seconds": self.seconds}

    def breakdown(self, top: int = 12) -> str:
        """Where the bytes and FLOPs go, by aten op (the report of the
        reference's ``hlo_costs.breakdown``, keyed by op)."""
        lines = [f"total flops={self.flops:.3e} bytes={self.bytes:.3e} "
                 f"ops={self.ops} memo_hits={self.memo_hits}",
                 "-- top bytes --"]
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])
        lines += [f"  {b:.3e}  {op} ({n})" for op, (n, _, b) in rows[:top]
                  if b]
        lines.append("-- top flops --")
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][1])
        lines += [f"  {f:.3e}  {op} ({n})" for op, (n, f, _) in rows[:top]
                  if f]
        return "\n".join(lines)
