"""The program's own spans and counters.

Off by default. Then :func:`span` checks one module flag and returns a
shared no-op context, and :func:`count` returns at once: no allocation, no
clock read, no ``record_function``. :func:`recording` turns both on for its
block and yields a :class:`Recorder`; ``Recorder.take()`` hands back, and
clears, what was recorded since the last take.

A recorded span keeps ``(id, parent, name, attrs, t0_ns, t1_ns)`` on
``time.perf_counter_ns()``, its parent being the innermost span open on the
same thread. A counter adds to the innermost open span. While torch's
profiler runs, a recorded span also opens ``record_function("repro_torch."
+ name)``, so it lies in the profiler's trace beside the card's kernels and
copies, on the profiler's clock.

A span never synchronizes and never reads a device value: it times the
host, so around asynchronous device work it times the enqueue, and its
``attrs`` hold host values only. :func:`timed` alone synchronizes, where it
is given a device, with recording on or off: it is how the program writes
its ``timings``.

Spans of the main path (``dbscan``, engine ``grid``), outermost first:
``make_engine`` > ``engine.to_device``, ``engine.build`` > ``plan`` (>
``plan.bounds``, ``plan.layout``, ``plan.need``), ``build.slabs``,
``build.check``, where a reused plan builds under ``build.layout`` and
``build.slabs`` instead of ``plan``; and
``dbscan`` > ``stage1``, ``stage2`` (> ``stage2.round``, attr ``round``),
``border``; ``core.dbscan.hook_rounds`` opens ``stage2.round`` wherever
it runs (ingest and distributed ranks too). ``serve.assign`` >
``assign.pad``, ``assign.to_device``, ``assign.sweep``,
``assign.readback``.

Counters: ``h2d_bytes`` and ``d2h_bytes``, the bytes of each bulk copy
between the host and another device (0 on a CPU run); ``host_syncs``, each
point where the host waits for the engine's device (a synchronize, a
``torch.equal``, a flag read as a bool, a ``.cpu()``), counted on every
device alike; ``jump_steps``, each step of ``union_find.pointer_jump``;
``csr_layouts``, each sort-by-cell pass of the CSR grid (``grid._csr_layout``);
``window_bounds_launches``, each launch of the window-bounds kernel
(``kernels/csr_layout.py``: one a layout on the card, none on the CPU);
``sweep_items``, ``sweep_kept_runs`` and ``sweep_kept_pairs``, each slab
sweep's work items, kept candidate runs and the pairs those runs hold
(``kernels/csr_sweep.py`` ``record_work``).

A counter whose value lies on the device (the sweeps' work) is given to
:func:`count_later` as a tensor: the recorder holds the tensor and reads it
when the record is taken, so recording adds no wait inside a call.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

PREFIX = "repro_torch."

_NOOP = contextlib.nullcontext()
_on = False                   # the one flag the off path reads
_recorder: Recorder | None = None
_local = threading.local()    # .stack: the thread's open spans
_ids = itertools.count(1)
_CPU = torch.device("cpu")


class Span(NamedTuple):
    id: int
    parent: int | None        # the enclosing span's id, None at the top
    name: str
    attrs: dict
    t0_ns: int
    t1_ns: int


class Record(NamedTuple):
    spans: list               # Spans, in the order they closed
    counts: dict              # (span id or None, counter) -> total


class Recorder:
    """Spans and counters recorded since the last :meth:`take`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans, self._counts, self._later = [], {}, []

    def _add(self, span_id, counts: dict, span_: Span | None = None):
        with self._lock:
            if span_ is not None:
                self._spans.append(span_)
            for name, k in counts.items():
                key = (span_id, name)
                self._counts[key] = self._counts.get(key, 0) + k

    def _add_later(self, span_id, name: str, value: torch.Tensor,
                   scale: int):
        with self._lock:
            self._later.append((span_id, name, value, scale))

    def take(self) -> Record:
        """What was recorded since the last take; the tensors of
        :func:`count_later` are read now, one read a device."""
        with self._lock:
            spans, counts, later = self._spans, self._counts, self._later
            self._spans, self._counts, self._later = [], {}, []
        by_device = {}
        for entry in later:
            by_device.setdefault(entry[2].device, []).append(entry)
        for entries in by_device.values():
            values = torch.stack([v.reshape(())
                                  for _, _, v, _ in entries]).tolist()
            for (span_id, name, _, scale), v in zip(entries, values):
                key = (span_id, name)
                counts[key] = counts.get(key, 0) + v * scale
        return Record(spans, counts)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A recorded span while it is open."""
    __slots__ = ("rec", "id", "parent", "name", "attrs", "counts", "rf",
                 "t0")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.id, self.counts = next(_ids), {}

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        self.rec._add(self.id, self.counts, Span(
            self.id, self.parent, self.name, self.attrs, self.t0, t1))
        return False


def span(name: str, **attrs):
    """A context that records a span named ``name`` while recording is on,
    and does nothing otherwise."""
    if not _on:
        return _NOOP
    return _Open(_recorder, name, attrs)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` of the innermost open span (of the
    recording, where no span is open) while recording is on."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + k
    else:
        _recorder._add(None, {name: k})


def count_later(name: str, value: torch.Tensor, scale: int = 1) -> None:
    """Add ``scale`` times the one integer in ``value`` to counter ``name``
    of the innermost open span, while recording is on. ``value`` may lie
    on a device: it is held, not read, until the record is taken."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    _recorder._add_later(stack[-1].id if stack else None, name, value, scale)


def is_recording() -> bool:
    """Whether spans and counters are recorded now."""
    return _on


@contextlib.contextmanager
def recording():
    """Record spans and counters for the block; yields the
    :class:`Recorder`."""
    global _on, _recorder
    prev = _on, _recorder
    _recorder = Recorder()
    _on = True
    try:
        yield _recorder
    finally:
        _on, _recorder = prev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU); one
    ``host_syncs``."""
    count("host_syncs")
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(timings: dict, key: str, device: torch.device | None = None,
          name: str | None = None):
    """A span (``name``, by default ``key`` without its ``_s``) that also
    writes the block's host seconds to ``timings[key]``, after
    synchronizing ``device`` where one is given, recording on or off."""
    with span(name or key.removesuffix("_s")):
        t0 = time.perf_counter()
        yield
        if device is not None:
            synchronize(device)
        timings[key] = time.perf_counter() - t0


def copy_counter(src: torch.device, dst: torch.device) -> str | None:
    """The counter a copy from ``src`` to ``dst`` adds its bytes to:
    ``h2d_bytes`` from the host to another device, ``d2h_bytes`` back,
    None where both are the host or neither is."""
    if (src.type == "cpu") == (dst.type == "cpu"):
        return None
    return "h2d_bytes" if src.type == "cpu" else "d2h_bytes"


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, counting the
    result's bytes where they crossed from the host."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if _on:
        src = x.device if isinstance(x, torch.Tensor) else _CPU
        kind = copy_counter(src, t.device)
        if kind:
            count(kind, t.nbytes)
    return t


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: one ``host_syncs``, and its bytes where they crossed
    from a device."""
    if _on:
        count("host_syncs")
        kind = copy_counter(t.device, _CPU)
        if kind:
            count(kind, t.nbytes)
    return t.cpu()


def total(record: Record, counter: str, under: str | None = None) -> int:
    """``counter`` summed over the record, or only over the spans named
    ``under`` and the spans inside them."""
    if under is None:
        return sum(v for (_, c), v in record.counts.items() if c == counter)
    parent = {s.id: s.parent for s in record.spans}
    name = {s.id: s.name for s in record.spans}

    def inside(sid):
        while sid is not None:
            if name.get(sid) == under:
                return True
            sid = parent.get(sid)
        return False
    return sum(v for (sid, c), v in record.counts.items()
               if c == counter and inside(sid))
