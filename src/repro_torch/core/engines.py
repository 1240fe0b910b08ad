"""Capability-based neighbor-engine registry.

One dispatch table for ``make_engine`` and ``dbscan``'s round-driver
selection. An engine registers once and advertises what it can do through
the fields of the :class:`Engine` it builds:

  * ``sweep``        — the fused (counts, min-core-root) primitive every
                       engine must provide;
  * ``sweep_sorted`` + ``order`` — optional sorted-layout fast path; its
                       presence opts a run into ``dbscan``'s sorted hooking
                       loop;
  * ``sweep_counts`` — optional counts-only stage-1 sweep in sorted layout
                       (skips the payload plane the stage discards);
  * ``neighbors``    — optional neighbor-*list* capability backing
                       ``find_neighbors``;
  * ``query``        — optional cross-corpus queries against the frozen
                       layout (fresh points, not corpus members): the
                       serving tier's ``assign`` and ingest;
  * ``sweep_frontier`` — optional frontier-compacted stage-2 rounds: a
                       :class:`FrontierPlan` that lets
                       ``dbscan(hook_loop="frontier")`` re-sweep only the
                       tiles that can still produce a union;
  * ``meta``         — the engine's static plan (``CSRGridSpec``,
                       ``GridSpec``, ``WavefrontSpec``, or the stack
                       engine's ``{"stack", "depth"}``);
  * ``timings``      — build-time breakdown: ``make_engine`` records
                       ``build_s``; builders may add finer phases.

The port registers every engine of the reference: ``grid``, ``grid-hash``
and ``brute`` (``neighbors.py``), ``bvh`` and ``bvh-stack`` (``bvh.py``).
Asking for another raises ``ValueError``.

A second table holds the distributed driver's *local* engines (``brute``,
``csr``, ``grid``, ``bvh``; ``distributed/dbscan_dist.py``), through
:func:`register_local_engine` and :func:`get_local_engine`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import trace
from ..trace import synchronize  # noqa: F401  (re-export: one helper)


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA without a card raises: the
    port never carries on on the CPU unless the caller says ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev


class FrontierPlan(NamedTuple):
    """The ``sweep_frontier`` capability: everything the frontier round
    driver needs to re-sweep only the live tiles of a hooking round.

      * ``sweep(state, croot_s, qroot_s, changed_s, pending) ->
        (minroot, pending', n_live)`` — one frontier round: fold
        ``changed_s`` (payload changed since last round, sorted layout)
        into ``pending``, intersect with the live-seam test, sweep exactly
        the live tiles, clear them from ``pending``. Parked tiles return
        INT32_MAX rows (a no-op for the hook). ``n_live`` is a device
        scalar.
      * ``border(state, croot_s, core_s) -> minroot`` — the final border
        sweep, restricted to tiles with both a core candidate in the slab
        and a non-core query.
    """
    n_tiles: int
    sweep: Callable
    border: Callable


class Engine(NamedTuple):
    """A built neighbor-search engine; fields double as capability flags."""
    name: str
    state: Any                       # NamedTuple of tensors on ``device``
    sweep: Callable                  # (state, core, root) -> (counts, minroot)
    device: torch.device
    meta: Any = None                 # static plan (CSRGridSpec, ...)
    sweep_sorted: Callable | None = None  # (state, croot_sorted) ->
    #                                  (counts, minroot), all in sorted layout
    order: Any = None                # (n,) sorted position -> original index
    timings: dict | None = None      # build-time breakdown, seconds
    sweep_counts: Callable | None = None  # (state, work=None) -> counts,
    #                                  sorted layout; a sweep that counts
    #                                  its work puts "kept_runs" (a device
    #                                  scalar) and "pairs_per_run" in the
    #                                  dict ``work``
    neighbors: Callable | None = None     # (state, k_max=) -> (idx, counts)
    sweep_frontier: FrontierPlan | None = None  # frontier-compacted stage-2
    #                                  rounds; presence opts dbscan's
    #                                  hook_loop="frontier" in
    query: Callable | None = None    # (state, q, nq, croot_sorted, *,
    #                                  slab=None, block_q=256) -> (counts,
    #                                  minroot, mind2, overflow)


class EngineSpec(NamedTuple):
    """Registry entry: how to build an engine, a one-line description, and
    the capabilities the built Engine will advertise."""
    name: str
    build: Callable                  # (points, eps, **kw) -> Engine
    doc: str = ""
    capabilities: frozenset = frozenset()


_REGISTRY: dict[str, EngineSpec] = {}
_LOCAL_REGISTRY: dict[str, Callable] = {}


def register_engine(name: str, build_fn: Callable, *, doc: str = "",
                    capabilities=()) -> None:
    """Register (or re-register) a single-device engine builder."""
    _REGISTRY[name] = EngineSpec(name=name, build=build_fn, doc=doc,
                                 capabilities=frozenset(capabilities))


def register_local_engine(name: str, build_fn: Callable) -> None:
    """Register a distributed *local* engine builder with signature
    ``build(cand_pts, eps, n_cand, p_own, cfg) -> (sweep_all, sweep_own,
    overflow)`` where ``sweep_*(croot) -> (counts, minroot)`` answer the
    fused query for all local candidates / the owned prefix respectively,
    and ``overflow`` raises the driver's regrow-and-restart flag."""
    _LOCAL_REGISTRY[name] = build_fn


def _ensure_builtin() -> None:
    # neighbors, bvh and the distributed driver import this module, so they
    # register themselves here lazily rather than being imported at the top.
    from . import bvh as _bvh       # noqa: F401  (bvh, bvh-stack)
    from . import neighbors as _nb  # noqa: F401  (brute, grid, grid-hash)
    from ..distributed import dbscan_dist as _dd  # noqa: F401 (local engines)


def get_engine_spec(name: str) -> EngineSpec:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered engines: "
            f"{', '.join(available_engines())}") from None


def available_engines() -> tuple:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def get_local_engine(name: str) -> Callable:
    _ensure_builtin()
    try:
        return _LOCAL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown local_engine {name!r}; registered local engines: "
            f"{', '.join(available_local_engines())}") from None


def available_local_engines() -> tuple:
    _ensure_builtin()
    return tuple(sorted(_LOCAL_REGISTRY))


def make_engine(points, eps: float, *, engine: str = "grid",
                chunk: int = 2048, dims: int | None = None, spec=None,
                device=None, **extra) -> Engine:
    """Build an engine over ``points`` (n, 3) for radius ``eps``.

    The structure build (plan, cell sort or hashing, BVH build and
    frontier calibration) happens here; its wall-clock is recorded in
    ``Engine.timings["build_s"]`` (plan included). ``spec`` reuses a plan
    (``CSRGridSpec`` for ``grid``, ``GridSpec`` for ``grid-hash``,
    ``WavefrontSpec`` for ``bvh``) from the same dataset. ``chunk`` tiles
    the brute and grid-hash query sweeps; the CSR engine's tile size is
    part of its plan. Engine-specific keywords (``batch=``,
    ``terminate=``, ``prune_dtype=`` for ``bvh``; ``early_stop=``,
    ``stack=`` for ``bvh-stack``) are forwarded to the builder, and one
    the builder does not take is a ``TypeError``. ``device=None`` means
    ``cuda``.
    """
    entry = get_engine_spec(engine)
    dev = resolve_device(device)
    built: dict = {}
    with trace.span("make_engine", engine=engine):
        with trace.span("engine.to_device"):
            points = trace.to_device(points, dev, torch.float32)
        with trace.timed(built, "build_s", dev, name="engine.build"):
            eng = entry.build(points, float(eps), chunk=chunk, dims=dims,
                              spec=spec, **extra)
    timings = dict(eng.timings or {})
    timings.setdefault("build_s", built["build_s"])
    return eng._replace(timings=timings)
