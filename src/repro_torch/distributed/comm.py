"""Collectives of the distributed driver: the port's counterpart of the
``jax.lax`` collectives that the reference calls inside ``shard_map``.

Each rank of a group holds a ``Comm`` with

  * ``axis_index()`` and ``axis_size()``;
  * ``psum``, ``pmin``, ``pmax`` — elementwise over the ranks;
  * ``all_to_all(x)`` — equal splits of ``x``'s first axis, chunk ``j`` to
    rank ``j``; a rank receives its chunks concatenated in source order
    (``jax.lax.all_to_all(x, ax, 0, 0, tiled=True)``);
  * ``ppermute(x, shift)`` — rank ``i`` sends to ``(i + shift) % D`` and
    receives from ``(i - shift) % D`` (the reference's ``perm_r`` is
    ``shift=+1``, its ``perm_l`` ``shift=-1``).

Two groups; the caller picks one, and nothing picks one when the other
fails:

  * :class:`ThreadGroup` — D ranks as D threads of one process on one
    device. A collective is a barrier and an exchange of tensors that stay
    on the device. On a card every rank launches on the device's default
    stream, so stream order puts each collective's reads after the
    producers' writes: no host copy and no event. This is the counterpart
    of the reference's ``xla_force_host_platform_device_count``, and how D
    ranks run on one card.
  * :class:`ProcessGroup` — one process a rank over ``torch.distributed``:
    NCCL when every rank has its own card (``cuda:rank``), gloo on the CPU.
    :func:`spawn` starts such a group and returns rank 0's result.
"""
from __future__ import annotations

import collections
import contextlib
import socket
import threading

import torch

from ..core.engines import resolve_device


class ThreadGroup:
    """D ranks as D threads of this process, all on ``device`` (``None``
    means ``cuda``; it raises without a card)."""

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError(f"a group needs at least one rank, got {size}")
        self.size = size
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._slots = [None] * size
        self._barrier = threading.Barrier(size)

    def run(self, fn, *args) -> list:
        """``[fn(comm_0, *args), ..., fn(comm_{D-1}, *args)]``, each call on
        its own thread. A rank that raises breaks the barrier, so the
        others stop at their next collective; the first error is raised
        here."""
        self._barrier.reset()
        results = [None] * self.size
        errors = []

        def body(rank):
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                results[rank] = fn(_ThreadComm(self, rank), *args)
            except BaseException as e:   # noqa: BLE001  (re-raised below)
                errors.append((rank, e))
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"rank-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            # the first failure, not the broken barriers it caused
            first = next((e for _, e in errors
                          if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0][1])
            raise first
        return results

    def _exchange(self, rank: int, x):
        """Every rank's ``x``, in rank order. The second barrier keeps a
        slot from being overwritten before every rank has read it."""
        self._slots[rank] = x
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
        return out


def _sent(comm, name: str, x) -> None:
    """Count the bytes this rank puts into collective ``name``."""
    comm.sent[name] += x.numel() * x.element_size()


class _ThreadComm:
    def __init__(self, group: ThreadGroup, rank: int):
        self.group, self.rank = group, rank
        self.device = group.device
        self.sent = collections.Counter()   # bytes put in, by collective

    def axis_index(self) -> int:
        return self.rank

    def axis_size(self) -> int:
        return self.group.size

    def _all(self, x):
        return self.group._exchange(self.rank, x)

    def psum(self, x):
        _sent(self, "psum", x)
        vals = self._all(x)
        out = vals[0].clone()
        for v in vals[1:]:
            out += v
        return out

    def pmin(self, x):
        _sent(self, "pmin", x)
        return torch.stack(self._all(x)).amin(dim=0)

    def pmax(self, x):
        _sent(self, "pmax", x)
        return torch.stack(self._all(x)).amax(dim=0)

    def all_to_all(self, x):
        _sent(self, "all_to_all", x)
        vals = self._all(x)
        return torch.cat([v.chunk(self.group.size)[self.rank] for v in vals])

    def ppermute(self, x, shift: int):
        _sent(self, "ppermute", x)
        return self._all(x)[(self.rank - shift) % self.group.size].clone()


class ProcessGroup:
    """This process's rank of the ``torch.distributed`` default group.

    ``device`` ``"cuda"`` (the default) runs on ``cuda:rank`` over NCCL and
    raises when there are fewer cards than ranks; ``"cpu"`` runs over gloo.
    ``init_method`` is a ``tcp://localhost:<port>`` address (see
    :func:`free_address`). :meth:`close` ends the group."""

    def __init__(self, rank: int, size: int, init_method: str, device=None):
        import torch.distributed as dist
        kind = torch.device("cuda" if device is None else device).type
        if kind == "cuda":
            resolve_device("cuda")
            if size > torch.cuda.device_count():
                raise RuntimeError(
                    f"a process group of {size} CUDA ranks needs {size} "
                    f"cards and {torch.cuda.device_count()} are visible; "
                    "run several ranks on one card with ThreadGroup")
            self.device = torch.device("cuda", rank)
            torch.cuda.set_device(self.device)
            backend = "nccl"
        else:
            self.device = torch.device("cpu")
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=size)
        self._dist = dist
        self.rank, self.size = rank, size
        self.sent = collections.Counter()   # bytes put in, by collective

    def close(self) -> None:
        self._dist.destroy_process_group()

    def run(self, fn, *args) -> list:
        """``[fn(self, *args)]``: this process is one rank of the group."""
        return [fn(self, *args)]

    def axis_index(self) -> int:
        return self.rank

    def axis_size(self) -> int:
        return self.size

    def _reduce(self, x, op, name):
        _sent(self, name, x)
        out = x.clone()
        self._dist.all_reduce(out, op=op)
        return out

    def psum(self, x):
        return self._reduce(x, self._dist.ReduceOp.SUM, "psum")

    def pmin(self, x):
        return self._reduce(x, self._dist.ReduceOp.MIN, "pmin")

    def pmax(self, x):
        return self._reduce(x, self._dist.ReduceOp.MAX, "pmax")

    def all_to_all(self, x):
        _sent(self, "all_to_all", x)
        x = x.contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x)
        return out

    def ppermute(self, x, shift: int):
        _sent(self, "ppermute", x)
        if self.size == 1:
            return x.clone()
        # bool travels as uint8, which every backend carries
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        out = torch.empty_like(wire)
        ops = [self._dist.P2POp(self._dist.isend, wire,
                                (self.rank + shift) % self.size),
               self._dist.P2POp(self._dist.irecv, out,
                                (self.rank - shift) % self.size)]
        for req in self._dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(torch.bool) if x.dtype == torch.bool else out


def free_address() -> str:
    """A ``tcp://localhost:<port>`` address on a port that was free."""
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _spawned(rank, size, init_method, device, threads, fn, args, queue):
    if threads:
        torch.set_num_threads(threads)
    group = None
    try:
        group = ProcessGroup(rank, size, init_method, device)
        out = fn(group, *args)
        if rank == 0:
            queue.put(("ok", out))
    except BaseException as e:   # noqa: BLE001  (reported, then re-raised)
        queue.put(("error", f"rank {rank}: {type(e).__name__}: {e}"))
        raise
    finally:
        if group is not None:
            group.close()


def spawn(size: int, fn, *args, device=None, threads: int | None = None,
          timeout: float = 600.0):
    """Run ``fn(group, *args)`` on ``size`` new processes, each one rank of
    a :class:`ProcessGroup` on ``device`` (``"cuda"``: NCCL, a card a rank;
    ``"cpu"``: gloo), and return rank 0's result. ``fn`` and its arguments
    and result are pickled (``fn`` by its import path); ``threads`` sets
    each process's torch intra-op threads. Raises when a rank fails or the
    group does not finish within ``timeout`` seconds; every process is
    ended before it returns."""
    import multiprocessing as mp
    import queue as queue_mod
    if torch.device("cuda" if device is None else device).type == "cuda":
        resolve_device("cuda")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = free_address()
    procs = [ctx.Process(target=_spawned,
                         args=(r, size, init, device, threads, fn, args, q))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        try:
            status, out = q.get(timeout=timeout)
        except queue_mod.Empty:
            raise RuntimeError(f"process group of {size} did not finish in "
                               f"{timeout} s") from None
        if status != "ok":
            raise RuntimeError(f"process group failed: {out}")
        for p in procs:
            p.join(timeout)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"process group ranks exited with {bad}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
