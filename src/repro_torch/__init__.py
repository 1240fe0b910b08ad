"""RT-DBSCAN on PyTorch and CUDA: the port of ``repro`` (JAX, TPU) to one
NVIDIA H100.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise. On the CPU every kernel wrapper runs its plain
PyTorch version. This package imports neither ``jax`` nor ``repro``.
"""
from .core.dbscan import DBSCANResult, dbscan
from .core.engines import make_engine
from .core.neighbors import find_neighbors
from .data import synth

__all__ = ["DBSCANResult", "dbscan", "find_neighbors", "make_engine",
           "synth"]
