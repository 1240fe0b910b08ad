"""Build the CUDA kernel sources in ``repro_torch/csrc`` and launch them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, into ``repro_torch/build/`` (listed in ``.gitignore``),
under a name keyed by the source, every ``csrc`` header it includes (at any
depth) and the flags, so an edited source or header is rebuilt and never
stale. :func:`launch` is the one way the kernel wrappers call a library:
it binds the C signature, passes the device, tensor pointers and PyTorch's
current stream, and raises on a non-zero CUDA error code. Nothing here runs
at import time: this module imports on a machine with no ``nvcc`` and no
card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
# ctypes types of the letters of a launch signature
_CTYPES = {"i": ctypes.c_int, "f": ctypes.c_float, "p": ctypes.c_void_p}


class Built(NamedTuple):
    path: Path
    log: str      # nvcc's output (ptxas register and spill lines); "" if
    #               the library was already built


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch build only where the CUDA toolkit "
            "is installed")
    return nvcc


def local_headers(path: Path) -> list[Path]:
    """Every header in ``path``'s directory that ``path`` includes with
    ``#include "..."``, directly or through another such header, sorted."""
    seen: dict[Path, None] = {}
    todo = [path]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_bytes()):
            hdr = path.parent / name.decode()
            if hdr.is_file() and hdr not in seen:
                seen[hdr] = None
                todo.append(hdr)
    return sorted(seen)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the bytes of the source
    and of every local header it includes, and by the flags."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in local_headers(src):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> list[str]:
    """Names of every kernel source in ``csrc``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names) -> dict[str, Built]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together. Raises RuntimeError with the compiler's output if any
    build fails."""
    out = {name: Built(library_path(name), "") for name in names}
    todo = [name for name, b in out.items() if not b.path.exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        # a per-process temporary name, renamed into place when complete,
        # so concurrent builders never load half a file
        tmp = out[name].path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[name].path)
        out[name] = out[name]._replace(log=log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name].path))


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = load(name)
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


@functools.cache
def _function(lib: str, fn: str, sig: str):
    f = getattr(_library(lib), fn)
    f.argtypes = [_CTYPES[c] for c in sig]
    f.restype = ctypes.c_int
    return f


def launch(lib: str, fn: str, sig: str, kernel: str, device: torch.device,
           *args) -> None:
    """Call ``fn`` of ``csrc/<lib>.cu`` on ``device``'s current stream.

    Every launch function has the C signature ``int fn(int device, ...,
    void* stream)`` and returns a ``cudaError_t`` code. ``sig`` spells the
    middle arguments, one letter each: ``p`` a tensor (its data pointer),
    ``i`` an int, ``f`` a float. Raises RuntimeError naming ``kernel`` when
    the code is not 0 (for example a refused launch).
    """
    f = _function(lib, fn, "i" + sig + "p")
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = f(device.index, *conv, ctypes.c_void_p(stream))
    if err != 0:
        msg = getattr(_library(lib), f"{lib}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg})")
