"""Build the CUDA kernel sources in ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, into ``repro_torch/build/`` (listed in ``.gitignore``),
under a name keyed by the source and the flags, so an edited source is
rebuilt and never stale. Nothing here runs at import time: this module
imports on a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source bytes and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


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
