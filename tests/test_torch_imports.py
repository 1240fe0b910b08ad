"""repro_torch stands alone: importing it loads neither JAX nor the JAX
package, and its entry points never fall back to the CPU by themselves."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import grid as tgrid

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODULES = ["repro_torch", "repro_torch.baselines",
           "repro_torch.baselines.brute", "repro_torch.baselines.fdbscan",
           "repro_torch.core", "repro_torch.core.bvh",
           "repro_torch.core.dbscan", "repro_torch.core.engines",
           "repro_torch.core.grid", "repro_torch.core.labels",
           "repro_torch.core.neighbors", "repro_torch.core.union_find",
           "repro_torch.data", "repro_torch.data.synth",
           "repro_torch.distributed", "repro_torch.distributed.checkpoint",
           "repro_torch.kernels", "repro_torch.kernels.build",
           "repro_torch.kernels.bvh_sweep",
           "repro_torch.kernels.cross_sweep",
           "repro_torch.kernels.csr_sweep",
           "repro_torch.kernels.frontier_sweep",
           "repro_torch.kernels.gathered_sweep",
           "repro_torch.kernels.morton", "repro_torch.kernels.ops",
           "repro_torch.kernels.pairwise_sweep", "repro_torch.kernels.ref",
           "repro_torch.serve", "repro_torch.serve.assign",
           "repro_torch.serve.faults", "repro_torch.serve.ingest",
           "repro_torch.serve.resilience", "repro_torch.serve.scheduler",
           "repro_torch.serve.snapshot", "repro_torch.serve.wal"]


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import repro_torch\n"
        "pts = [[0.0, 0.0, 0.0], [0.01, 0.0, 0.0]]\n"
        "for e in ('grid', 'grid-hash', 'brute'):\n"
        "    repro_torch.dbscan(pts, 0.1, 2, engine=e, device='cpu')\n"
        "    repro_torch.find_neighbors(pts, 0.1, 4, engine=e, device='cpu')\n"
        "repro_torch.dbscan(pts, 0.1, 2, hook_loop='frontier', device='cpu')\n"
        "for e in ('bvh', 'bvh-stack'):\n"
        "    repro_torch.dbscan(pts, 0.1, 2, engine=e, device='cpu')\n"
        "repro_torch.dbscan(pts, 0.1, 2, engine='bvh', hook_loop='frontier',"
        " device='cpu')\n"
        "from repro_torch.baselines import fdbscan\n"
        "fdbscan.run(pts, 0.1, 2, early_exit=True, device='cpu')\n"
        "import tempfile\n"
        "from repro_torch import serve\n"
        "d = tempfile.mkdtemp()\n"
        "s = serve.ServeSession(serve.build_snapshot(pts, 0.1, 2, device='cpu'),"
        " ckpt_dir=d + '/ck', wal=serve.WriteAheadLog(d + '/wal'))\n"
        "s.assign([[0.0, 0.01, 0.0]])\n"
        "s.ingest([[0.02, 0.0, 0.0]])\n"
        "s.compact()\n"
        "s.wal.close()\n"
        "serve.ServeSession.recover(d + '/ck', d + '/wal', device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.dbscan(pts, 0.1, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.make_engine(pts, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgrid.plan_csr_grid(pts, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.dbscan(pts, 0.1, 2, device="cuda")
    for engine in ("grid-hash", "brute"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.dbscan(pts, 0.1, 2, engine=engine)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.find_neighbors(pts, 0.1, 4, engine=engine)
    for engine in ("bvh", "bvh-stack"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.dbscan(pts, 0.1, 2, engine=engine)
    res = repro_torch.dbscan(pts, 0.1, 2, device="cpu")
    assert res.labels.tolist() == [0, 0, 0, 0]


def test_kernel_build_is_keyed_and_raises_without_nvcc(monkeypatch,
                                                       tmp_path):
    from repro_torch.kernels import build
    assert build.sources() == ["bvh_sweep", "csr_sweep", "gathered_sweep",
                               "lbvh"]
    path = build.library_path("csr_sweep")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-g",))
    assert build.library_path("csr_sweep") != path  # flags change the key
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("csr_sweep")
    assert list(tmp_path.iterdir()) == []


def test_kernel_build_key_covers_included_headers(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    for name in build.sources():
        headers = build.local_headers(build.CSRC_DIR / f"{name}.cu")
        assert [h.name for h in headers] == ["sweep_common.cuh"]
    # a copy of csrc: editing the shared header, or a header it includes,
    # changes every key; editing one source changes only its own
    for p in build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {n: build.library_path(n) for n in build.sources()}
    hdr = tmp_path / "sweep_common.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    after = {n: build.library_path(n) for n in build.sources()}
    assert all(after[n] != before[n] for n in before)
    (tmp_path / "nested.cuh").write_text("// v1\n")
    hdr.write_bytes(hdr.read_bytes() + b'#include "nested.cuh"\n')
    mid = {n: build.library_path(n) for n in build.sources()}
    (tmp_path / "nested.cuh").write_text("// v2\n")
    assert all(build.library_path(n) != mid[n] for n in mid)
    src = tmp_path / "gathered_sweep.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert build.library_path("gathered_sweep") != mid["gathered_sweep"]
    assert len(build.local_headers(src)) == 2
