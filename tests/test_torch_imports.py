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
           "repro_torch.baselines.brute", "repro_torch.baselines.dclust",
           "repro_torch.baselines.fdbscan", "repro_torch.baselines.gdbscan",
           "repro_torch.configs", "repro_torch.configs.base",
           "repro_torch.configs.granite_moe_1b_a400m",
           "repro_torch.configs.h2o_danube_1_8b",
           "repro_torch.configs.hymba_1_5b",
           "repro_torch.configs.moonshot_v1_16b_a3b",
           "repro_torch.configs.qwen2_vl_72b", "repro_torch.configs.qwen3_8b",
           "repro_torch.configs.stablelm_12b",
           "repro_torch.configs.starcoder2_3b",
           "repro_torch.configs.whisper_large_v3",
           "repro_torch.configs.xlstm_1_3b",
           "repro_torch.core", "repro_torch.core.bvh",
           "repro_torch.core.dbscan", "repro_torch.core.engines",
           "repro_torch.core.grid", "repro_torch.core.labels",
           "repro_torch.core.neighbors", "repro_torch.core.union_find",
           "repro_torch.data", "repro_torch.data.pipeline",
           "repro_torch.data.synth",
           "repro_torch.distributed", "repro_torch.distributed.checkpoint",
           "repro_torch.distributed.comm",
           "repro_torch.distributed.collectives",
           "repro_torch.distributed.dbscan_dist",
           "repro_torch.distributed.elastic",
           "repro_torch.kernels", "repro_torch.kernels.build",
           "repro_torch.kernels.bvh_sweep",
           "repro_torch.kernels.cross_sweep",
           "repro_torch.kernels.csr_sweep",
           "repro_torch.kernels.frontier_sweep",
           "repro_torch.kernels.gathered_sweep",
           "repro_torch.kernels.morton", "repro_torch.kernels.ops",
           "repro_torch.kernels.pairwise_sweep", "repro_torch.kernels.ref",
           "repro_torch.launch", "repro_torch.launch.analysis",
           "repro_torch.launch.cluster", "repro_torch.launch.dryrun",
           "repro_torch.launch.mesh", "repro_torch.launch.op_costs",
           "repro_torch.launch.train",
           "repro_torch.models", "repro_torch.models.encdec",
           "repro_torch.models.layers", "repro_torch.models.model",
           "repro_torch.models.moe", "repro_torch.models.sharding",
           "repro_torch.models.ssm",
           "repro_torch.models.transformer", "repro_torch.models.xlstm",
           "repro_torch.serve", "repro_torch.serve.assign",
           "repro_torch.serve.faults", "repro_torch.serve.health",
           "repro_torch.serve.ingest", "repro_torch.serve.resilience",
           "repro_torch.serve.router", "repro_torch.serve.scheduler",
           "repro_torch.serve.shard", "repro_torch.serve.snapshot",
           "repro_torch.serve.wal", "repro_torch.trace", "repro_torch.train",
           "repro_torch.train.optimizer", "repro_torch.train.trainer"]


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
        "t = serve.ShardedTier.build(pts, 0.1, 2, n_shards=2, device='cpu',"
        " ckpt_root=d + '/tck', wal_root=d + '/twal')\n"
        "t.replicate(0)\n"
        "t.warmup(256)\n"
        "t.health.record_failure((0, 0))\n"
        "t.assign([[0.0, 0.01, 0.0]])\n"
        "t.ingest([[0.02, 0.0, 0.0]])\n"
        "t.compact()\n"
        "t.health.force_down((0, 0))\n"
        "assert t.recover_shard(0)\n"
        "t.close()\n"
        "from repro_torch.baselines import dclust, gdbscan\n"
        "gdbscan.run(pts, 0.1, 2, device='cpu')\n"
        "dclust.run(pts, 0.1, 2, device='cpu')\n"
        "from repro_torch.data.pipeline import point_stream\n"
        "list(point_stream('taxi2d', 10, 4))\n"
        "from repro_torch.distributed import comm\n"
        "from repro_torch.distributed.dbscan_dist import DistConfig,"
        " dbscan_distributed\n"
        "for e in ('grid', 'csr', 'bvh', 'brute'):\n"
        "    dbscan_distributed(pts + [[0.02, 0.0, 0.0], [0.5, 0.5, 0.0]],"
        " 0.1, 2, comm.ThreadGroup(2, 'cpu'),"
        " cfg=DistConfig(local_engine=e))\n"
        "from repro_torch.configs import ALL\n"
        "from repro_torch.models import model as M\n"
        "for name in ('qwen3-8b', 'hymba-1.5b', 'whisper-large-v3'):\n"
        "    cfg = ALL[name].reduced()\n"
        "    lm = M.LM(cfg, M.init_params(cfg, 0, device='cpu'))\n"
        "    b = M.synth_batch(cfg, 1, 16, 0, train=False, device='cpu')\n"
        "    lm(b)\n"
        "    _, c = lm.prefill(b, 24)\n"
        "    lm.decode_step(c, b['tokens'][:, :1], 16)\n"
        "from repro_torch.launch import train\n"
        "train.main(['--arch', 'granite-moe-1b-a400m', '--reduced',"
        " '--steps', '2', '--batch', '2', '--seq', '16', '--device', 'cpu',"
        " '--ckpt-dir', d + '/train'])\n"
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


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import ALL
    from repro_torch.models import model as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ALL["qwen3-8b"].reduced()
    params = M.init_params(cfg, 0, device="cpu")
    tree = {"embed": np.zeros((cfg.vocab, cfg.d_model), np.float32)}
    for call in (lambda: M.init_params(cfg, 0),
                 lambda: M.synth_batch(cfg, 1, 8, 0),
                 lambda: M.init_cache(cfg, 1, 8),
                 lambda: M.params_from_jax(cfg, tree),
                 lambda: M.init_params(cfg, 0, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert M.init_cache(cfg, 1, 8, device="meta")["k"].is_meta
    assert M.LM(cfg, params).device.type == "cpu"


def test_kernel_build_is_keyed_and_raises_without_nvcc(monkeypatch,
                                                       tmp_path):
    from repro_torch.kernels import build
    assert build.sources() == ["bvh_sweep", "csr_layout", "csr_sweep",
                               "gathered_sweep", "lbvh"]
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
