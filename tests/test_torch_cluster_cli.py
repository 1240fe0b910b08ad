"""repro_torch's clustering driver CLI (``python -m
repro_torch.launch.cluster``) on the CPU against the JAX reference's
``repro.launch.cluster.main`` on the same arguments: the same result
(labels, core, counts, ``n_rounds`` bitwise) and the same printed
statistics; it runs on ``cuda`` by default and raises without a card
unless given ``--device cpu``. ``--distributed --device cpu`` (one gloo
rank) prints the statistics of the reference's ``--distributed``; the
reference's driver cannot run on one device, so its run here has two fake
CPU devices (the labels are global ids, the same for any number of
ranks)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import cluster as jcluster
from repro_torch.launch import cluster

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps them fast
    beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(out: str) -> list:
    """The printed lines without the timing line and the device word."""
    return [line.replace(" device=cpu", "") for line in out.splitlines()
            if not line.startswith("time:")]


@pytest.mark.parametrize("args", [
    ["--dataset", "roadnet2d", "-n", "3000", "--eps", "0.02",
     "--min-pts", "8"],
    ["--dataset", "taxi2d", "-n", "2000", "--eps", "0.08", "--min-pts", "16",
     "--engine", "brute", "--seed", "3"],
    ["--dataset", "iono3d", "-n", "1500", "--eps", "4.0", "--min-pts", "16",
     "--engine", "grid-hash"],
], ids=["grid", "brute", "grid-hash"])
def test_cli_matches_reference(args, capsys):
    res = cluster.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    ref = jcluster.main(args)
    ref_out = capsys.readouterr().out
    for f in ("labels", "core", "counts"):
        a, b = np.asarray(getattr(ref, f)), getattr(res, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert res.n_rounds == int(ref.n_rounds)
    assert _stats(out) == _stats(ref_out)
    assert "device=cpu" in out.splitlines()[0]
    assert out.splitlines()[-1].startswith("time: total=")


def test_cli_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.main(["-n", "100"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.main(["-n", "100", "--distributed"])


def test_cli_distributed_matches_reference_stats(capsys):
    args = ["--dataset", "roadnet2d", "-n", "4000", "--eps", "0.02",
            "--min-pts", "8", "--distributed"]
    res = cluster.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.cluster"]
                         + args, env=env, capture_output=True, text=True,
                         timeout=600)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _stats(out) == _stats(ref.stdout)
    assert "build=0.000s" in out.splitlines()[-1]
    assert res.labels.dtype == torch.int32 and res.core.dtype == torch.bool
    assert int(res.core.sum()) == 125


def test_cli_as_a_module_loads_no_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['cluster', '--dataset', 'highway', '-n', '500',"
            " '--eps', '0.05', '--min-pts', '4', '--device', 'cpu']\n"
            "runpy.run_module('repro_torch.launch.cluster',"
            " run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or"
            " m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout and "clusters:" in out.stdout
