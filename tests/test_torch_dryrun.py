"""The port's dry run (``repro_torch.launch.dryrun``, ``analysis``):
the CLI's cells and skips against the reference's, full-size cells traced
on ``meta``, the ring-model formulas against the reference's HLO parser,
and the paper's distributed cell on the CPU against single-rank
``dbscan``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import ALL as REF_ALL, SHAPES as REF_SHAPES
from repro.configs import shape_applicable as ref_applicable
from repro.launch.analysis import parse_collectives
from repro_torch.configs import ALL
from repro_torch.launch import analysis as A
from repro_torch.launch import dryrun as D

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(module, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_list_prints_the_references_cells_in_its_order():
    port = _cli("repro_torch.launch.dryrun", "--list")
    ref = _cli("repro.launch.dryrun", "--list")
    assert port.returncode == 0 and ref.returncode == 0, port.stderr
    lines = port.stdout.splitlines()
    assert lines == ref.stdout.splitlines() and len(lines) == 80


@pytest.mark.parametrize("arch", [a for a in sorted(ALL)
                                  if not ALL[a].sub_quadratic])
def test_skips_keep_the_references_reasons(tmp_path, arch):
    rec = D.run_cell(arch, "long_500k", "single", str(tmp_path))
    reason = ref_applicable(REF_ALL[arch], REF_SHAPES["long_500k"])
    assert rec["status"] == "skipped" and rec["reason"] == reason
    with open(tmp_path / f"{arch}__long_500k__single.json") as f:
        assert json.load(f) == rec


def test_two_full_size_cells_trace_ok_on_both_meshes(tmp_path, capsys):
    D.main(["--archs", "granite-moe-1b-a400m,xlstm-1.3b", "--shapes",
            "decode_32k", "--out", str(tmp_path)])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "done: ok=4 skipped=0 error=0")
    for arch in ("granite-moe-1b-a400m", "xlstm-1.3b"):
        recs = {}
        for mk, n_dev in (("single", 256), ("multi", 512)):
            with open(tmp_path / f"{arch}__decode_32k__{mk}.json") as f:
                rec = recs[mk] = json.load(f)
            assert rec["status"] == "ok" and rec["n_devices"] == n_dev
            assert rec["trace_device"] == "meta"
            assert rec["collectives"] == {} and \
                rec["terms"]["collective_s"] == 0
            mem = rec["memory"]
            assert mem["temp_bytes"] is None
            assert mem["peak_per_dev"] == (mem["argument_bytes"]
                                           + mem["output_bytes"]
                                           - mem["alias_bytes"])
            assert rec["terms"]["compute_s"] == \
                rec["flops_total"] / n_dev / A.PEAK_FLOPS
            assert rec["terms"]["memory_s"] == \
                rec["bytes_total"] / n_dev / A.HBM_BW
            assert rec["bottleneck"] == "memory_s"   # a decode step
            assert rec["flops_total"] >= rec["model_flops"] > 0
        # one trace for both meshes: the same program's counts
        assert recs["single"]["trace"] == recs["multi"]["trace"]
        assert recs["single"]["memory"]["argument_bytes"] > \
            recs["multi"]["memory"]["argument_bytes"]
    # the odd vocab falls back to replication, recorded
    with open(tmp_path / "granite-moe-1b-a400m__decode_32k__single.json") \
            as f:
        assert "args/0/embed dim 0 (49155) over model" in \
            json.load(f)["replicated_dims"]


def test_a_cell_that_raises_is_recorded_and_fails_the_run(tmp_path,
                                                           monkeypatch):
    def broken(*a):
        raise ValueError("no such layout")

    monkeypatch.setattr(D, "build_cell", broken)
    rec = D.run_cell("qwen3-8b", "train_4k", "single", str(tmp_path))
    assert rec["status"] == "error"
    assert rec["error"] == "ValueError: no such layout"
    assert "broken" in rec["traceback"]
    with pytest.raises(SystemExit) as e:
        D.main(["--archs", "qwen3-8b", "--shapes", "train_4k", "--mesh",
                "single", "--out", str(tmp_path), "--force"])
    assert e.value.code == 1


# ---- analysis --------------------------------------------------------------

_HLO = {
    "all-gather": "%x = f32[64,128]{1,0} all-gather(f32[4,128]{1,0} %p), "
                  "replica_groups=[16,16]<=[256], dimensions={0}",
    "reduce-scatter": "%x = bf16[4,128]{1,0} reduce-scatter(bf16[64,128]"
                      "{1,0} %p), replica_groups=[16,16]<=[256], "
                      "dimensions={0}, to_apply=%add",
    "all-reduce": "%x = f32[1024]{0} all-reduce-start(f32[1024]{0} %p), "
                  "replica_groups={{0,1,2,3}}, to_apply=%add",
    "all-to-all": "%x = s32[512,4]{1,0} all-to-all(s32[512,4]{1,0} %p), "
                  "replica_groups=[32,16]<=[512], dimensions={0}",
    "collective-permute": "%x = f32[300,4]{1,0} collective-permute(f32"
                          "[300,4]{1,0} %p), source_target_pairs="
                          "{{0,1},{1,2}}",
}


@pytest.mark.parametrize("op", sorted(_HLO))
def test_ring_traffic_equals_the_references_parser(op):
    ref = parse_collectives(_HLO[op])[op]
    g = {"all-gather": 16, "reduce-scatter": 16, "all-reduce": 4,
         "all-to-all": 16, "collective-permute": 1}[op]
    operand, traffic = A.ring_traffic(op, ref["result_bytes"], g)
    assert (operand, traffic) == (ref["operand_bytes"],
                                  ref["traffic_bytes"])


def test_comm_names_map_to_the_ring_model():
    sent = {"psum": 400.0, "pmin": 12.0, "pmax": 12.0,
            "all_to_all": 1024.0, "ppermute": 96.0}
    colls = A.comm_collectives(sent, 4)
    assert colls["all-reduce"]["operand_bytes"] == 424.0
    assert colls["all-reduce"]["traffic_bytes"] == 2 * 424.0 * 3 / 4
    assert colls["all-to-all"]["traffic_bytes"] == 1024.0
    assert colls["collective-permute"]["traffic_bytes"] == 96.0
    with pytest.raises(KeyError):
        A.comm_collectives({"broadcast": 1.0}, 4)


def test_analyze_builds_the_record_from_numbers():
    rec = A.analyze({"flops": 989e12 * 8, "bytes": 3.35e12 * 4},
                    n_devices=4, model_flops=989e12 * 4,
                    memory={"argument_bytes": 10, "output_bytes": 6,
                            "alias_bytes": 5, "temp_bytes": None},
                    collectives={"all-reduce": {
                        "operand_bytes": 50e9, "result_bytes": 50e9,
                        "traffic_bytes": 150e9}})
    assert (A.PEAK_FLOPS, A.HBM_BW, A.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert rec["terms"] == {"compute_s": 2.0, "memory_s": 1.0,
                            "collective_s": 3.0}
    assert rec["bottleneck"] == "collective_s"
    assert rec["useful_flops_ratio"] == 0.5
    assert rec["roofline_fraction"] == pytest.approx(1 / 3)
    assert rec["memory"]["peak_per_dev"] == 11
    assert "dynamic_whiles" not in rec and "xla_raw_flops_per_dev" not in rec


# ---- the paper's cells ------------------------------------------------------


def test_paper_cells_hold_one_devices_share(tmp_path):
    mesh = {mk: D.production_mesh(mk) for mk in ("single", "multi")}
    assert {mk: D.PAPER_SHAPES["cluster_64m"] // m.size
            for mk, m in mesh.items()} == {"single": 262_144,
                                           "multi": 131_072}
    rec = D.run_paper_cell("cluster_1b", "single", str(tmp_path),
                           device="cpu")
    assert rec["status"] == "skipped" and "MAX_POINTS" in rec["reason"]
    assert rec["points_run"] == 4 * 4_194_304 == 1 << 24


def test_paper_points_have_the_density_of_n_in_the_unit_cube():
    pts = D.paper_points(4096, 1 << 20)
    extent = pts.max(axis=0) - pts.min(axis=0)
    assert pts.min() >= 0
    assert 4096 / np.prod(extent.astype(np.float64)) == \
        pytest.approx(1 << 20, rel=1e-4)


def test_clustering_eps_gives_min_pts_expected_neighbours():
    n = 20_000
    eps = D.clustering_eps(n)
    assert D.clustering_eps(1 << 26) > 7 * D.PAPER_EPS
    pts = torch.from_numpy(np.random.default_rng(0).random((n, 3)))
    inner = pts[((pts > eps) & (pts < 1 - eps)).all(1)][:1000]
    counts = (torch.cdist(inner, pts) <= eps).sum(1).double()
    assert counts.mean().item() == pytest.approx(D.PAPER_MIN_PTS, rel=0.03)


@pytest.mark.parametrize("eps,min_pts,dist", [
    (D.PAPER_EPS, D.PAPER_MIN_PTS, D.PAPER_DIST),
    (0.016, 8, dict(send_factor=4.0, halo_factor=0.5, query_chunk=4096))])
def test_paper_cell_on_the_cpu_matches_single_rank_dbscan(
        tmp_path, monkeypatch, eps, min_pts, dist):
    monkeypatch.setattr(D, "PAPER_SHAPES", {"tiny": 1024 * 256})
    monkeypatch.setattr(D, "PAPER_MIN_PTS", min_pts)
    monkeypatch.setattr(D, "PAPER_DIST", dist)
    rec = D.run_paper_cell("tiny", "single", str(tmp_path), device="cpu",
                           eps=eps)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["matches_single"] and rec["points_run"] == 4096
    assert rec["eps"] == eps
    assert rec["device"] == "cpu" and rec["peak_memory_bytes"] is None
    assert rec["clusters"] + rec["noise"] > 0
    if min_pts == 100:     # the paper's ε and minPts at this density
        assert (rec["clusters"], rec["noise"]) == (0, 4096)
    else:
        assert rec["clusters"] > 1 and rec["core"] > 0
    assert set(rec["sent_per_rank"]) == {"psum", "pmin", "pmax",
                                         "all_to_all", "ppermute"}
    assert rec["collective_s"] == \
        rec["collective_traffic_per_dev"] / A.LINK_BW
    assert set(rec["steps_s"]) >= {"cuts", "all_to_all", "halo",
                                   "local_build", "stage1", "components",
                                   "label_rounds", "border", "return"}


def test_the_paper_cells_need_a_card_unless_told_otherwise(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        D.main(["--archs", "qwen3-8b", "--shapes", "long_500k", "--paper",
                "--mesh", "single", "--out", str(tmp_path)])
    assert e.value.code == 1
    with open(tmp_path / "rt-dbscan__cluster_64m__single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "error" and "cuda" in rec["error"].lower()
