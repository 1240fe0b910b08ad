"""The dry run's paper cell (``repro_torch.launch.dryrun.run_paper_cell``)
on the card against the CPU: a 4,096-point cell of 4 thread ranks, at the
paper's ε and minPts and at an ε where the points cluster. On either
device the distributed answer must equal single-rank ``dbscan``'s, and the
card's record (clusters, noise, core points, rounds, regrows, the bytes a
rank put into each collective) must equal the CPU's.

Every test here is marked ``cuda`` and skips, with its reason, where torch
sees no CUDA device. It imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_dryrun_card.py
"""
import pytest
import torch

from repro_torch.launch import dryrun as D

SAME = ("clusters", "noise", "core", "regrows", "label_rounds",
        "local_rounds", "sent_per_rank", "points_run", "matches_single")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test holds the card's paper "
                    "cell to the CPU's (torch.cuda.is_available() is false)")


@pytest.mark.cuda
@pytest.mark.parametrize("eps,min_pts,dist", [
    (D.PAPER_EPS, D.PAPER_MIN_PTS, D.PAPER_DIST),
    (0.016, 8, dict(send_factor=4.0, halo_factor=0.5, query_chunk=4096))])
def test_paper_cell_on_the_card_is_the_cpus(card, tmp_path, monkeypatch,
                                            eps, min_pts, dist):
    monkeypatch.setattr(D, "PAPER_SHAPES", {"tiny": 1024 * 256})
    monkeypatch.setattr(D, "PAPER_EPS", eps)
    monkeypatch.setattr(D, "PAPER_MIN_PTS", min_pts)
    monkeypatch.setattr(D, "PAPER_DIST", dist)
    recs = {dev: D.run_paper_cell("tiny", "single", str(tmp_path / dev),
                                  device=dev) for dev in ("cuda", "cpu")}
    for dev, rec in recs.items():
        assert rec["status"] == "ok", (dev, rec.get("traceback"))
    assert {k: recs["cuda"][k] for k in SAME} == \
        {k: recs["cpu"][k] for k in SAME}
    assert recs["cuda"]["peak_memory_bytes"] > 0
