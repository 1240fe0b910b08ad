"""The blocked reference (``reference/dbscan_blocked.py``) against the
unblocked one and against the program's CPU path at a few thousand
points, with blocks small enough that every pass over the pairs splits:
counts, core flags, partition and labels equal."""
import pytest
import torch

from portbench import check
from portbench.data import iono3d, roadnet2d, taxi2d
from portbench.reference import dbscan as ref
from portbench.reference import dbscan_blocked as blocked
from repro_torch.core.dbscan import dbscan


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CASES = [  # generator, n, eps, dims, minPts
    (taxi2d, 4_000, 0.03, 2, 4),        # many small clusters
    (taxi2d, 4_000, 0.05, 2, 8),
    (taxi2d, 4_000, 0.1, 2, 48),        # hubs: a wide border
    (taxi2d, 3_000, 0.2, 2, 32),
    (roadnet2d, 4_000, 0.1, 2, 8),
    (iono3d, 4_000, 8.0, 3, 16),
]
BLOCK = 2_000


@pytest.mark.parametrize("gen, n, eps, dims, min_pts", CASES)
def test_blocked_reference_equals_the_reference_and_the_program(
        gen, n, eps, dims, min_pts):
    pts = gen.generate(n, 11)
    pairs = blocked.neighbour_pairs(pts, eps, dims, device="cpu",
                                    block=BLOCK)
    # every pass walks several blocks, none over BLOCK pairs
    assert len(pairs.src) > 4
    assert all(s.dtype == d.dtype == torch.int32 and s.shape == d.shape
               and s.numel() <= BLOCK for s, d in zip(pairs.src, pairs.dst))
    got = blocked.answer(pairs, min_pts)
    want = ref.answer(ref.neighbour_pairs(pts, eps, dims, device="cpu"),
                      min_pts)
    assert torch.equal(got.counts, want.counts)
    assert torch.equal(got.core, want.core)
    assert torch.equal(got.labels, want.labels)
    port = dbscan(pts, eps, min_pts, device="cpu")
    assert check.compare(got, port.counts, port.core, port.labels) == \
        dict.fromkeys(check.LIMITS, 0)
    assert torch.equal(port.labels, got.labels)


@pytest.mark.parametrize("gen, n, eps, dims, min_pts",
                         [c for c in CASES if c[0] is taxi2d])
def test_the_taxi_cases_have_core_border_and_noise(gen, n, eps, dims,
                                                   min_pts):
    a = blocked.answer(blocked.neighbour_pairs(gen.generate(n, 11), eps,
                                               dims, device="cpu"), min_pts)
    border = ~a.core & (a.labels >= 0)
    assert a.core.any() and border.any() and (a.labels < 0).any()
    assert len(torch.unique(a.labels[a.core])) > 1


def test_the_bfloat16_control_differs_from_the_float32_answer():
    pts = taxi2d.generate(4_000, 11)
    exact = blocked.answer(blocked.neighbour_pairs(
        pts, 0.05, 2, device="cpu", block=BLOCK), 8)
    low = blocked.answer(blocked.neighbour_pairs(
        pts, 0.05, 2, device="cpu", dtype=torch.bfloat16, block=BLOCK), 8)
    got = check.compare(exact, low.counts, low.core, low.labels)
    assert got["count_mismatch"] > 0 and not check.within(got)
