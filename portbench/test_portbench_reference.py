"""The plain reference against the program's CPU path (plain PyTorch
versions of the kernels) at a few thousand points: counts, core flags,
partition and labels equal."""
import pytest
import torch

from portbench import check
from portbench.data import iono3d, roadnet2d
from portbench.reference import dbscan as ref
from repro_torch.core.dbscan import dbscan


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CASES = [  # generator, n, eps, dims, minPts
    (roadnet2d, 4_000, 0.02, 2, 8),     # the configuration's ε: sparse
    (roadnet2d, 4_000, 0.1, 2, 8),      # clusters, border and noise
    (roadnet2d, 3_000, 0.1, 2, 32),
    (iono3d, 4_000, 2.0, 3, 4),
    (iono3d, 4_000, 8.0, 3, 16),        # sheets: clusters, border and noise
]


@pytest.mark.parametrize("gen, n, eps, dims, min_pts", CASES)
def test_reference_equals_the_programs_cpu_path(gen, n, eps, dims, min_pts):
    pts = gen.generate(n, 11)
    want = ref.answer(ref.neighbour_pairs(pts, eps, dims, device="cpu",
                                          block=3_000), min_pts)
    got = dbscan(pts, eps, min_pts, device="cpu")
    assert check.compare(want, got.counts, got.core, got.labels) == \
        dict.fromkeys(check.LIMITS, 0)
    assert torch.equal(got.labels, want.labels)


def test_the_cases_exercise_core_border_and_noise():
    pts = roadnet2d.generate(4_000, 11)
    a = ref.answer(ref.neighbour_pairs(pts, 0.1, 2, device="cpu"), 8)
    border = ~a.core & (a.labels >= 0)
    assert a.core.any() and border.any() and (a.labels < 0).any()
    assert len(torch.unique(a.labels[a.core])) > 1


def test_counts_include_self_and_the_pair_at_eps():
    # two points exactly ε apart on the x axis, a third far away
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0],
                        [3.0, 0.0, 0.0]]).numpy()
    pairs = ref.neighbour_pairs(pts, 0.5, 2, device="cpu")
    assert pairs.counts.tolist() == [2, 2, 1]
    a = ref.answer(pairs, 2)
    assert a.core.tolist() == [True, True, False]
    assert a.labels.tolist() == [0, 0, -1]
