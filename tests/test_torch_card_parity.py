"""Card parity of the slab sweep kernels that skip runs: ``frontier_sweep``
and ``cross_sweep`` on CUDA tensors, each bit-identical to its plain
version on the same tensors, on layouts built to be culled
(``cull_layouts.py``: box gaps of exactly ε and one f32 step either side, a
heavy tile split over work items, +1e30 tail runs; for the frontier every
live-set size under the park contract, for the cross query tiles of +1e30
padding rows).

Every test here is marked ``cuda`` and skips, with its reason, where torch
sees no CUDA device. It imports neither JAX nor the JAX package, so it
runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_card_parity.py
"""
import numpy as np
import pytest
import torch

from cull_layouts import EQ_BELOW, culled_layout, with_padding_tiles
from repro_torch.kernels import cross_sweep as tcross
from repro_torch.kernels import frontier_sweep as tfrontier

INT_MAX = np.iinfo(np.int32).max
LAYOUTS = [(d, bq, bk) for d in (2, 3) for bq, bk in ((32, 128), (64, 512))]
IDS = [f"{d}d-bq{bq}-bk{bk}" for d, bq, bk in LAYOUTS]


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card "
                    "(torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _same(k, p):
    torch.cuda.synchronize()
    assert k.shape == p.shape and torch.equal(k, p), \
        f"{int((k != p).sum())} of {k.numel()} rows differ"


@pytest.mark.cuda
@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_frontier_sweep_kernel_is_its_plain_version(card, layout, eps2):
    dims, bq, bk = layout
    args, kinds = culled_layout(dims, bq, bk, seed=dims)
    q, cp, croot, st, nb = (torch.as_tensor(x, device=card) for x in args)
    T = len(st)
    order = [4, 2, 0, 3, 1, 5, 6]      # the heavy tile first
    kw = dict(max_blocks=len(kinds), block_k=bk)
    for n_active in sorted({0, 1, T // 2, T}):
        live = order[:n_active]
        active = torch.tensor(live + [live[-1] if live else 0] *
                              (T - n_active), dtype=torch.int32, device=card)
        na = torch.tensor([n_active], dtype=torch.int32, device=card)
        k = tfrontier.frontier_sweep(q, cp, croot, st, nb, active, na, eps2,
                                     block_q=bq, **kw)
        p = tfrontier.frontier_sweep_plain(q, cp, croot, st, nb, active, na,
                                           eps2, **kw)
        _same(k, p)
        assert (k[n_active * bq:] == INT_MAX).all()


@pytest.mark.cuda
@pytest.mark.parametrize("eps2", EQ_BELOW, ids=["eq", "below"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_cross_sweep_kernel_is_its_plain_version(card, layout, eps2):
    dims, bq, bk = layout
    args, kinds = culled_layout(dims, bq, bk, seed=dims)
    args = with_padding_tiles(args, bq, bq // 2)
    q, cp, croot, st, nb = (torch.as_tensor(x, device=card) for x in args)
    kw = dict(max_blocks=len(kinds), block_k=bk)
    k = tcross.cross_sweep(q, cp, croot[None, :], st, nb, eps2, block_q=bq,
                           **kw)
    p = tcross.cross_sweep_plain(q, cp, croot[None, :], st, nb, eps2, **kw)
    for a, b in zip(k, p):
        _same(a, b)
    assert torch.isfinite(k[2]).any()
