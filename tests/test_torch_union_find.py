"""repro_torch union-find against the JAX reference on the cases of
tests/test_union_find.py: identical root arrays, not only the same
partition."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import union_find as J
from repro_torch.core import union_find as P


def _roots_both(n, u, v, valid=None):
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.as_tensor(valid)
    r = np.asarray(J.connected_components(n, jnp.asarray(u), jnp.asarray(v),
                                          valid=jv))
    p = P.connected_components(n, torch.as_tensor(u), torch.as_tensor(v),
                               valid=tv).numpy()
    return r, p


def test_pointer_jump_identity_and_chain():
    assert np.array_equal(P.pointer_jump(P.init_parents(7)).numpy(),
                          np.arange(7))
    chain = np.asarray([0, 0, 1, 2, 3, 4], np.int32)
    np.testing.assert_array_equal(
        P.pointer_jump(torch.as_tensor(chain)).numpy(),
        np.asarray(J.pointer_jump(jnp.asarray(chain))))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n,m", [(10, 5), (50, 80), (200, 150), (128, 1)])
def test_connected_components_matches_reference(seed, n, m):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    r, p = _roots_both(n, u, v)
    assert p.dtype == np.int32
    np.testing.assert_array_equal(r, p)


def test_union_edges_masked_matches_reference():
    u = np.asarray([0, 2, 4], np.int32)
    v = np.asarray([1, 3, 5], np.int32)
    r, p = _roots_both(8, u, v, valid=np.asarray([True, False, True]))
    np.testing.assert_array_equal(r, p)
    assert p[0] == p[1] and p[2] != p[3] and p[4] == p[5]


@pytest.mark.parametrize("seed", range(6))
def test_hook_min_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 64
    parent = np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int32)
    src = rng.integers(0, n, 40).astype(np.int32)
    tgt = rng.integers(0, n, 40).astype(np.int32)
    valid = rng.uniform(size=40) < 0.6
    r = J.hook_min(jnp.asarray(parent), jnp.asarray(src), jnp.asarray(tgt),
                   valid=jnp.asarray(valid))
    p = P.hook_min(torch.as_tensor(parent), torch.as_tensor(src),
                   torch.as_tensor(tgt), valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(np.asarray(r), p.numpy())


@pytest.mark.parametrize("seed", range(10))
def test_union_edges_random_sizes_match_reference(seed):
    # the hypothesis property of tests/test_union_find.py, on fixed seeds
    rng = np.random.default_rng(1000 + seed)
    n, m = int(rng.integers(2, 65)), int(rng.integers(0, 129))
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    r, p = _roots_both(n, u, v)
    np.testing.assert_array_equal(r, p)
    assert np.array_equal(p[p], p) and (p <= np.arange(n)).all()
