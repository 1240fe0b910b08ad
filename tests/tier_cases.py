"""Shared inputs and readers of the sharded-tier tests
(tests/test_torch_shard.py, tests/test_torch_router.py), numpy and torch
only: tests/test_shard.py's ε and minPts and domain queries, and the
reassembly of a tier's global labels from its shards."""
import numpy as np

EPS, MINPTS = 0.05, 8


def domain_queries(pts, m, seed=5):
    """tests/test_shard.py's ``_domain_queries``: uniform over the corpus's
    box grown by 2ε, planar when the corpus is."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    q = rng.uniform(lo - 2 * EPS, hi + 2 * EPS, (m, 3)).astype(np.float32)
    if np.all(pts[:, 2] == pts[0, 2]):
        q[:, 2] = pts[0, 2]
    return q


def tier_global_labels(tier, local=lambda x: x.numpy()):
    """The tier's canonical-order global labels and core, reassembled from
    its shard-local parts through their label tables. ``local`` reads a
    shard's labels/core (torch tensors by default; ``np.asarray`` for the
    reference's tier)."""
    n = sum(p.n for p in tier.parts)
    lab = np.full(n, -2, np.int64)
    core = np.zeros(n, bool)
    for p in tier.parts:
        loc = local(p.snapshot.labels)
        g = np.full(len(loc), -1, np.int64)
        if p.label_table.size:
            m = loc >= 0
            g[m] = p.label_table.astype(np.int64)[loc[m]]
        lab[p.orig_index] = g
        core[p.orig_index] = local(p.snapshot.core)
    assert (lab != -2).all(), "shard rows must partition the corpus"
    return lab, core


def same_answer(a, b, what=""):
    """Two assign answers bit-identical: labels, counts and dist, dtypes
    included."""
    for f in ("labels", "counts", "dist"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (what, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
