"""Layouts built to be culled by the slab sweep kernels' skip, shared by
the plain-version tests (``test_torch_csr_cull.py``,
``test_torch_frontier_cross_cull.py``) and the card parity tests
(``test_torch_card_parity.py``); and the point sets of the LBVH build's
tests (``lbvh_cases``: ``test_torch_lbvh.py`` and the card parity tests).
numpy and torch only, so that the card tests run where JAX is not
installed."""
import numpy as np

from repro_torch.kernels import csr_sweep as tcsr

INT_MAX = np.iinfo(np.int32).max
EPS = 3 / 8                     # on the 1/8 lattice: ε² = 9/64 exactly
EPS2 = EPS * EPS
EQ_BELOW = [EPS2, float(np.nextafter(np.float32(EPS2), np.float32(0)))]


def lattice(rng, n, dims, lo=0.0):
    """n points on the 1/8 lattice in [lo, lo + 1/2]^dims (z = 0 in 2-D),
    the box's two corners among them."""
    p = lo + rng.integers(0, 5, (n, 3)).astype(np.float32) / 8
    p[0], p[1] = lo, lo + 0.5
    if dims == 2:
        p[:, 2] = 0
    return p.astype(np.float32)


def culled_layout(dims, block_q, block_k, seed):
    """Query tiles and candidate runs built to be culled, as kernel inputs
    (q, cands (3, nc), croot, starts_blk, nblk) with ε = 3/8, and the kind
    of each run. Tiles 0-3 are lattice cubes of side 1/2, 4 apart along x;
    next to tile i lie its runs: "own" (overlapping), "edge" (box gap
    exactly ε along x, its corner exactly ε from the tile's), "edge-" and
    "edge+" (that gap one f32 step smaller and larger) and "far" (gap 3/2).
    Then 30 "filler" runs at y = 10, and 3 runs of +1e30 padding. Tile i's
    slab covers the runs of tiles i-1 .. i+1 (tile 3's reaches the end of
    the array, padding included); tile 4 spans every run (a heavy tile
    that keeps more runs than one work item holds); tiles 5 and 6 have
    nblk = 0. A run here is one block; each of its G-column runs has its
    own corner at the run's lowest x, so all of them are kept or skipped
    alike."""
    G = tcsr.run_width(block_k)
    rng = np.random.default_rng(seed)
    kinds, runs = [], []

    def cube(n, at):
        p = lattice(rng, n, dims) + np.asarray(at, np.float32)
        return p.astype(np.float32)

    tiles = []
    for i in range(4):
        a = np.array([4.0 * i, 0, 0], np.float32)
        tiles.append(cube(block_q, a))
        edge = a[0] + np.float32(0.5 + EPS)
        for kind, x0 in (("own", a[0]), ("edge", edge),
                         ("edge-", np.nextafter(edge, np.float32(-np.inf))),
                         ("edge+", np.nextafter(edge, np.float32(np.inf))),
                         ("far", a[0] + 2)):
            c = cube(block_k, (0, a[1], a[2]))
            c[:, 0] += x0
            c[::G, 0] = x0            # the corner pins each box exactly
            kinds.append(kind)
            runs.append(c)
    for k in range(30):
        kinds.append("filler")
        runs.append(cube(block_k, (0.5 * k, 10, 0)))
    for _ in range(3):
        kinds.append("padding")
        runs.append(np.full((block_k, 3), 1e30, np.float32))
    lo = np.min([r.min(0) for r in runs[:-3]], axis=0)
    hi = np.max([r.max(0) for r in runs[:-3]], axis=0)
    heavy = (lo + rng.integers(0, 9, (block_q, 3)) / 8 *
             (hi - lo)).astype(np.float32)
    heavy[0], heavy[1] = lo, hi
    q = np.concatenate(tiles + [heavy] + [cube(block_q, (1, 1, 0))] * 2)
    n_runs = len(runs)
    starts = np.array([max(5 * (i - 1), 0) for i in range(4)] + [0, 3, 0],
                      np.int32)
    nblk = np.array([10, 15, 15, n_runs - 10, n_runs, 0, 0], np.int32)
    cands = np.ascontiguousarray(np.concatenate(runs).T)
    croot = rng.integers(0, 9999, cands.shape[1]).astype(np.int32)
    croot[rng.uniform(size=cands.shape[1]) < 0.3] = INT_MAX
    return (q, cands, croot, starts, nblk), kinds


def with_padding_tiles(args, block_q, n_real):
    """A culled layout with two query tiles more whose slab is every run:
    ``n_real`` rows of tile 0 then +1e30 padding rows (the last tile of a
    padded bucket), and padding rows alone (chip_smoke.py's)."""
    q, cp, croot, st, nb = args
    tail = np.full((2 * block_q, 3), 1e30, np.float32)
    tail[:n_real] = q[:n_real]
    n_blocks = max(nb)
    return (np.concatenate([q, tail]), cp, croot,
            np.concatenate([st, [0, 0]]).astype(np.int32),
            np.concatenate([nb, [n_blocks, n_blocks]]).astype(np.int32))


# --- the grid-hash sweep and the fused BVH level -------------------------

# (name, n, ε, dims) of the datasets the fused kernels are held on
FUSED_DATASETS = [("roadnet2d", 20_000, 0.02, 2), ("iono3d", 20_000, 4.0, 3),
                  ("skewed2d", 20_000, 0.02, 2)]


def lattice_cloud(rng, n, dims, side=32):
    """n points on the 1/8 lattice in [0, side/8]^dims (z = 0 in 2-D): with
    ε = 3/8 many pairs lie at d² = 9/64 = ε² exactly."""
    p = rng.integers(0, side + 1, (n, 3)).astype(np.float32) / 8
    if dims == 2:
        p[:, 2] = 0
    return p.astype(np.float32)


def payload(rng, n):
    """A seeded payload: core (n,) bool, root (n,) int32."""
    return rng.uniform(size=n) < 0.5, rng.integers(0, n, n).astype(np.int32)


def lattice_counts(q, pts, eps2):
    """ε-counts of the lattice queries ``q`` over ``pts`` (every sum exact
    on the 1/8 lattice, so any order of the sum gives the same d²)."""
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return (d2 <= np.float32(eps2)).sum(1).astype(np.int32)


def lbvh_cases():
    """(name, points (n, D) f32, dims, lo, hi) of the LBVH build's tests:
    n = 2, 3, 5, 1,023 and 4,097; 2-D data in (n, 3) with z = 0 and in
    (n, 2), 3-D and 4-D; all points equal; heavy duplicates; +1e30
    sentinel rows under a ``lo``/``hi`` override of the real extent (else
    None, None); coordinates that hold both -0.0 and +0.0."""
    rng = np.random.default_rng(18)

    def uni(n, d):
        return rng.uniform(-1, 1, (n, d)).astype(np.float32)

    flat = uni(4097, 3)
    flat[:, 2] = 0
    dups = uni(50, 3)[rng.integers(0, 50, 4097)]
    sent = uni(1023, 3)
    lo, hi = sent[:900].min(0), sent[:900].max(0)
    sent[900:] = 1e30
    zeros = np.stack([rng.choice(np.float32([-0.0, 0.0, 1, 2]), 1023),
                      rng.choice(np.float32([-0.0, 0.0, -1, -2]), 1023),
                      rng.choice(np.float32([-0.0, 0.0]), 1023)], axis=1)
    same = np.tile(np.float32([[0.25, -3.0, 7.5]]), (1023, 1))
    cases = [
        ("n2", uni(2, 3), 3, None, None),
        ("n3", uni(3, 3), 3, None, None),
        ("n5-2d-in-3", flat[:5], 2, None, None),
        ("n1023-2d", uni(1023, 2), 2, None, None),
        ("n1023-4d", uni(1023, 4), 4, None, None),
        ("n4097-3d", uni(4097, 3), 3, None, None),
        ("n4097-2d-in-3", flat, 2, None, None),
        ("n5-equal", same[:5], 3, None, None),
        ("n1023-equal", same, 3, None, None),
        ("n2-equal", same[:2], 3, None, None),
        ("dups", dups.astype(np.float32), 3, None, None),
        ("sentinels", sent, 3, lo, hi),
        ("signed-zero", zeros.astype(np.float32), 3, None, None),
        ("signed-zero-2d", zeros[:, :2].copy(), 2, None, None),
    ]
    return [(name, np.ascontiguousarray(p, np.float32), dims, lo, hi)
            for name, p, dims, lo, hi in cases]
