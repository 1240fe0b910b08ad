"""Layouts built to be culled by the slab sweep kernels' skip, shared by
the plain-version tests (``test_torch_csr_cull.py``,
``test_torch_frontier_cross_cull.py``) and the card parity tests
(``test_torch_card_parity.py``). numpy and torch only, so that the card
tests run where JAX is not installed."""
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
