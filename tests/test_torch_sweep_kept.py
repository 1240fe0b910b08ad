"""The slab sweeps' count of their own work: the work items the cull
appends and the candidate runs it keeps (``csrc/csr_sweep.cu``'s third
counter; ``kernels/csr_sweep.py`` ``work_plain`` in the plain versions).

On the CPU: ``dbscan`` reports stage 1's kept pairs (kept runs × run width
× block_q of the plain run mask) in ``timings["stage1_kept_pairs"]``, read
after ``stage1_s`` is taken, and leaves counts, core flags, labels and
round counts as they are without it; while ``repro_torch.trace`` records,
every slab sweep adds ``sweep_items``, ``sweep_kept_runs`` and
``sweep_kept_pairs`` to the innermost span, and with recording off nothing
is recorded and the plain stage-2 sweeps build no run mask.

One ``cuda``-marked test holds the kernel's counts bit for bit to the
plain version's; it skips here. On the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_sweep_kept.py
"""
import pytest
import torch

import repro_torch.core.dbscan as dbscan_mod
from repro_torch import dbscan, make_engine, serve, trace
from repro_torch.data import synth
from repro_torch.kernels import csr_sweep as csr
from repro_torch.kernels import ops

CASES = [  # dataset, n, ε, minPts: clusters, border and noise at each
    ("roadnet2d", 3_000, 0.03, 4),
    ("taxi2d", 3_000, 0.1, 16),
    ("iono3d", 2_000, 10.0, 8),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kept_plain(eng, eps):
    """The grid engine's stage-1 sweep's kept-run mask (plain version)."""
    g, spec = eng.state, eng.meta
    q, starts_blk, nblk, max_blocks = ops._slab_args(
        g.q_sorted, g.starts, g.nblk, slab=spec.slab, block_q=spec.chunk,
        block_k=spec.block_k)
    return csr.kept_runs_plain(q, g.cands, starts_blk, nblk,
                               float(eps) ** 2, max_blocks=max_blocks,
                               block_k=spec.block_k)


def test_work_plain_counts_segments_and_runs():
    kept = torch.zeros((3, 70), dtype=torch.bool)
    kept[0, [0, 33, 34, 69]] = True      # segments 0, 1 and 2
    kept[2, 31] = True                   # the last run of segment 0
    assert csr.work_plain(kept).tolist() == [4, 5]
    assert csr.work_plain(kept[2:]).tolist() == [1, 1]
    assert csr.work_plain(kept[1:2]).tolist() == [0, 0]
    assert csr.work_plain(kept[:0]).tolist() == [0, 0]


@pytest.mark.parametrize("name,n,eps,min_pts", CASES,
                         ids=[c[0] for c in CASES])
def test_stage1_reports_its_kept_pairs_and_changes_nothing(
        name, n, eps, min_pts, monkeypatch):
    pts = synth.load(name, n, seed=3)
    eng = make_engine(pts, eps, device="cpu")
    got = dbscan(pts, eps, min_pts, eng=eng)
    kept = _kept_plain(eng, eps)
    spec = eng.meta
    assert got.timings["stage1_kept_pairs"] == \
        int(kept.sum()) * csr.run_width(spec.block_k) * spec.chunk
    assert isinstance(got.timings["stage1_kept_pairs"], int)
    assert 0 < got.timings["stage1_kept_pairs"] <= \
        spec.n_tiles * spec.chunk * spec.slab
    # the same run with stage 1 asked for no count
    real = dbscan_mod._counts_stage1_fn
    monkeypatch.setattr(dbscan_mod, "_counts_stage1_fn",
                        lambda fn, state, order, work=None:
                        real(fn, state, order))
    plain = dbscan(pts, eps, min_pts, eng=eng)
    for f in ("counts", "core", "labels"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    assert got.n_rounds == plain.n_rounds
    assert set(got.timings) - set(plain.timings) == {"stage1_kept_pairs"}
    assert got.timings["stage1_s"] > 0 and plain.timings["stage1_s"] > 0


def test_the_count_is_read_after_stage1_s_is_taken(monkeypatch):
    pts = synth.load("taxi2d", 2_000, seed=5)
    eng = make_engine(pts, 0.1, device="cpu")
    order = []
    timed, to_host = trace.timed, trace.to_host

    def spy_timed(timings, key, *a, **kw):
        order.append(("open", key))
        return timed(timings, key, *a, **kw)

    def spy_to_host(t):
        order.append(("read", t.numel()))
        return to_host(t)
    monkeypatch.setattr(trace, "timed", spy_timed)
    monkeypatch.setattr(trace, "to_host", spy_to_host)
    dbscan(pts, 0.1, 16, eng=eng)
    # one read, of one int32, between stage 1 and stage 2
    assert order[:3] == [("open", "stage1_s"), ("read", 1),
                         ("open", "stage2_s")]
    assert order.count(("read", 1)) == 1


@pytest.mark.parametrize("hook_loop", ["device", "frontier"])
@pytest.mark.parametrize("name,n,eps,min_pts", CASES,
                         ids=[c[0] for c in CASES])
def test_recording_counts_every_sweep_under_its_span(name, n, eps, min_pts,
                                                     hook_loop):
    pts = synth.load(name, n, seed=3)
    eng = make_engine(pts, eps, device="cpu")
    with trace.recording() as rec:
        res = dbscan(pts, eps, min_pts, eng=eng, hook_loop=hook_loop)
        got = rec.take()
    names = {s.id: s.name for s in got.spans}
    per_span = {}
    for (sid, counter), v in got.counts.items():
        if counter.startswith("sweep_"):
            per_span.setdefault(names[sid], []).append((sid, counter, v))
    # stage 1's sweep, one a round, the border's
    assert set(per_span) == {"stage1", "stage2.round", "border"}
    rounds = [s for s in got.spans if s.name == "stage2.round"]
    assert len(rounds) == res.n_rounds
    for counter in ("sweep_items", "sweep_kept_runs", "sweep_kept_pairs"):
        assert {sid for sid, c, _ in per_span["stage2.round"]
                if c == counter} == {s.id for s in rounds}
    stage1 = {c: v for _, c, v in per_span["stage1"]}
    work = csr.work_plain(_kept_plain(eng, eps)).tolist()
    spec = eng.meta
    assert stage1 == {
        "sweep_items": work[0], "sweep_kept_runs": work[1],
        "sweep_kept_pairs": res.timings["stage1_kept_pairs"]}
    assert stage1["sweep_kept_pairs"] == \
        work[1] * csr.run_width(spec.block_k) * spec.chunk
    if hook_loop == "device":
        # every full re-sweep keeps the runs stage 1 kept
        assert all(v == stage1[c] for _, c, v in per_span["stage2.round"])
    else:
        # a frontier round keeps no more than a full sweep
        assert all(v <= stage1[c] for _, c, v in per_span["stage2.round"])


def test_recording_off_records_nothing_and_builds_no_mask(monkeypatch):
    pts = synth.load("taxi2d", 2_000, seed=5)
    eng = make_engine(pts, 0.1, device="cpu")
    masks = []
    real = csr.kept_runs_plain

    def counted(*a, **kw):
        masks.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(csr, "kept_runs_plain", counted)
    with trace.recording() as rec:
        pass
    res = dbscan(pts, 0.1, 16, eng=eng)
    assert rec.take().counts == {}
    assert len(masks) == 1                 # stage 1's count alone
    trace.count_later("sweep_items", torch.tensor(5))   # off: a no-op
    with trace.recording() as rec:
        on = dbscan(pts, 0.1, 16, eng=eng)
        got = rec.take()
    assert len(masks) == 1 + 1 + on.n_rounds + 1
    assert on.n_rounds == res.n_rounds
    assert trace.total(got, "sweep_items") > 0


def test_count_later_reads_when_the_record_is_taken():
    value = torch.tensor([3, 7], dtype=torch.int32)
    with trace.recording() as rec:
        with trace.span("outer"):
            trace.count_later("n", value[1], scale=10)
            value[1] = 9              # read at the take, not before
        trace.count_later("n", value[0])
        got = rec.take()
    (outer,) = got.spans
    assert got.counts == {(outer.id, "n"): 90, (None, "n"): 3}
    assert rec.take().counts == {}


def test_assign_records_its_cross_sweep():
    pts = synth.load("roadnet2d", 1_500, seed=6)
    q = synth.load("roadnet2d", 300, seed=7, structure_seed=6,
                   structure_n=1_500)
    snap = serve.build_snapshot(pts, 0.03, 4, device="cpu")
    with trace.recording() as rec:
        serve.assign(snap, q)
        got = rec.take()
    assert trace.total(got, "sweep_items", under="assign.sweep") > 0
    assert trace.total(got, "sweep_kept_runs", under="assign.sweep") >= \
        trace.total(got, "sweep_items", under="assign.sweep")


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: it holds the kernel's count to "
                    "the plain version's (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,eps", [
    ("roadnet2d", 200_000, 0.02), ("iono3d", 200_000, 2.0),
    ("taxi2d", 200_000, 0.01)])
def test_the_kernels_work_count_is_the_plain_versions(card, name, n, eps):
    pts = synth.load(name, n, seed=1)
    eng = make_engine(pts, eps, device=card)
    g, spec = eng.state, eng.meta
    q, starts_blk, nblk, max_blocks = ops._slab_args(
        g.q_sorted, g.starts, g.nblk, slab=spec.slab, block_q=spec.chunk,
        block_k=spec.block_k)
    eps2 = float(eps) ** 2
    kw = dict(max_blocks=max_blocks, block_q=spec.chunk,
              block_k=spec.block_k)
    counts, work = csr.csr_sweep_counts(q, g.cands, starts_blk, nblk, eps2,
                                        with_work=True, **kw)
    host = [t.cpu() for t in (q, g.cands, starts_blk, nblk)]
    want = csr.work_plain(csr.kept_runs_plain(
        *host, eps2, max_blocks=max_blocks, block_k=spec.block_k))
    assert work.cpu().tolist() == want.tolist()
    assert want[1] > 0
    # the counts beside it are those of a sweep without the count
    assert torch.equal(counts, csr.csr_sweep_counts(
        q, g.cands, starts_blk, nblk, eps2, **kw))
    # through dbscan and the record, the same count
    with trace.recording() as rec:
        res = dbscan(pts, eps, 16, eng=eng)
        got = rec.take()
    run_pairs = csr.run_width(spec.block_k) * spec.chunk
    assert res.timings["stage1_kept_pairs"] == int(want[1]) * run_pairs
    assert trace.total(got, "sweep_kept_runs", under="stage1") == \
        int(want[1])
    assert trace.total(got, "sweep_items", under="stage1") == int(want[0])
