"""The comparison that decides ``correct`` catches what it must: a run
whose timed path is broken underneath comes out not correct, once for
each fault a cell of this benchmark can have, and so does the control
(the reference in bfloat16 in the program's place). A sound run comes
out correct. The harness's look for a card is skipped: the rest of a run
is driven on the CPU at a few thousand points. (One card a cell: there is
no exchange between chips to leave out.)"""
import pytest
import torch

import repro_torch.core.dbscan as dbscan_mod
from portbench import check, control, harness


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small(name, **traffic):
    """The cell at 3,000 points, at an ε where the stand-in clusters."""
    cell = harness.load_cell(name)
    cell.config.update(n=3_000, eps=0.1 if "roadnet" in name else 8.0)
    cell.traffic.update(pool=2, **traffic)
    return cell


def _run(cell, seed=2**31 + 17, seconds=0.0, traced=False):
    out = harness.run_cell(cell, seed, seconds, traced, "cpu", 0.0)
    line = harness.result(cell, out, False, "cpu", "none")
    assert list(line)[-1] == "checks" and line["compared"] == out.compared
    return out, line


def _period(cell):
    return len(harness.schedule(cell.config, cell.traffic))


@pytest.mark.parametrize("name", ["roadnet2d-435k.cluster",
                                  "iono3d-1m.cluster"])
def test_a_sound_run_is_correct(name):
    cell = _small(name)
    out, line = _run(cell)
    assert line["correct"] and line["failed"] == 0
    p = _period(cell)
    assert len(out.sampled_early) == len(out.sampled_late) == p
    assert p <= out.compared <= 2 * p
    assert all(v["value"] == 0 for v in line["checks"].values())


def test_a_sound_minpts_run_compares_every_min_pts():
    cell = _small("roadnet2d-435k.minpts", min_pts=[4, 64])
    out, line = _run(cell)
    assert line["correct"] and out.compared >= _period(cell) == 4


@pytest.mark.parametrize("traffic", [
    {"eps_scale": [0.5, 1.0], "min_pts": [4, 16]},
    {"min_pts": [4, 16], "saved_counts": True},
    {"min_pts": [8], "engine": "grid-hash"},
], ids=["eps", "saved_counts", "grid_hash"])
def test_a_sound_rerun_mix_written_as_data_is_correct(traffic):
    cell = _small("iono3d-1m.minpts", **traffic)
    cell.traffic["pool"] = 1
    out, line = _run(cell)
    assert line["correct"] and out.compared >= _period(cell)
    assert {(c.dataset, c.eps, c.min_pts) for c in out.calls} == \
        set(harness.schedule(cell.config, cell.traffic))


def test_a_sound_cluster_mix_over_eps_is_correct():
    cell = _small("roadnet2d-435k.cluster", eps_scale=[0.5, 2.0])
    cell.traffic["pool"] = 1
    out, line = _run(cell)
    assert line["correct"] and len(out.ref_pairs) == 2


def test_late_samples_fall_late_in_the_window_after_the_traced_calls():
    cell = _small("roadnet2d-435k.minpts", min_pts=[4, 8], trace_calls=3)
    cell.traffic["pool"] = 1
    out, line = _run(cell, seconds=1.0, traced=True)
    assert line["correct"]
    first = out.calls[0].index
    assert first == 3 and len(out.sampled_late) == 2
    for i in out.sampled_late:
        # the calls' own time before it, a lower bound on when it started:
        # its share of the window was drawn at 0.5 or more
        assert sum(c.seconds for c in out.calls if c.index < i) >= 0.3


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    # stage 2's hooking step hooks nothing: every core point its own
    monkeypatch.setattr(dbscan_mod, "_hook_step",
                        lambda root, m, core: (root, False))
    out, line = _run(_small("roadnet2d-435k.cluster"))
    assert not line["correct"]
    assert line["checks"]["partition_mismatch"]["value"] > 0


def test_half_of_the_points_left_out(monkeypatch):
    # stage 1 counts only the first half of the points
    real = dbscan_mod._counts_stage1_fn

    def half(*args):
        counts = real(*args)
        counts[counts.shape[0] // 2:] = 0
        return counts
    monkeypatch.setattr(dbscan_mod, "_counts_stage1_fn", half)
    out, line = _run(_small("iono3d-1m.cluster"))
    assert not line["correct"]
    assert line["checks"]["count_mismatch"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    real = dbscan_mod.dbscan

    def altered(*args, **kw):
        res = real(*args, **kw)
        labels = res.labels.clone()
        labels[1] += 1
        return res._replace(labels=labels)
    monkeypatch.setattr(dbscan_mod, "dbscan", altered)
    out, line = _run(_small("roadnet2d-435k.cluster"))
    assert not line["correct"] and line["failed"] == out.compared
    assert line["checks"]["label_mismatch"]["value"] == out.compared


@pytest.mark.parametrize("name", ["roadnet2d-435k.minpts",
                                  "iono3d-1m.cluster"])
def test_the_control_is_not_correct(name):
    cell = harness.load_cell(name)
    cell.config["n"] = 20_000        # the configuration's ε
    cell.traffic["pool"] = 1
    rows = control.control_numbers(cell, 2**31 + 3, "cpu")
    assert rows and all(not check.within(numbers) for _, _, numbers in rows)
