"""``stage1_sweep_roofline``: the sweep's instructions and issue rate, and
its reader on made-up outcomes."""
import pytest

from portbench import check, harness, sweep_roofline


def _outcome(timings):
    calls = [harness.Call(i, 0, 0.01, 16, 0.1, dict(t), None, 5)
             for i, t in enumerate(timings)]
    return harness.Outcome(
        setup_s=10.0, window_s=0.4, calls=calls, attempted=len(calls),
        memory_peak_bytes=2**28, ref_s=20.0, traced=None, ref_pairs={},
        checks=dict.fromkeys(check.LIMITS, 0), compared=1, failed=0,
        n=2_000_000)


def test_instructions_and_issue_rate():
    assert sweep_roofline.FP32_RATE == pytest.approx(3.345408e13)
    assert sweep_roofline.sweep_instructions(1_000) == 9_000.0
    # iono3d 1M's kept pairs (6.84e9) at the rate: the kernel table's
    # issue-rate bound of 1.840 ms
    assert sweep_roofline.sweep_least_s(6_840_000_000) == \
        pytest.approx(1.840e-3, rel=1e-3)


def test_the_reader_on_a_made_up_outcome():
    pairs = 3_717_120_000          # 1 ms at the issue rate
    out = _outcome([{"stage1_s": 0.004, "stage1_kept_pairs": pairs},
                    {"stage1_s": 0.006, "stage1_kept_pairs": 3 * pairs}])
    # mean least 2 ms over mean stage1_s 5 ms
    assert harness.load_reader("stage1_sweep_roofline")(out) == \
        pytest.approx(40.0)


def test_the_reader_reads_only_calls_with_the_count():
    pairs = 3_717_120_000
    out = _outcome([{"stage1_s": 0.004, "stage1_kept_pairs": pairs},
                    {"stage1_s": 0.5}])
    assert harness.load_reader("stage1_sweep_roofline")(out) == \
        pytest.approx(25.0)


@pytest.mark.parametrize("timings", [
    [{"stage1_s": 0.004, "stage2_s": 0.01}],   # a program without the count
    [{"stage2_s": 0.01}],                      # saved counts: no stage-1 sweep
    [],
], ids=["no_count", "no_stage1", "no_calls"])
def test_the_reader_without_the_count_reads_nothing(timings):
    assert harness.load_reader("stage1_sweep_roofline")(_outcome(timings)) \
        is None
