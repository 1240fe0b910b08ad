"""repro_torch's failure-domain primitives, mirroring tests/test_health.py:
the per-target HealthRegistry state machine under an injectable clock,
the jittered Backoff ladder, and the tag-targeted fault registry that lets
chaos tests address one exact serving copy. Plus parity with the JAX
reference's registry (``repro.serve.health``): the same scripted signals
give the same states and report rows."""
import pytest

from repro.serve import health as jhealth
from repro_torch import serve
from repro_torch.serve import faults
from repro_torch.serve.health import (DOWN, HEALTHY, RECOVERING, SUSPECT,
                                      HealthRegistry)
from repro_torch.serve.resilience import Backoff


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# --- state machine ----------------------------------------------------------

def test_state_machine_healthy_suspect_down_recovering():
    clk = FakeClock()
    reg = HealthRegistry(down_after=3, recover_after_s=10.0, clock=clk)
    k = (0, 0)
    assert reg.state(k) == HEALTHY          # unseen target has no strikes
    reg.record_failure(k)
    assert reg.state(k) == SUSPECT
    reg.record_success(k)
    assert reg.state(k) == HEALTHY          # success resets the ladder
    for _ in range(3):
        reg.record_failure(k)
    assert reg.state(k) == DOWN             # down_after consecutive strikes
    clk.advance(9.9)
    assert reg.state(k) == DOWN             # quarantine window still open
    clk.advance(0.2)
    assert reg.state(k) == RECOVERING       # breaker half-open
    reg.record_success(k)
    assert reg.state(k) == HEALTHY


def test_failed_halfopen_probe_reopens_quarantine():
    clk = FakeClock()
    reg = HealthRegistry(down_after=2, recover_after_s=5.0, clock=clk)
    k = (1, 0)
    reg.record_failure(k)
    reg.record_failure(k)
    assert reg.state(k) == DOWN
    clk.advance(5.0)
    assert reg.state(k) == RECOVERING
    reg.record_failure(k)                   # the admitted probe failed
    assert reg.state(k) == DOWN             # fresh quarantine window
    clk.advance(4.9)
    assert reg.state(k) == DOWN


def test_force_down_quarantines_immediately():
    reg = HealthRegistry(down_after=5)
    reg.force_down((0, 1))
    assert reg.state((0, 1)) == DOWN        # no three-strikes escalation
    assert reg.quarantined(0, 2) is False   # replica 0 still live
    reg.force_down((0, 0))
    assert reg.quarantined(0, 2) is True


def test_begin_end_recovery_lifecycle():
    reg = HealthRegistry(down_after=1)
    k = (2, 0)
    reg.record_failure(k)
    assert reg.state(k) == DOWN
    reg.begin_recovery(k)
    assert reg.state(k) == RECOVERING       # re-materialize in flight
    reg.end_recovery(k, ok=False)
    assert reg.state(k) == DOWN             # failed attempt re-quarantines
    reg.begin_recovery(k)
    reg.end_recovery(k, ok=True, latency_s=0.01)
    assert reg.state(k) == HEALTHY
    assert reg.target(k).last_latency_s == 0.01


# --- routing ----------------------------------------------------------------

def test_candidates_rotate_and_skip_down():
    reg = HealthRegistry()
    assert reg.candidates(0, 3, start=0) == [0, 1, 2]
    assert reg.candidates(0, 3, start=4) == [1, 2, 0]   # ring wraps
    reg.force_down((0, 1))
    # the quarantined replica's turn passes to the next live copy
    assert reg.candidates(0, 3, start=1) == [2, 0]
    reg.force_down((0, 0))
    reg.force_down((0, 2))
    assert reg.candidates(0, 3, start=0) == []
    assert reg.quarantined(0, 3) is True


def test_report_rows():
    reg = HealthRegistry()
    reg.record_success((0, 0), 0.002)
    reg.record_failure((1, 0), probe=True, latency_s=0.5)
    rows = reg.report()
    assert rows[(0, 0)]["state"] == HEALTHY
    assert rows[(0, 0)]["last_latency_s"] == 0.002
    assert rows[(1, 0)]["state"] == SUSPECT
    assert rows[(1, 0)]["probes"] == 1
    assert rows[(1, 0)]["last_probe_ok"] is False


# --- backoff ----------------------------------------------------------------

def test_backoff_deterministic_jitter_honors_hint():
    d1 = [Backoff(seed=7).delay(a) for a in range(4)]
    d2 = [Backoff(seed=7).delay(a) for a in range(4)]
    assert d1 == d2                          # seeded: replays bit-identical
    b = Backoff(seed=7)
    seq = [b.delay(a) for a in range(4)]
    assert seq[1] >= 0.1 and seq[2] >= 0.2   # exponential floor (base 0.05)
    assert all(d <= 2.0 * 1.5 for d in seq)  # cap * (1 + jitter)
    # a server retry_after hint floors the jittered delay
    assert Backoff(seed=0).delay(0, retry_after=9.0) >= 9.0
    assert Backoff(seed=0, cap_s=0.2).delay(10) <= 0.2 * 1.5


# --- tag-targeted fault registry --------------------------------------------

def test_fault_tags_prefix_match_and_specificity():
    faults.clear()
    try:
        faults.inject("serve.shard.assign", error=RuntimeError("r0"),
                      times=-1, tag="shard-000/r0")
        # non-matching tags: nothing fires
        assert faults.fire("serve.shard.assign", "shard-000/r1") is False
        assert faults.fire("serve.shard.assign", "shard-001/r0") is False
        with pytest.raises(RuntimeError):
            faults.fire("serve.shard.assign", "shard-000/r0")
        # shard-scoped arming hits every replica (prefix match)
        faults.clear("serve.shard.assign")
        faults.inject("serve.shard.assign", error=RuntimeError("any"),
                      times=-1, tag="shard-002")
        for t in ("shard-002/r0", "shard-002/r1", "shard-002"):
            with pytest.raises(RuntimeError):
                faults.fire("serve.shard.assign", t)
        # the most specific armed match wins
        faults.inject("serve.shard.assign", error=KeyError("specific"),
                      times=-1, tag="shard-002/r1")
        with pytest.raises(KeyError):
            faults.fire("serve.shard.assign", "shard-002/r1")
        with pytest.raises(RuntimeError):
            faults.fire("serve.shard.assign", "shard-002/r0")
        assert faults.fired_count("serve.shard.assign") >= 5
        # untagged faults keep the PR-8 behavior: fire for every caller
        faults.clear("serve.shard.assign")
        faults.inject("serve.shard.assign", times=2)
        assert faults.fire("serve.shard.assign", "shard-000/r0") is True
        assert faults.fire("serve.shard.assign") is True
        assert faults.fire("serve.shard.assign") is False   # exhausted
    finally:
        faults.clear()


def test_unknown_site_and_clear_by_tag():
    faults.clear()
    try:
        with pytest.raises(ValueError):
            faults.inject("serve.shard.nope")
        faults.inject("serve.shard.probe", tag="shard-000")
        faults.inject("serve.shard.probe", tag="shard-001")
        faults.clear("serve.shard.probe", tag="shard-000")
        assert faults.fire("serve.shard.probe", "shard-000/r0") is False
        assert faults.fire("serve.shard.probe", "shard-001/r0") is True
    finally:
        faults.clear()


# --- parity with the reference ----------------------------------------------

def _script(reg, clk):
    """Signals for four targets over a fake clock; the state of every
    target after every step."""
    keys = [(0, 0), (0, 1), (1, 0), (2, 0)]
    seen = []
    steps = [
        lambda: reg.record_failure((0, 0)),
        lambda: reg.record_success((0, 1), 0.004),
        lambda: reg.record_failure((1, 0), probe=True, latency_s=0.3),
        lambda: reg.record_failure((1, 0)),
        lambda: reg.record_failure((1, 0)),
        lambda: clk.advance(4.0),
        lambda: reg.force_down((2, 0)),
        lambda: clk.advance(1.5),
        lambda: reg.begin_recovery((2, 0)),
        lambda: reg.end_recovery((2, 0), ok=True, latency_s=0.02),
        lambda: reg.record_failure((1, 0), probe=True, latency_s=0.1),
        lambda: clk.advance(5.0),
        lambda: reg.record_success((1, 0), 0.001, probe=True),
        lambda: reg.record_success((0, 0)),
    ]
    for step in steps:
        step()
        seen.append([reg.state(k) for k in keys]
                    + [reg.candidates(0, 2, start=1),
                       reg.quarantined(1, 1)])
    return seen, reg.report()


def test_registry_matches_reference_on_a_script():
    clk_a, clk_b = FakeClock(), FakeClock()
    got = _script(HealthRegistry(down_after=3, recover_after_s=5.0,
                                 clock=clk_a), clk_a)
    ref = _script(jhealth.HealthRegistry(down_after=3, recover_after_s=5.0,
                                         clock=clk_b), clk_b)
    assert got == ref
    assert (HEALTHY, SUSPECT, DOWN, RECOVERING) == (
        jhealth.HEALTHY, jhealth.SUSPECT, jhealth.DOWN, jhealth.RECOVERING)
    # the package exports the tier's health names, as the reference's does
    assert serve.HealthRegistry is HealthRegistry
    assert serve.TargetHealth.__name__ == "TargetHealth"
    assert (serve.HEALTHY, serve.SUSPECT, serve.DOWN, serve.RECOVERING) == (
        HEALTHY, SUSPECT, DOWN, RECOVERING)
