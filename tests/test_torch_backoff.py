"""The port's fault-tolerance primitives (``repro_torch/ft/backoff.py``)
and fault-injection harness (``repro_torch/ft/faults.py``): the JAX
package's ``test_backoff.py`` run on the port, then the port against the
reference on the same seeds -- a seeded ``Backoff`` gives the reference's
delays bit for bit, and ``FaultPlan.from_seed`` its trips."""
import numpy as np
import pytest

import repro.ft.backoff as JB
import repro.ft.faults as JF
import repro_torch.ft.backoff as TB
from repro_torch.ft.backoff import (Backoff, HeartbeatTracker, StrikeCounter,
                                    TokenBucket, retry_call)
from repro_torch.ft.faults import (ALL_BOUNDARIES, BOUNDARIES, ENV_SEED,
                                   SERVE_BOUNDARIES, FaultPlan,
                                   InjectedFault, check)


# -- Backoff ----------------------------------------------------------------

def test_backoff_exponential_growth_and_cap():
    bo = Backoff(base=0.1, factor=2.0, max_delay=1.0, jitter=0.0)
    assert bo.delay(0) == pytest.approx(0.1)
    assert bo.delay(1) == pytest.approx(0.2)
    assert bo.delay(2) == pytest.approx(0.4)
    assert bo.delay(10) == pytest.approx(1.0)  # clamped


def test_backoff_jitter_bounds_and_seed_determinism():
    a = Backoff(base=0.1, factor=2.0, max_delay=10.0, jitter=0.5, seed=7)
    b = Backoff(base=0.1, factor=2.0, max_delay=10.0, jitter=0.5, seed=7)
    seq_a = [a.delay(i) for i in range(8)]
    seq_b = [b.delay(i) for i in range(8)]
    assert seq_a == seq_b  # seeded schedule replays exactly
    for i, d in enumerate(seq_a):
        nominal = min(0.1 * 2.0 ** i, 10.0)
        assert 0.5 * nominal <= d <= 1.5 * nominal


def test_backoff_delays_generator_matches_delay():
    bo = Backoff(base=0.05, factor=3.0, max_delay=5.0, jitter=0.0)
    gen = bo.delays()
    assert [next(gen) for _ in range(4)] == \
        [bo.delay(i) for i in range(4)]


def test_backoff_rejects_bad_params():
    with pytest.raises(ValueError):
        Backoff(base=-1.0)
    with pytest.raises(ValueError):
        Backoff(factor=0.5)
    with pytest.raises(ValueError):
        Backoff(jitter=1.0)


# -- retry_call -------------------------------------------------------------

def test_retry_call_retries_then_succeeds():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("boom")
        return "ok"

    out = retry_call(flaky, retries=5,
                     backoff=Backoff(base=0.1, factor=2.0, jitter=0.0),
                     sleep=slept.append)
    assert out == "ok"
    assert len(calls) == 3
    assert slept == pytest.approx([0.1, 0.2])


def test_retry_call_exhausts_and_raises():
    slept = []
    with pytest.raises(RuntimeError):
        retry_call(lambda: (_ for _ in ()).throw(RuntimeError("always")),
                   retries=2, backoff=Backoff(jitter=0.0),
                   sleep=slept.append)
    assert len(slept) == 2  # one sleep per retry, none after the last


def test_retry_call_only_catches_retry_on():
    with pytest.raises(KeyError):
        retry_call(lambda: (_ for _ in ()).throw(KeyError("x")),
                   retries=5, retry_on=(RuntimeError,),
                   sleep=lambda s: None)


def test_retry_call_on_retry_observer():
    seen = []

    def fail_twice(state={"n": 0}):
        state["n"] += 1
        if state["n"] <= 2:
            raise RuntimeError("x")
        return state["n"]

    retry_call(fail_twice, retries=5, backoff=Backoff(jitter=0.0),
               sleep=lambda s: None,
               on_retry=lambda a, d, e: seen.append((a, type(e))))
    assert seen == [(0, RuntimeError), (1, RuntimeError)]


# -- HeartbeatTracker -------------------------------------------------------

def test_heartbeat_tracker_expiry():
    t = {"now": 0.0}
    hb = HeartbeatTracker(timeout=10.0, clock=lambda: t["now"])
    hb.register("a")
    hb.register("b")
    t["now"] = 5.0
    hb.beat("b")
    t["now"] = 11.0
    assert hb.is_expired("a")
    assert not hb.is_expired("b")
    assert hb.expired() == ["a"]
    t["now"] = 16.0
    assert sorted(hb.expired()) == ["a", "b"]
    hb.drop("a")
    assert hb.expired() == ["b"]


# -- StrikeCounter ----------------------------------------------------------

def test_strike_counter_trip_and_clear():
    s = StrikeCounter(3)
    assert not s.strike()
    assert not s.strike()
    assert s.strike()      # third strike trips
    assert s.tripped
    s.clear()
    assert not s.tripped
    assert s.strikes == 0
    with pytest.raises(ValueError):
        StrikeCounter(0)


# -- FaultPlan --------------------------------------------------------------

def test_fault_plan_trips_then_clears():
    plan = FaultPlan({"compact.pre_swap": 2})
    for hit in (1, 2):
        with pytest.raises(InjectedFault) as ei:
            plan.check("compact.pre_swap")
        assert ei.value.boundary == "compact.pre_swap"
        assert ei.value.hit == hit
    plan.check("compact.pre_swap")  # trips consumed: no longer raises
    assert plan.fired == {"compact.pre_swap": 2}
    assert plan.remaining() == 0
    assert plan.history == ["compact.pre_swap"] * 2


def test_fault_plan_unarmed_boundary_is_silent():
    plan = FaultPlan({"compact.mid_gc": 1})
    plan.check("ingest.append")  # not armed
    assert plan.total_fired() == 0


def test_fault_plan_from_seed_deterministic():
    a = FaultPlan.from_seed(11)
    b = FaultPlan.from_seed(11)
    assert a.trips == b.trips
    assert set(a.trips) <= set(BOUNDARIES)
    # across seeds, at least one differing pattern exists
    patterns = {tuple(sorted(FaultPlan.from_seed(s).trips.items()))
                for s in range(8)}
    assert len(patterns) > 1


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_SEED", raising=False)
    assert FaultPlan.from_env() is None
    assert FaultPlan.from_env(default_seed=3).trips == \
        FaultPlan.from_seed(3).trips
    monkeypatch.setenv("REPRO_FAULT_SEED", "5")
    assert FaultPlan.from_env().trips == FaultPlan.from_seed(5).trips


def test_check_helper_none_safe():
    check(None, "compact.pre_swap")  # no plan: no-op
    with pytest.raises(InjectedFault):
        check(FaultPlan({"store.write": 1}), "store.write")


# -- the port against the reference -----------------------------------------

def test_boundary_names_equal_the_reference():
    assert BOUNDARIES == JF.BOUNDARIES
    assert SERVE_BOUNDARIES == JF.SERVE_BOUNDARIES
    assert ALL_BOUNDARIES == JF.ALL_BOUNDARIES
    assert ENV_SEED == JF.ENV_SEED


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("jitter", [0.0, 0.5, 0.9])
def test_seeded_backoff_delays_equal_the_reference(seed, jitter):
    kw = dict(base=0.05, factor=2.0, max_delay=2.0, jitter=jitter, seed=seed)
    a, b = Backoff(**kw), JB.Backoff(**kw)
    got = [a.delay(i) for i in range(12)] + [d for d, _ in
                                             zip(a.delays(), range(5))]
    want = [b.delay(i) for i in range(12)] + [d for d, _ in
                                              zip(b.delays(), range(5))]
    assert got == want                     # bit for bit, not approx


@pytest.mark.parametrize("seed", range(6))
def test_fault_plan_from_seed_trips_equal_the_reference(seed):
    for kw in ({}, {"boundaries": SERVE_BOUNDARIES},
               {"boundaries": ALL_BOUNDARIES, "max_trips": 3}):
        jkw = dict(kw)
        if "boundaries" in jkw:
            jkw["boundaries"] = getattr(
                JF, {SERVE_BOUNDARIES: "SERVE_BOUNDARIES",
                     ALL_BOUNDARIES: "ALL_BOUNDARIES"}[jkw["boundaries"]])
        assert FaultPlan.from_seed(seed, **kw).trips == \
            JF.FaultPlan.from_seed(seed, **jkw).trips


def test_retry_call_replays_the_reference_schedule():
    """A failing call under both packages' retry loops sleeps the same
    seeded delays and reports the same attempts."""
    def run(mod):
        slept, seen, n = [], [], {"k": 0}

        def flaky():
            n["k"] += 1
            if n["k"] <= 4:
                raise RuntimeError("x")
            return n["k"]

        out = mod.retry_call(flaky, retries=6,
                             backoff=mod.Backoff(seed=3),
                             sleep=slept.append,
                             on_retry=lambda a, d, e: seen.append((a, d)))
        return out, slept, seen

    assert run(JB) == run(TB)


def test_token_bucket_equals_the_reference():
    rng = np.random.default_rng(4)
    ticks = np.cumsum(rng.integers(0, 4, 60)).astype(float)
    a, b = TokenBucket(0.7, 2.5), JB.TokenBucket(0.7, 2.5)
    for t in ticks:
        assert a.try_take(t) == b.try_take(t)
        assert a.level == b.level
