"""The port's multi-tenant admission (``repro_torch/serve/tenancy.py``),
overload ladder (``serve/overload.py``) and their engine integration: the
JAX package's ``test_tenancy.py``, each test driving both packages'
token buckets, schedulers, overload controllers and engines through the
same sequence of submits, pops, expiries and latencies, asserting the
reference's invariants on the port and the port's decisions, outcomes,
counters and tokens equal to the reference's."""
import types

import numpy as np
import pytest

import repro.core as J
import repro.ft.backoff as JB
import repro.serve.engine as JEng
import repro.serve.overload as JO
import repro.serve.retrieval as JR
import repro.serve.tenancy as JT
import repro_torch.core as T
import repro_torch.ft.backoff as TB
import repro_torch.serve.engine as TEng
import repro_torch.serve.overload as TO
import repro_torch.serve.retrieval as TR
import repro_torch.serve.tenancy as TT
from _hypothesis_shim import HAVE_HYPOTHESIS, given, settings, st
from _torch_serve import comparable_stats, lake, models
from repro_torch.ft.backoff import TokenBucket
from repro_torch.serve.engine import UndrainedError
from repro_torch.serve.overload import (LADDER, OverloadConfig,
                                        OverloadController)
from repro_torch.serve.tenancy import (RejectReason, RequestStatus,
                                       SubmitStatus)

MAX_LEN = 64

#: each package's pieces under one set of names
PKGS = {
    "jax": types.SimpleNamespace(core=J, B=JB, T=JT, O=JO, R=JR, E=JEng),
    "torch": types.SimpleNamespace(core=T, B=TB, T=TT, O=TO, R=TR, E=TEng),
}


def both(scenario):
    """Run ``scenario(P)`` for both packages; the port's result must equal
    the reference's.  Returns the port's."""
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want
    return got


def _req(i, tenant="default", deadline=None, size=4, P=None):
    E = P.E if P is not None else TEng
    return E.Request(i, np.full(size, 7, np.int32), max_new_tokens=2,
                     tenant=tenant, deadline_ticks=deadline)


def _sched(*cfgs, P=None):
    Tn = P.T if P is not None else TT
    return Tn.TenantScheduler([Tn.TenantConfig(**c) for c in cfgs])


def _outcome(o):
    return (o.status.value, o.tenant, o.reason.value if o.reason else None,
            o.retry_after)


# ------------------------------ token bucket -------------------------------

def test_token_bucket_rate_burst_and_retry_after():
    b = TokenBucket(rate=0.5, burst=2.0)
    assert b.try_take(0) == (True, 0.0)      # burst admits immediately
    assert b.try_take(0) == (True, 0.0)
    ok, wait = b.try_take(0)                 # empty: 1 token / 0.5 rate
    assert not ok and wait == pytest.approx(2.0)
    ok, _ = b.try_take(2.0)                  # waiting retry_after works
    assert ok
    assert not b.try_take(2.0)[0]

    def run(P):
        b = P.B.TokenBucket(rate=0.5, burst=2.0)
        return [b.try_take(t) for t in (0, 0, 0, 2.0, 2.0, 7.5)]
    both(run)


def test_token_bucket_zero_rate_never_refills():
    b = TokenBucket(rate=0.0, burst=1.0)
    assert b.try_take(0)[0]
    ok, wait = b.try_take(1e9)
    assert not ok and wait == float("inf")

    def run(P):
        b = P.B.TokenBucket(rate=0.0, burst=1.0)
        return [b.try_take(0), b.try_take(1e9)]
    both(run)


def test_token_bucket_level_never_exceeds_burst():
    b = TokenBucket(rate=100.0, burst=3.0)
    b.try_take(0)
    b.refill(1e6)
    assert b.level == 3.0

    def run(P):
        b = P.B.TokenBucket(rate=100.0, burst=3.0)
        b.try_take(0)
        b.refill(0.001)
        lv = b.level
        b.refill(1e6)
        return lv, b.level
    both(run)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 20), st.integers(1, 40),
       st.lists(st.integers(0, 5), min_size=1, max_size=40))
def test_token_bucket_deterministic_replay(rate10, burst10, gaps):
    """Two fresh buckets fed the identical (seeded) submit schedule make
    identical decisions with identical retry hints -- and the port's
    make the reference's."""
    rate, burst = rate10 / 10.0, burst10 / 10.0
    ticks = np.cumsum(gaps)

    def run(P=PKGS["torch"]):
        b = P.B.TokenBucket(rate=rate, burst=burst)
        return [b.try_take(float(t)) for t in ticks]

    a, b = run(), run()
    assert a == b
    for ok, wait in a:
        assert ok == (wait == 0.0)
    assert a == run(PKGS["jax"])


# ----------------------------- DWRR scheduling -----------------------------

def test_dwrr_exact_weight_shares_when_backlogged():
    """All tenants backlogged: one full round serves exactly ``weight``
    requests per tenant -- fairness as an equality."""
    def run(P):
        sched = _sched(dict(name="a", weight=3, max_queue=100),
                       dict(name="b", weight=2, max_queue=100),
                       dict(name="c", weight=1, max_queue=100), P=P)
        for i in range(60):
            assert sched.submit(_req(i, "abc"[i % 3], P=P), 0).admitted
        got = sched.pop(3 * 6, 1)            # W = 3 + 2 + 1
        return [(r.request_id, r.tenant) for r in got]

    got = both(run)
    counts = {n: sum(1 for _, t in got if t == n) for n in "abc"}
    assert counts == {"a": 9, "b": 6, "c": 3}


def test_dwrr_chunked_pops_do_not_recredit_head():
    """pop(1) x N must serve the same weighted shares as one pop(N)."""
    def serve(chunks, P=PKGS["torch"]):
        sched = _sched(dict(name="a", weight=3, max_queue=100),
                       dict(name="b", weight=1, max_queue=100), P=P)
        for i in range(40):
            sched.submit(_req(i, "ab"[i % 2], P=P), 0)
        out = []
        for c in chunks:
            out.extend(sched.pop(c, 1))
        return [r.tenant for r in out]

    assert serve([1] * 16) == serve([16]) == serve([5, 3, 7, 1])
    counts = {n: serve([1] * 16).count(n) for n in "ab"}
    assert counts == {"a": 12, "b": 4}       # 4 rounds of W=4
    for chunks in ([1] * 16, [5, 3, 7, 1]):
        assert serve(chunks) == serve(chunks, PKGS["jax"])


def test_dwrr_work_conserving_and_starvation_free():
    def run(P):
        sched = _sched(dict(name="hog", weight=8, max_queue=100),
                       dict(name="mouse", weight=1, max_queue=100), P=P)
        for i in range(30):
            sched.submit(_req(i, "hog" if i < 25 else "mouse", P=P), 0)
        got = sched.pop(12, 1)
        rest = sched.pop(100, 2)
        return ([(r.request_id, r.tenant) for r in got],
                [r.request_id for r in rest], sched.pending())

    got, rest, pending = both(run)
    assert len(got) == 12                    # work-conserving
    assert any(t == "mouse" for _, t in got)  # served within a round
    assert len(rest) == 30 - 12
    assert pending == 0


if HAVE_HYPOTHESIS:
    _mixes = st.lists(
        st.tuples(st.integers(1, 6), st.integers(0, 12)),
        min_size=1, max_size=5)

    @settings(max_examples=60, deadline=None)
    @given(_mixes, st.integers(0, 40))
    def test_dwrr_work_conserving_property(mix, k):
        """Across random weight/backlog mixes, pop(k) always returns
        min(k, pending), in the reference's order."""
        def run(P):
            sched = _sched(*[dict(name=f"t{j}", weight=w, max_queue=1000)
                             for j, (w, _) in enumerate(mix)], P=P)
            i = 0
            for j, (_, backlog) in enumerate(mix):
                for _ in range(backlog):
                    assert sched.submit(_req(i, f"t{j}", P=P), 0).admitted
                    i += 1
            pending = sched.pending()
            got = sched.pop(k, 1)
            return pending, [r.request_id for r in got], sched.pending()

        pending, ids, after = both(run)
        assert len(ids) == min(k, pending)
        assert after == pending - len(ids)
        assert len(set(ids)) == len(ids)

    @settings(max_examples=60, deadline=None)
    @given(_mixes, st.lists(st.integers(1, 7), min_size=1, max_size=8))
    def test_dwrr_peek_matches_pop_across_chunks(mix, chunks):
        """peek(k) previews exactly what the next pops return, even when
        the pops are split into arbitrary chunks."""
        def build(P):
            s = _sched(*[dict(name=f"t{j}", weight=w, max_queue=1000)
                         for j, (w, _) in enumerate(mix)], P=P)
            i = 0
            for j, (_, backlog) in enumerate(mix):
                for _ in range(backlog):
                    s.submit(_req(i, f"t{j}", P=P), 0)
                    i += 1
            return s

        def run(P):
            want = [r.request_id for r in build(P).peek(sum(chunks))]
            sched = build(P)
            got = []
            for c in chunks:
                p = [r.request_id for r in sched.peek(c)]
                popped = [r.request_id for r in sched.pop(c, 1)]
                assert p == popped
                got.extend(popped)
            return want, got

        want, got = both(run)
        assert got == want


# --------------------------- admission gating ------------------------------

def test_submit_rejects_with_typed_retry_after():
    def run(P):
        sched = _sched(dict(name="t", rate=1.0, burst=2.0, max_queue=10),
                       P=P)
        outs = [sched.submit(_req(i, "t", P=P), 0) for i in range(3)]
        outs.append(sched.submit(_req(3, "t", P=P),
                                 0 + outs[2].retry_after))
        return [_outcome(o) for o in outs]

    outs = both(run)
    assert outs[0][0] == outs[1][0] == SubmitStatus.ADMITTED.value
    assert outs[2] == (SubmitStatus.REJECTED.value, "t",
                       RejectReason.RATE_LIMITED.value, 1)
    assert outs[3][0] == SubmitStatus.ADMITTED.value


def test_submit_sheds_on_bounded_queue():
    def run(P):
        sched = _sched(dict(name="t", max_queue=2), P=P)
        outs = [sched.submit(_req(i, "t", P=P), 0) for i in range(3)]
        sched.pop(1, 1)                      # a slot drains
        outs.append(sched.submit(_req(3, "t", P=P), 1))
        return [_outcome(o) for o in outs]

    outs = both(run)
    assert outs[2][0] == SubmitStatus.REJECTED.value
    assert outs[2][2] == RejectReason.QUEUE_FULL.value
    assert outs[2][3] >= 1
    assert outs[3][0] == SubmitStatus.ADMITTED.value


def test_submit_unknown_tenant_typed():
    out = both(lambda P: _outcome(_sched(dict(name="t"), P=P).submit(
        _req(0, "nope", P=P), 0)))
    assert out == (SubmitStatus.REJECTED.value, "nope",
                   RejectReason.UNKNOWN_TENANT.value, None)


def test_queue_expiry_is_typed_and_counted():
    def run(P):
        sched = _sched(dict(name="t", deadline_ticks=2, max_queue=10), P=P)
        sched.submit(_req(0, "t", P=P), 0)
        sched.submit(_req(1, "t", deadline=100, P=P), 0)
        early = sched.expire(2)              # now == deadline_at: live
        expired = sched.expire(3)
        return ([r.request_id for r in early],
                [r.request_id for r in expired], sched.pending(),
                sched.stats())

    early, expired, pending, stats = both(run)
    assert early == [] and expired == [0]
    assert pending == 1
    assert stats["t"]["expired"] == 1


def test_tenant_config_validation():
    for P in PKGS.values():
        with pytest.raises(ValueError):
            P.T.TenantConfig("t", weight=0)
        with pytest.raises(ValueError):
            P.T.TenantConfig("t", max_queue=0)
        with pytest.raises(ValueError):
            P.T.TenantConfig("t", rate=0.0)
        with pytest.raises(ValueError):
            P.T.TenantScheduler([P.T.TenantConfig("t"),
                                 P.T.TenantConfig("t")])
        with pytest.raises(ValueError):
            P.T.TenantScheduler([])
    assert [e.value for e in RequestStatus] == \
        [e.value for e in JT.RequestStatus]
    assert [e.value for e in RejectReason] == \
        [e.value for e in JT.RejectReason]


# ------------------------- overload ladder (unit) --------------------------

def _tiny_retriever(P):
    _, adj, tok, _ = lake(P.core, num_docs=60, vocab=128, mean_len=8,
                          seed=3, page_size=64)
    return P.R.GraphRetriever(adj, tok, max_neighbors=8,
                              tokens_per_neighbor=4, engine="numpy",
                              page_cache_pages=None, hops=2)


class _StubEngine:
    """Just enough engine surface for the controller: the knob targets."""

    def __init__(self, retr):
        self.context_fn = retr
        self.spec_disabled = False
        self.tick_no = 0

    def _discard_prefetch(self):
        pass


def test_overload_ladder_degrades_and_restores_in_order():
    def run(P):
        retr = _tiny_retriever(P)
        eng = _StubEngine(retr)
        ctl = P.O.OverloadController(eng, P.O.OverloadConfig(
            target_p99_ms=10.0, window=8, patience=2))
        trace = []
        for ms in [100.0] * 30 + [0.5] * 60:
            ctl.observe(ms)
            trace.append((ctl.level, retr.hops, eng.spec_disabled,
                          retr.max_neighbors))
        return trace, ctl.stats()

    trace, stats = both(run)
    assert trace[29] == (3, 1, True, 4)      # every rung applied
    assert trace[-1] == (0, 2, False, 8)     # every knob restored
    assert stats["degrade_steps"] == 3 and stats["restore_steps"] == 3
    steps = [(h["dir"], h["step"]) for h in stats["transitions"]]
    assert steps == [("degrade", "cap_hops"),
                     ("degrade", "no_speculation"),
                     ("degrade", "shrink_context"),
                     ("restore", "shrink_context"),
                     ("restore", "no_speculation"),
                     ("restore", "cap_hops")]
    assert LADDER == JO.LADDER


def test_overload_single_slow_tick_is_debounced():
    def run(P):
        ctl = P.O.OverloadController(
            _StubEngine(_tiny_retriever(P)),
            P.O.OverloadConfig(target_p99_ms=10.0, window=8, patience=3))
        for ms in [1.0] * 20 + [500.0] + [1.0] * 20:
            ctl.observe(ms)
        return ctl.level, ctl.degrade_steps, ctl.last_p99

    level, degrades, _ = both(run)
    assert level == 0 and degrades == 0
    with pytest.raises(ValueError):
        OverloadConfig(target_p99_ms=0.0)
    with pytest.raises(ValueError):
        OverloadController(None, OverloadConfig(1.0, window=2))


def test_set_knob_rejects_unknown_and_degenerate():
    for P in PKGS.values():
        retr = _tiny_retriever(P)
        with pytest.raises(ValueError):
            retr.set_knob("meter", 0)
        with pytest.raises(ValueError):
            retr.set_knob("max_neighbors", 0)
        assert retr.set_knob("max_neighbors", 4) == 8
        assert retr.stats()["knobs"]["max_neighbors"] == 4


# ------------------------- engine integration ------------------------------

def _mk(P, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("eos_id", -1)
    _, jm, jp, tm = models()
    if P is PKGS["jax"]:
        return P.E.ServeEngine(jm, jp, **kw)
    return P.E.ServeEngine(tm, **kw)


def _prompts(P, n, seed=0, mnt=2):
    cfg = models()[0]
    rng = np.random.default_rng(seed)
    return [P.E.Request(i, rng.integers(4, cfg.vocab_size, size=5)
                        .astype(np.int32), max_new_tokens=mnt)
            for i in range(n)]


def _finished(fin):
    return [(r.request_id, r.tenant, r.status.value, r.output,
             r.finished_tick) for r in fin]


def _tenants(P, *cfgs):
    return [P.T.TenantConfig(**c) for c in cfgs]


def test_engine_fairness_under_saturation():
    """Saturated two-tenant engine: admitted slots split by weight, no
    tenant starves, and stats()['tenants'] carries the full field set."""
    def run(P):
        eng = _mk(P, tenants=_tenants(
            P, dict(name="prod", weight=3, max_queue=64),
            dict(name="best_effort", weight=1, max_queue=64)))
        for i, r in enumerate(_prompts(P, 32, mnt=2)):
            r.tenant = "prod" if i % 2 == 0 else "best_effort"
            assert eng.submit(r).admitted
        fin = eng.run_until_drained()
        return _finished(fin), comparable_stats(eng.stats())

    fin, stats = both(run)
    assert len(fin) == 32
    assert all(s == RequestStatus.OK.value for _, _, s, _, _ in fin)
    first = [t for _, t, _, _, _ in fin[:16]]
    assert first.count("prod") == 12 and first.count("best_effort") == 4
    ts = stats["tenants"]
    for name in ("prod", "best_effort"):
        for field in ("weight", "queue_depth", "submitted", "admitted",
                      "rejected_rate", "rejected_queue_full", "expired",
                      "scheduled", "finished_ok", "finished_failed",
                      "bucket_level", "deficit", "rate", "max_queue"):
            assert field in ts[name]
    assert ts["prod"]["finished_ok"] == 16


def test_engine_typed_rejection_and_backpressure():
    def run(P):
        eng = _mk(P, tenants=_tenants(P, dict(name="t", rate=1.0,
                                              burst=2.0, max_queue=2)))
        reqs = _prompts(P, 4)
        for r in reqs:
            r.tenant = "t"
        outs = [_outcome(eng.submit(r)) for r in reqs]
        rejected = [(r.request_id, r.status.value) for r in eng.rejected]
        fin = eng.run_until_drained()
        late = _prompts(P, 1, seed=9)[0]
        late.tenant = "t"
        return (outs, rejected, _finished(fin), eng.stats()["rejected"],
                eng.submit(late).admitted)

    outs, rejected, fin, n_rejected, late_ok = both(run)
    assert [o[0] for o in outs] == [
        SubmitStatus.ADMITTED.value, SubmitStatus.ADMITTED.value,
        SubmitStatus.REJECTED.value, SubmitStatus.REJECTED.value]
    assert outs[2][3] == 1
    assert len(rejected) == 2
    assert all(s == RequestStatus.REJECTED.value for _, s in rejected)
    assert sorted(i for i, _, _, _, _ in fin) == [0, 1]
    assert n_rejected == 2
    assert late_ok                           # the bucket refilled


def test_engine_deadline_exceeded_in_slot_and_queue():
    """A slot request past its deadline finishes with the typed status
    and frees the slot that same tick; queued requests expire without
    ever holding a slot."""
    def run(P):
        eng = _mk(P, max_slots=1, tenants=_tenants(
            P, dict(name="t", max_queue=16, deadline_ticks=3)))
        long, short, queued = _prompts(P, 3, mnt=40)
        long.deadline_ticks = 4              # expires while decoding
        short.deadline_ticks = 100
        short.max_new_tokens = 2
        queued.deadline_ticks = 2            # expires while queued
        for r in (long, short, queued):
            r.tenant = "t"
            assert eng.submit(r).admitted
        fin = eng.run_until_drained()
        s = comparable_stats(eng.stats())
        nxt = _prompts(P, 1, seed=7)[0]
        nxt.tenant = "t"
        assert eng.submit(nxt).admitted
        return _finished(fin), s, _finished(eng.run_until_drained())

    fin, s, more = both(run)
    by_id = {i: (st_, out) for i, _, st_, out, _ in fin}
    assert by_id[0][0] == RequestStatus.DEADLINE_EXCEEDED.value
    assert 0 < len(by_id[0][1]) < 40         # partial, typed
    assert by_id[2] == (RequestStatus.DEADLINE_EXCEEDED.value, [])
    assert by_id[1][0] == RequestStatus.OK.value
    assert s["deadline_exceeded"] == 2 and s["expired_in_queue"] == 1
    assert s["tenants"]["t"]["finished_failed"] >= 1
    assert len(more) == 1


def test_engine_deadlines_without_tenancy():
    """deadline_ticks works on the single-queue path too."""
    def run(P):
        eng = _mk(P, max_slots=1)
        a, b_ = _prompts(P, 2, mnt=30)
        a.deadline_ticks = 3
        b_.deadline_ticks = 1                # expires before a slot frees
        assert eng.submit(a).admitted and eng.submit(b_).admitted
        return _finished(eng.run_until_drained())

    fin = both(run)
    by_id = {i: (s, out) for i, _, s, out, _ in fin}
    assert by_id[0][0] == RequestStatus.DEADLINE_EXCEEDED.value
    assert by_id[1] == (RequestStatus.DEADLINE_EXCEEDED.value, [])


def test_single_unmetered_tenant_matches_legacy_queue():
    """One unmetered tenant with a roomy queue reduces to the FIFO: same
    retirement order, same outputs."""
    def run(P, **kw):
        eng = _mk(P, **kw)
        for r in _prompts(P, 8, mnt=3):
            assert eng.submit(r).admitted
        return [(r.request_id, r.output) for r in eng.run_until_drained()]

    legacy = both(run)
    tenant = both(lambda P: run(P, tenants=_tenants(
        P, dict(name="default", max_queue=64))))
    assert legacy == tenant


def test_run_until_drained_raises_typed_undrained():
    eng = _mk(PKGS["torch"], max_slots=1)
    for r in _prompts(PKGS["torch"], 4, mnt=8):
        eng.submit(r)
    with pytest.raises(UndrainedError) as ei:
        eng.run_until_drained(max_ticks=3)
    err = ei.value
    assert err.max_ticks == 3
    stuck = set(err.queued_ids) | set(err.active_ids)
    assert stuck and stuck <= {0, 1, 2, 3}
    assert err.active_ids                    # someone holds the slot
    # the report is diagnosis, not corruption: draining still completes
    eng.run_until_drained()
    assert len(eng.finished) == 4

    def run(P):
        eng = _mk(P, max_slots=1)
        for r in _prompts(P, 4, mnt=8):
            eng.submit(r)
        try:
            eng.run_until_drained(max_ticks=3)
        except (JEng.UndrainedError, UndrainedError) as e:
            return e.queued_ids, e.active_ids, str(e)
    both(run)


def test_engine_overload_integration():
    """An impossible latency target drives the engine down the whole
    ladder mid-drain; serving completes and stats() shows the trace."""
    def run(P):
        eng = _mk(P, tenants=_tenants(P, dict(name="t", max_queue=64)),
                  overload=P.O.OverloadConfig(target_p99_ms=1e-6,
                                              window=4, patience=1))
        for r in _prompts(P, 12, mnt=3):
            r.tenant = "t"
            eng.submit(r)
        fin = eng.run_until_drained()
        ov = eng.stats()["overload"]
        return (_finished(fin), ov["level"], ov["degrade_steps"],
                ov["active_steps"], eng.spec_disabled,
                [(h["tick"], h["step"], h["dir"])
                 for h in ov["transitions"]])

    fin, level, degrades, active, spec_disabled, trace = both(run)
    assert len(fin) == 12
    assert level == 3 and degrades == 3
    assert active == list(LADDER)
    assert spec_disabled
