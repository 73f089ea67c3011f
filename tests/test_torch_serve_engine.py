"""The port's ``ServeEngine`` (``repro_torch/serve/engine.py``) against the
reference's, on the reduced smollm (``n_units=2``, the port carrying the
reference's ``init(0)`` weights through ``params_from_jax``) and on lakes
both packages build from one seed.

* Greedy tokens equal the reference engine's on every decisive step: a
  step whose top two logits in the reference's float32 forward lie more
  than ``MARGIN`` apart; past a step that is not decisive the streams may
  part.  IOMeter and ``stats()`` counters are equal.
* Pipelined against sequential, bit for bit (the JAX package's
  ``test_serve_pipeline.py`` at one partition), mis-speculation on a queue
  change, on a ``bump_version`` of the adjacency column and on an ingest
  between two ticks, the admission clamps, the prefill template reused by
  a shorter group, a sampled stream under a shared logits stub, and
  ``test_serve_chaos.py``: its two cases at the four serve boundaries with
  an ingest mid-drain, and an ingest under the ``serve.ingest`` fault
  landing exactly once, as the reference's does.
* The vector-index cache write drops positions past the cache's end
  without a host sync, as the reference's ``mode="drop"`` scatter.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_serve import (ENGINE_PAIRS, assert_same_requests,
                          comparable_stats, decisive_prefix, engines, lake,
                          models, requests)
from repro.ft.faults import FaultPlan as JFaultPlan
from repro.serve import engine as JE
from repro.serve.retrieval import GraphRetriever as JGraphRetriever
from repro.serve.tenancy import TenantConfig as JTenantConfig
from repro_torch.ft.faults import SERVE_BOUNDARIES, FaultPlan
from repro_torch.serve import engine as TE
from repro_torch.serve.retrieval import GraphRetriever
from repro_torch.serve.tenancy import RequestStatus, TenantConfig

MAX_LEN = 96
SEED = int(os.environ.get("REPRO_FAULT_SEED", "1"))


def _retrievers(jeng, teng, filtered=False, **kw):
    """The reference's and the port's retriever, each over a fresh lake."""
    kw = {"max_neighbors": 2, "tokens_per_neighbor": 8,
          "page_cache_pages": 64, **kw}
    out = []
    for core, cls, eng in ((J, JGraphRetriever, jeng),
                           (T, GraphRetriever, teng)):
        g, adj, tok, _ = lake(core)
        if filtered:
            kw.update(filter_vt=g.vertex("doc"),
                      filter_cond=core.L("HighQuality") & ~core.L("Spam"))
        out.append(cls(adj, tok, meter=core.IOMeter(), engine=eng, **kw))
    return out


def _assert_tokens_agree(jfin, tfin):
    """Equal request ids, prompts, contexts and statuses, and equal tokens
    on every decisive step: two streams may part only at a step that is
    not decisive."""
    _, jm, jp, _ = models()
    assert [r.request_id for r in tfin] == [r.request_id for r in jfin]
    for a, b in zip(tfin, jfin):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.context_tokens == b.context_tokens
        assert a.status.value == b.status.value
        if a.output != b.output:
            k = decisive_prefix(jm, jp, b)
            assert k < len(b.output) and a.output[:k] == b.output[:k], \
                f"request {b.request_id} parts at a decisive step"


# --------------------- the port against the reference ---------------------

@pytest.mark.parametrize("jeng,teng", ENGINE_PAIRS)
def test_engine_equals_the_reference(jeng, teng):
    """Two tenants, a label-scoped two-hop retriever with an LRU, the
    pipeline on, prompts of three lengths: tokens agree on decisive steps,
    and IOMeter and every counter of ``stats()`` are equal."""
    cfg = models()[0]
    jr, tr = _retrievers(jeng, teng, hops=2, filtered=True)
    kw = dict(max_slots=3, max_len=MAX_LEN, eos_id=-1, pipeline=True)
    jeng_, teng_ = engines(jkw=dict(context_fn=jr, tenants=[
        JTenantConfig("prod", weight=3), JTenantConfig("batch")]),
        tkw=dict(context_fn=tr, tenants=[
            TenantConfig("prod", weight=3), TenantConfig("batch")]), **kw)
    for pkg, eng, r in ((JE, jeng_, jr), (TE, teng_, tr)):
        for i, req in enumerate(requests(pkg, cfg, r.adj, 12, mnt=4,
                                         tenants=("prod", "batch"))):
            req.prompt = req.prompt[:4 + i % 3]
            assert eng.submit(req).admitted
    jfin = jeng_.run_until_drained()
    tfin = teng_.run_until_drained()
    _assert_tokens_agree(jfin, tfin)
    assert (tr.meter.nbytes, tr.meter.nrequests) == \
        (jr.meter.nbytes, jr.meter.nrequests)
    assert comparable_stats(teng_.stats()) == comparable_stats(jeng_.stats())
    assert teng_.stats()["pipeline"]["prefetch_hits"] > 0


# --------------------- pipelined == sequential oracle ---------------------

def _run(engine, pipeline, n=10, **kw):
    cfg, _, _, tm = models()
    meter = T.IOMeter()
    _, adj, tok, _ = lake(T)
    retr = GraphRetriever(adj, tok, max_neighbors=2, tokens_per_neighbor=8,
                          meter=meter, engine=engine, page_cache_pages=64,
                          partitions=1, **kw)
    eng = TE.ServeEngine(tm, max_slots=3, max_len=MAX_LEN, eos_id=-1,
                         context_fn=retr, pipeline=pipeline)
    for r in requests(TE, cfg, adj, n):
        eng.submit(r)
    finished = eng.run_until_drained()
    return eng, retr, meter, finished


def _assert_identical(fin_a, fin_b, m_a, m_b, r_a, r_b):
    assert_same_requests(fin_a, fin_b)
    assert (m_a.nbytes, m_a.nrequests) == (m_b.nbytes, m_b.nrequests)
    assert r_a.calls == r_b.calls
    assert r_a.vertices_seen == r_b.vertices_seen
    ca, cb = r_a.page_cache, r_b.page_cache
    assert (ca.hits, ca.misses) == (cb.hits, cb.misses)


@pytest.mark.parametrize("hops", [1, 2])
@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_pipelined_bit_identical_to_sequential(engine, hops):
    eng_s, retr_s, m_s, fin_s = _run(engine, False, hops=hops)
    eng_p, retr_p, m_p, fin_p = _run(engine, True, hops=hops)
    assert len(fin_s) == len(fin_p) == 10
    _assert_identical(fin_s, fin_p, m_s, m_p, retr_s, retr_p)
    # the pipeline actually pipelined: speculative retrievals were
    # consumed by the predicted admissions, not just rolled back
    pstats = eng_p.stats()["pipeline"]
    assert pstats["enabled"] and pstats["prefetch_hits"] > 0
    assert pstats["prefetch_issued"] == \
        pstats["prefetch_hits"] + pstats["mis_speculations"]
    sstats = eng_s.stats()["pipeline"]
    assert not sstats["enabled"] and sstats["prefetch_issued"] == 0


# ------------------------- mis-speculation paths --------------------------

def _one_slot(pipeline, between):
    cfg, _, _, tm = models()
    meter = T.IOMeter()
    _, adj, tok, _ = lake(T)
    retr = GraphRetriever(adj, tok, max_neighbors=2, tokens_per_neighbor=8,
                          meter=meter, engine="numpy", page_cache_pages=64)
    eng = TE.ServeEngine(tm, max_slots=1, max_len=MAX_LEN, eos_id=-1,
                         context_fn=retr, pipeline=pipeline)
    reqs = requests(TE, cfg, adj, 3, mnt=2)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    eng.step()                       # prefetch speculated for reqs[1]
    between(eng, retr, reqs)
    eng.run_until_drained()
    return eng, retr, meter, eng.finished


def test_mis_speculation_on_column_version(monkeypatch):
    """A ``bump_version`` of the adjacency column between prefetch and
    consumption moves the mutation epoch: the engine restores and falls
    back synchronously, bit-identical to a sequential run with the same
    interleaving (the write version stands in for an ingest here)."""
    def bump(eng, retr, reqs):
        retr.adj.table[retr.adj.value_col].encoded.bump_version()

    eng_s, retr_s, m_s, fin_s = _one_slot(False, bump)
    eng_p, retr_p, m_p, fin_p = _one_slot(True, bump)
    assert len(fin_p) == 2
    _assert_identical(fin_s, fin_p, m_s, m_p, retr_s, retr_p)
    assert retr_p.mutation_epoch()[0] == 1
    p = eng_p.stats()["pipeline"]
    assert p["mis_speculations"] >= 1 and p["prefetch_issued"] >= 1


def test_mis_speculation_on_graph_mutation():
    """An ingest between prefetch and consumption moves the mutation
    epoch (pending rows and ingest calls): the engine restores and falls
    back synchronously, bit-identical to a sequential run with the same
    interleaving."""
    def ingest(eng, retr, reqs):
        eng.ingest([0], [1])

    eng_s, retr_s, m_s, fin_s = _one_slot(False, ingest)
    eng_p, retr_p, m_p, fin_p = _one_slot(True, ingest)
    assert len(fin_p) == 2
    _assert_identical(fin_s, fin_p, m_s, m_p, retr_s, retr_p)
    assert retr_p.mutation_epoch() == (0, 1, 1)
    assert retr_p.stats()["mutable"] == retr_s.stats()["mutable"]
    p = eng_p.stats()["pipeline"]
    assert p["mis_speculations"] >= 1


def test_mis_speculation_on_queue_change():
    """A cancelled/replaced queue entry invalidates the predicted batch:
    the engine rolls back and retrieves synchronously for the real
    batch."""
    def replace(eng, retr, reqs):
        eng.queue.clear()                # reqs[1] cancelled...
        eng.submit(reqs[2])              # ...a different request replaces it

    eng_s, retr_s, m_s, fin_s = _one_slot(False, replace)
    eng_p, retr_p, m_p, fin_p = _one_slot(True, replace)
    assert [r.request_id for r in fin_p] == [0, 2]
    _assert_identical(fin_s, fin_p, m_s, m_p, retr_s, retr_p)
    assert eng_p.stats()["pipeline"]["mis_speculations"] >= 1


def test_prefetch_skipped_without_snapshot_support():
    """A context_fn without snapshot/restore cannot be rolled back, so
    the engine must never speculate against it."""
    cfg, _, _, tm = models()
    calls = []

    def ctx(vs):
        calls.append(np.asarray(vs).copy())
        return [np.zeros(0, np.int32)] * len(vs)

    eng = TE.ServeEngine(tm, max_slots=2, max_len=MAX_LEN, eos_id=-1,
                         context_fn=ctx, pipeline=True)
    for r in requests(TE, cfg, lake(T)[1], 4, mnt=2):
        eng.submit(r)
    finished = eng.run_until_drained()
    assert len(finished) == 4
    p = eng.stats()["pipeline"]
    assert p["prefetch_issued"] == 0 and p["mis_speculations"] == 0
    assert len(calls) == 2               # one synchronous batch per admit


# --------------------- admission clamping regression ----------------------

def test_admission_clamps_prompt_and_max_new_tokens():
    """A prompt at/over max_len is clamped to max_len - 2 and
    max_new_tokens to the remaining rows; the tokens equal the
    reference engine's."""
    cfg = models()[0]
    max_len = 24
    jeng, teng = engines(max_slots=1, max_len=max_len, eos_id=-1)
    rng = np.random.default_rng(3)
    prompt = rng.integers(4, cfg.vocab_size, size=max_len + 5) \
        .astype(np.int32)
    out = []
    for pkg, eng in ((JE, jeng), (TE, teng)):
        req = pkg.Request(0, prompt.copy(), max_new_tokens=10_000)
        eng.submit(req)
        finished = eng.run_until_drained()
        assert len(finished) == 1 and finished[0].done
        assert len(req.prompt) == max_len - 2
        assert req.max_new_tokens == max_len - 1 - len(req.prompt)
        assert len(req.output) <= req.max_new_tokens
        assert len(req.prompt) + len(req.output) <= max_len
        out.append(finished)
    _assert_tokens_agree(*out)


def test_context_budget_respects_clamped_tokens():
    """Context attachment happens after clamping, so the context budget
    is computed from the clamped prompt/max_new_tokens pair and the slot
    still fits."""
    cfg, _, _, tm = models()
    max_len = 32
    _, adj, tok, _ = lake(T)
    retr = GraphRetriever(adj, tok, max_neighbors=2, tokens_per_neighbor=8,
                          engine="torch")
    eng = TE.ServeEngine(tm, max_slots=1, max_len=max_len, eos_id=-1,
                         context_fn=retr)
    v = int(np.flatnonzero(adj.degrees() > 0)[0])
    rng = np.random.default_rng(4)
    req = TE.Request(0, rng.integers(4, cfg.vocab_size, size=max_len * 2)
                     .astype(np.int32), max_new_tokens=99, context_vertex=v)
    eng.submit(req)
    finished = eng.run_until_drained()
    assert len(finished) == 1 and finished[0].done
    assert len(req.prompt) + len(req.output) <= max_len


def test_pipeline_env_default(monkeypatch):
    tm = models()[3]

    def mk(**kw):
        return TE.ServeEngine(tm, max_slots=1, max_len=16, **kw)

    monkeypatch.delenv("REPRO_PIPELINE", raising=False)
    assert mk().pipeline is True
    monkeypatch.setenv("REPRO_PIPELINE", "0")
    assert mk().pipeline is False
    assert mk(pipeline=True).pipeline is True      # explicit arg wins
    monkeypatch.setenv("REPRO_PIPELINE", "off")
    assert mk().pipeline is False
    monkeypatch.setenv("REPRO_PIPELINE", "1")
    assert mk().pipeline is True
    assert mk(pipeline=False).pipeline is False
    s = mk().stats()["pipeline"]
    for k in ("enabled", "prefetch_issued", "prefetch_hits",
              "mis_speculations", "pipeline_overlap_ms", "last_tick",
              "totals"):
        assert k in s


def test_unbatched_baseline_equals_the_reference():
    """``batched=False``: one prefill and one sample read per request, the
    same tokens as the reference's baseline."""
    cfg = models()[0]
    jeng, teng = engines(max_slots=2, max_len=MAX_LEN, eos_id=-1,
                         batched=False)
    out = []
    for pkg, eng in ((JE, jeng), (TE, teng)):
        rng = np.random.default_rng(6)
        for i in range(4):
            eng.submit(pkg.Request(i, rng.integers(4, cfg.vocab_size, 7)
                                   .astype(np.int32), max_new_tokens=3))
        out.append(eng.run_until_drained())
    _assert_tokens_agree(*out)
    assert teng.steps == jeng.steps


# ------------------------------ the template -------------------------------

def _kv(cache, jax_side):
    """Every layer's k and v of an engine cache as float32 numpy."""
    if jax_side:
        kv = cache["units"]["l0"]["kv"]
        return [np.asarray(kv[n][u], np.float32)
                for u in range(kv["k"].shape[0]) for n in ("k", "v")]
    return [layer["kv"][n].float().numpy() for layer in cache["layers"]
            for n in ("k", "v")]


def test_template_reused_by_a_shorter_group():
    """A group of two prompts of 20 tokens, then a group of two of 8: the
    reused batch-2 template is zeroed, so the engine cache and the tokens
    equal the reference engine's (which builds on a fresh zero cache)."""
    cfg = models()[0]
    jeng, teng = engines(max_slots=2, max_len=40, eos_id=-1)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 20, 8, 8)]
    out = []
    for pkg, eng in ((JE, jeng), (TE, teng)):
        for i, p in enumerate(prompts):
            eng.submit(pkg.Request(i, p.copy(), max_new_tokens=2))
        out.append(eng)
    for tick in range(4):
        jeng.step()
        teng.step()
        for a, b in zip(_kv(teng.cache, False), _kv(jeng.cache, True)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                       err_msg=f"tick {tick}")
    assert set(teng._tmp_caches) == {2}
    jeng.run_until_drained()
    teng.run_until_drained()
    _assert_tokens_agree(jeng.finished, teng.finished)


# ------------------------------ sampling -----------------------------------

#: the stub's next-token table: each token's successors and their logits
STUB_VOCAB = 16


def _stub_table(vocab):
    rng = np.random.default_rng(2)
    table = np.full((vocab, vocab), -1e9, np.float32)
    for t in range(vocab):
        nxt = rng.choice(STUB_VOCAB, 3, replace=False)
        table[t, nxt] = [2.0, 1.0, 0.0]
    return table


class _JStub:
    """The reference model with its logits replaced by ``table[token]``."""

    def __init__(self, model, table):
        self.model, self.table = model, jnp.asarray(table)
        self.init_cache = model.init_cache

    def prefill(self, params, batch, cache):
        _, cache = self.model.prefill(params, batch, cache)
        return self.table[batch["tokens"][:, -1]][:, None], cache

    def decode_step(self, params, tokens, cache):
        _, cache = self.model.decode_step(params, tokens, cache)
        return self.table[tokens[:, 0]][:, None], cache


class _TStub:
    """The port's model with the same logits stub."""

    def __init__(self, model, table):
        self.model, self.table = model, torch.from_numpy(table)
        self.device, self.init_cache = model.device, model.init_cache

    def prefill(self, batch, cache):
        _, cache = self.model.prefill(batch, cache)
        tokens = torch.as_tensor(batch["tokens"]).long()
        return self.table[tokens[:, -1]][:, None], cache

    def decode_step(self, tokens, cache):
        _, cache = self.model.decode_step(tokens, cache)
        return self.table[tokens[:, 0].long()][:, None], cache


def test_sampled_stream_under_a_shared_logits_stub():
    """Both engines under one logits stub (each token's successors: three
    tokens at logits 2, 1, 0): greedy slots give equal tokens; sampled
    slots draw only successors, at the softmax's frequencies in both
    packages (their random streams differ), and the port's stream is the
    same under the same seed and another under another."""
    cfg, jm, jp, tm = models()
    table = _stub_table(cfg.vocab_size)
    probs = np.exp([2.0, 1.0, 0.0])
    probs /= probs.sum()

    def run(pkg, eng):
        for i in range(12):
            eng.submit(pkg.Request(i, np.array([3 + i % 5], np.int32),
                                   max_new_tokens=40,
                                   temperature=0.0 if i % 3 == 0 else 1.0))
        return eng.run_until_drained()

    def port(seed):
        return run(TE, TE.ServeEngine(_TStub(tm, table), max_slots=4,
                                      max_len=64, eos_id=-1, seed=seed))

    jfin = run(JE, JE.ServeEngine(_JStub(jm, table), jp, max_slots=4,
                                  max_len=64, eos_id=-1, seed=0))
    tfin = port(0)
    greedy = [r.request_id for r in tfin if r.temperature == 0.0]
    assert greedy
    for a, b in zip(sorted(tfin, key=lambda r: r.request_id),
                    sorted(jfin, key=lambda r: r.request_id)):
        if a.temperature == 0.0:
            assert a.output == b.output
    for fin in (tfin, jfin):
        ranks = []
        for r in fin:
            seq = [int(r.prompt[-1])] + r.output
            for prev, tok in zip(seq, seq[1:]):
                row = table[prev]
                assert row[tok] > -1e8, "drew a token outside the stub"
                if r.temperature > 0:
                    ranks.append(int((row > row[tok]).sum()))
        freq = np.bincount(ranks, minlength=3) / len(ranks)
        assert len(ranks) == 8 * 40
        np.testing.assert_allclose(freq, probs, atol=0.08)
    assert [r.output for r in port(0)] == [r.output for r in tfin]
    assert [r.output for r in port(1)] != [r.output for r in tfin]


# ------------------------------ chaos ---------------------------------------

def _chaos_retriever(engine):
    _, adj, tok, _ = lake(T)
    return GraphRetriever(adj, tok, max_neighbors=2, tokens_per_neighbor=8,
                          meter=T.IOMeter(), engine=engine,
                          page_cache_pages=64)


def _chaos_requests(adj, n):
    return requests(TE, models()[0], adj, n, seed=11,
                    tenants=("prod", "batch"))


def _chaos_ingest(adj, reqs):
    """An edge batch rooted at the two highest vertices no request names
    as its context: the mutation epoch moves (prefetches roll back) but no
    request's context changes, so the no-ingest oracle stays valid."""
    ctx = {r.context_vertex for r in reqs}
    free = [v for v in range(adj.num_key_vertices - 1, -1, -1)
            if v not in ctx]
    return free[:2], [0, 1]


@pytest.fixture(scope="module")
def oracles():
    """Unthrottled, sequential, fault-free ground truth per request id,
    for each engine, held against the reference's oracle."""
    cfg = models()[0]
    out = {}
    for jeng, teng in ENGINE_PAIRS:
        jr, tr = _retrievers(jeng, teng)
        fins = []
        for pkg, eng, r in zip((JE, TE), engines(
                jkw=dict(context_fn=jr), tkw=dict(context_fn=tr),
                max_slots=3, max_len=MAX_LEN, eos_id=-1, pipeline=False),
                (jr, tr)):
            for req in requests(pkg, cfg, r.adj, 10, seed=11):
                assert eng.submit(req).admitted
            fins.append(eng.run_until_drained())
        _assert_tokens_agree(*fins)
        out[teng] = {r.request_id: r for r in fins[1]}
    return out


def _check_against_oracle(fin, oracle):
    for r in fin:
        if r.status is not RequestStatus.OK:
            continue
        o = oracle[r.request_id]
        np.testing.assert_array_equal(r.prompt, o.prompt)
        assert r.output == o.output, f"request {r.request_id} diverged"
        assert r.context_tokens == o.context_tokens


@pytest.mark.parametrize("boundary", SERVE_BOUNDARIES)
@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_chaos_boundary_bit_identical_or_typed(oracles, engine, boundary):
    tm = models()[3]
    k = SERVE_BOUNDARIES.index(boundary)
    trips = 1 + (SEED + k) % 2
    plan = FaultPlan({boundary: trips})
    retr = _chaos_retriever(engine)
    eng = TE.ServeEngine(tm, max_slots=3, max_len=MAX_LEN, eos_id=-1,
                         context_fn=retr, pipeline=True,
                         tenants=[TenantConfig("prod", weight=3,
                                               max_queue=64),
                                  TenantConfig("batch", weight=1,
                                               max_queue=64)],
                         faults=plan)
    reqs = _chaos_requests(retr.adj, 10)
    for r in reqs:
        assert eng.submit(r).admitted
    eng.step()
    eng.step()
    eng.ingest(*_chaos_ingest(retr.adj, reqs))    # mid-drain mutation
    eng.run_until_drained()
    fin = eng.finished                            # with the manual ticks
    assert retr.ingest_calls == 1

    # none lost, none double-answered
    ids = sorted(r.request_id for r in fin)
    assert ids == [r.request_id for r in reqs]
    assert all(r.status is RequestStatus.OK for r in fin)
    _check_against_oracle(fin, oracles[engine])

    # the armed boundary fired and every injection recovered
    assert eng.fault_hits.get(boundary, 0) >= 1, \
        f"{boundary} never injected -- placebo chaos"
    s = eng.stats()["faults"]
    assert s["plan"]["fired"][boundary] == trips
    assert s["plan"]["remaining"] == 0
    assert s["recovered"] == sum(s["injected"].values())

    # the engine keeps ticking after the chaos drain
    more = _chaos_requests(retr.adj, 2)
    for r in more:
        r.request_id += 100
        assert eng.submit(r).admitted
    fin2 = eng.run_until_drained()
    assert sorted(r.request_id for r in fin2) == [100, 101]
    assert all(r.status is RequestStatus.OK for r in fin2)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_chaos_all_boundaries_with_deadlines(oracles, engine):
    """The four serve boundaries armed together from a seeded plan, an
    ingest mid-drain, rate limits and deadlines live: every submitted
    request ends in exactly one typed bucket (OK / DEADLINE_EXCEEDED /
    REJECTED), the OK ones bit-identical to the oracle; the plan equals
    the reference's."""
    tm = models()[3]
    plan = FaultPlan.from_seed(SEED, boundaries=SERVE_BOUNDARIES,
                               max_trips=2)
    assert plan.trips == JFaultPlan.from_seed(
        SEED, boundaries=SERVE_BOUNDARIES, max_trips=2).trips
    if not plan.trips:
        plan = FaultPlan({SERVE_BOUNDARIES[0]: 1})
    retr = _chaos_retriever(engine)
    tenants = [TenantConfig("prod", weight=3, max_queue=64),
               TenantConfig("batch", weight=1, rate=2.0, burst=6.0,
                            max_queue=4, deadline_ticks=30)]
    eng = TE.ServeEngine(tm, max_slots=3, max_len=MAX_LEN, eos_id=-1,
                         context_fn=retr, pipeline=True, tenants=tenants,
                         faults=plan)
    reqs = _chaos_requests(retr.adj, 10)
    admitted, rejected = [], []
    for r in reqs:
        (admitted if eng.submit(r).admitted else rejected).append(r)
    eng.step()
    eng.ingest(*_chaos_ingest(retr.adj, reqs))
    eng.run_until_drained()
    fin = eng.finished                            # with the manual tick

    fin_ids = [r.request_id for r in fin]
    rej_ids = [r.request_id for r in eng.rejected]
    assert sorted(fin_ids + rej_ids) == [r.request_id for r in reqs]
    assert rej_ids == [r.request_id for r in rejected]
    for r in fin:
        assert r.status in (RequestStatus.OK,
                            RequestStatus.DEADLINE_EXCEEDED)
    for r in eng.rejected:
        assert r.status is RequestStatus.REJECTED
    _check_against_oracle(fin, oracles[engine])

    assert sum(eng.fault_hits.values()) >= 1
    s = eng.stats()["faults"]
    assert s["recovered"] == sum(s["injected"].values())
    ts = eng.stats()["tenants"]
    assert sum(t["finished_ok"] + t["finished_failed"]
               for t in ts.values()) == len(fin)
    assert sum(t["rejected_rate"] + t["rejected_queue_full"]
               for t in ts.values()) == len(rejected)


def test_chaos_ingest_fault_preserves_batch_atomicity():
    """A ``serve.ingest`` injection happens *before* the delta-plane
    append: after the retries the batch lands exactly once -- the epoch
    moved once, no duplicate rows -- in both packages alike."""
    out = []
    jr, tr = _retrievers("numpy", "numpy")
    for pkg, plan, retr in ((JE, JFaultPlan, jr), (TE, FaultPlan, tr)):
        kw = dict(max_slots=2, max_len=MAX_LEN, eos_id=-1, context_fn=retr,
                  faults=plan({"serve.ingest": 2}))
        eng = (JE.ServeEngine(models()[1], models()[2], **kw)
               if pkg is JE else TE.ServeEngine(models()[3], **kw))
        n = retr.adj.num_key_vertices
        delta = eng.ingest([n - 1, n - 2], [0, 1])
        assert eng.fault_hits.get("serve.ingest", 0) == 2
        assert retr.ingest_calls == 1            # once, not once a retry
        assert delta.pending_rows() == 2
        out.append((eng.fault_hits, eng.fault_backoff_s, delta.stats(),
                    retr.mutation_epoch()))
    assert out[0] == out[1]


# ------------------------- the sync-free cache write -------------------------

def test_vector_cache_write_drops_positions_past_the_end():
    """Slots whose index lies at, or past, the cache's end: the write
    drops what falls outside (``.at[].set(mode="drop")`` in the
    reference), and logits and caches equal the reference's."""
    _, jm, jp, tm = models()
    t = 12
    rng = np.random.default_rng(5)
    jcache = jm.init_cache(4, t, dtype=jnp.float32, vector_index=True)
    tcache = tm.init_cache(4, t, dtype=torch.float32, vector_index=True)
    # filled caches, so a dropped write that landed would show
    fill = [rng.standard_normal(np.asarray(x).shape).astype(np.float32)
            for x in (jcache["units"]["l0"]["kv"]["k"],
                      jcache["units"]["l0"]["kv"]["v"])]
    jcache["units"]["l0"]["kv"]["k"] = jnp.asarray(fill[0])
    jcache["units"]["l0"]["kv"]["v"] = jnp.asarray(fill[1])
    for i, layer in enumerate(tcache["layers"]):
        layer["kv"]["k"].copy_(torch.from_numpy(fill[0][i]))
        layer["kv"]["v"].copy_(torch.from_numpy(fill[1][i]))
    idx = np.array([t - 1, t, t + 5, 3], np.int32)
    jcache["index"] = jnp.asarray(idx)
    jcache["units"]["l0"]["kv"]["index"] = jnp.asarray(
        np.broadcast_to(idx, (2, 4)))
    tcache["index"] = torch.from_numpy(idx.copy())
    for layer in tcache["layers"]:
        layer["kv"]["index"] = torch.from_numpy(idx.copy())
    for step in range(2):
        tok = rng.integers(0, 512, (4, 1)).astype(np.int32)
        jlog, jcache = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jcache)
        tlog, tcache = tm.decode_step(torch.from_numpy(tok), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=2e-4, atol=2e-4)
        for a, b in zip(_kv(tcache, False), _kv(jcache, True)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    assert tcache["index"].tolist() == (idx + 2).tolist()
    # the rows of slots 1 and 2 (every position dropped) are untouched
    for a, f in zip(_kv(tcache, False), [fill[0][0], fill[1][0],
                                         fill[0][1], fill[1][1]]):
        np.testing.assert_array_equal(a[1:3], f[1:3])
