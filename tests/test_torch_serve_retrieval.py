"""The port's ``GraphRetriever`` (``repro_torch/serve/retrieval.py``).

First the JAX package's ``test_serve_retrieval.py`` on the port (its
engine tests on the port's ``ServeEngine``), then the port's ``numpy``
and ``torch`` engines against the reference's ``numpy`` and ``jax`` on
lakes both packages build from one seed: ``hops`` 1 and 2, with and
without the label filter, with no cache and with an LRU cold then warm.
Contexts, IOMeter bytes and requests, LRU counters and ``stats()`` must be
equal (``stats()``'s device mirror names the device where the reference
names the engine).  Then a ``snapshot``/``restore`` round trip, and the
plane that is not ported: ``partitions > 1`` raises (``ingest`` is held
against the reference in ``test_torch_mutable_plane.py``).
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_serve import (ENGINE_PAIRS, lake, models, retrieval_stats)
from repro.serve.retrieval import GraphRetriever as JGraphRetriever
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.retrieval import GraphRetriever


@pytest.fixture(scope="module")
def engine_parts():
    cfg, _, _, tm = models()
    return cfg, tm


@pytest.fixture(scope="module")
def doc_graph():
    g, _, _, lk = lake(T, num_docs=400)
    return g, lk


@pytest.fixture(scope="module")
def doc_lake(doc_graph):
    g, _ = doc_graph
    return g.adjacency("doc-links-doc", T.BY_SRC), \
        g.vertex("doc").table["tokens"]


# ------------------------- test_serve_retrieval.py --------------------------

def test_run_until_drained_returns_finished(engine_parts):
    cfg, model = engine_parts
    eng = ServeEngine(model, max_slots=2, max_len=96, eos_id=-1)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(4, cfg.vocab_size, size=6 + i)
                    .astype(np.int32), max_new_tokens=4)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    finished = eng.run_until_drained()
    assert len(finished) == len(reqs)
    assert {r.request_id for r in finished} == {r.request_id for r in reqs}
    assert all(r.done and len(r.output) >= 1 for r in finished)
    assert not eng.queue and all(s is None for s in eng.slots)
    # a second drain returns only newly retired requests
    assert eng.run_until_drained() == []


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_graph_retriever_batches_per_call(doc_lake, engine):
    adj, tokens_col = doc_lake
    r = GraphRetriever(adj, tokens_col, max_neighbors=2,
                       tokens_per_neighbor=8, engine=engine)
    vs = np.array([0, 3, 3, 7])
    ctx = r(vs)
    assert r.calls == 1 and r.vertices_seen == 4
    assert len(ctx) == len(vs)
    for v, c in zip(vs, ctx):
        nbrs = adj.neighbor_ids(int(v))[:2]
        want = (np.concatenate([tokens_col.get(int(n))[:8] for n in nbrs])
                if len(nbrs) else np.zeros(0, np.int32))
        np.testing.assert_array_equal(c, want.astype(np.int32))


def test_engine_attaches_context_one_retrieval_per_tick(engine_parts,
                                                        doc_lake):
    cfg, model = engine_parts
    adj, tokens_col = doc_lake
    retr = GraphRetriever(adj, tokens_col, max_neighbors=1,
                          tokens_per_neighbor=4, engine="torch")
    eng = ServeEngine(model, max_slots=4, max_len=96, eos_id=-1,
                      context_fn=retr)
    # pick seeds that definitely have neighbors
    deg = adj.degrees()
    seeds = np.flatnonzero(deg > 0)[:4]
    for i, v in enumerate(seeds):
        eng.submit(Request(i, np.arange(4, 10, dtype=np.int32),
                           max_new_tokens=3, context_vertex=int(v)))
    finished = eng.run_until_drained()
    assert len(finished) == len(seeds)
    # all 4 admitted in tick 1 -> exactly one batched retrieval
    assert retr.calls == 1
    assert retr.vertices_seen == len(seeds)
    assert all(r.context_tokens > 0 for r in finished)
    # engine surfaces the retrieval plane's counters
    stats = eng.stats()
    assert stats["finished"] == len(seeds)
    assert stats["retrieval"]["calls"] == 1
    assert "page_cache" in stats["retrieval"]


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_retriever_warm_ticks_charge_less(doc_lake, engine):
    adj, tokens_col = doc_lake
    m = T.IOMeter()
    r = GraphRetriever(adj, tokens_col, max_neighbors=2,
                       tokens_per_neighbor=8, meter=m, page_cache_pages=64,
                       engine=engine)
    r.page_cache.clear()
    r.page_cache.reset_stats()
    vs = np.flatnonzero(adj.degrees() > 0)[:8]
    c1 = r(vs)
    cold = m.nbytes
    c2 = r(vs)
    warm = m.nbytes - cold
    assert warm < cold                     # decode served from the LRU
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a, b)
    s = r.stats()
    assert s["calls"] == 2
    assert s["page_cache"]["hits"] > 0


def test_retriever_cache_opt_out_detaches(doc_lake):
    adj, tokens_col = doc_lake
    GraphRetriever(adj, tokens_col, page_cache_pages=16)   # leaves a cache
    r = GraphRetriever(adj, tokens_col, page_cache_pages=None)
    # opt-out must actually detach: decode paths consult the column cache
    assert adj.table[adj.value_col].encoded.page_cache is None
    assert r.page_cache is None
    assert "page_cache" not in r.stats()


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_retriever_label_scoped_context(doc_graph, doc_lake, engine):
    g, lk = doc_graph
    adj, tokens_col = doc_lake
    vt = g.vertex("doc")
    r = GraphRetriever(adj, tokens_col, max_neighbors=3,
                       tokens_per_neighbor=8, page_cache_pages=None,
                       filter_vt=vt, filter_cond=T.L("HighQuality"),
                       engine=engine)
    vs = np.flatnonzero(adj.degrees() > 0)[:16]
    ctx = r(vs)
    assert len(ctx) == len(vs)
    hq = lk.labels["HighQuality"]
    for v, c in zip(vs, ctx):
        nbrs = adj.neighbor_ids(int(v))[:3]
        keep = [int(n) for n in nbrs if hq[int(n)]]
        want = (np.concatenate([tokens_col.get(n)[:8] for n in keep])
                if keep else np.zeros(0, np.int32))
        np.testing.assert_array_equal(c, want.astype(np.int32))
    s = r.stats()
    assert s["filter"]["considered"] >= s["filter"]["kept"] > 0
    # the bitmap is cached across ticks: label metadata charged once
    m = T.IOMeter()
    r2 = GraphRetriever(adj, tokens_col, max_neighbors=3, meter=m,
                        page_cache_pages=None, filter_vt=vt,
                        filter_cond=T.L("HighQuality"), engine=engine)
    r2(vs)
    first = m.nbytes
    r2(vs)
    assert m.nbytes - first < first    # no second label-metadata charge


def test_retriever_filter_requires_vt(doc_lake):
    adj, tokens_col = doc_lake
    with pytest.raises(ValueError):
        GraphRetriever(adj, tokens_col, filter_cond=T.L("HighQuality"))


def test_retriever_stats_track_live_cache(doc_lake):
    adj, tokens_col = doc_lake
    r = GraphRetriever(adj, tokens_col, page_cache_pages=64)
    # a later re-attach with another capacity replaces the column's cache;
    # stats() must follow the cache the decode paths actually consult
    fresh = T.attach_page_cache(adj.table[adj.value_col], 32)
    assert r.page_cache is fresh
    assert r.stats()["page_cache"]["capacity"] == 32
    adj.table[adj.value_col].encoded.page_cache = None


# --------------------------- against the reference --------------------------

def _pair(jeng, teng, hops, filtered, cache):
    """The reference's and the port's retriever over fresh lakes."""
    out = []
    for core, cls, eng in ((J, JGraphRetriever, jeng),
                           (T, GraphRetriever, teng)):
        g, adj, tok, _ = lake(core, num_docs=300, seed=9)
        kw = {}
        if filtered:
            kw = dict(filter_vt=g.vertex("doc"),
                      filter_cond=core.L("HighQuality") & ~core.L("Spam"))
        out.append(cls(adj, tok, max_neighbors=3, tokens_per_neighbor=8,
                       meter=core.IOMeter(), engine=eng,
                       page_cache_pages=cache, hops=hops, **kw))
    return out


def _batches(adj, n_ticks=3, width=9):
    rng = np.random.default_rng(2)
    n = len(adj.degrees())
    # repeated and zero-degree seeds included
    return [rng.integers(0, n, width) for _ in range(n_ticks)] + \
        [np.array([0, 0, 5]), np.zeros(0, np.int64)]


def _assert_same(jr, tr):
    assert (jr.meter.nbytes, jr.meter.nrequests) == \
        (tr.meter.nbytes, tr.meter.nrequests)
    assert retrieval_stats(tr.stats()) == retrieval_stats(jr.stats())
    if jr.page_cache is not None:
        assert tr.page_cache.stats() == jr.page_cache.stats()


@pytest.mark.parametrize("cache", [None, 16])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("hops", [1, 2])
@pytest.mark.parametrize("jeng,teng", ENGINE_PAIRS)
def test_retriever_equals_the_reference(jeng, teng, hops, filtered, cache):
    jr, tr = _pair(jeng, teng, hops, filtered, cache)
    # no cache: one pass; an LRU: the same batches cold, then warm
    for _ in range(1 if cache is None else 2):
        for vs in _batches(jr.adj):
            want, got = jr(vs), tr(vs)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == np.int32
                np.testing.assert_array_equal(a, b)
            _assert_same(jr, tr)
    if cache is not None:
        assert tr.page_cache.hits > 0 and tr.page_cache.evictions > 0


@pytest.mark.parametrize("jeng,teng", ENGINE_PAIRS)
def test_snapshot_restore_round_trip(jeng, teng):
    """A speculative call rewound by ``restore`` leaves the meter, the LRU
    (contents and recency order) and the counters where they were: the
    next calls equal the reference's, which never speculated."""
    jr, tr = _pair(jeng, teng, 2, True, 8)
    batches = _batches(jr.adj)
    for vs in batches[:2]:
        jr(vs)
        tr(vs)
    snap = tr.snapshot()
    before = (tr.meter.nbytes, tr.meter.nrequests, tr.calls,
              list(tr.page_cache._pages), tr.page_cache.stats())
    tr(batches[2][::-1])                     # speculate, then rewind
    tr(np.arange(40))
    tr.restore(snap)
    assert (tr.meter.nbytes, tr.meter.nrequests, tr.calls,
            list(tr.page_cache._pages), tr.page_cache.stats()) == before
    tr.restore(snap)                         # one snapshot rewinds twice
    for vs in batches[2:]:
        for a, b in zip(tr(vs), jr(vs)):
            np.testing.assert_array_equal(a, b)
        assert (jr.meter.nbytes, jr.meter.nrequests) == \
            (tr.meter.nbytes, tr.meter.nrequests)
        assert tr.page_cache.stats() == jr.page_cache.stats()
        assert list(tr.page_cache._pages) == list(jr.page_cache._pages)
        # what a snapshot covers; the column's pruning and traversal
        # counters are not part of it, in either package
        ts, js = tr.stats(), jr.stats()
        for key in ("calls", "vertices_seen", "filter"):
            assert ts[key] == js[key]


def test_set_knob_and_stats_equal_the_reference():
    jr, tr = _pair("numpy", "numpy", 2, False, None)
    for r in (jr, tr):
        assert r.set_knob("max_neighbors", 1) == 3
        assert r.set_knob("hops", 1) == 2
    assert tr.stats()["knobs"] == jr.stats()["knobs"] == \
        {"hops": 1, "max_neighbors": 1, "changes": 2}
    for vs in _batches(jr.adj):
        for a, b in zip(tr(vs), jr(vs)):
            np.testing.assert_array_equal(a, b)
    _assert_same(jr, tr)


# ------------------------------ not ported ----------------------------------

def test_ingest_and_partitions_raise(doc_lake):
    """One partition keeps the monolithic column and no section; at
    ``partitions=2`` (once the partition plane's raise) the retriever's
    contexts, IOMeter, LRU and ``stats()`` -- its ``partitions`` section
    and the pruning's ``partitions_stats_pruned`` included -- equal the
    reference's."""
    adj, tokens_col = doc_lake
    r = GraphRetriever(adj, tokens_col, engine="numpy", partitions=1)
    assert "partitions" not in r.stats() and "mutable" not in r.stats()
    rs = {}
    for mod, cls, eng in ((J, JGraphRetriever, "jax"),
                          (T, GraphRetriever, "torch")):
        g, adj2, tok, lk = lake(mod)
        rs[mod] = cls(adj2, tok, meter=mod.IOMeter(), engine=eng,
                      partitions=2, page_cache_pages=16, hops=2,
                      filter_vt=g.vertex("doc"),
                      filter_cond=mod.L(sorted(lk.labels)[0]))
    for vs in _batches(rs[J].adj):
        for a, b in zip(rs[T](vs), rs[J](vs)):
            np.testing.assert_array_equal(a, b)
    _assert_same(rs[J], rs[T])
    assert rs[T].stats()["partitions"]["n_parts"] == 2
    assert "partitions_stats_pruned" in rs[T].stats()["pruning"]


def test_mutation_epoch_follows_the_column_version():
    _, adj, tok, _ = lake(T, num_docs=100)
    r = GraphRetriever(adj, tok, engine="numpy")
    enc = adj.table[adj.value_col].encoded
    assert r.mutation_epoch() == (enc.version, 0, 0)
    enc.bump_version()
    assert r.mutation_epoch() == (enc.version, 0, 0)
    assert enc.version == 1


def test_default_engine_is_cuda(doc_lake, monkeypatch):
    adj, tokens_col = doc_lake
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = GraphRetriever(adj, tokens_col, page_cache_pages=None)
    assert r.engine == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        r(np.flatnonzero(adj.degrees() > 0)[:4])
