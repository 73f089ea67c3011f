"""The slice as a whole: batched, label-filtered neighbor retrieval.

``retrieve_neighbors_batch``, ``neighbor_ids_batch`` and
``decode_edge_ranges`` run on the JAX package (engines ``numpy`` and
``jax``) and on the port (engines ``numpy`` and ``torch``) over one
seeded graph: batches below and above ``FUSED_MIN_RANGES``, unfiltered
and filtered (one predicate narrow enough that page pruning drops
pages), with no page cache and with a cold then warm LRU.  PAC words,
ids, IOMeter and LRU counters must be identical (exact equality).
"""
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro_torch.kernels import _pad
from repro_torch.kernels.pac_decode import ops as O

torch.set_num_threads(1)

N = 4000
PAGE = 256
TPS = 512
NAMES = ["A", "B", "C", "Low"]
ENGINES = [(RC, "numpy"), (RC, "jax"), (TC, "numpy"), (TC, "torch")]


def _cond(mod, name):
    if name == "mix":
        return (mod.L("A") & mod.L("B")) | ~mod.L("C")
    if name == "low":               # qualifying hull [0, N/4): prunes pages
        return mod.L("Low") & ~mod.L("A")
    return None


@pytest.fixture(scope="module")
def graphs():
    from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
    src, dst = powerlaw_graph(N, 6, locality=1.0, seed=31)
    labels = clustered_labels(N, NAMES[:3], density=0.4, run_scale=64,
                              seed=2)
    labels["Low"] = np.arange(N) < N // 4
    out = {}
    for mod in (RC, TC):
        adj = mod.build_adjacency(src, dst, N, N, mod.BY_SRC,
                                  mod.ENC_GRAPHAR, page_size=PAGE)
        vt = mod.VertexTable.build(
            mod.VertexTypeSchema("v", [], labels=NAMES), {}, labels,
            num_vertices=N)
        out[mod] = (adj, vt)
    return out


def _pac(pac):
    return [(p, pac.bitmaps[p].tolist()) for p in sorted(pac.bitmaps)]


def _lru(cache):
    return None if cache is None else (cache.hits, cache.misses,
                                       cache.evictions, len(cache))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("cond", [None, "mix", "low"])
@pytest.mark.parametrize("batch", [8, 40])
def test_retrieval_identical_across_packages(graphs, batch, cond, cached):
    vs = np.random.default_rng(batch).integers(0, N, batch)
    results = []
    pruned = 0
    for mod, engine in ENGINES:
        adj, vt = graphs[mod]
        enc = adj.table["<dst>"].encoded
        cache = mod.DecodedPageCache(64) if cached else None
        filt = mod.LabelFilter(vt, _cond(mod, cond)) if cond else None
        before = enc.prune_stats.pages_pruned
        runs = []
        for _ in range(2 if cached else 1):       # cold, then warm
            enc.page_cache = cache
            meter = mod.IOMeter()
            pac = mod.retrieve_neighbors_batch(adj, vs, TPS, meter,
                                               engine=engine, filter=filt)
            runs.append((_pac(pac), meter.nbytes, meter.nrequests,
                         _lru(cache)))
        enc.page_cache = None
        pruned = enc.prune_stats.pages_pruned - before
        results.append(runs)
    for mod_engine, r in zip(ENGINES[1:], results[1:]):
        assert r == results[0], mod_engine
    if cond == "low":
        assert pruned > 0                # the statistics pushdown fired
    if cached:
        assert results[0][1][3][0] > 0   # the warm run hit the LRU


@pytest.mark.parametrize("batch", [8, 40])
def test_ids_identical_across_packages(graphs, batch):
    vs = np.random.default_rng(batch + 1).integers(0, N, batch)
    qual = (0, N // 4)
    out = []
    for mod, engine in ENGINES:
        adj, _ = graphs[mod]
        meter = mod.IOMeter()
        ids = mod.neighbor_ids_batch(adj, vs, meter, engine=engine)
        seq = mod.neighbor_ids_batch(adj, vs, meter, engine=engine,
                                     unique=False)
        pruned = mod.neighbor_ids_batch(adj, vs, meter, engine=engine,
                                        qual=qual)
        los, his = adj.edge_ranges_batch(vs)
        rows = mod.decode_edge_ranges(adj, los, his, meter, engine=engine)
        out.append((ids.tolist(), seq.tolist(), pruned.tolist(),
                    rows.tolist(), meter.nbytes, meter.nrequests))
    for r in out[1:]:
        assert r == out[0]


def test_single_vertex_retrieval(graphs):
    for v in (0, 17, 1234, N - 1):
        want = None
        for mod, engine in ENGINES:
            adj, _ = graphs[mod]
            meter = mod.IOMeter()
            got = (_pac(mod.retrieve_neighbors(adj, v, TPS, meter,
                                               engine=engine)),
                   meter.nbytes, meter.nrequests)
            want = got if want is None else want
            assert got == want, (v, engine)


def test_steady_state_keeps_shape_classes_flat(graphs):
    adj, vt = graphs[TC]
    filt = TC.LabelFilter(vt, _cond(TC, "mix"))
    rng = np.random.default_rng(23)
    batches = [rng.integers(0, N, s) for s in rng.integers(40, 64, 100)]
    _pad.reset_shape_classes()
    for vs in batches:                    # warm every size class
        TC.retrieve_neighbors_batch(adj, vs, TPS, engine="torch",
                                    filter=filt)
    before = _pad.shape_class_count()
    for vs in batches:
        TC.retrieve_neighbors_batch(adj, vs, TPS, engine="torch",
                                    filter=filt)
    assert _pad.shape_class_count() == before
    assert _pad.shape_class_counts()[
        "fused_gather_decode_filter_bitmap_batch"] <= 4


def test_unported_routes_raise(graphs, monkeypatch):
    adj, vt = graphs[TC]
    vs = np.arange(20)
    monkeypatch.setenv("REPRO_PARTITIONS", "4")
    with pytest.raises(NotImplementedError, match="partition"):
        TC.retrieve_neighbors_batch(adj, vs, TPS, engine="torch")
    monkeypatch.delenv("REPRO_PARTITIONS")
    monkeypatch.setattr(adj, "delta", object())
    with pytest.raises(NotImplementedError, match="mutable"):
        TC.retrieve_neighbors_batch(adj, vs, TPS, engine="torch")


def test_words_pool_double_buffers(graphs):
    adj, _ = graphs[TC]
    O.reset_dispatch_pools()
    seen = []
    for seed in range(4):
        vs = np.random.default_rng(seed).integers(0, N, 32)
        TC.retrieve_neighbors_batch(adj, vs, TPS, engine="torch")
        ring = O._WORDS_POOL[("cpu", -(-N // 32))]
        seen.append([b.data_ptr() for b in ring])
    assert len(seen[-1]) == 2
    assert seen[2][-1] == seen[0][-1]     # reused two dispatches later
    assert seen[3][-1] != seen[2][-1]
