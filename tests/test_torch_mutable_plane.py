"""The port's mutable plane (``repro_torch/core/delta_segment.py``) against
the JAX package's, on the same seeded graphs and ingests.

The JAX package's ``test_mutable_plane.py`` on the port: every read with
delta rows pending (batched neighbors unique and per-vertex merged, PAC
retrieval, filtered retrieval, ``k_hop`` and its fused entry's counted
fallback) equals a from-scratch rebuild over base + deltas and the
reference's own result on its ``numpy``/``jax`` engines, with IOMeter
bytes and requests, ``DeltaSegments.stats()`` and ``traversal_stats``
equal; ingest atomicity under the ``ingest.append`` fault, bounds checks,
zone-map pruning, the poisoned device mirror's route to the host oracle
and its heal, and ``GraphRetriever.ingest``/``ServeEngine.ingest``.  Then
the reads that see the packed base only while rows are pending --
``two_hop_pac``, ``frontier_edge_counts`` and BI-2 -- pinned against the
reference's, which read the base only too.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import delta_segment as JD
from repro.core import query as JQ
from repro.data.synthetic import ldbc_like as j_ldbc_like
from repro.ft.faults import FaultPlan as JFaultPlan
from repro.kernels.traversal import ops as JTO
from repro_torch.core import delta_segment as TD
from repro_torch.core import query as TQ
from repro_torch.data.synthetic import clustered_labels, ldbc_like
from repro_torch.ft.faults import FaultPlan, InjectedFault
from repro_torch.kernels.traversal import ops as TTO

torch.set_num_threads(1)

N = 600
NVAL = 500
PAGE = 128
TPS = 512
#: the reference's engine beside the port's on the same inputs
PAIRS = [("numpy", "numpy"), ("jax", "torch")]
DELTA = {J: JD, T: TD}


def _graph(mod, seed=3, n_edges=4000, nval=NVAL):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, n_edges)
    dst = rng.integers(0, nval, n_edges)
    return mod.build_adjacency(src, dst, N, nval, mod.BY_SRC,
                               mod.ENC_GRAPHAR, page_size=PAGE)


def _ingest_some(mod, adj, seed=11, rows=150, nval=NVAL):
    rng = np.random.default_rng(seed)
    DELTA[mod].ingest_edges(adj, rng.integers(0, N, rows),
                            rng.integers(0, nval, rows))


def _rebuilt(mod, adj, nval=NVAL):
    """From-scratch oracle over base + pending deltas."""
    return mod.build_adjacency(*DELTA[mod].all_edges(adj), N, nval,
                               mod.BY_SRC, mod.ENC_GRAPHAR, page_size=PAGE)


def _pending(mod, seed=3, nval=NVAL):
    adj = _graph(mod, seed, nval=nval)
    _ingest_some(mod, adj, nval=nval)
    return adj


def _words(pac):
    return [(p, pac.bitmaps[p].tolist()) for p in sorted(pac.bitmaps)]


def _label_vt(mod):
    labels = clustered_labels(NVAL, ["A", "B"], density=0.3, run_scale=32,
                              seed=9)
    return mod.VertexTable.build(
        mod.VertexTypeSchema("v", [mod.PropertySchema("x", "int64")],
                             labels=["A", "B"], page_size=PAGE),
        {"x": np.arange(NVAL)}, labels, num_vertices=NVAL)


@pytest.fixture()
def batch():
    rng = np.random.default_rng(5)
    vs = rng.integers(0, N, 48)
    return np.concatenate([vs, vs[:7]])         # duplicates included


# ------------------------- union == rebuild ------------------------------

@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_neighbor_union_matches_rebuild(batch, jeng, teng):
    for unique in (True, False):
        out = []
        for mod, engine in ((J, jeng), (T, teng)):
            adj = _pending(mod)
            meter = mod.IOMeter()
            got = mod.neighbor_ids_batch(adj, batch, meter, engine=engine,
                                         unique=unique)
            want = mod.neighbor_ids_batch(_rebuilt(mod, adj), batch,
                                          engine="numpy", unique=unique)
            np.testing.assert_array_equal(got, want)
            out.append((got.tolist(), meter.nbytes, meter.nrequests,
                        adj.delta.stats()))
        assert out[0] == out[1]


@pytest.mark.parametrize("jeng,teng,fused", [
    ("numpy", "numpy", None), ("jax", "torch", None),
    ("jax", "torch", False), ("jax", "torch", True)])
def test_pac_retrieval_union_matches_rebuild(batch, jeng, teng, fused):
    out = []
    for mod, engine in ((J, jeng), (T, teng)):
        adj = _pending(mod)
        meter = mod.IOMeter()
        got = mod.retrieve_neighbors_batch(adj, batch, TPS, meter,
                                           engine=engine, fused=fused)
        want = mod.retrieve_neighbors_batch(_rebuilt(mod, adj), batch, TPS,
                                            engine="numpy")
        np.testing.assert_array_equal(got.to_ids(), want.to_ids())
        out.append((_words(got), meter.nbytes, meter.nrequests,
                    adj.delta.stats()))
    assert out[0] == out[1]


@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_filtered_retrieval_union_matches_rebuild(batch, jeng, teng):
    out = []
    for mod, engine in ((J, jeng), (T, teng)):
        adj = _pending(mod)
        vt = _label_vt(mod)
        cond = mod.L("A") & ~mod.L("B")
        meter = mod.IOMeter()
        got = mod.retrieve_neighbors_batch(
            adj, batch, TPS, meter, engine=engine,
            filter=mod.LabelFilter(vt, cond))
        want = mod.retrieve_neighbors_batch(
            _rebuilt(mod, adj), batch, TPS, engine="numpy",
            filter=mod.LabelFilter(vt, cond))
        np.testing.assert_array_equal(got.to_ids(), want.to_ids())
        out.append((_words(got), meter.nbytes, meter.nrequests,
                    adj.delta.stats()))
    assert out[0] == out[1]


def _square(mod, seed=21):
    rng = np.random.default_rng(seed)
    adj = mod.build_adjacency(rng.integers(0, N, 4000),
                              rng.integers(0, N, 4000), N, N, mod.BY_SRC,
                              mod.ENC_GRAPHAR, page_size=PAGE)
    DELTA[mod].ingest_edges(adj, rng.integers(0, N, 120),
                            rng.integers(0, N, 120))
    return adj, rng.integers(0, N, 9)


@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_k_hop_union_matches_rebuild(jeng, teng):
    out = []
    for mod, engine, tops in ((J, jeng, JTO), (T, teng, TTO)):
        # value ids must be valid seeds for hop 2: a square graph
        adj, seeds = _square(mod)
        oracle = mod.build_adjacency(*DELTA[mod].all_edges(adj), N, N,
                                     mod.BY_SRC, mod.ENC_GRAPHAR,
                                     page_size=PAGE)
        runs = []
        for k in (1, 2, 3):
            meter = mod.IOMeter()
            got = mod.k_hop(adj, seeds, k, meter, engine=engine)
            np.testing.assert_array_equal(
                got, mod.k_hop(oracle, seeds, k, engine="numpy"))
            runs.append((got.tolist(), meter.nbytes, meter.nrequests))
        out.append((runs, tops.traversal_stats(adj), adj.delta.stats()))
    assert out[0] == out[1]
    if teng == "torch":                        # the counted fallback
        assert out[1][1]["fallbacks"] == 3


def test_fused_traversal_degrades_on_pending_deltas():
    """A direct fused-traversal call under pending deltas degrades to the
    bit-identical host-loop oracle and counts the fallback, as the
    reference's does."""
    out = []
    for mod, engine, tops in ((J, "jax", JTO), (T, "torch", TTO)):
        rng = np.random.default_rng(2)
        adj = mod.build_adjacency(rng.integers(0, N, 2000),
                                  rng.integers(0, N, 2000), N, N,
                                  mod.BY_SRC, mod.ENC_GRAPHAR,
                                  page_size=PAGE)
        assert tops.plan_supported(adj)
        DELTA[mod].ingest_edges(adj, [1], [2])
        got = tops.k_hop_fused(adj, np.arange(4), 2, [None, None],
                               engine=engine)
        oracle = mod.build_adjacency(*DELTA[mod].all_edges(adj), N, N,
                                     mod.BY_SRC, mod.ENC_GRAPHAR,
                                     page_size=PAGE)
        np.testing.assert_array_equal(
            got, mod.k_hop(oracle, np.arange(4), 2, engine="numpy"))
        assert tops.traversal_stats(adj)["fallbacks"] >= 1
        assert not getattr(adj, "_traversal_plans", None)  # none built
        out.append((got.tolist(), tops.traversal_stats(adj)))
    assert out[0] == out[1]


# --------------------- accounting under pending writes -------------------

@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_meter_identical_across_engines_while_pending(batch, jeng, teng):
    """Delta reads are RAM-resident: the lake footprint under pending
    writes is exactly the base footprint, on every engine of both
    packages, and the decoded-page LRU evolves alike."""
    out = []
    for mod, engine in ((J, "numpy"), (J, jeng), (T, "numpy"), (T, teng)):
        adj = _pending(mod)
        cache = mod.attach_page_cache(adj.table["<dst>"], 8)
        m = mod.IOMeter()
        for _ in range(2):                       # cold, then warm
            mod.neighbor_ids_batch(adj, batch, m, engine=engine)
        out.append((m.nbytes, m.nrequests, cache.hits, cache.misses))
    assert len(set(out)) == 1


def test_zone_maps_prune_segments():
    out = []
    for mod in (J, T):
        adj = _graph(mod)
        DELTA[mod].ingest_edges(adj, np.arange(40), np.zeros(40, np.int64))
        d = DELTA[mod].live_delta(adj)
        before = d.segments_pruned
        # a qualifying range far above every ingested value prunes all
        ids = d.unique_ids(np.arange(40), qual=(NVAL - 2, NVAL - 1))
        assert ids.size == 0
        assert d.segments_pruned > before
        kept = d.unique_ids(np.arange(40), qual=(0, 1))
        out.append((kept.tolist(), d.stats()))
    assert out[0] == out[1]


# ----------------------------- ingest semantics --------------------------

def test_ingest_atomicity_under_fault():
    """A crash mid-append publishes nothing; the retry applies the batch
    exactly once (stage-then-publish, no half/double-apply)."""
    out = []
    for mod, plan, exc in ((J, JFaultPlan, None), (T, FaultPlan,
                                                   InjectedFault)):
        adj = _graph(mod)
        d = DELTA[mod].attach_delta(adj, faults=plan({"ingest.append": 1}))
        src = np.asarray([1, 2, 3, 1], np.int64)
        dst = np.asarray([4, 5, 6, 4], np.int64)
        with pytest.raises(Exception) as e:
            d.ingest(src, dst)
        assert type(e.value).__name__ == "InjectedFault"
        if exc is not None:
            assert isinstance(e.value, exc)
        assert d.pending_rows() == 0 and DELTA[mod].live_delta(adj) is None
        d.ingest(src, dst)                       # retry: exactly once
        assert d.pending_rows() == 4
        vals, lens = d.lookup_batch(np.asarray([1, 2, 7], np.int64))
        out.append((vals.tolist(), lens.tolist(), d.stats()))
    assert out[0] == out[1]
    assert out[1][0] == [4, 4, 5]


def test_ingest_validates_bounds():
    for mod in (J, T):
        adj = _graph(mod)
        d = DELTA[mod].attach_delta(adj)
        with pytest.raises(ValueError):
            d.ingest([N + 5], [0])
        with pytest.raises(ValueError):
            d.ingest([0], [NVAL + 5])
        with pytest.raises(ValueError):
            d.ingest([0, 1], [0])
        assert d.ingest([], []) == 0
        assert d.pending_rows() == 0


def test_write_once_path_untouched_until_first_ingest():
    out = []
    for mod in (J, T):
        adj = _graph(mod)
        assert DELTA[mod].live_delta(adj) is None
        d = DELTA[mod].attach_delta(adj)
        assert DELTA[mod].attach_delta(adj) is d  # attach is idempotent
        assert DELTA[mod].live_delta(adj) is None  # attached but empty
        DELTA[mod].ingest_edges(adj, [0], [0])
        assert DELTA[mod].live_delta(adj) is d
        out.append((repr(d), d.stats()))
    assert out[0] == out[1]


def test_all_edges_roundtrip():
    out = []
    for mod in (J, T):
        adj = _graph(mod)
        b = DELTA[mod].base_edges(adj)
        _ingest_some(mod, adj, rows=17)
        s, t = DELTA[mod].all_edges(adj)
        assert s.size == b[0].size + 17 and t.size == b[1].size + 17
        snap = adj.delta.snapshot()
        out.append((s.tolist(), t.tolist(),
                    {p: (k.tolist(), v.tolist()) for p, (k, v) in
                     snap.items()}, adj.delta.nbytes()))
    assert out[0] == out[1]


# ------------------- poisoned mirror: degrade + heal ---------------------

def test_poisoned_mirror_falls_back_to_host_oracle(batch):
    """A poisoned mirror routes every read to the host oracle with the
    reference's ids, PAC, IOMeter and counters.  A ``bump_version`` then
    heals the port's mirror (a fresh one ships and the dispatch takes the
    kernel again); the reference routes on to the host there until a
    compaction repacks the column, a difference kept on purpose."""
    out = []
    for mod, engine in ((J, "jax"), (T, "torch")):
        adj = _pending(mod)
        oracle = _rebuilt(mod, adj)
        col = adj.table[adj.value_col].encoded
        # materialize the device mirror, then poison it
        mod.neighbor_ids_batch(adj, batch, engine=engine)
        packed = col.packed_cache
        assert packed is not None
        packed.poison()
        meter = mod.IOMeter()
        got = mod.neighbor_ids_batch(adj, batch, meter, engine=engine)
        np.testing.assert_array_equal(
            got, mod.neighbor_ids_batch(oracle, batch, engine="numpy"))
        pac = mod.retrieve_neighbors_batch(adj, batch, TPS, meter,
                                           engine=engine)
        np.testing.assert_array_equal(
            pac.to_ids(),
            mod.retrieve_neighbors_batch(oracle, batch, TPS,
                                         engine="numpy").to_ids())
        hops = mod.k_hop(adj, batch[:4], 2, meter, engine=engine)
        assert packed.fallbacks > 0
        stats = packed.device_stats()
        assert stats["poisoned"] is True
        out.append((got.tolist(), meter.nbytes, meter.nrequests,
                    _words(pac), hops.tolist(),
                    {k: v for k, v in stats.items() if k != "engines"}))
    assert out[0] == out[1]
    # heal (the port): the version bump rebuilds a clean mirror
    col.bump_version()
    from repro_torch.kernels import _pad
    _pad.reset_shape_classes()
    got2 = T.neighbor_ids_batch(adj, batch, engine="torch")
    np.testing.assert_array_equal(
        got2, T.neighbor_ids_batch(oracle, batch, engine="numpy"))
    healed = col.packed_cache
    assert healed is not packed and not healed.poisoned
    assert healed.device_transfers == 1 and healed.fallbacks == 0
    assert _pad.shape_class_count("gather_decode") == 1   # kernel again
    assert packed.fallbacks == out[1][-1]["fallbacks"]    # no more


def _poisoned_writes(tree):
    """Each place in a module that assigns ``<obj>.poisoned`` (plainly,
    augmented, annotated or through ``setattr``), with the function that
    holds it."""
    import ast
    found = []

    def visit(node, owner):
        for child in ast.iter_child_nodes(node):
            here = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else owner
            targets = []
            if isinstance(child, ast.Assign):
                targets = child.targets
            elif isinstance(child, (ast.AugAssign, ast.AnnAssign)):
                targets = [child.target]
            if any(isinstance(t, ast.Attribute) and t.attr == "poisoned"
                   for t in targets):
                found.append((here, child.lineno))
            if isinstance(child, ast.Call) and getattr(
                    child.func, "id", None) == "setattr" and any(
                    isinstance(a, ast.Constant) and a.value == "poisoned"
                    for a in child.args):
                found.append((here, child.lineno))
            visit(child, here)

    visit(tree, None)
    return found


def test_only_an_explicit_poison_enters_the_host_route(batch):
    """The poisoned-mirror route moves a kernel engine's reads to the
    host, so the port must enter it only on an explicit
    ``PackedPages.poison()``: no other code in the port assigns
    ``poisoned``, and ingests, reads on every route, a failed and a
    retried compaction leave the mirror unpoisoned with no fallback."""
    import ast
    from pathlib import Path
    import repro_torch
    from repro_torch.core.compaction import CompactionRunner
    root = Path(repro_torch.__file__).parent
    writes = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for owner, line in _poisoned_writes(tree):
            writes[f"{path.relative_to(root)}:{owner}"] = line
    assert list(writes) == ["core/encoding.py:poison"], writes

    adj = _pending(T)
    col = adj.table[adj.value_col].encoded
    T.neighbor_ids_batch(adj, batch, engine="torch")
    T.neighbor_ids_batch(adj, batch, engine="torch", unique=False)
    T.retrieve_neighbors_batch(adj, batch, TPS, engine="torch")
    T.k_hop(adj, batch[:4], 2, engine="torch")
    plan = FaultPlan({"compact.pre_swap": 1})
    runner = CompactionRunner(adj, faults=plan, max_attempts=1)
    assert not runner.compact()                 # the fault: no swap
    assert runner.compact()
    T.k_hop(adj, batch[:4], 2, engine="torch")
    T.retrieve_neighbors_batch(adj, batch, TPS, engine="torch")
    packed = col.packed_cache
    assert packed is not None
    stats = packed.device_stats()
    assert stats["poisoned"] is False and stats["fallbacks"] == 0


# ------------------------- serve-plane integration -----------------------

@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_retriever_serves_ingested_edges(jeng, teng):
    from repro.serve.retrieval import GraphRetriever as JGraphRetriever
    from repro_torch.serve.retrieval import GraphRetriever
    out = []
    for mod, cls, engine in ((J, JGraphRetriever, jeng),
                             (T, GraphRetriever, teng)):
        rng = np.random.default_rng(33)
        adj = _graph(mod)
        tok = mod.TokensColumn("tokens",
                               [rng.integers(0, 99, 6).astype(np.int32)
                                for _ in range(NVAL)], PAGE)
        r = cls(adj, tok, max_neighbors=3, engine=engine,
                meter=mod.IOMeter())
        vs = rng.integers(0, N, 16)
        r(vs)                                    # warm, write-once tick
        e0 = r.mutation_epoch()
        delta = r.ingest(rng.integers(0, N, 60), rng.integers(0, NVAL, 60))
        assert delta is adj.delta
        oracle = _rebuilt(mod, adj)
        r2 = cls(oracle, tok, max_neighbors=3, engine="numpy")
        got, want = r(vs), r2(vs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        mut = r.stats()["mutable"]
        assert mut["ingest_calls"] == 1 and mut["ingest_rows"] == 60
        assert mut["pending_rows"] == 60
        out.append(([g.tolist() for g in got], e0, r.mutation_epoch(), mut,
                    r.meter.nbytes, r.meter.nrequests))
    assert out[0] == out[1]


def test_serve_engine_ingest_forwarder():
    from repro_torch.serve.engine import ServeEngine

    class _Ctx:
        def __init__(self):
            self.got = None

        def __call__(self, vs):
            return [np.zeros(0, np.int32)] * len(vs)

        def ingest(self, src, dst):
            self.got = (list(src), list(dst))
            return "delta"

    eng = ServeEngine.__new__(ServeEngine)
    eng.context_fn = _Ctx()
    assert eng.ingest([1, 2], [3, 4]) == "delta"
    assert eng.context_fn.got == ([1, 2], [3, 4])
    eng.context_fn = None
    with pytest.raises(ValueError, match="ingest-capable"):
        eng.ingest([1], [2])


# ---------------- base-only reads while rows are pending -----------------

def _chain(mod):
    """A of 300 keys -> 500 values, B of 500 keys -> 400 values, with rows
    pending on both, and a label table over B's values."""
    rng = np.random.default_rng(11)
    adj_a = mod.build_adjacency(rng.integers(0, 300, 1500),
                                rng.integers(0, 500, 1500), 300, 500,
                                mod.BY_SRC, mod.ENC_GRAPHAR, page_size=64)
    adj_b = mod.build_adjacency(rng.integers(0, 500, 2500),
                                rng.integers(0, 400, 2500), 500, 400,
                                mod.BY_SRC, mod.ENC_GRAPHAR, page_size=64)
    DELTA[mod].ingest_edges(adj_a, rng.integers(0, 300, 200),
                            rng.integers(0, 500, 200))
    DELTA[mod].ingest_edges(adj_b, rng.integers(0, 500, 300),
                            rng.integers(0, 400, 300))
    labels = clustered_labels(400, ["R"], density=0.5, run_scale=16, seed=3)
    vt = mod.VertexTable.build(mod.VertexTypeSchema("m", [], labels=["R"]),
                               {}, labels, num_vertices=400)
    return adj_a, adj_b, vt


def test_traversal_reads_base_only_while_pending():
    """``two_hop_pac`` and ``frontier_edge_counts`` read the packed base
    only while rows are pending -- the reference's behaviour, kept: the
    result equals the reference's and a base-only graph's, and differs
    from the rebuild's."""
    out = []
    for mod, engine, tops in ((J, "jax", JTO), (T, "torch", TTO)):
        adj_a, adj_b, vt = _chain(mod)
        filt = mod.LabelFilter(vt, mod.L("R"))
        seeds = [7, 8, 150, 299]
        meter = mod.IOMeter()
        pac = tops.two_hop_pac(adj_a, adj_b, seeds, 128, filt, meter,
                               engine)
        base_a = mod.build_adjacency(*DELTA[mod].base_edges(adj_a), 300,
                                     500, mod.BY_SRC, mod.ENC_GRAPHAR,
                                     page_size=64)
        base_b = mod.build_adjacency(*DELTA[mod].base_edges(adj_b), 500,
                                     400, mod.BY_SRC, mod.ENC_GRAPHAR,
                                     page_size=64)
        want = tops.two_hop_pac(base_a, base_b, seeds, 128, filt, None,
                                engine)
        assert _words(pac) == _words(want)
        starts, ends = np.array([3, 100, 420]), np.array([40, 180, 500])
        off = adj_b.offsets["<offset>"].values
        counts = tops.frontier_edge_counts(adj_b, starts, ends, off[starts],
                                           off[ends], meter, engine)
        full = np.zeros(400, np.int64)
        for s, e in zip(starts, ends):
            full += np.bincount(mod.neighbor_ids_batch(
                adj_b, np.arange(s, e), engine="numpy", unique=False),
                minlength=400)
        assert not np.array_equal(counts, full)  # pending rows unseen
        out.append((_words(pac), counts.tolist(), meter.nbytes,
                    meter.nrequests, tops.traversal_stats(adj_a),
                    tops.traversal_stats(adj_b)))
    assert out[0] == out[1]


def test_bi2_reads_base_only_while_pending():
    snbs = {JQ: j_ldbc_like(scale=1, seed=0), TQ: ldbc_like(scale=1, seed=0)}
    out = []
    for mod, Q, engine in ((J, JQ, "numpy"), (J, JQ, "jax"),
                           (T, TQ, "numpy"), (T, TQ, "torch")):
        g = Q.build_snb_graphar(snbs[Q], 1024)
        adj = g.adjacency("message-hasTag-tag", mod.BY_SRC)
        n_msg = adj.num_key_vertices
        rng = np.random.default_rng(4)
        before = Q.bi2_graphar(g, "TagClass3", engine=engine)
        DELTA[mod].ingest_edges(adj, rng.integers(0, n_msg, 500),
                                rng.integers(0, adj.num_value_vertices,
                                             500))
        meter = mod.IOMeter()
        counts = Q.bi2_graphar(g, "TagClass3", meter, engine=engine)
        assert counts == before                  # the base only
        out.append((counts, meter.nbytes, meter.nrequests))
    assert all(o == out[0] for o in out)
