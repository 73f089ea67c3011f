"""The port's partition plane (``repro_torch/core/partition.py``,
``kernels/shard.py`` and the partitioned routes of ``pac_decode``,
``label_filter`` and ``traversal``) against the JAX package's, on the same
seeded graphs.

The JAX package's ``test_partition_plane.py`` on both packages: at 1, 2,
3 and 8 partitions the port's ``torch`` engine gives the ids, PACs,
IOMeter bytes and requests, LRU hits, misses and evictions,
``traversal_stats`` and partition counters (``dispatches``,
``partitions_pruned``, ``stats_pruned``) of the reference's ``numpy`` and
``jax`` engines -- on the single-shard tail, and on the multi-device tail
forced onto a mesh that names the CPU 8 (or 4) times
(``pac_decode.ops._devices`` replaced, ``SHARD_MIN_PAGES`` 0).  The
reference on one host device always takes its single-shard tail.  At 8
partitions over a 4-entry mesh the port's ``k_hop`` equals the numpy
oracle where the reference's sharded k-hop raises (pinned in a
subprocess with 4 forced host devices).  Then the partition cases of
``test_page_pruning.py``, ``test_traversal.py``, ``test_page_cache.py``,
``test_batched_neighbor.py``, ``test_core_tables.py`` and
``test_serve_pipeline.py``, and the plain version of ``rt_merge_hop``
against a numpy oracle at ``_summary_shape``'s edges.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import partition as JP
from repro.data.synthetic import clustered_labels, powerlaw_graph
from repro.kernels.pac_decode import ops as JO
from repro.kernels.traversal import ops as JTO
from repro_torch.core import partition as TP
from repro_torch.kernels import _pad, shard
from repro_torch.kernels.pac_decode import ops as TO
from repro_torch.kernels.traversal import kernel as TK
from repro_torch.kernels.traversal import ops as TTO
from repro_torch.kernels.traversal import ref as TR

torch.set_num_threads(1)

N = 2000
PAGE = 256
TPS = 512
PART_COUNTS = (1, 2, 3, 8)
#: the port's tails: the single-shard tail, and the multi-device tail on a
#: mesh naming the CPU 8 times
TAILS = ("single", "mesh8")
CPU = torch.device("cpu")


def _edges():
    return powerlaw_graph(N, 6, seed=13)


def _adj(mod, edges=None, n=N, page=PAGE):
    src, dst = edges if edges is not None else _edges()
    return mod.build_adjacency(src, dst, n, n, mod.BY_SRC, mod.ENC_GRAPHAR,
                               page_size=page)


_LABELS = clustered_labels(N, ["A", "B"], density=0.3, run_scale=64, seed=7)


def _vt(mod, labels=None, n=N):
    labels = _LABELS if labels is None else labels
    return mod.VertexTable.build(
        mod.VertexTypeSchema("v", [], labels=sorted(labels)), {}, labels,
        num_vertices=n)


def _col(adj):
    return adj.table["<dst>"].encoded


def _set_parts(mod, adj, n):
    mod.partition_column(_col(adj), n)


def _counters(parts):
    """The partition counters both packages must agree on (the device
    names differ: ``cpu`` against the JAX platform's)."""
    if parts is None:
        return None
    s = parts.stats()
    return {k: s[k] for k in ("n_parts", "dispatches", "partitions_pruned",
                              "stats_pruned", "version")}


def _meter(m):
    return (m.nbytes, m.nrequests)


def _words(pac):
    return [(p, pac.bitmaps[p].tolist()) for p in sorted(pac.bitmaps)]


def _mesh(monkeypatch, entries):
    monkeypatch.setattr(TO, "_devices", lambda engine: (CPU,) * entries)
    monkeypatch.setattr(TO, "SHARD_MIN_PAGES", 0)


@pytest.fixture
def tail(request, monkeypatch):
    """The tail's name and a count of the multi-device entries' calls."""
    calls = {}
    if request.param == "mesh8":
        _mesh(monkeypatch, 8)
        for name in ("sharded_fused", "sharded_decode", "sharded_khop"):
            fn = getattr(shard, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(shard, name, counted)
    return request.param, calls


# ------------------------------- construction ------------------------------

@pytest.mark.parametrize("n_pages,n_parts",
                         [(10, 4), (8, 2), (3, 8), (0, 3), (33683, 8)])
def test_partition_bounds_even_split(n_pages, n_parts):
    np.testing.assert_array_equal(TP.partition_bounds(n_pages, n_parts),
                                  JP.partition_bounds(n_pages, n_parts))


@pytest.mark.parametrize("n_parts", (2, 3, 8))
def test_partitions_cover_column_and_record_stats(n_parts):
    vals = np.sort(np.random.default_rng(0).integers(0, 1 << 20,
                                                     5 * PAGE + 37))
    jp = J.partition_column(J.delta_encode_column(vals, PAGE), n_parts)
    tp = T.partition_column(T.delta_encode_column(vals, PAGE), n_parts)
    np.testing.assert_array_equal(tp.bounds, jp.bounds)
    assert (tp.pmax, tp.stack_rows) == (jp.pmax, jp.stack_rows)
    for a, b in zip(tp.parts, jp.parts):
        assert (a.index, a.page_lo, a.page_hi, a.row_lo, a.row_hi, a.vmin,
                a.vmax, a.stats_known) == \
            (b.index, b.page_lo, b.page_hi, b.row_lo, b.row_hi, b.vmin,
             b.vmax, b.stats_known)
        for x, y in zip(a.packed.host_arrays(), b.packed.host_arrays()):
            np.testing.assert_array_equal(x, y)
    # the stacked plan, bit for bit (the port's words as int32 patterns)
    for x, y in zip(tp.stacked_plan_host(), jp.stacked_plan_host()):
        np.testing.assert_array_equal(x, np.asarray(y).view(np.int32))


def test_single_partition_detaches_to_monolithic():
    vals = np.sort(np.random.default_rng(2).integers(0, 1 << 20, 2 * PAGE))
    col = T.delta_encode_column(vals, PAGE)
    T.partition_column(col, 4)
    assert T.live_partitions(col) is not None
    assert T.partition_column(col, 1) is None
    assert T.live_partitions(col) is None and col.partitions == 0


def test_partition_cache_rebuilds_on_version_bump():
    vals = np.sort(np.random.default_rng(3).integers(0, 1 << 20,
                                                     3 * PAGE + 17))
    col = T.delta_encode_column(vals, PAGE)
    parts = T.partition_column(col, 3)
    new_tail = np.sort(np.random.default_rng(4).integers(0, 1 << 20, 17))
    col.set_page(len(col.pages) - 1, T.delta_encode_page(new_tail))
    fresh = T.live_partitions(col)
    assert fresh is not parts and fresh.version == col.version
    last = len(col.pages) - 1
    k = int(fresh.part_of_pages(np.array([last]))[0])
    local = last - int(fresh.bounds[k])
    assert fresh.parts[k].packed.page_min[local] == int(new_tail.min())


@pytest.mark.parametrize("placed", [False, True])
def test_dropped_partitioned_column_dies_without_a_collection(placed):
    """The plane holds its column weakly: a partitioned column (with its
    stacked plan placed, when ``placed``) that its caller drops is freed
    by reference counting alone, with the cyclic collector off."""
    import gc
    import weakref
    adj = _adj(T)
    _set_parts(T, adj, 8)
    col = _col(adj)
    parts = TP.live_partitions(col)
    if placed:
        T.retrieve_neighbors_batch(adj, np.arange(0, N, 7), TPS,
                                   T.IOMeter(), engine="torch")
        assert parts._device_plans
    dead_col, dead_parts = weakref.ref(col), weakref.ref(parts)
    assert parts.col is col
    gc.disable()
    try:
        del adj, col, parts
        assert dead_col() is None and dead_parts() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("n_parts", (1, 2, 3, 6, 8))
def test_mesh_size_is_largest_divisor(n_parts):
    vals = np.sort(np.random.default_rng(5).integers(0, 1 << 20, 8 * PAGE))
    tp = TP.PartitionedColumn(T.delta_encode_column(vals, PAGE),
                              np.zeros(n_parts + 1, np.int64),
                              [None] * n_parts)
    jp = JP.PartitionedColumn(J.delta_encode_column(vals, PAGE),
                              np.zeros(n_parts + 1, np.int64),
                              [None] * n_parts)
    for devices in range(1, 9):
        assert tp.mesh_size(devices) == jp.mesh_size(devices)
    devs = [torch.device("cpu")] * 8
    assert len(tp.mesh_devices(devs)) == tp.mesh_size(8)


def test_page_class_caps_at_stack():
    for n, rows in ((53, 160), (157, 160), (3, 160), (4211, 4211)):
        assert TO._page_class(n, rows) == JO._page_class(n, rows)


def test_pac_set_operations_equal_the_reference():
    rng = np.random.default_rng(6)
    ids = [np.unique(rng.integers(0, 6000, k)) for k in (40, 70, 0, 5)]
    jp = [J.PAC.from_ids(x, 512) if x.size else J.PAC(512) for x in ids]
    tp = [T.PAC.from_ids(x, 512) if x.size else T.PAC(512) for x in ids]
    assert T.pages_union(tp) == J.pages_union(jp)
    assert _words(T.PAC.union_all(tp, 512)) == \
        _words(J.PAC.union_all(jp, 512))
    assert T.PAC.union_all([], 512).count() == 0
    for i in range(len(ids)):
        for k in range(len(ids)):
            assert _words(tp[i].difference(tp[k])) == \
                _words(jp[i].difference(jp[k]))
    acc_t, acc_j = T.PAC(512), J.PAC(512)
    for a, b in zip(tp, jp):
        assert acc_t.union_(a) is acc_t
        acc_j.union_(b)
        assert _words(acc_t) == _words(acc_j)


# ----------------- partitioned == monolithic == the reference ---------------

@pytest.mark.parametrize("tail,jeng,teng",
                         [("single", "numpy", "numpy"),
                          ("single", "jax", "torch"),
                          ("mesh8", "jax", "torch")],
                         indirect=["tail"])
@pytest.mark.parametrize("n_parts", PART_COUNTS)
def test_sharded_bit_identical_to_resident(tail, jeng, teng, n_parts):
    mono, part, jpart = _adj(T), _adj(T), _adj(J)
    _set_parts(T, part, n_parts)
    _set_parts(J, jpart, n_parts)
    kw = {} if teng == "numpy" else dict(fused=True, resident=True)
    for seed in (17, 18):
        vs = np.random.default_rng(seed).integers(0, N, 64)
        m_mono, m_part, m_j = T.IOMeter(), T.IOMeter(), J.IOMeter()
        want = T.retrieve_neighbors_batch(mono, vs, TPS, m_mono,
                                          engine=teng, **kw)
        got = T.retrieve_neighbors_batch(part, vs, TPS, m_part, engine=teng,
                                         **kw)
        ref = J.retrieve_neighbors_batch(jpart, vs, TPS, m_j, engine=jeng,
                                         **kw)
        assert got == want
        assert _words(got) == _words(ref)
        assert _meter(m_part) == _meter(m_mono) == _meter(m_j)
    assert _counters(T.live_partitions(_col(part))) == \
        _counters(J.live_partitions(_col(jpart)))
    name, calls = tail
    assert calls.get("sharded_fused", 0) == \
        (2 if name == "mesh8" and n_parts > 1 else 0)


@pytest.mark.parametrize("tail", TAILS, indirect=True)
@pytest.mark.parametrize("n_parts", (2, 8))
def test_sharded_filtered_bit_identical(tail, n_parts):
    part, jpart = _adj(T), _adj(J)
    _set_parts(T, part, n_parts)
    _set_parts(J, jpart, n_parts)
    tvt, jvt = _vt(T), _vt(J)
    vs = np.random.default_rng(23).integers(0, N, 64)
    m_t, m_j = T.IOMeter(), J.IOMeter()
    got = T.retrieve_neighbors_batch(
        part, vs, TPS, m_t, engine="torch", fused=True, resident=True,
        filter=T.LabelFilter(tvt, T.L("A") | ~T.L("B")))
    want = J.retrieve_neighbors_batch(
        jpart, vs, TPS, m_j, engine="jax", fused=True, resident=True,
        filter=J.LabelFilter(jvt, J.L("A") | ~J.L("B")))
    assert _words(got) == _words(want)
    assert _meter(m_t) == _meter(m_j)
    assert _counters(T.live_partitions(_col(part))) == \
        _counters(J.live_partitions(_col(jpart)))


@pytest.mark.parametrize("tail", TAILS, indirect=True)
@pytest.mark.parametrize("n_parts", PART_COUNTS)
def test_nonfused_and_properties_route_through_partitions(tail, n_parts):
    """The page-matrix decode (``neighbor_ids_batch``) and the batched
    property fetch with ``partitions=``, against the reference's."""
    tadj, jadj = _adj(T), _adj(J)
    tvt = T.VertexTable.build(
        T.VertexTypeSchema("v", [T.PropertySchema("x", "int64")],
                           labels=["A", "B"], page_size=PAGE),
        {"x": np.arange(N) * 3}, _LABELS, num_vertices=N)
    jvt = J.VertexTable.build(
        J.VertexTypeSchema("v", [J.PropertySchema("x", "int64")],
                           labels=["A", "B"], page_size=PAGE),
        {"x": np.arange(N) * 3}, _LABELS, num_vertices=N)
    vs = np.random.default_rng(41).integers(0, N, 40)
    m_t, m_j = T.IOMeter(), J.IOMeter()
    got = T.neighbor_properties_batch(tadj, vs, tvt, "x", m_t,
                                      engine="torch", partitions=n_parts)
    want = J.neighbor_properties_batch(jadj, vs, jvt, "x", m_j,
                                       engine="jax", partitions=n_parts)
    np.testing.assert_array_equal(got, want)
    ids_t = T.neighbor_ids_batch(tadj, vs, m_t, engine="torch")
    ids_j = J.neighbor_ids_batch(jadj, vs, m_j, engine="jax")
    np.testing.assert_array_equal(ids_t, ids_j)
    assert _meter(m_t) == _meter(m_j)
    assert _counters(T.live_partitions(_col(tadj))) == \
        _counters(J.live_partitions(_col(jadj)))


@pytest.mark.parametrize("tail", TAILS, indirect=True)
@pytest.mark.parametrize("n_parts", PART_COUNTS)
@pytest.mark.parametrize("hops", (2, 3))
def test_khop_routes_through_partitions(tail, n_parts, hops):
    """``k_hop(partitions=)`` with a per-hop predicate pattern, an LRU and
    a meter: ids, IOMeter, LRU counters, ``traversal_stats`` and the
    partition counters equal the reference's fused route and the host
    oracle's ids."""
    tadj, jadj, oadj = _adj(T), _adj(J), _adj(J)
    tvt, jvt = _vt(T), _vt(J)
    for a in (tadj, jadj, oadj):
        (T if a is tadj else J).attach_page_cache(a.table["<dst>"], 64)
    tf = [None, T.LabelFilter(tvt, T.L("A")), None][:hops]
    jf = [None, J.LabelFilter(jvt, J.L("A")), None][:hops]
    rng = np.random.default_rng(29 + n_parts)
    for seeds in (rng.integers(0, N, 8), rng.integers(0, N, 1)):
        m_t, m_j, m_o = T.IOMeter(), J.IOMeter(), J.IOMeter()
        got = T.k_hop(tadj, seeds, hops, m_t, engine="torch", filter=tf,
                      partitions=n_parts)
        want = J.k_hop(jadj, seeds, hops, m_j, engine="jax", filter=jf,
                       partitions=n_parts)
        oracle = J.k_hop(oadj, seeds, hops, m_o, filter=jf,
                         partitions=n_parts, fused=False)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)
        assert _meter(m_t) == _meter(m_j) == _meter(m_o)
    assert T.live_cache(_col(tadj)).stats() == \
        J.live_cache(_col(jadj)).stats()
    assert TTO.traversal_stats(tadj) == JTO.traversal_stats(jadj)
    assert _counters(T.live_partitions(_col(tadj))) == \
        _counters(J.live_partitions(_col(jadj)))
    name, calls = tail
    sharded = name == "mesh8" and n_parts > 1
    # the plan build's whole-column decode, then the two traversals
    assert (calls.get("sharded_decode", 0), calls.get("sharded_khop", 0)) \
        == ((1, 2) if sharded else (0, 0))


def test_khop_mesh_launches_per_entry_not_per_partition(monkeypatch):
    """On a 4-entry mesh over 8 partitions each hop runs one expansion
    per mesh entry and one merge."""
    _mesh(monkeypatch, 4)
    tadj = _adj(T)
    calls = {"expand": 0, "merge": 0}
    expand, merge = TK.expand_words, TK.merge_hop

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(TK, "expand_words", count("expand", expand))
    monkeypatch.setattr(TK, "merge_hop", count("merge", merge))
    T.k_hop(tadj, np.array([3, 17, 999]), 3, engine="torch", partitions=8)
    assert calls == {"expand": 3 * 4, "merge": 3}


def test_khop_ppd2_equals_oracle_where_the_reference_raises(monkeypatch):
    """8 partitions over a 4-entry mesh (two partitions an entry): the
    port's sharded k-hop equals the numpy oracle; the reference's, run
    over 4 forced host devices, raises on its per-partition stacking."""
    _mesh(monkeypatch, 4)
    seeds = np.random.default_rng(29).integers(0, N, 8)
    tadj, oadj = _adj(T), _adj(J)
    for hops in (2, 3):
        got = T.k_hop(tadj, seeds, hops, engine="torch", partitions=8)
        want = J.k_hop(oadj, seeds, hops, engine="numpy", partitions=8)
        np.testing.assert_array_equal(got, want)
        parts = T.live_partitions(_col(tadj))
        assert parts.mesh_size(4) == 4 and parts.n_parts // 4 == 2
    # retrieval on the same mesh equals the oracle too
    vs = np.random.default_rng(3).integers(0, N, 64)
    m_t, m_o = T.IOMeter(), J.IOMeter()
    got = T.retrieve_neighbors_batch(tadj, vs, TPS, m_t, engine="torch",
                                     fused=True, resident=True)
    want = J.retrieve_neighbors_batch(oadj, vs, TPS, m_o)
    assert _words(got) == _words(want) and _meter(m_t) == _meter(m_o)
    code = textwrap.dedent("""
        import numpy as np
        import repro.core as J
        from repro.data.synthetic import powerlaw_graph
        src, dst = powerlaw_graph(2000, 6, seed=13)
        adj = J.build_adjacency(src, dst, 2000, 2000, J.BY_SRC,
                                J.ENC_GRAPHAR, page_size=256)
        seeds = np.random.default_rng(29).integers(0, 2000, 8)
        try:
            J.k_hop(adj, seeds, 2, engine="jax", fused=True, partitions=8)
            print("RESULT none")
        except TypeError as e:
            print("RESULT TypeError", e)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_SHARD_MIN_PAGES="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "RESULT TypeError" in out.stdout, out.stdout + out.stderr
    assert "incompatible shapes" in out.stdout


@pytest.mark.parametrize("n_parts", (2, 3, 8))
def test_traversal_plans_keyed_by_partition_count(monkeypatch, n_parts):
    """Switching the partition count keeps the same version's plans (no
    rebuild), and the counters equal the reference's after the switch."""
    tadj, jadj = _adj(T), _adj(J)
    seeds = np.array([3, 17, 999])
    for parts in (n_parts, 1, n_parts):
        np.testing.assert_array_equal(
            T.k_hop(tadj, seeds, 2, engine="torch", partitions=parts),
            J.k_hop(jadj, seeds, 2, engine="jax", partitions=parts))
    plans = tadj._traversal_plans
    assert sorted(plans) == [(0, 0), (0, n_parts)]
    assert all(p.rows for p in plans.values())   # none released
    assert TTO.traversal_stats(tadj) == JTO.traversal_stats(jadj)
    # a version bump releases the older plans only
    col = _col(tadj)
    col.bump_version()
    T.k_hop(tadj, seeds, 2, engine="torch")
    assert [k for k, p in plans.items() if p.rows] == [(1, n_parts)]


@pytest.mark.parametrize("n_parts", (1, 3, 8))
def test_two_hop_and_edge_counts_on_partitioned_plans(n_parts):
    """IC-8's chain and BI-2's counting expansion over partitioned
    columns, with LRUs attached: PAC, counts, IOMeter and LRU counters
    equal the reference's."""
    rng = np.random.default_rng(11)
    ea = (rng.integers(0, 300, 3000), rng.integers(0, 500, 3000))
    eb = (rng.integers(0, 500, 4000), rng.integers(0, 400, 4000))
    labels = clustered_labels(400, ["A"], density=0.4, run_scale=16, seed=2)

    def build(mod):
        a = mod.build_adjacency(*ea, 300, 500, mod.BY_SRC, mod.ENC_GRAPHAR,
                                page_size=64)
        b = mod.build_adjacency(*eb, 500, 400, mod.BY_SRC, mod.ENC_GRAPHAR,
                                page_size=64)
        for x in (a, b):
            mod.partition_column(_col(x), n_parts)
            mod.attach_page_cache(x.table["<dst>"], 16)
        return a, b, _vt(mod, labels, 400)
    (ta, tb, tvt), (ja, jb, jvt) = build(T), build(J)
    seeds = np.array([0, 5, 77, 299])
    m_t, m_j = T.IOMeter(), J.IOMeter()
    got = TTO.two_hop_pac(ta, tb, seeds, 128,
                          filt=T.LabelFilter(tvt, T.L("A")), meter=m_t,
                          engine="torch")
    want = JTO.two_hop_pac(ja, jb, seeds, 128,
                           filt=J.LabelFilter(jvt, J.L("A")), meter=m_j,
                           engine="jax")
    assert _words(got) == _words(want)
    starts, ends = np.array([10, 200]), np.array([40, 260])
    los, his = ta.edge_ranges_batch(np.arange(10, 40))
    got_c = TTO.frontier_edge_counts(ta, starts, ends, los, his, m_t,
                                     engine="torch")
    want_c = JTO.frontier_edge_counts(ja, starts, ends, los, his, m_j,
                                      engine="jax")
    np.testing.assert_array_equal(got_c, want_c)
    assert _meter(m_t) == _meter(m_j)
    for x, y in ((ta, ja), (tb, jb)):
        assert T.live_cache(_col(x)).stats() == J.live_cache(_col(y)).stats()
        assert TTO.traversal_stats(x) == JTO.traversal_stats(y)


# ------------------------------ decoded-page LRU ---------------------------

@pytest.mark.parametrize("tail", TAILS, indirect=True)
@pytest.mark.parametrize("n_parts", (2, 8))
def test_warm_lru_charges_nothing_and_keys_by_partition(tail, n_parts):
    part, jpart = _adj(T), _adj(J)
    _set_parts(T, part, n_parts)
    _set_parts(J, jpart, n_parts)
    cache = T.attach_page_cache(part.table["<dst>"], 24)
    jcache = J.attach_page_cache(jpart.table["<dst>"], 24)
    rng = np.random.default_rng(31)
    for vs in (rng.integers(0, N, 64), rng.integers(0, N, 64)):
        for _ in range(2):   # cold, then warm
            m_t, m_j = T.IOMeter(), J.IOMeter()
            a = T.retrieve_neighbors_batch(part, vs, TPS, m_t,
                                           engine="torch", fused=True,
                                           resident=True)
            b = J.retrieve_neighbors_batch(jpart, vs, TPS, m_j,
                                           engine="jax", fused=True,
                                           resident=True)
            assert _words(a) == _words(b) and _meter(m_t) == _meter(m_j)
            assert cache.stats() == jcache.stats()
            assert list(cache._pages) == list(jcache._pages)
    # a non-fused decode and the host oracle share the same namespace
    vs = rng.integers(0, N, 40)
    np.testing.assert_array_equal(
        T.neighbor_ids_batch(part, vs, engine="torch"),
        J.neighbor_ids_batch(jpart, vs, engine="jax"))
    np.testing.assert_array_equal(
        T.neighbor_ids_batch(part, vs, engine="numpy"),
        J.neighbor_ids_batch(jpart, vs, engine="numpy"))
    assert cache.stats() == jcache.stats()
    keys = list(cache._pages)
    assert keys and all(isinstance(k, tuple) and len(k) == 2 for k in keys)
    parts = T.live_partitions(_col(part))
    for k, p in keys:
        assert parts.bounds[k] <= p < parts.bounds[k + 1]
    assert cache.evictions > 0


def test_page_cache_partition_namespace_isolated():
    cache = T.DecodedPageCache(8)
    cache.put(3, np.array([1]), part=0)
    cache.put(3, np.array([2]), part=1)
    cache.put(3, np.array([3]))
    assert cache.get(3, part=0)[0] == 1
    assert cache.get(3, part=1)[0] == 2
    assert cache.get(3)[0] == 3
    state = cache.snapshot()
    cache.put(4, np.array([4]), part=1)
    cache.restore(state)
    assert cache.get(4, part=1) is None and len(cache) == 3


@pytest.mark.parametrize("tail", TAILS, indirect=True)
def test_per_dispatch_route_uses_the_partition_namespace(tail):
    """``resident=False`` (the single-device oracle route) probes and
    fills the ``(partition, page)`` keys too."""
    part, jpart = _adj(T), _adj(J)
    _set_parts(T, part, 3)
    _set_parts(J, jpart, 3)
    cache = T.attach_page_cache(part.table["<dst>"], 4096)
    jcache = J.attach_page_cache(jpart.table["<dst>"], 4096)
    vs = np.random.default_rng(8).integers(0, N, 64)
    for resident in (False, True, False):
        m_t, m_j = T.IOMeter(), J.IOMeter()
        a = T.retrieve_neighbors_batch(part, vs, TPS, m_t, engine="torch",
                                       fused=True, resident=resident)
        b = J.retrieve_neighbors_batch(jpart, vs, TPS, m_j, engine="jax",
                                       fused=True, resident=resident)
        assert _words(a) == _words(b) and _meter(m_t) == _meter(m_j)
        assert cache.stats() == jcache.stats()
    assert set(cache._pages) == set(jcache._pages)


# --------------------------- statistics pushdown ---------------------------

def _local_ring(n):
    """Perfectly local graph: partition value hulls track src ranges."""
    src = np.repeat(np.arange(n), 2)
    dst = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1).ravel()
    return src, dst


@pytest.mark.parametrize("tail", TAILS, indirect=True)
def test_stats_pruning_skips_partitions_and_reduces_io(tail):
    n = 2048
    labels = {"A": np.arange(n) < n // 4}
    out = {}
    for mod, eng in ((T, "torch"), (J, "jax")):
        lvt = _vt(mod, labels, n)
        mono = _adj(mod, _local_ring(n), n)
        part = _adj(mod, _local_ring(n), n)
        _set_parts(mod, part, 8)
        vs = np.arange(0, n, 7)
        m_none, m_mono, m_part = mod.IOMeter(), mod.IOMeter(), mod.IOMeter()
        mod.retrieve_neighbors_batch(mono, vs, TPS, m_none, engine=eng,
                                     fused=True, resident=True)
        want = mod.retrieve_neighbors_batch(
            mono, vs, TPS, m_mono, engine=eng, fused=True, resident=True,
            filter=mod.LabelFilter(lvt, mod.L("A")))
        got = mod.retrieve_neighbors_batch(
            part, vs, TPS, m_part, engine=eng, fused=True, resident=True,
            filter=mod.LabelFilter(lvt, mod.L("A")))
        assert got == want
        parts = mod.live_partitions(_col(part))
        assert parts.stats_pruned > 0
        assert m_part.nbytes == m_mono.nbytes < m_none.nbytes
        out[mod] = (_words(got), _meter(m_part), _counters(parts),
                    _col(part).prune_stats.as_dict())
    assert out[T] == out[J]


def test_stats_pruning_everything_yields_empty_pac():
    n = 2048
    lvt = _vt(T, {"Z": np.zeros(n, bool)}, n)
    part = _adj(T, _local_ring(n), n)
    _set_parts(T, part, 4)
    got = T.retrieve_neighbors_batch(part, np.arange(0, n, 9), TPS,
                                     engine="torch", fused=True,
                                     resident=True,
                                     filter=T.LabelFilter(lvt, T.L("Z")))
    assert got.count() == 0


def test_page_stats_survive_serialization(tmp_path):
    from repro_torch.core.storage import read_table, write_table
    n = 2048
    adj = _adj(T, _local_ring(n), n)
    path = str(tmp_path / "edges.gar")
    write_table(adj.table, path)
    col = read_table(path)["<dst>"].encoded
    for orig, back in zip(_col(adj).pages, col.pages):
        assert (back.vmin, back.vmax) == (orig.vmin, orig.vmax)
    parts = T.partition_column(col, 4)
    assert all(p.stats_known for p in parts.parts)
    # partitions are not part of the file: bytes equal an unpartitioned
    # write and the reference's
    T.partition_column(_col(adj), 4)
    write_table(adj.table, str(tmp_path / "again.gar"))
    jadj = _adj(J, _local_ring(n), n)
    from repro.core.storage import write_table as j_write_table
    j_write_table(jadj.table, str(tmp_path / "ref.gar"))
    data = (tmp_path / "edges.gar").read_bytes()
    assert data == (tmp_path / "again.gar").read_bytes() == \
        (tmp_path / "ref.gar").read_bytes()


def test_unknown_page_stats_never_prune():
    n = 2048
    lvt = _vt(T, {"A": np.arange(n) < n // 4}, n)
    mono = _adj(T, _local_ring(n), n)
    part = _adj(T, _local_ring(n), n)
    for pg in _col(part).pages:
        pg.vmin, pg.vmax = 0, -1            # statistics never recorded
    parts = T.partition_column(_col(part), 8)
    assert not any(p.stats_known for p in parts.parts)
    vs = np.arange(0, n, 7)
    kw = dict(engine="torch", fused=True, resident=True,
              filter=T.LabelFilter(lvt, T.L("A")))
    assert T.retrieve_neighbors_batch(part, vs, TPS, **kw) == \
        T.retrieve_neighbors_batch(mono, vs, TPS, **kw)
    assert parts.stats_pruned == 0


# ---- the partition cases of test_page_pruning.py (N 1024, pages of 128) ---

PN, PPAGE, PTPS, DEG = 1024, 128, 256, 6


def _prune_graph(mod):
    off = np.concatenate([np.arange(-(DEG // 2), 0),
                          np.arange(1, DEG - DEG // 2 + 1)])
    dst = np.clip(np.arange(PN)[:, None] + off[None, :], 0, PN - 1).ravel()
    src = np.repeat(np.arange(PN), DEG)
    return mod.build_adjacency(src, dst, PN, PN, mod.BY_SRC,
                               mod.ENC_GRAPHAR, page_size=PPAGE)


def _prune_vt(mod):
    rng = np.random.default_rng(3)
    age = (np.arange(PN) // 4).astype(np.int64)
    score = rng.integers(0, 50, PN).astype(np.int64)
    labels = {"A": np.arange(PN) < PN // 6, "R": rng.random(PN) < 0.4,
              "Z": np.zeros(PN, bool)}
    return mod.VertexTable.build(
        mod.VertexTypeSchema("v", [mod.PropertySchema("age", "int64"),
                                   mod.PropertySchema("score", "int64")],
                             labels=["A", "R", "Z"], page_size=PPAGE),
        {"age": age, "score": score}, labels, num_vertices=PN)


def _predicate(mod, vt, kind, rng):
    L = mod.L
    if kind % 2 == 0:
        conds = [L("A"), L("R"), L("A") | L("R"), ~L("A"),
                 L("A") & ~L("R"), ~L("Z")]
        return mod.LabelFilter(vt, conds[kind // 2 % len(conds)])
    age, score = mod.NumProp("age"), mod.NumProp("score")
    lo = int(rng.integers(0, PN // 4))
    w = int(rng.integers(1, PN // 8))
    conds = [age.between(lo, lo + w), age >= lo, age < lo + w,
             age.between(lo, lo + w) | (age == 2 * lo + 7),
             ~(age < lo), age.between(lo, lo + w) & (score >= 10)]
    return mod.NumericFilter(vt, conds[kind // 2 % len(conds)])


@pytest.mark.parametrize("tail", TAILS, indirect=True)
@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_pruned_retrieval_fuzz_over_partition_counts(tail, seed):
    """A random predicate over partition counts 1, 2 and 8 on both
    packages: ids equal the unpruned oracle, the meter is never above the
    oracle's, and meters and pruning counters equal the reference's at
    every count and engine."""
    rng = np.random.default_rng(seed)
    kind = int(rng.integers(0, 24))
    vs = np.sort(rng.choice(PN, int(rng.integers(1, 200)), replace=False))
    res = {}
    for mod, engs in ((T, ("numpy", "torch")), (J, ("numpy", "jax"))):
        adj, vt = _prune_graph(mod), _prune_vt(mod)
        col = _col(adj)
        filt = _predicate(mod, vt, kind, np.random.default_rng(seed + 99))
        m_un = mod.IOMeter()
        want = mod.retrieve_neighbors_batch(adj, vs, PTPS, m_un,
                                            engine="numpy") \
            .intersect(filt.pac(PTPS))
        filt.charge(m_un)
        rows = []
        for parts in (1, 2, 8):
            mod.partition_column(col, parts)
            for eng in engs:
                m = mod.IOMeter()
                got = mod.retrieve_neighbors_batch(adj, vs, PTPS, m, eng,
                                                   filter=filt)
                np.testing.assert_array_equal(got.to_ids(), want.to_ids())
                assert m.nbytes <= m_un.nbytes
                rows.append((parts, _meter(m),
                             _counters(mod.live_partitions(col))))
        res[mod] = (rows, col.prune_stats.as_dict())
    assert res[T] == res[J]


@pytest.mark.parametrize("tail", TAILS, indirect=True)
def test_delta_union_respects_all_three_granularities(tail):
    """Partition hulls and page zone maps on the base, segment zone maps on
    the mutable plane, one segment per partition: ids equal the exact
    oracle and the reference's, with the same counters."""
    res = {}
    for mod, eng in ((T, "torch"), (J, "jax")):
        from importlib import import_module
        seg = import_module(mod.__name__ + ".delta_segment")
        adj, vt = _prune_graph(mod), _prune_vt(mod)
        col = _col(adj)
        mod.partition_column(col, 4)
        delta = seg.attach_delta(adj)
        rng = np.random.default_rng(9)
        delta.ingest(rng.integers(0, PN, 64),
                     rng.integers(PN // 2, PN, 64))
        filt = mod.LabelFilter(vt, mod.L("A"))
        vs = np.arange(0, PN, 7)
        before = delta.segments_pruned
        got = mod.retrieve_neighbors_batch(adj, vs, PTPS, engine=eng,
                                           filter=filt)
        base = mod.retrieve_neighbors_batch(adj, vs, PTPS, engine="numpy")
        want = base.intersect(filt.pac(PTPS)).to_ids()
        np.testing.assert_array_equal(got.to_ids(), want)
        assert col.prune_stats.pages_pruned > 0
        assert delta.segments_pruned > before
        assert len(delta.segments) > 1      # one segment per partition
        res[mod] = (_words(got), sorted(delta.segments),
                    delta.segments_pruned, col.prune_stats.as_dict(),
                    _counters(mod.live_partitions(col)))
    assert res[T] == res[J]


# --------------------------- dispatch-cost plane ---------------------------

@pytest.mark.parametrize("tail", TAILS, indirect=True)
def test_sharded_steady_state_mints_no_shapes(tail):
    part = _adj(T)
    _set_parts(T, part, 2)
    rng = np.random.default_rng(37)
    batches = [rng.integers(0, N, s) for s in rng.integers(40, 64, size=8)]
    for vs in batches:                          # warm every size class
        T.retrieve_neighbors_batch(part, vs, TPS, engine="torch",
                                   fused=True, resident=True)
    before = _pad.shape_class_count()
    for vs in batches:
        T.retrieve_neighbors_batch(part, vs, TPS, engine="torch",
                                   fused=True, resident=True)
    assert _pad.shape_class_count() == before


def test_device_plan_placed_once_per_device_and_mesh():
    vals = np.sort(np.random.default_rng(41).integers(0, 1 << 20, 4 * PAGE))
    parts = T.partition_column(T.delta_encode_column(vals, PAGE), 2)
    single = parts.device_plan_single(CPU)
    assert parts.device_plan_single("cpu") is single
    assert parts.device_transfers == 1
    blocks = parts.device_plan((CPU, CPU))
    assert parts.device_plan((CPU, CPU)) is blocks
    # a mesh naming one device takes row views of its single placement
    assert parts.device_transfers == 1
    rows = parts.pmax
    for i, block in enumerate(blocks):
        for a, b in zip(block, single[0]):
            assert a.data_ptr() == b[i * rows:].data_ptr()
            assert a.shape[0] == rows
    assert all(p.device == CPU for p in parts.parts)
    assert parts.stats()["devices"] == ["cpu"]
    with pytest.raises(ValueError, match="does not divide"):
        parts.device_plan((CPU,) * 3)


def test_filter_plane_placed_once_per_mesh():
    plan = T.LabelFilter(_vt(T), T.L("A")).plan()
    planes = plan.device_bitmap_sharded((CPU,) * 4, plan.n_words)
    assert plan.device_bitmap_sharded((CPU,) * 4, plan.n_words) is planes
    assert len(planes) == 4 and all(p is planes[0] for p in planes)
    assert planes[0] is plan.device_bitmap(CPU, plan.n_words)
    assert plan.device_bitmap_sharded(CPU, plan.n_words)[0] is planes[0]


def test_env_default_partitions(monkeypatch):
    adj = _adj(T)
    monkeypatch.setattr(TP, "DEFAULT_PARTITIONS", 2)
    T.retrieve_neighbors_batch(adj, np.arange(16), TPS, engine="torch",
                               fused=True, resident=True)
    parts = T.live_partitions(_col(adj))
    assert parts is not None and parts.n_parts == 2
    # an explicit count wins over the default
    T.retrieve_neighbors_batch(adj, np.arange(16), TPS, engine="torch",
                               partitions=3)
    assert T.live_partitions(_col(adj)).n_parts == 3


# --- the partition cases of test_page_cache.py / test_core_tables.py -------

@pytest.mark.parametrize("engine", ("numpy", "torch"))
@pytest.mark.parametrize("seed", (0, 7, 23, 91))
def test_version_staleness_partitioned(engine, seed):
    """In-place page writes interleaved with warm-cache reads never serve
    stale rows on a partitioned column (the reference's
    ``test_version_staleness_seeded`` at 3 partitions)."""
    small = 32
    rng = np.random.default_rng(seed)
    mirror = np.sort(rng.integers(0, 1 << 20, 3 * small))
    col = T.delta_encode_column(np.asarray(mirror, np.int64), small)
    T.attach_page_cache(col, 64)
    T.partition_column(col, 3)
    orng = np.random.default_rng(seed + 1000)
    for _ in range(12):
        kind, arg = int(orng.integers(0, 3)), int(orng.integers(0, 10_000))
        if kind == 0:
            vals = np.sort(rng.integers(0, 1 << 20, small))
            col.append_page(T.delta_encode_page(vals))
            mirror = np.concatenate([mirror, vals])
        elif kind == 1:
            i = arg % len(col.pages)
            vals = np.sort(rng.integers(0, 1 << 20, small))
            col.set_page(i, T.delta_encode_page(vals))
            mirror = mirror.copy()
            mirror[i * small:(i + 1) * small] = vals
        else:
            lo = arg % max(col.count, 1)
            hi = min(lo + 1 + (arg % (2 * small)), col.count)
            got = TO.decode_row_ranges(col, np.asarray([lo]),
                                       np.asarray([hi]), None, engine)
            np.testing.assert_array_equal(got, mirror[lo:hi])
    got = TO.decode_row_ranges(col, np.asarray([0]), np.asarray([col.count]),
                               None, engine)
    np.testing.assert_array_equal(got, mirror)


def test_host_read_range_shares_the_partition_namespace():
    """``DeltaIntColumn.read_range`` (the single-vertex host path) probes
    and fills the ``(partition, page)`` keys, as the reference's does."""
    res = {}
    for mod in (T, J):
        adj = _adj(mod)
        mod.partition_column(_col(adj), 3)
        cache = mod.attach_page_cache(adj.table["<dst>"], 32)
        m = mod.IOMeter()
        for v in (3, 17, 999, 3):
            mod.retrieve_neighbors(adj, v, TPS, m, engine="numpy")
        res[mod] = (cache.stats(), list(cache._pages), _meter(m))
    assert res[T] == res[J]


# ------------------------------ serving stats ------------------------------

@pytest.mark.parametrize("n_parts", (2, 8))
def test_retriever_surfaces_partition_counters(n_parts):
    from _torch_serve import lake, retrieval_stats
    from repro.serve.retrieval import GraphRetriever as JGraphRetriever
    from repro_torch.serve.retrieval import GraphRetriever
    out = {}
    for mod, cls, eng in ((T, GraphRetriever, "torch"),
                          (J, JGraphRetriever, "jax")):
        _, adj, tok, lk = lake(mod, num_docs=300, page_size=128)
        vt = _vt(mod, {k: v for k, v in lk.labels.items()}, len(lk.tokens))
        r = cls(adj, tok, engine=eng, partitions=n_parts, hops=2,
                filter_vt=vt, filter_cond=mod.L(sorted(lk.labels)[0]))
        for s in range(3):
            r(np.random.default_rng(s).integers(0, 300, 12))
        st = retrieval_stats(r.stats())
        assert st["partitions"]["n_parts"] == n_parts
        assert st["partitions"]["dispatches"] >= 1
        out[mod] = st
    assert out[T] == out[J]


# ------------------------- rt_merge_hop's plain version ---------------------

def _merge_oracle(partial, fw, vis, n, g, n_sum):
    """numpy: the OR of the rows, AND fw, ANDNOT vis, and the summary."""
    p = np.bitwise_or.reduce(partial.view(np.uint32), axis=0)
    nxt = p & fw.view(np.uint32) & ~vis.view(np.uint32)
    bits = np.unpackbits(nxt.view(np.uint8), bitorder="little")[:n]
    groups = np.zeros(32 * n_sum, bool)
    groups[np.flatnonzero(nxt) >> g] = True
    summ = np.packbits(groups, bitorder="little").view(np.uint32)
    return nxt, summ, bits.astype(np.int32), vis.view(np.uint32) | nxt


@pytest.mark.parametrize("n_words", (1, 31, 33, 6144 * 32, 6144 * 32 + 1))
@pytest.mark.parametrize("mesh", (1, 3, 8))
def test_merge_hop_plain_version(n_words, mesh):
    rng = np.random.default_rng(n_words + mesh)
    n = 32 * n_words - int(rng.integers(0, 31))
    g, n_sum = TK._summary_shape(n_words)
    tail = (1 << (n - 32 * (n_words - 1))) - 1 if n % 32 else 0xFFFFFFFF
    sparse = rng.random((mesh, n_words)) < 0.05

    def words(shape, density=None):
        w = rng.integers(0, 1 << 32, shape, dtype=np.uint64) \
            .astype(np.uint32)
        if density is not None:
            w[~density] = 0
        w[..., -1] &= np.uint32(tail)
        return w.view(np.int32)
    partial = words((mesh, n_words), sparse)
    fw = words(n_words)
    vis = words(n_words, rng.random(n_words) < 0.5)
    t = torch.from_numpy
    visited = t(np.unpackbits(vis.view(np.uint32).view(np.uint8),
                              bitorder="little")[:n].astype(np.int32))
    out_w = torch.zeros(n_words, dtype=torch.int32)
    out_s = torch.zeros(n_sum, dtype=torch.int32)
    plane = torch.zeros(n, dtype=torch.int32)
    size = torch.zeros(1, dtype=torch.int32)
    vis_t = t(vis.copy())
    TK.merge_hop(t(partial), t(fw), vis_t, visited, out_w, out_s, g, plane,
                 size, n)
    nxt, summ, bits, vis_after = _merge_oracle(partial, fw, vis, n, g,
                                               n_sum)
    np.testing.assert_array_equal(out_w.numpy().view(np.uint32), nxt)
    np.testing.assert_array_equal(out_s.numpy().view(np.uint32), summ)
    np.testing.assert_array_equal(plane.numpy(), bits)
    np.testing.assert_array_equal(vis_t.numpy().view(np.uint32), vis_after)
    np.testing.assert_array_equal(
        visited.numpy(),
        np.unpackbits(vis_after.view(np.uint8), bitorder="little")[:n])
    assert int(size[0]) == int(bits.sum())
    # the plain summary agrees with the merge's
    np.testing.assert_array_equal(
        TR.summary_words(out_w, g, n_sum).numpy(), out_s.numpy())


# ------------------ test_serve_pipeline.py at 2 and 8 partitions -----------

def _serve(partitions, pipeline):
    from _torch_serve import lake, models, requests
    from repro_torch.serve import engine as TE
    from repro_torch.serve.retrieval import GraphRetriever
    cfg, _, _, tm = models()
    meter = T.IOMeter()
    _, adj, tok, _ = lake(T)
    retr = GraphRetriever(adj, tok, max_neighbors=2, tokens_per_neighbor=8,
                          meter=meter, engine="torch", page_cache_pages=64,
                          partitions=partitions)
    eng = TE.ServeEngine(tm, max_slots=3, max_len=96, eos_id=-1,
                         context_fn=retr, pipeline=pipeline)
    for r in requests(TE, cfg, adj, 10):
        eng.submit(r)
    return eng, retr, meter, eng.run_until_drained()


@pytest.mark.parametrize("partitions", (2, 8))
def test_pipelined_serving_over_partitions(partitions):
    """Pipelined equals sequential bit for bit over a partitioned column,
    and both equal the monolithic column's drain: requests, contexts,
    IOMeter and LRU counters."""
    from _torch_serve import assert_same_requests
    runs = [_serve(p, pipe) for p, pipe in
            ((partitions, False), (partitions, True), (1, False))]
    (_, r_s, m_s, f_s), (e_p, r_p, m_p, f_p), (_, r_m, m_m, f_m) = runs
    assert len(f_s) == len(f_p) == 10
    assert_same_requests(f_s, f_p)
    assert_same_requests(f_s, f_m)
    assert _meter(m_s) == _meter(m_p) == _meter(m_m)
    assert r_s.page_cache.stats() == r_p.page_cache.stats() == \
        r_m.page_cache.stats()
    assert e_p.stats()["pipeline"]["prefetch_hits"] > 0
    st = e_p.stats()["retrieval"]["partitions"]
    assert st["n_parts"] == partitions and st["dispatches"] > 0
    assert r_s.stats()["partitions"]["dispatches"] == st["dispatches"]
