"""The traversal plane: fused k-hop, IC-8's two-hop chain, BI-2's counting
expansion.

The same seeded inputs go through the JAX package and the port.  The
plain kernel versions (``repro_torch.kernels.traversal.ref``) are held
against the JAX package's jnp references (which the reference's own tests
tie to its Pallas kernels); ``k_hop``, ``two_hop_pac`` and
``frontier_edge_counts`` run on the JAX package (engines ``numpy`` and
``jax``) and on the port (engines ``numpy`` and ``torch``).  Ids, words,
counts, IOMeter and LRU counters must be identical (exact equality).
"""
import numpy as np
import pytest
import torch
from _torch_cases import (COUNT_HOP_CASES, KHOP_CASES, NE, TWO_HOP_CASES,
                          count_hop_edge_case, khop_edge_case,
                          two_hop_edge_case)

import repro.core as RC
import repro_torch.core as TC
from repro.kernels.traversal import ops as RO
from repro.kernels.traversal import ref as JR
from repro_torch.kernels import _pad
from repro_torch.kernels.traversal import ops as TO
from repro_torch.kernels.traversal import ref as TR

torch.set_num_threads(1)

N = 2000
PAGE = 256
ENGINES = [(RC, "numpy"), (RC, "jax"), (TC, "numpy"), (TC, "torch")]


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    """A result of either package as a numpy array; uint32 words held in
    int32 tensors are compared as their bit patterns."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def graphs():
    from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
    src, dst = powerlaw_graph(N, 6, seed=13)
    labels = clustered_labels(N, ["A", "B"], density=0.3, run_scale=64,
                              seed=7)
    out = {}
    for mod in (RC, TC):
        adj = mod.build_adjacency(src, dst, N, N, mod.BY_SRC,
                                  mod.ENC_GRAPHAR, page_size=PAGE)
        vt = mod.VertexTable.build(
            mod.VertexTypeSchema("v", [], labels=["A", "B"]), {}, labels,
            num_vertices=N)
        out[mod] = (adj, vt)
    return out


@pytest.fixture(scope="module")
def plan(graphs):
    """The port's plan arrays (equal to the reference's, asserted)."""
    adj_r, _ = graphs[RC]
    adj_t, _ = graphs[TC]
    p_r = RO.traversal_plan(adj_r, "jax")
    p_t = TO.traversal_plan(adj_t, "torch")
    np.testing.assert_array_equal(p_t.key_sorted, p_r.key_sorted)
    np.testing.assert_array_equal(p_t.voff, p_r.voff)
    np.testing.assert_array_equal(p_t.host_vals, p_r.host_vals)
    return p_t.key_sorted, p_t.voff


def _padded_plan(ks, voff, rng):
    """The plan with extra padding keys scattered over the rows (and one
    above the key space), and the last segment stretched to ``rows_pad``
    so one bound reads the clamped last word under a zero mask."""
    ks = ks.copy()
    hit = rng.choice(len(ks), 40, replace=False)
    ks[hit[:30]] = N
    ks[hit[30:]] = N + 7
    voff = voff.copy()
    voff[-1] = len(ks)
    assert len(ks) % 32 == 0
    return ks, voff


def _filter_words(rng, hops):
    """Random predicate words with bits set past N in the last word."""
    n_words = -(-N // 32)
    fw = rng.integers(0, 1 << 32, (hops, n_words), dtype=np.uint64)
    fw = fw.astype(np.uint32)
    fw[:, -1] |= np.uint32(0xFFFF0000)
    fw[0] = np.uint32(0xFFFFFFFF)
    return fw


SEEDS = np.array([5, 5, 17, 999, 1999, -3, N, N, 4 * N, N], np.int32)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("hops", [1, 2, 3])
def test_khop_scan_equals_reference(plan, hops, padded):
    rng = np.random.default_rng(hops + 10 * padded)
    ks, voff = _padded_plan(*plan, rng) if padded else plan
    fw = _filter_words(rng, hops)
    want = JR.khop_scan_ref(_jnp(ks), _jnp(voff), _jnp(SEEDS), _jnp(fw),
                            n_out=N)
    got = TR.khop_scan(_t(ks), _t(voff), _t(SEEDS), _t(fw.view(np.int32)),
                       N)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert _np(got[1]).sum() > 0            # the hops discovered something


@pytest.mark.parametrize("case", KHOP_CASES)
def test_khop_scan_edge_cases_equal_reference(case):
    ks, voff, seeds, fw = khop_edge_case(case)
    want = JR.khop_scan_ref(_jnp(ks), _jnp(voff), _jnp(seeds),
                            _jnp(fw.view(np.uint32)), n_out=NE)
    got = TR.khop_scan(_t(ks), _t(voff), _t(seeds), _t(fw), NE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))
    sizes = _np(got[2])
    if case == "segments":
        assert sizes.min() > 0
    elif case == "hub_last_row":
        assert _np(got[1])[0, 5] == 1
    else:
        assert sizes.sum() == 0


@pytest.mark.parametrize("padded", [False, True])
def test_two_hop_equals_reference(plan, padded):
    rng = np.random.default_rng(5 + padded)
    ks, voff = _padded_plan(*plan, rng) if padded else plan
    n_words = -(-N // 32)
    fw = _filter_words(rng, 1)[0]
    fw[0] = np.uint32(0x0F0F0F0F)
    kw = dict(n_key=N, n_mid=N, n_out=N, n_words=n_words)
    want = JR.two_hop_ref(_jnp(ks), _jnp(voff), _jnp(ks), _jnp(voff),
                          _jnp(SEEDS), _jnp(fw), **kw)
    got = TR.two_hop(_t(ks), _t(voff), _t(ks), _t(voff), _t(SEEDS),
                     _t(fw.view(np.int32)), **kw)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]).view(np.uint32),
                                  _np(want[1]))
    assert _np(want[1]).any()


@pytest.mark.parametrize("case", TWO_HOP_CASES)
def test_two_hop_edge_cases_equal_reference(case):
    ks_a, voff_a, ks_b, voff_b, seeds, fw, kw = two_hop_edge_case(case)
    want = JR.two_hop_ref(_jnp(ks_a), _jnp(voff_a), _jnp(ks_b), _jnp(voff_b),
                          _jnp(seeds), _jnp(fw.view(np.uint32)), **kw)
    got = TR.two_hop(_t(ks_a), _t(voff_a), _t(ks_b), _t(voff_b), _t(seeds),
                     _t(fw), **kw)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]).view(np.uint32),
                                  _np(want[1]))
    mid, words = _np(got[0]), _np(got[1]).view(np.uint32)
    if case == "zero_filter":
        assert mid.any() and not words.any()
    else:
        assert words.any()
    if case == "hub_last_row":
        assert mid[5] == 1
    if case == "few_targets":           # the words past the targets
        assert not words[1:].any()


@pytest.mark.parametrize("case", COUNT_HOP_CASES)
def test_count_hop_edge_cases_equal_reference(case):
    ks, voff, starts, ends, kw = count_hop_edge_case(case)
    want = JR.count_hop_ref(_jnp(ks), _jnp(voff), _jnp(starts), _jnp(ends),
                            **kw)
    got = TR.count_hop(_t(ks), _t(voff), _t(starts), _t(ends), **kw)
    np.testing.assert_array_equal(_np(got), _np(want))
    counts = _np(got)
    if case == "no_interval":
        assert not counts.any()
    else:
        assert counts.max() > 1
    if case == "hub_last_row":
        assert counts[5] >= 1
    if case == "every_key":     # every row with a key in range counts
        assert counts.sum() == (ks[:voff[-1]] < kw["n_key"]).sum()


@pytest.mark.parametrize("case", ["disjoint", "overlap", "end_at_n_key",
                                  "negative"])
def test_count_hop_equals_reference(plan, case):
    ks, voff = plan
    s = [3, 100, 700, 1500]
    e = [40, 350, 900, 1600]
    if case == "overlap":
        s, e = [3, 20, 100, 110, 600], [50, 30, 400, 120, 2000]
    elif case == "end_at_n_key":
        s, e = [10, 1990], [200, N]
    elif case == "negative":              # normalised once, or dropped
        s, e = [-50, 5, -9999], [-1, 60, 12]
    i_pad = 8
    starts = np.full(i_pad, N + 1, np.int32)
    ends = np.full(i_pad, N + 1, np.int32)
    starts[:len(s)] = s
    ends[:len(e)] = e
    want = JR.count_hop_ref(_jnp(ks), _jnp(voff), _jnp(starts), _jnp(ends),
                            n_key=N, n_out=N)
    got = TR.count_hop(_t(ks), _t(voff), _t(starts), _t(ends), n_key=N,
                       n_out=N)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _np(want).max() > 1               # multiplicity survives


def test_expand_counts_rank_edges(plan):
    """A random frontier over a segment layout with an empty segment and
    a last bound at ``rows_pad``."""
    ks, voff = plan
    rng = np.random.default_rng(3)
    frontier = rng.integers(0, 2, N).astype(np.int32)
    v = voff.copy()
    v[5] = v[6]                              # an empty segment
    v[-1] = len(ks)
    want = JR.expand_counts(_jnp(ks), _jnp(v), _jnp(frontier))
    got = TR.expand_counts(_t(ks), _t(v), _t(frontier))
    np.testing.assert_array_equal(_np(got), _np(want))


# ------------------------------- the slice --------------------------------

def _cond(mod, name):
    return {"A": mod.L("A"), "mix": mod.L("A") | ~mod.L("B")}[name]


def _filters(mod, vt, kind, hops):
    if kind is None:
        return None
    if kind == "single":
        return mod.LabelFilter(vt, _cond(mod, "mix"))
    lut = [None, mod.LabelFilter(vt, _cond(mod, "A")),
           mod.LabelFilter(vt, _cond(mod, "mix"))]
    return [lut[h % 3] for h in range(hops)]


def _lru(cache):
    return None if cache is None else (cache.hits, cache.misses,
                                       cache.evictions, len(cache))


@pytest.mark.parametrize("kind", [None, "single", "per_hop"])
@pytest.mark.parametrize("hops", [1, 2, 3])
def test_k_hop_identical_across_packages(graphs, hops, kind):
    seeds = np.random.default_rng(hops).integers(0, N, 6)
    results = []
    for mod, engine in ENGINES:
        adj, vt = graphs[mod]
        enc = adj.table["<dst>"].encoded
        filt = _filters(mod, vt, kind, hops)
        runs = []
        for fused in (None, False):
            for include in (True, False):
                for mode in ("none", "meter", "lru"):
                    cache = mod.DecodedPageCache(24) if mode == "lru" \
                        else None
                    for _ in range(2 if cache is not None else 1):
                        enc.page_cache = cache
                        meter = mod.IOMeter() if mode != "none" else None
                        ids = mod.k_hop(adj, seeds, hops, meter,
                                        engine=engine, filter=filt,
                                        include_seeds=include, fused=fused)
                        runs.append((ids.tolist(),
                                     meter and (meter.nbytes,
                                                meter.nrequests),
                                     _lru(cache)))
                    enc.page_cache = None
        results.append(runs)
    for mod_engine, r in zip(ENGINES[1:], results[1:]):
        assert r == results[0], mod_engine
    assert len(results[0][0][0]) > len(set(seeds.tolist()))
    assert results[0][3][2][0] > 0           # the warm run hit the LRU


def test_k_hop_fused_is_the_default_and_counted(graphs):
    """The fused route serves ``engine="torch"`` by default, counts one
    dispatch and ``hops`` fused hops, and its sizes equal the
    reference's."""
    sizes = []
    for mod, engine, ops in ((RC, "jax", RO), (TC, "torch", TO)):
        adj, vt = graphs[mod]
        filt = mod.LabelFilter(vt, _cond(mod, "A"))
        mod.k_hop(adj, np.array([3]), 3, engine=engine)   # build the plan
        p = ops.traversal_plan(adj, engine)
        d0, r0, h0 = p.dispatches, p.device_roundtrips, p.hops_fused
        mod.k_hop(adj, np.array([17, 999]), 3, engine=engine,
                  filter=[None, filt, None])
        assert p.dispatches == d0 + 1
        assert p.device_roundtrips == r0 + 1          # no per-hop trips
        assert p.hops_fused == h0 + 3
        sizes.append(p.last_frontier_sizes.tolist())
        meter = mod.IOMeter()
        mod.k_hop(adj, np.array([17, 999]), 3, meter, engine=engine)
        assert p.device_roundtrips == r0 + 3          # + the replay's copy
    assert sizes[0] == sizes[1] and len(sizes[1]) == 3


def test_traversal_stats_equal_reference():
    stats = []
    for mod, engine, ops in ((RC, "jax", RO), (TC, "torch", TO)):
        adj = _fresh_adj(mod)
        assert ops.traversal_stats(adj) is None
        mod.k_hop(adj, np.array([3]), 2, engine=engine)
        mod.k_hop(adj, np.array([3, 40]), 3, mod.IOMeter(), engine=engine)
        stats.append(ops.traversal_stats(adj))
    assert stats[0] == stats[1]
    assert stats[1]["traversal_device_roundtrips"] == 3


def _fresh_adj(mod):
    from repro_torch.data.synthetic import powerlaw_graph
    src, dst = powerlaw_graph(N, 6, seed=13)
    return mod.build_adjacency(src, dst, N, N, mod.BY_SRC, mod.ENC_GRAPHAR,
                               page_size=PAGE)


def test_steady_state_keeps_shape_classes_flat(graphs):
    adj, vt = graphs[TC]
    filt = TC.LabelFilter(vt, _cond(TC, "mix"))
    rng = np.random.default_rng(37)
    batches = [rng.integers(0, N, s) for s in rng.integers(2, 40, size=10)]
    for vs in batches:                     # warm the one size class
        TC.k_hop(adj, vs, 2, engine="torch", filter=filt)
    before = _pad.shape_class_count()
    for _ in range(3):
        for vs in batches:
            TC.k_hop(adj, vs, 2, engine="torch", filter=filt)
    assert _pad.shape_class_count() == before
    assert _pad.shape_class_counts()["khop_scan"] >= 1


def test_unported_routes_raise(graphs):
    """The numpy engine still refuses the fused route; ``partitions=2``,
    once the partition plane's raise, now partitions the column, with ids,
    IOMeter and ``traversal_stats`` equal to the reference's (fresh
    adjacencies: the fixture's are shared)."""
    adj, _ = graphs[TC]
    with pytest.raises(ValueError, match="kernel engine"):
        TC.k_hop(adj, np.array([0]), 2, engine="numpy", fused=True)
    from repro_torch.data.synthetic import powerlaw_graph
    src, dst = powerlaw_graph(N, 6, seed=13)
    out = {}
    for mod, eng in ((RC, "jax"), (TC, "torch")):
        fresh = mod.build_adjacency(src, dst, N, N, mod.BY_SRC,
                                    mod.ENC_GRAPHAR, page_size=PAGE)
        m = mod.IOMeter()
        ids = mod.k_hop(fresh, np.array([0, 17, 999]), 2, m, engine=eng,
                        filter=mod.LabelFilter(graphs[mod][1], mod.L("A")),
                        partitions=2)
        parts = mod.live_partitions(fresh.table["<dst>"].encoded)
        out[mod] = (ids.tolist(), m.nbytes, m.nrequests, parts.n_parts,
                    parts.dispatches,
                    (RO if mod is RC else TO).traversal_stats(fresh))
    assert out[TC] == out[RC]


# ----------------------- IC-8's chain and BI-2's count ---------------------

@pytest.fixture(scope="module")
def chain():
    """A of 300 keys -> 500 values, B of 500 keys -> 400 values, and a
    label table over B's 400 values."""
    from repro_torch.data.synthetic import clustered_labels
    rng = np.random.default_rng(11)
    a_src, a_dst = rng.integers(0, 300, 1500), rng.integers(0, 500, 1500)
    b_src, b_dst = rng.integers(0, 500, 2500), rng.integers(0, 400, 2500)
    labels = clustered_labels(400, ["R"], density=0.5, run_scale=16,
                              seed=3)
    out = {}
    for mod in (RC, TC):
        adj_a = mod.build_adjacency(a_src, a_dst, 300, 500, mod.BY_SRC,
                                    mod.ENC_GRAPHAR, page_size=64)
        adj_b = mod.build_adjacency(b_src, b_dst, 500, 400, mod.BY_SRC,
                                    mod.ENC_GRAPHAR, page_size=64)
        vt = mod.VertexTable.build(mod.VertexTypeSchema("m", [],
                                                        labels=["R"]),
                                   {}, labels, num_vertices=400)
        out[mod] = (adj_a, adj_b, vt)
    return out


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("mode", ["none", "meter", "lru"])
def test_two_hop_pac_identical_to_reference(chain, filtered, mode):
    out = []
    for mod, engine, ops in ((RC, "jax", RO), (TC, "torch", TO)):
        adj_a, adj_b, vt = chain[mod]
        filt = mod.LabelFilter(vt, mod.L("R")) if filtered else None
        cols = [a.table["<dst>"].encoded for a in (adj_a, adj_b)]
        caches = [mod.DecodedPageCache(8) if mode == "lru" else None
                  for _ in cols]
        runs = []
        for seeds in ([7], [7, 8, 150, 299], [7]):
            for c, cache in zip(cols, caches):
                c.page_cache = cache
            meter = mod.IOMeter() if mode != "none" else None
            pac = ops.two_hop_pac(adj_a, adj_b, seeds, 128, filt, meter,
                                  engine)
            runs.append(([(p, pac.bitmaps[p].tolist())
                          for p in sorted(pac.bitmaps)],
                         meter and (meter.nbytes, meter.nrequests),
                         [_lru(c) for c in caches]))
        for c in cols:
            c.page_cache = None
        out.append(runs)
    assert out[0] == out[1]
    assert any(r[0] for r in out[1])


@pytest.mark.parametrize("mode", ["none", "meter", "lru"])
def test_frontier_edge_counts_identical_to_reference(graphs, mode):
    out = []
    for mod, engine, ops in ((RC, "jax", RO), (TC, "torch", TO)):
        adj, vt = graphs[mod]
        enc = adj.table["<dst>"].encoded
        starts, ends = mod.LabelFilter(vt, mod.L("A")).intervals("numpy")
        off = adj.offsets["<offset>"]
        cache = mod.DecodedPageCache(6) if mode == "lru" else None
        runs = []
        for _ in range(2):
            enc.page_cache = cache
            meter = mod.IOMeter() if mode != "none" else None
            bounds = np.asarray(off.read_rows_concat(
                np.concatenate([starts, ends]),
                np.concatenate([starts, ends]) + 1, meter), np.int64)
            los, his = bounds[:len(starts)], bounds[len(starts):]
            counts = ops.frontier_edge_counts(adj, starts, ends, los, his,
                                              meter, engine)
            runs.append((counts.tolist(),
                         meter and (meter.nbytes, meter.nrequests),
                         _lru(cache)))
        enc.page_cache = None
        out.append(runs)
        if mod is TC:                       # the counts are BI-2's oracle
            rows = TC.decode_edge_ranges(adj, los, his, engine="numpy")
            assert runs[0][0] == np.bincount(rows, minlength=N).tolist()
    assert out[0] == out[1]
    assert max(out[1][0][0]) > 1


# ------------------------- Frontier and mask_ids ---------------------------

def test_frontier_identical_to_reference():
    from repro.core.frontier import ids_to_words as r_words
    from repro.core.frontier import plane_to_words as r_plane
    from repro_torch.core.frontier import ids_to_words, plane_to_words
    ids = np.array([1, 5, 64, 1999])
    plane = np.zeros(N, np.int32)
    plane[[0, 31, 32, 1999]] = 1
    np.testing.assert_array_equal(ids_to_words(ids, N), r_words(ids, N))
    np.testing.assert_array_equal(plane_to_words(plane), r_plane(plane))
    got, want = [], []
    for mod, out in ((RC, want), (TC, got)):
        f = mod.Frontier.from_ids(ids, N)
        g = mod.Frontier.from_ids(np.array([5, 7]), N)
        d = mod.Frontier.from_dense_plane(plane)
        u = f.copy().or_(g)
        out.append(u.to_ids().tolist())
        out.append(u.andnot(g).to_ids().tolist())
        out.append(u.and_(mod.Frontier.from_ids([64], N)).to_ids().tolist())
        out.append((len(f), 64 in f, 63 in f, d.to_ids().tolist()))
        out.append([(p, b.tolist()) for p, b in
                    sorted(d.set_ids([77]).to_pac(64).bitmaps.items())])
        with pytest.raises(ValueError):
            f.or_(mod.Frontier.from_ids(np.array([0]), N + 1))
    assert got == want


def test_frontier_device_plane_is_cached_and_invalidated():
    ids = np.array([0, 31, 32, 255, 256])
    f = TC.Frontier.from_ids(ids, 512)
    cpu = torch.device("cpu")
    p1 = f.device_plane(cpu)
    assert p1.dtype == torch.int32 and p1.shape == (512,)
    assert f.device_plane(cpu) is p1
    assert f.device_stats()["transfers"] == 1
    np.testing.assert_array_equal(np.flatnonzero(p1.numpy()), ids)
    f.set_ids(np.array([7]))
    assert f.device_plane(cpu) is not p1


def test_mask_ids_identical_to_reference(graphs):
    ids = np.random.default_rng(4).integers(0, N, 300)
    masks = []
    for mod, engines in ((RC, ("numpy", "jax")), (TC, ("numpy", "torch"))):
        _, vt = graphs[mod]
        filt = mod.LabelFilter(vt, _cond(mod, "mix"))
        masks += [filt.mask_ids(ids, e).tolist() for e in engines]
    assert all(m == masks[0] for m in masks) and any(masks[0])
