"""The per-dispatch pack route (``REPRO_DEVICE_RESIDENT=0``) against the
JAX package.

Kernels: the plain versions of ``delta_decode``,
``fused_decode_bitmap_batch`` and ``fused_decode_filter_bitmap_batch``
(what the wrappers run for CPU tensors) are held against the reference's
jnp refs -- ``decode_pages_ref``, ``fused_batch_ref`` and
``fused_filter_batch_ref`` -- on one set of numpy arrays, including every
padding edge of the route: a warm dispatch with no miss pages (one zero
page), no LRU hits (one zero cached row), ``gidx`` entries past
``gcount`` and past the matrix, reads past a page's packed words, lanes
past the filter's row count, and a NOT that is not the program's last op.
One tiny case each also runs the Pallas kernels in interpret mode.

Route: ``retrieve_neighbors_batch(resident=False)``, ``decode_page_list``
with the module switch off and ``k_hop(resident=False)`` run on the JAX
package (engines ``numpy`` and ``jax``) and on the port (``numpy`` and
``torch``) over one seeded graph.  Every output is an integer: ids, PAC
words, IOMeter and LRU counters must be equal (bit for bit).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as RC
import repro_torch.core as TC
from repro.kernels.label_filter import kernel as RLK
from repro.kernels.label_filter import ops as RLO
from repro.kernels.label_filter import ref as RLR
from repro.kernels.pac_decode import kernel as RK
from repro.kernels.pac_decode import ops as RO
from repro.kernels.pac_decode import ref as RR
from repro_torch.kernels import _pad
from repro_torch.kernels.label_filter import kernel as LK
from repro_torch.kernels.pac_decode import kernel as K
from repro_torch.kernels.pac_decode import ops as O

torch.set_num_threads(1)

PAGE = 256
N_T = 1000            # filter rows: lanes in [N_T, 32 * NW) are forced off
NW = 36
N_PAGES = 6


def _values() -> np.ndarray:
    """Pages of sorted ids inside and past the target space, one of wide
    unsorted deltas (32-bit residuals, int32 wraparound), one constant
    page (width 0) and a partial tail page."""
    rng = np.random.default_rng(5)
    return np.concatenate([
        np.sort(rng.integers(0, 1200, 3 * PAGE)),
        rng.integers(-(1 << 30), 1 << 30, PAGE),
        np.full(PAGE, 700),
        np.cumsum(rng.integers(0, 9, 100)),
    ])


@pytest.fixture(scope="module")
def column():
    col = RC.delta_encode_column(_values(), PAGE)
    assert len(col.pages) == N_PAGES and col.pages[-1].count == 100
    return col, RC.pack_column(col)


@pytest.fixture(scope="module")
def labels():
    from repro_torch.data.synthetic import clustered_labels
    lab = clustered_labels(N_T, ["L0", "L1", "L2"], density=0.5,
                           run_scale=40, seed=4)
    return RC.VertexTable.build(
        RC.VertexTypeSchema("v", [], labels=["L0", "L1", "L2"]), {}, lab,
        num_vertices=N_T)


def _pad_rows(args, rows):
    return tuple(np.concatenate([a, np.zeros((rows - len(a),) + a.shape[1:],
                                             a.dtype)]) for a in args)


def _batch(col, rp, miss, hits, seed):
    """The arrays of one per-dispatch fused call, as the route builds them,
    with adversarial ``gidx`` entries added."""
    rng = np.random.default_rng(seed)
    m_pad = _pad.next_pow2(len(miss))
    args = _pad_rows(rp.gather(miss), m_pad)
    cached = np.zeros((_pad.next_pow2(len(hits)), PAGE), np.int32)
    for i, p in enumerate(hits):
        cached[i, :col.pages[p].count] = RC.delta_decode_page(col.pages[p])
    rows = [(i, col.pages[p].count) for i, p in enumerate(miss)] + \
        [(m_pad + i, col.pages[p].count) for i, p in enumerate(hits)]
    pos = [r * PAGE + int(rng.integers(0, c))
           for r, c in (rows[k] for k in rng.integers(0, len(rows), 300))]
    end = (m_pad + len(cached)) * PAGE
    pos += [end + 5, -7, end - 1]         # past the matrix: clamped
    total = len(pos)
    pos += list(rng.integers(-50, end + 50, 29))   # past gcount: ignored
    gidx = np.asarray(pos, np.int32)
    gcount = np.full((1, 1), total, np.int32)
    return args, cached, gidx, gcount


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in arrays]


BATCHES = {                  # miss pages, LRU-hit pages
    "cold": ([0, 1, 3, 4, 5], []),          # no hits: one zero cached row
    "mixed": ([1, 3], [0, 2, 4, 5]),
    "warm": ([], [0, 1, 2, 3, 4, 5]),       # no misses: one zero page
}


def test_decode_pages_matches_jnp_ref(column):
    col, rp = column
    args = list(_pad_rows(rp.host_arrays(), 8))
    # a page whose later miniblocks point past its packed words: only
    # deltas at or past count - 1 read there, and those are zeroed
    for a, v in zip(args, rp.gather([0])):
        a[6] = v[0]
    args[5][6, 0] = 40
    args[3][6, 2:] = args[4].shape[1] + 100
    got = K.delta_decode(*_torch(args), page_size=PAGE)
    want = RR.decode_pages_ref(*map(jnp.asarray, args), page_size=PAGE)
    assert got.dtype == torch.int32 and got.shape == (8, PAGE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, page in enumerate(col.pages):
        np.testing.assert_array_equal(got[i, :page.count].numpy(),
                                      RC.delta_decode_page(page))
    tiny = [a[[2, 5]] for a in args]
    np.testing.assert_array_equal(
        K.delta_decode(*_torch(tiny), page_size=PAGE).numpy(),
        np.asarray(RK.delta_decode_pallas(*map(jnp.asarray, tiny),
                                          page_size=PAGE)))


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_fused_batch_matches_jnp_ref(column, case):
    col, rp = column
    args, cached, gidx, gcount = _batch(col, rp, *BATCHES[case], seed=1)
    gw, gi = K.fused_decode_bitmap_batch(
        *_torch(args), *_torch([cached, gidx, gcount]), n_words=NW)
    ww, wi = RR.fused_batch_ref(
        *map(jnp.asarray, (*args, cached, gidx, gcount)), page_size=PAGE,
        n_words=NW)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gw.numpy().view(np.uint32),
                                  np.asarray(ww))
    assert np.asarray(ww).any()


COND = {
    "mix": lambda m: (m.L("L0") & m.L("L1")) | ~m.L("L2"),  # NOT mid-program
    "not_first": lambda m: ~m.L("L0") & m.L("L1"),
    "not_tail": lambda m: ~(m.L("L0") | m.L("L2")),
}


@pytest.mark.parametrize("cond", sorted(COND))
@pytest.mark.parametrize("case", sorted(BATCHES))
def test_fused_filter_batch_matches_jnp_ref(column, labels, case, cond):
    col, rp = column
    plan = RLO.make_plan(labels, COND[cond](RC))
    assert plan.program.ops == TC.compile_cond(COND[cond](TC)).ops
    args, cached, gidx, gcount = _batch(col, rp, *BATCHES[case], seed=2)
    gw, gi = LK.fused_decode_filter_bitmap_batch(
        *_torch(args), *_torch([cached, gidx, gcount, plan.pos, plan.meta]),
        plan.program.ops, NW)
    ww, wi = RLR.fused_filter_batch_ref(
        *map(jnp.asarray, (*args, cached, gidx, gcount, plan.pos,
                           plan.meta)),
        page_size=PAGE, n_words=NW, ops=plan.program.ops)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gw.numpy().view(np.uint32),
                                  np.asarray(ww))


def test_fused_kernels_match_pallas_interpret(column, labels):
    col, rp = column
    args, cached, gidx, gcount = _batch(col, rp, [1], [0, 5], seed=3)
    gw, gi = K.fused_decode_bitmap_batch(
        *_torch(args), *_torch([cached, gidx, gcount]), n_words=NW)
    ww, wi = RK.fused_decode_bitmap_batch(
        *map(jnp.asarray, (*args, cached, gidx, gcount)), page_size=PAGE,
        n_words=NW)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gw.numpy().view(np.uint32), np.asarray(ww))
    plan = RLO.make_plan(labels, COND["mix"](RC))
    gw, _ = LK.fused_decode_filter_bitmap_batch(
        *_torch(args), *_torch([cached, gidx, gcount, plan.pos, plan.meta]),
        plan.program.ops, NW)
    ww, _ = RLK.fused_decode_filter_bitmap_batch(
        *map(jnp.asarray, (*args, cached, gidx, gcount, plan.pos,
                           plan.meta)),
        page_size=PAGE, n_words=NW, ops=plan.program.ops)
    np.testing.assert_array_equal(gw.numpy().view(np.uint32), np.asarray(ww))


def test_decode_pages_and_packing_match_the_reference(column):
    col, rp = column
    tcol = TC.delta_encode_column(_values(), PAGE)
    for a, b in zip(O.pack_page_list(tcol, [1, 4, 5]),
                    RO.pack_page_list(col, [1, 4, 5])):
        np.testing.assert_array_equal(a, b)
    for p0, p1 in ((0, 6), (5, 6)):
        want = RO.decode_pages(col, p0, p1, use_pallas=False)
        got = O.decode_pages(tcol, p0, p1, engine="torch")
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------ the route ---------------------------------

N = 4000
GPAGE = 256
TPS = 512
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
    lab = clustered_labels(N, ["A", "B", "C"], density=0.4, run_scale=64,
                           seed=2)
    lab["Low"] = np.arange(N) < N // 4
    out = {}
    for mod in (RC, TC):
        adj = mod.build_adjacency(src, dst, N, N, mod.BY_SRC,
                                  mod.ENC_GRAPHAR, page_size=GPAGE)
        vt = mod.VertexTable.build(
            mod.VertexTypeSchema("v", [], labels=["A", "B", "C", "Low"]),
            {}, lab, num_vertices=N)
        out[mod] = (adj, vt)
    return out


@pytest.fixture
def switch_off(monkeypatch):
    """``REPRO_DEVICE_RESIDENT=0`` in both packages."""
    monkeypatch.setattr(RO, "DEVICE_RESIDENT", False)
    monkeypatch.setattr(O, "DEVICE_RESIDENT", False)


def _pac(pac):
    return [(p, pac.bitmaps[p].tolist()) for p in sorted(pac.bitmaps)]


def _lru(cache):
    return None if cache is None else (cache.hits, cache.misses,
                                       cache.evictions, len(cache))


def _kernels_run():
    return {k for k, v in _pad.shape_class_counts().items() if v}


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("cond", [None, "mix", "low"])
@pytest.mark.parametrize("batch,regime", [(8, "switch"), (40, "switch"),
                                          (40, "argument")])
def test_retrieval_identical_across_packages(graphs, monkeypatch, batch,
                                             regime, cond, cached):
    if regime == "switch":
        monkeypatch.setattr(RO, "DEVICE_RESIDENT", False)
        monkeypatch.setattr(O, "DEVICE_RESIDENT", False)
    vs = np.random.default_rng(batch + 3).integers(0, N, batch)
    _pad.reset_shape_classes()
    results = []
    for mod, engine in ENGINES:
        adj, vt = graphs[mod]
        enc = adj.table["<dst>"].encoded
        cache = mod.DecodedPageCache(64) if cached else None
        filt = mod.LabelFilter(vt, _cond(mod, cond)) if cond else None
        runs = []
        for _ in range(2 if cached else 1):       # cold, then warm
            enc.page_cache = cache
            meter = mod.IOMeter()
            pac = mod.retrieve_neighbors_batch(adj, vs, TPS, meter,
                                               engine=engine, filter=filt,
                                               resident=False)
            runs.append((_pac(pac), meter.nbytes, meter.nrequests,
                         _lru(cache)))
        enc.page_cache = None
        results.append(runs)
    for mod_engine, r in zip(ENGINES[1:], results[1:]):
        assert r == results[0], mod_engine
    if cached:
        assert results[0][1][3][0] > 0   # the warm run hit the LRU
    if batch < O.FUSED_MIN_RANGES:
        want = {"delta_decode"}
    else:
        want = {"fused_decode_filter_bitmap_batch" if cond
                else "fused_decode_bitmap_batch"}
    kernels = _kernels_run() - {"cond_bitmap"}
    assert kernels == want or (cached and kernels <= want)


def test_decode_page_list_identical_across_packages(graphs, switch_off):
    adj_r, _ = graphs[RC]
    adj_t, _ = graphs[TC]
    enc_r, enc_t = adj_r.table["<dst>"].encoded, adj_t.table["<dst>"].encoded
    lists = [[0, 3, 4, 9], [3, 4, 5], [1], list(range(0, 40, 3))]
    _pad.reset_shape_classes()
    for cached in (False, True):
        caches = (RC.DecodedPageCache(8), TC.DecodedPageCache(8)) \
            if cached else (None, None)
        enc_r.page_cache, enc_t.page_cache = caches
        for pages in lists:
            mr, mt = RC.IOMeter(), TC.IOMeter()
            want = RO.decode_page_list(enc_r, pages, engine="jax", meter=mr)
            got = O.decode_page_list(enc_t, pages, engine="torch", meter=mt)
            np.testing.assert_array_equal(got, want)
            assert (mt.nbytes, mt.nrequests) == (mr.nbytes, mr.nrequests)
            assert _lru(caches[1]) == _lru(caches[0])
    enc_r.page_cache = enc_t.page_cache = None
    assert _kernels_run() == {"delta_decode"}


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("filt", [None, "mix", "per_hop"])
@pytest.mark.parametrize("regime", ["argument", "switch"])
def test_k_hop_host_loop_identical_across_packages(graphs, monkeypatch,
                                                   regime, filt, cached):
    if regime == "switch":
        monkeypatch.setattr(RO, "DEVICE_RESIDENT", False)
        monkeypatch.setattr(O, "DEVICE_RESIDENT", False)
    seeds = np.random.default_rng(7).integers(0, N, 5)
    _pad.reset_shape_classes()
    results = []
    for mod, engine in ENGINES:
        adj, vt = graphs[mod]
        enc = adj.table["<dst>"].encoded
        cache = mod.DecodedPageCache(64) if cached else None
        f = {None: None, "mix": mod.LabelFilter(vt, _cond(mod, "mix")),
             "per_hop": [None, mod.LabelFilter(vt, _cond(mod, "low"))]}[filt]
        runs = []
        for _ in range(2 if cached else 1):
            enc.page_cache = cache
            meter = mod.IOMeter()
            ids = mod.k_hop(adj, seeds, 2, meter, engine=engine, filter=f,
                            resident=False)
            runs.append((ids.tolist(), meter.nbytes, meter.nrequests,
                         _lru(cache)))
        enc.page_cache = None
        results.append(runs)
    for mod_engine, r in zip(ENGINES[1:], results[1:]):
        assert r == results[0], mod_engine
    kernels = _kernels_run()
    assert "khop_scan" not in kernels          # the host loop ran
    # its hops decode through the module switch's route: resident=False
    # reaches the fused entries only
    assert ("delta_decode" if regime == "switch"
            else "gather_decode") in kernels


def test_module_switch_routes_k_hop_to_the_host_loop(graphs, switch_off):
    adj, _ = graphs[TC]
    _pad.reset_shape_classes()
    want = RC.k_hop(graphs[RC][0], np.array([3, 90]), 2, engine="numpy")
    got = TC.k_hop(adj, np.array([3, 90]), 2, engine="torch")
    np.testing.assert_array_equal(got, want)
    assert "khop_scan" not in _kernels_run()


def test_single_vertex_and_property_fetch(graphs, switch_off):
    for mod in (RC, TC):
        vt = graphs[mod][1]
        if "x" not in vt.table:
            vt.table.add(mod.PlainColumn("x", np.arange(N) * 3 % 1001,
                                         vt.page_size))
    for v in (0, 17, 1234, N - 1):
        vs = np.random.default_rng(v).integers(0, N, 20)
        want = None
        for mod, engine in ENGINES:
            adj, vt = graphs[mod]
            meter = mod.IOMeter()
            pac = mod.retrieve_neighbors(adj, v, TPS, meter, engine=engine)
            vals = mod.neighbor_properties(adj, v, vt, "x", meter,
                                           engine=engine)
            batch = mod.neighbor_properties_batch(adj, vs, vt, "x", meter,
                                                  engine=engine,
                                                  resident=False)
            scan = mod.retrieve_neighbors_scan(adj, v, TPS, meter)
            got = (_pac(pac), vals.tolist(), batch.tolist(), _pac(scan),
                   meter.nbytes, meter.nrequests)
            want = got if want is None else want
            assert got == want, (v, engine)
