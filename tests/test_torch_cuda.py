"""The traversal and per-dispatch kernels on the card, at the CPU tests'
small sizes.

Each CUDA kernel is held bit for bit against its plain PyTorch version on
the same CUDA tensors, and the cuda engine's ``k_hop``, ``two_hop_pac``,
``frontier_edge_counts`` and per-dispatch retrieval against the numpy
oracle (ids, counts, PACs, IOMeter and LRU counters).  Every test here needs an NVIDIA GPU and
``nvcc`` and skips without one; run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
from repro_torch.kernels._pad import next_pow2
from repro_torch.kernels.label_filter import kernel as LK
from repro_torch.kernels.label_filter import ops as LO
from repro_torch.kernels.pac_decode import kernel as PK
from repro_torch.kernels.pac_decode import ops as PO
from repro_torch.kernels.pac_decode import ref as PR
from repro_torch.kernels.traversal import kernel as K
from repro_torch.kernels.traversal import ops as TO
from repro_torch.kernels.traversal import ref as R

pytestmark = pytest.mark.cuda

N = 2000
PAGE = 256


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def graph():
    src, dst = powerlaw_graph(N, 6, seed=13)
    labels = clustered_labels(N, ["A", "B"], density=0.3, run_scale=64,
                              seed=7)
    adj = TC.build_adjacency(src, dst, N, N, TC.BY_SRC, TC.ENC_GRAPHAR,
                             page_size=PAGE)
    vt = TC.VertexTable.build(TC.VertexTypeSchema("v", [], labels=["A", "B"]),
                              {}, labels, num_vertices=N)
    return adj, vt


def _plan(dev, graph, padded):
    p = TO.traversal_plan(graph[0], "cuda")
    ks, voff = (t.clone() for t in p.device(dev))
    if padded:          # scattered padding keys, a last bound at rows_pad
        hit = torch.randperm(ks.shape[0], generator=torch.Generator()
                             .manual_seed(1))[:40].to(dev)
        ks[hit] = N
        voff[-1] = ks.shape[0]
    return ks, voff


def _words(dev, hops):
    rng = np.random.default_rng(hops)
    fw = rng.integers(0, 1 << 32, (hops, -(-N // 32)), dtype=np.uint64)
    fw = fw.astype(np.uint32)
    fw[:, -1] |= np.uint32(0xFFFF0000)      # bits set past N
    fw[0] = np.uint32(0xFFFFFFFF)
    return torch.from_numpy(fw.view(np.int32)).to(dev)


SEEDS = [5, 5, 17, 999, 1999, -3, N, N, 4 * N, N]


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("hops", [1, 2, 3])
def test_khop_kernel_equals_plain(dev, graph, hops, padded):
    ks, voff = _plan(dev, graph, padded)
    seeds = torch.tensor(SEEDS, dtype=torch.int32, device=dev)
    fw = _words(dev, hops)
    before = K.khop_scan.launches
    got = K.khop_scan(ks, voff, seeds, fw, N)
    want = R.khop_scan(ks, voff, seeds, fw, N)
    torch.cuda.synchronize()
    assert K.khop_scan.launches == before + hops
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2].sum()) > 0


@pytest.mark.parametrize("padded", [False, True])
def test_two_hop_kernel_equals_plain(dev, graph, padded):
    ks, voff = _plan(dev, graph, padded)
    seeds = torch.tensor(SEEDS, dtype=torch.int32, device=dev)
    fw = _words(dev, 2)[1]
    kw = dict(n_key=N, n_mid=N, n_out=N, n_words=-(-N // 32))
    got = K.two_hop(ks, voff, ks, voff, seeds, fw, **kw)
    want = R.two_hop(ks, voff, ks, voff, seeds, fw, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[1].any())


@pytest.mark.parametrize("bounds", [
    ([3, 100, 700, 1500], [40, 350, 900, 1600]),
    ([3, 20, 100, 110, 600], [50, 30, 400, 120, 2000]),   # overlapping
    ([10, 1990], [200, N]),                               # end == n_key
    ([-50, 5, -9999], [-1, 60, 12]),                      # normalised/dropped
])
def test_count_hop_kernel_equals_plain(dev, graph, bounds):
    ks, voff = _plan(dev, graph, False)
    s = np.full(8, N + 1, np.int32)
    e = np.full(8, N + 1, np.int32)
    s[:len(bounds[0])] = bounds[0]
    e[:len(bounds[1])] = bounds[1]
    s, e = torch.from_numpy(s).to(dev), torch.from_numpy(e).to(dev)
    got = K.count_hop(ks, voff, s, e, n_key=N, n_out=N)
    want = R.count_hop(ks, voff, s, e, n_key=N, n_out=N)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(want.max()) > 1


@pytest.mark.parametrize("kind", [None, "single", "per_hop"])
@pytest.mark.parametrize("hops", [2, 3])
def test_k_hop_cuda_equals_oracle(dev, graph, hops, kind):
    adj, vt = graph
    filt = TC.LabelFilter(vt, TC.L("A") | ~TC.L("B"))
    filt = {None: None, "single": filt,
            "per_hop": [None, filt, None][:hops]}[kind]
    enc = adj.table["<dst>"].encoded
    seeds = np.random.default_rng(hops).integers(0, N, 6)
    out = {}
    for engine, fused in (("cuda", None), ("numpy", False)):
        cache = TC.DecodedPageCache(24)
        runs = []
        for c in (None, cache, cache):
            enc.page_cache = c
            meter = TC.IOMeter()
            ids = TC.k_hop(adj, seeds, hops, meter, engine=engine,
                           filter=filt, fused=fused)
            runs.append((ids.tolist(), meter.nbytes, meter.nrequests,
                         c and (c.hits, c.misses, c.evictions)))
        enc.page_cache = None
        out[engine] = runs
    assert out["cuda"] == out["numpy"]
    plan = TO.traversal_plan(adj, "cuda")
    r0 = plan.device_roundtrips
    TC.k_hop(adj, seeds, hops, engine="cuda", filter=filt)
    assert plan.device_roundtrips == r0 + 1


def test_two_hop_pac_and_counts_equal_oracle(dev, graph):
    adj, vt = graph
    filt = TC.LabelFilter(vt, TC.L("A") | ~TC.L("B"))
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    pac = TO.two_hop_pac(adj, adj, [17], 256, filt, m_k, "cuda")
    created = TC.neighbor_ids_batch(adj, [17], m_o, engine="numpy")
    want = TC.retrieve_neighbors_batch(adj, created, 256, m_o, "numpy",
                                       filter=filt)
    assert pac == want and pac.count() > 0
    assert (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests)
    starts, ends = TC.LabelFilter(vt, TC.L("A")).intervals("numpy")
    off = np.asarray(adj.offsets["<offset>"].values, np.int64)
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    counts = TO.frontier_edge_counts(adj, starts, ends, off[starts],
                                     off[ends], m_k, "cuda")
    rows = TC.decode_edge_ranges(adj, off[starts], off[ends], m_o, "numpy")
    assert counts.tolist() == np.bincount(rows, minlength=N).tolist()
    assert (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests)


# ------------------------ the per-dispatch pack route ----------------------

def _shipped(dev, adj, miss, hits):
    """One per-dispatch fused call's tensors, built as the route builds
    them, with ``gidx`` entries past the matrix and past ``gcount``."""
    enc = adj.table["<dst>"].encoded
    m_pad = next_pow2(len(miss))
    args = PO._pad_pages(PO.pack_page_list(enc, miss), m_pad)
    cached = np.zeros((next_pow2(len(hits)), PAGE), np.int32)
    for i, p in enumerate(hits):
        cached[i, :enc.pages[p].count] = TC.delta_decode_page(enc.pages[p])
    rng = np.random.default_rng(len(miss))
    rows = [(i, p) for i, p in enumerate(miss)] + \
        [(m_pad + i, p) for i, p in enumerate(hits)]
    pos = [r * PAGE + int(rng.integers(0, enc.pages[p].count))
           for r, p in (rows[k] for k in rng.integers(0, len(rows), 500))]
    end = (m_pad + len(cached)) * PAGE
    pos += [end + 5, -7, end - 1]
    total = len(pos)
    pos += list(rng.integers(-50, end + 50, 21))
    return PO.ship_pages(args, dev) + tuple(
        torch.from_numpy(a).to(dev) for a in
        (cached, np.asarray(pos, np.int32), np.full((1, 1), total, np.int32)))


def test_delta_decode_kernel_equals_plain(dev, graph):
    enc = graph[0].table["<dst>"].encoded
    pages = list(range(len(enc.pages)))
    args = [a.copy() for a in PO._pad_pages(PO.pack_page_list(enc, pages),
                                            next_pow2(len(pages) + 1))]
    n = len(pages)
    for a in args:                    # a page reading past its words
        a[n] = a[0]
    args[5][n, 0] = 40
    args[3][n, 2:] = args[4].shape[1] + 100
    shipped = PO.ship_pages(tuple(args), dev)
    before = PK.delta_decode.launches
    got = PK.delta_decode(*shipped, page_size=PAGE)
    want = PR.decode_pages(*shipped, page_size=PAGE)
    torch.cuda.synchronize()
    assert PK.delta_decode.launches == before + 1
    assert torch.equal(got, want)
    for i, page in enumerate(enc.pages):
        assert got[i, :page.count].tolist() == \
            TC.delta_decode_page(page).tolist()


@pytest.mark.parametrize("cond", [None, "mix", "not_tail"])
@pytest.mark.parametrize("miss,hits", [([0, 2, 3, 7], []),
                                       ([1, 4], [0, 5, 6]),
                                       ([], [2, 3, 8])])
def test_fused_decode_kernels_equal_plain(dev, graph, miss, hits, cond):
    adj, vt = graph
    shipped = _shipped(dev, adj, miss, hits)
    n_words = -(-N // 32) + 2             # lanes past the filter's count
    if cond is None:
        fn, plain, extra = (PK.fused_decode_bitmap_batch, PR.fused_batch,
                            ())
    else:
        c = {"mix": (TC.L("A") & TC.L("B")) | ~TC.L("A"),
             "not_tail": ~(TC.L("A") | TC.L("B"))}[cond]
        plan = LO.make_plan(vt, c)
        extra = tuple(torch.from_numpy(a).to(dev)
                      for a in (plan.pos, plan.meta)) + (plan.program.ops,)
        fn = LK.fused_decode_filter_bitmap_batch
        from repro_torch.kernels.label_filter import ref as LR
        plain = LR.fused_filter_batch
    before = fn.launches
    got = fn(*shipped, *extra, n_words)
    want = plain(*shipped, *extra, n_words)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[0].any())


@pytest.mark.parametrize("cond", [None, "mix"])
@pytest.mark.parametrize("batch", [8, 40])
def test_per_dispatch_retrieval_cuda_equals_oracle(dev, graph, monkeypatch,
                                                   batch, cond):
    adj, vt = graph
    monkeypatch.setattr(PO, "DEVICE_RESIDENT", False)
    filt = TC.LabelFilter(vt, (TC.L("A") & TC.L("B")) | ~TC.L("A")) \
        if cond else None
    enc = adj.table["<dst>"].encoded
    vs = np.random.default_rng(batch).integers(0, N, batch)
    out = {}
    for engine in ("cuda", "numpy"):
        cache = TC.DecodedPageCache(24)
        runs = []
        for c in (None, cache, cache):
            enc.page_cache = c
            meter = TC.IOMeter()
            pac = TC.retrieve_neighbors_batch(adj, vs, 256, meter, engine,
                                              filter=filt)
            runs.append((sorted((p, w.tolist())
                                for p, w in pac.bitmaps.items()),
                         meter.nbytes, meter.nrequests,
                         c and (c.hits, c.misses, c.evictions)))
        enc.page_cache = None
        out[engine] = runs
    assert out["cuda"] == out["numpy"]
