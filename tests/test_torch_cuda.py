"""The resident, traversal, per-dispatch and single-range kernels on the
card, at the CPU tests' small sizes.

Each CUDA kernel is held bit for bit against its plain PyTorch version on
the same CUDA tensors, and the cuda engine's ``k_hop``, ``two_hop_pac``,
``frontier_edge_counts``, per-dispatch retrieval, the single-range,
RLE-label and selection entries, numeric-filtered retrieval and the
mutable plane's reads (rows pending, page writes, a poisoned mirror and
its heal, a compaction) and the partition plane's two tails (the
single-shard tail, and the multi-device tail on a mesh naming the card
several times, with its launches counted per mesh entry) against the
numpy oracle (ids, counts, values, PACs, IOMeter and LRU counters);
``rt_merge_hop`` against its plain version and the sharded k-hop against
``khop_scan``.
The flash attention kernel is held against its plain version at every
head dim it is built for, in float32 and bfloat16, and a reduced LM's
flash route against its plain route.
Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one;
run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch
from _torch_cases import (COND_CASES, COUNT_HOP_CASES, FUSED_PROGRAMS,
                          FUSED_WORDS, FWORDS_KINDS, KHOP_CASES, NE,
                          PAGE_SIZES, RESIDENT_CASES, RLE_CASES, SELECT_CASES,
                          SINGLE_IDS_KINDS, SINGLE_RANGE_KINDS,
                          SINGLE_RANGE_PAGE_SIZES, SINGLE_RANGE_WINDOWS,
                          TWO_HOP_CASES, cond_case, count_hop_edge_case,
                          fused_case, khop_edge_case, page_case,
                          resident_case, resident_fwords, rle_case, rle_rows,
                          select_case, single_ids_case, single_range_case,
                          two_hop_edge_case)

import repro_torch.core as TC
from repro_torch.configs import get_config
from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
from repro_torch.kernels._pad import next_pow2
from repro_torch.kernels.bitmap_select import kernel as BK
from repro_torch.kernels.bitmap_select import ops as BO
from repro_torch.kernels.bitmap_select import ref as BR
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.kernels.flash_attention import ops as AO
from repro_torch.kernels.flash_attention import ref as AR
from repro_torch.kernels.label_filter import kernel as LK
from repro_torch.kernels.label_filter import ops as LO
from repro_torch.kernels.label_filter import ref as LR
from repro_torch.kernels.pac_decode import kernel as PK
from repro_torch.kernels.pac_decode import ops as PO
from repro_torch.kernels.pac_decode import ref as PR
from repro_torch.kernels.rle_filter import kernel as FK
from repro_torch.kernels.rle_filter import ops as FO
from repro_torch.kernels.rle_filter import ref as FR
from repro_torch.kernels.traversal import kernel as K
from repro_torch.kernels.traversal import ops as TO
from repro_torch.kernels.traversal import ref as R
from repro_torch.models import build_model

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
    assert K.khop_scan.launches == before + hops + 1  # seeds, then hops
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2].sum()) > 0


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("case", KHOP_CASES)
def test_khop_kernel_edge_cases_equal_plain(dev, monkeypatch, case, coarse):
    if coarse:          # a summary bit for every 8 frontier words
        monkeypatch.setattr(K, "_summary_shape",
                            lambda nw: (3, ((nw - 1) >> 3) // 32 + 1))
    ks, voff, seeds, fw = (torch.from_numpy(a).to(dev)
                           for a in khop_edge_case(case))
    got = K.khop_scan(ks, voff, seeds, fw, NE)
    want = R.khop_scan(ks, voff, seeds, fw, NE)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "hub_last_row":
        assert int(want[1][0, 5]) == 1


def test_khop_kernel_refuses_misaligned_rows(dev):
    ks, voff, seeds, fw = (torch.from_numpy(a).to(dev)
                           for a in khop_edge_case("segments"))
    shifted = torch.empty(ks.shape[0] + 1, dtype=torch.int32, device=dev)
    shifted[1:] = ks            # the same rows, 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.khop_scan(shifted[1:], voff, seeds, fw, NE)


@pytest.mark.parametrize("past_count", [False, True])
@pytest.mark.parametrize("case", COND_CASES)
def test_cond_bitmap_kernel_equals_plain(dev, case, past_count):
    pos, meta, ops = cond_case(case)
    n_words = -(-int(meta[0, 1]) // 32) + (5 if past_count else 0)
    pos, meta = torch.from_numpy(pos).to(dev), torch.from_numpy(meta).to(dev)
    before = LK.cond_bitmap.launches
    got = LK.cond_bitmap(pos, meta, ops, n_words)
    want = LR.cond_bitmap(pos, meta, ops, n_words)
    torch.cuda.synchronize()
    assert LK.cond_bitmap.launches == before + 1
    assert torch.equal(got, want) and bool(want.any())


@pytest.mark.parametrize("padded", [False, True])
def test_two_hop_kernel_equals_plain(dev, graph, padded):
    ks, voff = _plan(dev, graph, padded)
    seeds = torch.tensor(SEEDS, dtype=torch.int32, device=dev)
    fw = _words(dev, 2)[1]
    kw = dict(n_key=N, n_mid=N, n_out=N, n_words=-(-N // 32))
    before = K.two_hop.launches
    got = K.two_hop(ks, voff, ks, voff, seeds, fw, **kw)
    want = R.two_hop(ks, voff, ks, voff, seeds, fw, **kw)
    torch.cuda.synchronize()
    assert K.two_hop.launches == before + 3     # seeds, A, B
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[1].any())


def _coarse(monkeypatch, coarse):
    """With ``coarse``, a frontier summary bit for every 8 words."""
    if coarse:
        monkeypatch.setattr(K, "_summary_shape",
                            lambda nw, *cap: (3, ((nw - 1) >> 3) // 32 + 1)
                            if nw else (0, 0))


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("case", TWO_HOP_CASES)
def test_two_hop_kernel_edge_cases_equal_plain(dev, monkeypatch, case,
                                               coarse):
    _coarse(monkeypatch, coarse)
    ks_a, voff_a, ks_b, voff_b, seeds, fw, kw = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in two_hop_edge_case(case))
    before = K.two_hop.launches
    got = K.two_hop(ks_a, voff_a, ks_b, voff_b, seeds, fw, **kw)
    want = R.two_hop(ks_a, voff_a, ks_b, voff_b, seeds, fw, **kw)
    torch.cuda.synchronize()
    assert K.two_hop.launches == before + 3
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("case", COUNT_HOP_CASES)
def test_count_hop_kernel_edge_cases_equal_plain(dev, monkeypatch, case,
                                                 coarse):
    _coarse(monkeypatch, coarse)
    ks, voff, starts, ends, kw = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in count_hop_edge_case(case))
    before = K.count_hop.launches
    got = K.count_hop(ks, voff, starts, ends, **kw)
    want = R.count_hop(ks, voff, starts, ends, **kw)
    torch.cuda.synchronize()
    assert K.count_hop.launches == before + 2   # interval words, tiles
    assert torch.equal(got, want)


def test_traversal_kernels_refuse_misaligned_rows(dev):
    ks_a, voff_a, ks_b, voff_b, seeds, fw, kw = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in two_hop_edge_case("segments"))
    shifted = torch.empty(ks_b.shape[0] + 1, dtype=torch.int32, device=dev)
    shifted[1:] = ks_b          # the same rows, 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.two_hop(ks_a, voff_a, shifted[1:], voff_b, seeds, fw, **kw)
    ks, voff, starts, ends, kw = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in count_hop_edge_case("segments"))
    shifted = torch.empty(ks.shape[0] + 1, dtype=torch.int32, device=dev)
    shifted[1:] = ks
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.count_hop(shifted[1:], voff, starts, ends, **kw)


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
    before = K.count_hop.launches
    got = K.count_hop(ks, voff, s, e, n_key=N, n_out=N)
    want = R.count_hop(ks, voff, s, e, n_key=N, n_out=N)
    torch.cuda.synchronize()
    assert K.count_hop.launches == before + 2
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


# --------------------- the resident route (kernels 1, 2, 4) -----------------

def _resident(dev, page_size, case):
    """A resident fused call's tensors on the card: the plan (uint32 words
    as int32 bit patterns), the staged vector, p_pad and n_words."""
    plan, staged, p_pad, n_words = resident_case(page_size, case)
    return ([torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
             for a in plan], torch.from_numpy(staged).to(dev), p_pad,
            n_words)


@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_gather_decode_kernel_resident_cases_equal_plain(dev, page_size):
    plan, staged, p_pad, _ = _resident(dev, page_size, "rows")
    idx = staged[:p_pad].clone()      # with padding -7 and n_pages + 5
    got, want = _held(PK.gather_decode, PR.gather_decode, *plan, idx)
    assert torch.equal(got, want)


def _fused_held(dev, page_size, case, want_ids, fwords=None):
    """Launch a resident fused kernel (kernel 1, or kernel 4 with predicate
    words of kind ``fwords``) into a words buffer of junk and its plain
    version on the same tensors, and hold them equal; returns the plain
    words."""
    plan, staged, p_pad, n_words = _resident(dev, page_size, case)
    words = torch.full((n_words,), -1, dtype=torch.int32, device=dev)
    if fwords is None:
        fn, fw, extra = PK.fused_gather_decode_bitmap_batch, None, ()
    else:
        fn = LK.fused_gather_decode_filter_bitmap_batch
        fw = torch.from_numpy(resident_fwords(fwords, n_words)).to(dev)
        extra = (fw,)
    before = fn.launches
    got = fn(*plan, staged, *extra, words, p_pad=p_pad, want_ids=want_ids)
    want = PR.fused_gather_batch(*plan, staged, n_words, p_pad, fw)
    torch.cuda.synchronize()
    assert fn.launches == before + PK.FUSED_LAUNCHES
    if want_ids:
        assert torch.equal(got[1], want[1])
        got = got[0]
    assert got is words and torch.equal(got, want[0])
    return want[0]


@pytest.mark.parametrize("want_ids", [True, False])
@pytest.mark.parametrize("case", RESIDENT_CASES)
@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_fused_gather_kernel_resident_cases_equal_plain(dev, page_size, case,
                                                        want_ids):
    want = _fused_held(dev, page_size, case, want_ids)
    assert bool(want.any()) == (case == "rows")


@pytest.mark.parametrize("want_ids", [True, False])
@pytest.mark.parametrize("fwords", FWORDS_KINDS)
@pytest.mark.parametrize("case", RESIDENT_CASES)
@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_fused_gather_filter_kernel_resident_cases_equal_plain(
        dev, page_size, case, fwords, want_ids):
    want = _fused_held(dev, page_size, case, want_ids, fwords)
    assert bool(want.any()) == (case == "rows" and fwords != "zeros")


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


def _on(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_delta_decode_kernel_page_cases_equal_plain(dev, page_size):
    shipped = _on(dev, page_case(page_size))
    got, want = _held(PK.delta_decode, PR.decode_pages, *shipped,
                      page_size=page_size)
    assert torch.equal(got, want)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_fused_decode_kernel_page_cases_equal_plain(dev, page_size, warm):
    pages, cached, gidx, gcount = fused_case(page_size, warm)
    shipped = _on(dev, (*pages, cached, gidx, gcount))
    got, want = _held(PK.fused_decode_bitmap_batch, PR.fused_batch,
                      *shipped, n_words=FUSED_WORDS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[0].any())


@pytest.mark.parametrize("program", sorted(FUSED_PROGRAMS))
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_fused_filter_kernel_page_cases_equal_plain(dev, page_size, warm,
                                                    program):
    pages, cached, gidx, gcount = fused_case(page_size, warm)
    pos, meta = rle_rows(np.random.default_rng(page_size),
                         32 * FUSED_WORDS - 50, 3)
    shipped = _on(dev, (*pages, cached, gidx, gcount, pos, meta))
    got, want = _held(LK.fused_decode_filter_bitmap_batch,
                      LR.fused_filter_batch, *shipped,
                      FUSED_PROGRAMS[program], FUSED_WORDS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[0].any())


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


# ------------- the single-range, RLE-label and selection entries -------------

def _held(fn, plain, *args, **kwargs):
    """Launch ``fn`` (one launch) and its plain version on the same
    tensors; return both results."""
    before = fn.launches
    got = fn(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return got, want


@pytest.mark.parametrize("case", ["sorted", "unsorted", "window", "empty"])
def test_ids_bitmap_kernel_equals_plain(dev, case):
    rng = np.random.default_rng(2)
    ids = {"sorted": np.sort(rng.integers(0, 9000, 5000)),
           "unsorted": rng.integers(0, 9000, 5000),
           "window": np.sort(rng.integers(-500, 9000, 5000)),
           "empty": np.zeros(0, np.int64)}[case]
    base, n_words = (1024, 100) if case == "window" else (0, 300)
    t = torch.from_numpy(ids.astype(np.int32)).to(dev)
    for count in (len(ids), len(ids) // 2):
        got, want = _held(PK.bitmap, PR.bitmap, t, count, base, n_words)
        assert torch.equal(got, want)
    if case == "unsorted":
        assert PO.ids_to_bitmap(ids, 0, 300, "cuda").tolist() == \
            PO.ids_to_bitmap(ids, 0, 300, "numpy").tolist()


@pytest.mark.parametrize("column", ["<src>", "<dst>"])
@pytest.mark.parametrize("base,n_words", [(0, -(-N // 32)), (512, 20)])
def test_fused_decode_bitmap_kernel_equals_plain(dev, graph, column, base,
                                                 n_words):
    enc = graph[0].table[column].encoded
    shipped = PO.ship_pages(PO.pack_pages(enc, 0, len(enc.pages)), dev)
    got, want = _held(PK.fused_decode_bitmap, PR.fused_decode_bitmap,
                      *shipped, base=base, page_size=PAGE, words_out=n_words)
    assert torch.equal(got, want) and bool(want.any())
    # the <dst> column is unsorted across key segments: the set of its ids
    got = PO.decode_range_to_bitmap(enc, 0, enc.count, base, n_words, "cuda")
    assert got.tolist() == PO.decode_range_to_bitmap(
        enc, 0, enc.count, base, n_words, "numpy").tolist()


@pytest.mark.parametrize("page_size", [32, 16384])
def test_fused_decode_bitmap_kernel_page_sizes(dev, page_size):
    # one page of 32 rows; pages of 16384 rows take a warp 64 passes
    rng = np.random.default_rng(page_size)
    vals = np.concatenate([rng.integers(0, 1 << 20, 3 * page_size),
                           rng.integers(0, 1 << 20, 77)])
    enc = TC.delta_encode_column(vals, page_size)
    shipped = PO.ship_pages(PO.pack_pages(enc, 0, len(enc.pages)), dev)
    got, want = _held(PK.fused_decode_bitmap, PR.fused_decode_bitmap,
                      *shipped, base=0, page_size=page_size,
                      words_out=1 << 15)
    assert torch.equal(got, want) and bool(want.any())


#: (page size, window, kind) of kernel 12's cases: 9,000 pages only at
#: page sizes 32 and 33
SINGLE_RANGE_CASES = [(ps, w, k) for ps in SINGLE_RANGE_PAGE_SIZES
                      for w in sorted(SINGLE_RANGE_WINDOWS)
                      for k in SINGLE_RANGE_KINDS
                      if k != "many_pages" or ps <= 33]


@pytest.mark.parametrize("page_size,window,kind", SINGLE_RANGE_CASES)
def test_fused_decode_bitmap_kernel_cases_equal_plain(dev, page_size, window,
                                                      kind):
    pages, base, n_words = single_range_case(page_size, window, kind)
    shipped = _on(dev, pages)
    got, want = _held(PK.fused_decode_bitmap, PR.fused_decode_bitmap,
                      *shipped, base=base, page_size=page_size,
                      words_out=n_words)
    assert torch.equal(got, want)
    assert kind in ("one_page", "no_page") or bool(want.any())


@pytest.mark.parametrize("window", sorted(SINGLE_RANGE_WINDOWS))
@pytest.mark.parametrize("kind", SINGLE_IDS_KINDS)
def test_ids_bitmap_kernel_cases_equal_plain(dev, kind, window):
    ids, count, base, n_words = single_ids_case(kind, window)
    t = torch.from_numpy(np.concatenate([[7], ids]).astype(np.int32)).to(dev)
    for view in (t[1:].clone(), t[1:]):      # aligned, then at offset 1
        got, want = _held(PK.bitmap, PR.bitmap, view, count, base, n_words)
        assert torch.equal(got, want) and bool(want.any())


@pytest.fixture(scope="module")
def odd_graphs():
    """page size -> (adjacency, vertex table) at page sizes that are no
    multiple of 32 (the miniblock layout of ``build_packed``)."""
    src, dst = powerlaw_graph(N, 5, locality=0.5, seed=1)
    labels = clustered_labels(N, ["A", "B", "C"], density=0.4, run_scale=64,
                              seed=2)
    out = {}
    for ps in (99, 2047):
        adj = TC.build_adjacency(src, dst, N, N, TC.BY_SRC, TC.ENC_GRAPHAR,
                                 page_size=ps)
        out[ps] = (adj, TC.VertexTable.build(
            TC.VertexTypeSchema("v", [], labels=["A", "B", "C"]), {},
            labels, num_vertices=N))
    return out


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("page_size", [99, 2047])
def test_odd_page_sizes_cuda_equals_oracle(dev, odd_graphs, page_size,
                                           resident):
    adj, vt = odd_graphs[page_size]
    enc = adj.table["<dst>"].encoded
    vs = np.random.default_rng(page_size).integers(0, N, 40)
    seeds = vs[:5]
    out = {}
    for engine in ("cuda", "numpy"):
        runs = []
        for cond in (None, (TC.L("A") & TC.L("B")) | ~TC.L("C")):
            filt = TC.LabelFilter(vt, cond) if cond is not None else None
            cache = TC.DecodedPageCache(16)
            for c in (None, cache, cache):
                enc.page_cache = c
                meter = TC.IOMeter()
                pac = TC.retrieve_neighbors_batch(
                    adj, vs, 256, meter, engine, filter=filt,
                    resident=resident)
                runs.append((sorted((p, w.tolist())
                                    for p, w in pac.bitmaps.items()),
                             meter.nbytes, meter.nrequests,
                             c and (c.hits, c.misses, c.evictions)))
            enc.page_cache = None
            meter = TC.IOMeter()
            runs.append((TC.k_hop(adj, seeds, 2, meter, engine,
                                  filter=filt).tolist(), meter.nbytes,
                         meter.nrequests))
        meter = TC.IOMeter()
        runs.append((TC.neighbor_ids_batch(adj, vs, meter, engine).tolist(),
                     meter.nbytes, meter.nrequests))
        for name in ("<src>", "<dst>"):
            col = adj.table[name].encoded
            runs.append(PO.decode_range_to_bitmap(
                col, 0, col.count, 0, -(-N // 32), engine).tolist())
        out[engine] = runs
    assert out["cuda"] == out["numpy"]


@pytest.mark.parametrize("kind", ["random", "alternating", "empty",
                                  "late_start"])
@pytest.mark.parametrize("want_value", [0, 1])
def test_rle_to_bitmap_kernel_equals_plain(dev, kind, want_value):
    rng = np.random.default_rng(5)
    n = 50_000
    if kind == "late_start":          # lanes before positions[0]: run -1
        pos = np.array([5, 40, 41, 100, 250, 300])
        n = 300
    else:
        dense = {"random": rng.random(n) < 0.3,
                 "alternating": np.arange(n) % 2 == 1,
                 "empty": np.zeros(0, bool)}[kind]
        rle = TC.rle_encode_bool(dense)
        pos, n = rle.positions, rle.count
    padded = np.full((1, -(-len(pos) // 128) * 128), n, np.int32)
    padded[0, :len(pos)] = pos
    meta = np.array([[1, want_value, n]], np.int32)
    n_words = -(-max(n, 1) // 2048) * 64
    got, want = _held(FK.rle_to_bitmap, FR.rle_to_bitmap,
                      torch.from_numpy(padded).to(dev),
                      torch.from_numpy(meta).to(dev), n_words)
    assert torch.equal(got, want)
    if kind == "random":
        col = TC.rle_encode_bool(dense)
        assert FO.rle_to_bitmap(col, bool(want_value), "cuda").tolist() == \
            FO.rle_to_bitmap(col, bool(want_value), "numpy").tolist()


@pytest.mark.parametrize("page_size", [32, 256, 2048])
def test_bitmap_select_kernel_equals_plain(dev, page_size):
    rng = np.random.default_rng(page_size)
    vals = rng.standard_normal((5, page_size)).astype(np.float32)
    vals.view(np.uint32)[0, :5] = [0x7FC01234, 0x80000000, 0x00000001,
                                   0x007FFFFF, 0xFFC00001]
    words = rng.integers(0, 1 << 32, (5, page_size // 32),
                         dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0x1F
    words[2] = 0                          # a page that selects nothing
    words[3] = 0xFFFFFFFF                 # one that selects everything
    (out, cnt), (r_out, r_cnt) = _held(
        BK.bitmap_select, BR.bitmap_select,
        torch.from_numpy(vals).to(dev),
        torch.from_numpy(words.view(np.int32)).to(dev), page_size)
    assert torch.equal(cnt, r_cnt)
    assert torch.equal(out.view(torch.int32), r_out.view(torch.int32))
    ids = np.flatnonzero(rng.random(7 * page_size) < 0.2)
    pac = TC.PAC.from_ids(ids, page_size)
    allv = rng.standard_normal(7 * page_size).astype(np.float32)
    pages = {p: allv[p * page_size:(p + 1) * page_size] for p in pac.pages()}
    got = BO.select_from_pages(pac, pages, "cuda")
    assert got.view(np.int32).tolist() == allv[ids].view(np.int32).tolist()


@pytest.mark.parametrize("want", [0, 1])
@pytest.mark.parametrize("case", RLE_CASES)
def test_rle_to_bitmap_kernel_cases_equal_plain(dev, case, want):
    pos, meta, n_words = rle_case(case, want)
    got, plain = _held(FK.rle_to_bitmap, FR.rle_to_bitmap,
                       torch.from_numpy(pos).to(dev),
                       torch.from_numpy(meta).to(dev), n_words)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("kind,page_size", SELECT_CASES)
def test_bitmap_select_kernel_cases_equal_plain(dev, kind, page_size,
                                                aligned):
    vals, words = select_case(kind, page_size)
    # the values at a 16-byte boundary, or 4 bytes past one
    flat = torch.zeros(vals.size + 1, dtype=torch.float32, device=dev)
    v = flat[:vals.size] if aligned else flat[1:]
    v.copy_(torch.from_numpy(vals.reshape(-1)))
    v = v.view(vals.shape)
    assert (v.data_ptr() % 16 == 0) == aligned
    (out, cnt), (r_out, r_cnt) = _held(
        BK.bitmap_select, BR.bitmap_select, v,
        torch.from_numpy(words.view(np.int32)).to(dev), page_size)
    assert torch.equal(cnt, r_cnt)
    assert torch.equal(out.view(torch.int32), r_out.view(torch.int32))


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("batch", [8, 40])
def test_numeric_retrieval_cuda_equals_oracle(dev, graph, batch, resident):
    adj, _ = graph
    rng = np.random.default_rng(9)
    vt = TC.VertexTable.build(
        TC.VertexTypeSchema("v", [TC.PropertySchema("age", "int64")],
                            page_size=PAGE),
        {"age": rng.integers(0, 100, N)}, {}, num_vertices=N)
    vs = rng.integers(0, N, batch)
    out = {}
    for engine in ("cuda", "numpy"):
        filt = TC.NumericFilter(vt, TC.NumProp("age").between(18, 30)
                                | (TC.NumProp("age") >= 90))
        meter = TC.IOMeter()
        pac = TC.retrieve_neighbors_batch(adj, vs, 256, meter, engine,
                                          filter=filt, resident=resident)
        out[engine] = (pac.to_ids().tolist(), meter.nbytes,
                       meter.nrequests, filt.prop_pages_read,
                       filt.prop_pages_skipped)
    assert out["cuda"] == out["numpy"] and out["cuda"][0]


@pytest.mark.parametrize("resident", [True, False])
def test_numeric_retrieval_cuda_skips_pages(dev, graph, resident):
    # `joined` rises with the vertex id, so the zone maps skip the pages of
    # `joined < 500` past its first half; NOT turns the leaf's False there
    # into True, which the kernels must carry over the skipped pages
    adj, _ = graph
    rng = np.random.default_rng(10)
    vt = TC.VertexTable.build(
        TC.VertexTypeSchema("v", [TC.PropertySchema("age", "int64"),
                                  TC.PropertySchema("joined", "int64")],
                            page_size=PAGE),
        {"age": rng.integers(0, 100, N),
         "joined": np.sort(rng.integers(0, 1000, N))}, {}, num_vertices=N)
    vs = rng.integers(0, N, 40)
    out = {}
    for engine in ("cuda", "numpy"):
        filt = TC.NumericFilter(vt, ~(TC.NumProp("joined") < 500)
                                & (TC.NumProp("age") >= 50))
        meter = TC.IOMeter()
        pac = TC.retrieve_neighbors_batch(adj, vs, 256, meter, engine,
                                          filter=filt, resident=resident)
        out[engine] = (pac.to_ids().tolist(), meter.nbytes,
                       meter.nrequests, filt.prop_pages_read,
                       filt.prop_pages_skipped)
    assert out["cuda"] == out["numpy"] and out["cuda"][0]
    assert out["cuda"][4] > 0


# ------------------------------------------- flash attention (kernel 15)

@pytest.mark.parametrize("layout", ["flat", "gqa"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("seq", [7, 64, 384])
def test_flash_attention_kernel_equals_plain(dev, seq, d, dtype, causal,
                                             layout):
    """``flat``: [3, seq, d] through ``flash_attention``; ``gqa``: the
    forward's layout through ``ops.mha``, 6 query heads over 2 KV heads,
    each a [b, h, seq, d] view of a [b, seq, h, d] tensor."""
    gen = torch.Generator(device=dev).manual_seed(seq + d)
    before = AK.flash_attention.launches
    if layout == "flat":
        q, k, v = (torch.randn((3, seq, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        got = AK.flash_attention(q, k, v, causal)
        want = AR.attention_ref(q, k, v, causal)
    else:
        q, k, v = (torch.randn((2, seq, n, d), generator=gen, device=dev)
                   .to(dtype).transpose(1, 2) for n in (6, 2, 2))
        got = AO.mha(q, k, v, causal)
        want = AR.attention_ref(q, k, v, causal, kv_group=3)
        assert got.transpose(1, 2).is_contiguous()
    torch.cuda.synchronize()
    assert AK.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:          # the reference test's 1e-4
        assert diff.max().item() <= 1e-4
    else:
        # one output rounding on each side, and p's bf16 rounding inside
        # a convex combination of V's rows
        bound = 2.0 ** -8 * (want.float().abs() + v.float().abs().max())
        assert bool((diff <= bound).all()), diff.max().item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_start", [0, 128, 256])
def test_flash_attention_offset_equals_plain_and_the_full_calls_rows(
        dev, q_start, d, dtype, causal):
    """128 query rows starting at ``q_start`` against 384 keys (a
    sequence-parallel rank's call), 6 heads over 2 KV heads in the
    forward's strided layout: equal to the plain version with the same
    ``q_start``, and bit for bit those rows of the whole sequence's call
    (``q_start`` a multiple of both kernels' query blocks, so the same
    tiles run in the same order)."""
    gen = torch.Generator(device=dev).manual_seed(q_start + d)
    q, k, v = (torch.randn((2, 384, n, d), generator=gen, device=dev)
               .to(dtype).transpose(1, 2) for n in (6, 2, 2))
    rows = q[:, :, q_start:q_start + 128]
    before = AK.flash_attention.launches
    got = AO.mha(rows, k, v, causal, q_start=q_start)
    want = AR.attention_ref(rows, k, v, causal, kv_group=3, q_start=q_start)
    whole = AO.mha(q, k, v, causal)
    torch.cuda.synchronize()
    assert AK.flash_attention.launches == before + 2
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4
    else:
        bound = 2.0 ** -8 * (want.float().abs() + v.float().abs().max())
        assert bool((diff <= bound).all()), diff.max().item()
    assert torch.equal(got, whole[:, :, q_start:q_start + 128])


def test_flash_attention_kernel_refuses_what_it_cannot_run(dev):
    q = torch.zeros((2, 64, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        AK.flash_attention(q, q, q)
    q = torch.zeros((2, 64, 64), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        AK.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="innermost stride"):
        AK.flash_attention(q, torch.zeros((2, 64, 128), device=dev)[..., ::2],
                           q)
    with pytest.raises(ValueError, match="not supported"):
        AK.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiple of"):
        AK.flash_attention(*(torch.zeros((1, 200, 64), device=dev),) * 3)
    with pytest.raises(ValueError, match="aligned"):
        x = torch.zeros((2 * 64 * 64 + 4,), device=dev,   # 8 bytes in
                        dtype=torch.bfloat16)[4:].view(2, 64, 64)
        AK.flash_attention(x, x, x)


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-4b"])
def test_lm_flash_route_on_the_card(dev, arch):
    """A reduced model on the card: the float32 flash route (kernel 15,
    launched once per layer) against the float32 plain route, and the
    prefill/decode of the same weights against the full forward."""
    cfg = get_config(arch).reduced()
    flash = build_model(cfg.with_(use_flash=True), dev).init(0)
    plain = build_model(cfg, dev)
    plain.load_state_dict(flash.state_dict())
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64),
                                           dtype=np.int32)).to(dev)
    before = AK.flash_attention.launches
    with torch.no_grad():           # the kernel has no backward
        got, _ = flash({"tokens": tokens})
    assert AK.flash_attention.launches == before + cfg.num_layers
    want, _ = plain({"tokens": tokens})
    # gemma3's reduced windows (64) do not bind at 64 tokens
    assert (got - want).abs().max().item() <= 1e-4
    cache = plain.init_cache(2, 64, dtype=torch.float32)
    logits, cache = plain.prefill({"tokens": tokens[:, :48]}, cache)
    steps = [logits[:, -1]]
    for t in range(48, 63):
        logits, cache = plain.decode_step(tokens[:, t:t + 1], cache)
        steps.append(logits[:, -1])
    assert (torch.stack(steps, 1) - want[:, 47:63]).abs().max().item() <= 1e-4


def _serve_run(model, engine):
    """The reduced engine over a document lake, the retriever on
    ``engine``: (finished requests, IOMeter, retriever stats)."""
    from repro_torch.data.synthetic import document_graph
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.retrieval import GraphRetriever
    from repro_torch.serve.tenancy import TenantConfig
    lake = document_graph(num_docs=300, vocab=512, mean_len=32, seed=5)
    b = TC.GraphArBuilder("docs")
    b.add_vertices(TC.VertexTypeSchema(
        "doc", [TC.PropertySchema("tokens", "tokens")],
        labels=list(lake.labels), page_size=128),
        {"tokens": lake.tokens}, lake.labels)
    b.add_edges(TC.EdgeTypeSchema("doc", "links", "doc", page_size=128),
                lake.links_src, lake.links_dst)
    g = b.build()
    adj = g.adjacency("doc-links-doc", TC.BY_SRC)
    meter = TC.IOMeter()
    retr = GraphRetriever(adj, g.vertex("doc").table["tokens"],
                          max_neighbors=2, tokens_per_neighbor=8,
                          meter=meter, engine=engine, page_cache_pages=64,
                          hops=2, filter_vt=g.vertex("doc"),
                          filter_cond=TC.L("HighQuality") & ~TC.L("Spam"))
    eng = ServeEngine(model, max_slots=3, max_len=96, eos_id=-1,
                      context_fn=retr, pipeline=True,
                      tenants=[TenantConfig("prod", weight=3),
                               TenantConfig("batch")])
    rng = np.random.default_rng(0)
    seeds = np.flatnonzero(adj.degrees() > 0)
    for i in range(10):
        eng.submit(Request(i, rng.integers(4, 512, 4 + i % 3)
                           .astype(np.int32), max_new_tokens=4,
                           context_vertex=int(seeds[rng.integers(
                               0, len(seeds))]),
                           tenant=("prod", "batch")[i % 2]))
    return eng.run_until_drained(), meter, retr.stats()


def test_serve_engine_cuda_equals_the_cpu_leg(dev):
    """The reduced engine with the model and the retriever on the card
    against the same weights on the CPU ``torch`` leg: equal contexts and
    IOMeter, equal tokens on every decisive step (top two float32 logits
    of the CPU forward more than 1e-4 apart)."""
    cfg = get_config("smollm-360m").reduced().with_(n_units=2)
    card = build_model(cfg, dev).init(0)
    cpu = build_model(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    got, gmeter, gstats = _serve_run(card, "cuda")
    want, wmeter, wstats = _serve_run(cpu, "torch")
    assert (gmeter.nbytes, gmeter.nrequests) == \
        (wmeter.nbytes, wmeter.nrequests)
    assert gstats["page_cache"] == wstats["page_cache"]
    assert gstats["filter"] == wstats["filter"]
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.context_tokens == b.context_tokens
        if a.output == b.output:
            continue
        seq = np.concatenate([b.prompt, np.asarray(b.output, np.int32)])
        logits, _ = cpu({"tokens": torch.from_numpy(seq[None])})
        top2 = logits[0, len(b.prompt) - 1:].topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1] > 1e-4).tolist() + [False]
        k = decisive.index(False)
        assert k < len(b.output), f"request {a.request_id} parts at a " \
            f"decisive step"
        assert a.output[:k] == b.output[:k], a.request_id


def test_decode_step_takes_no_host_sync(dev):
    """A continuous-batching decode step on the card, with a slot at and
    a slot past the cache's end, queues its work without one host sync
    (``set_sync_debug_mode("error")`` raises on any), and so does the
    engine's token upload."""
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("smollm-360m").reduced().with_(n_units=2)
    model = build_model(cfg, dev).init(0)
    eng = ServeEngine(model, max_slots=4, max_len=32)
    eng.cache["index"].copy_(torch.tensor([3, 31, 32, 40]))
    for layer in eng.cache["layers"]:
        layer["kv"]["index"].copy_(eng.cache["index"])
    tokens = np.arange(4, dtype=np.int32)[:, None] + 5
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            logits, eng.cache = model.decode_step(eng._device_tokens(tokens),
                                                  eng.cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eng.cache["index"].tolist() == [5, 33, 34, 42]
    assert bool(torch.isfinite(logits).all())


# ------------------------------ the mutable plane ----------------------------

def _mutable_graph(seed=17):
    src, dst = powerlaw_graph(N, 6, seed=seed)
    return TC.build_adjacency(src, dst, N, N, TC.BY_SRC, TC.ENC_GRAPHAR,
                              page_size=PAGE)


def _pending_reads(adj, vt, engine, cache):
    """Every read the mutable plane unions: PACs (fused, both filtered
    and not), ids unique and per vertex, ``k_hop`` -- with IOMeter and
    LRU counters."""
    from repro_torch.core.delta_segment import live_delta
    enc = adj.table["<dst>"].encoded
    vs = np.random.default_rng(3).integers(0, N, 40)
    filt = TC.LabelFilter(vt, TC.L("A") | ~TC.L("B"))
    runs = []
    for c in (None, cache, cache):
        enc.page_cache = c
        meter = TC.IOMeter()
        pacs = [TC.retrieve_neighbors_batch(adj, vs, 512, meter,
                                            engine=engine, filter=f)
                for f in (None, filt)]
        ids = [TC.neighbor_ids_batch(adj, vs, meter, engine=engine,
                                     unique=u) for u in (True, False)]
        hop = TC.k_hop(adj, vs[:5], 2, meter, engine=engine, filter=filt)
        runs.append(([p.to_ids().tolist() for p in pacs],
                     [i.tolist() for i in ids], hop.tolist(), meter.nbytes,
                     meter.nrequests, c and (c.hits, c.misses)))
    enc.page_cache = None
    d = live_delta(adj)
    return runs, d and d.stats()


def test_pending_rows_cuda_equals_numpy(dev, graph):
    from repro_torch.core.delta_segment import ingest_edges
    _, vt = graph
    out, adjs, launched = {}, {}, {}
    for engine in ("cuda", "numpy"):
        adj = adjs[engine] = _mutable_graph()
        rng = np.random.default_rng(5)
        ingest_edges(adj, rng.integers(0, N, 300), rng.integers(0, N, 300))
        wrappers = (PK.fused_gather_decode_bitmap_batch,
                    LK.fused_gather_decode_filter_bitmap_batch, K.khop_scan)
        before = [w.launches for w in wrappers]
        out[engine] = _pending_reads(adj, vt, engine,
                                     TC.DecodedPageCache(24))
        launched[engine] = [w.launches - b for w, b in zip(wrappers, before)]
    assert out["cuda"] == out["numpy"]
    # kernels 1 and 4 served the base; k_hop took the host loop
    assert launched["cuda"][0] > 0 and launched["cuda"][1] > 0
    assert launched["cuda"][2] == 0
    assert TO.traversal_stats(adjs["cuda"])["fallbacks"] == 3


def test_page_writes_reship_the_mirror(dev, graph):
    """``set_page`` (same count, other ids) and ``append_page`` (rows past
    the offsets) re-key the packed column: a fresh plan ships once and
    kernels 1 and 4 equal numpy on the rewritten pages."""
    from repro_torch.core.encoding import delta_decode_page, delta_encode_page
    _, vt = graph
    adj = _mutable_graph(seed=19)
    enc = adj.table["<dst>"].encoded
    vs = np.random.default_rng(4).integers(0, N, 40)
    filt = TC.LabelFilter(vt, TC.L("A") & ~TC.L("B"))
    TC.retrieve_neighbors_batch(adj, vs, 512, engine="cuda")
    first = enc.packed_cache
    rng = np.random.default_rng(8)
    for write in range(2):
        if write == 0:
            i = int(adj.offsets["<offset>"].values[vs[0]] // PAGE)
            count = enc.pages[i].count
            enc.set_page(i, delta_encode_page(
                np.sort(rng.integers(0, N, count))))
        else:
            enc.append_page(delta_encode_page(rng.integers(0, N, 77)))
            assert delta_decode_page(enc.pages[-1]).size == 77
        launches = (PK.fused_gather_decode_bitmap_batch.launches,
                    LK.fused_gather_decode_filter_bitmap_batch.launches)
        for f in (None, filt):
            got = TC.retrieve_neighbors_batch(adj, vs, 512, engine="cuda",
                                              filter=f)
            want = TC.retrieve_neighbors_batch(adj, vs, 512, engine="numpy",
                                               filter=f)
            assert got == want
        packed = enc.packed_cache
        assert packed is not first and packed.version == enc.version
        assert packed.device_transfers == 1
        assert PK.fused_gather_decode_bitmap_batch.launches > launches[0]
        assert LK.fused_gather_decode_filter_bitmap_batch.launches > \
            launches[1]
        first = packed


def test_poisoned_mirror_falls_back_and_heals(dev, graph):
    adj = _mutable_graph(seed=23)
    enc = adj.table["<dst>"].encoded
    vs = np.random.default_rng(6).integers(0, N, 40)
    want = TC.retrieve_neighbors_batch(adj, vs, 512, engine="numpy")
    assert TC.retrieve_neighbors_batch(adj, vs, 512, engine="cuda") == want
    packed = enc.packed_cache
    packed.poison()
    before = PK.fused_gather_decode_bitmap_batch.launches
    assert TC.retrieve_neighbors_batch(adj, vs, 512, engine="cuda") == want
    assert PK.fused_gather_decode_bitmap_batch.launches == before
    assert packed.fallbacks == 1 and packed.device_stats()["poisoned"]
    enc.bump_version()                           # heals: a fresh mirror
    assert TC.retrieve_neighbors_batch(adj, vs, 512, engine="cuda") == want
    assert PK.fused_gather_decode_bitmap_batch.launches > before
    assert enc.packed_cache is not packed
    assert enc.packed_cache.device_transfers == 1


def test_compaction_then_fused_k_hop_equals_host_loop(dev, graph):
    from repro_torch.core.compaction import CompactionRunner
    from repro_torch.core.delta_segment import ingest_edges
    _, vt = graph
    adj = _mutable_graph(seed=29)
    filt = TC.LabelFilter(vt, TC.L("A") | ~TC.L("B"))
    seeds = np.random.default_rng(9).integers(0, N, 6)
    TC.k_hop(adj, seeds, 2, engine="cuda")       # the write-once plan
    rng = np.random.default_rng(10)
    ingest_edges(adj, rng.integers(0, N, 400), rng.integers(0, N, 400))
    pending = [TC.k_hop(adj, seeds, h, engine="cuda", filter=filt)
               for h in (2, 3)]
    assert CompactionRunner(adj).compact()
    before = K.khop_scan.launches
    for h, p in zip((2, 3), pending):
        got = TC.k_hop(adj, seeds, h, engine="cuda", filter=filt)
        want = TC.k_hop(adj, seeds, h, engine="numpy", filter=filt,
                        fused=False)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, p)
    assert K.khop_scan.launches == before + 3 + 4  # seeds, then hops
    stats = TO.traversal_stats(adj)
    assert stats["fallbacks"] == 2 and stats["dispatches"] == 3
    stale = [p for k, p in adj._traversal_plans.items()
             if k[0] != adj.table["<dst>"].encoded.version]
    assert len(stale) == 1 and not stale[0]._device


# ------------------------------ partition plane ------------------------------

def _part_graph(n_parts):
    src, dst = powerlaw_graph(N, 6, seed=13)
    adj = TC.build_adjacency(src, dst, N, N, TC.BY_SRC, TC.ENC_GRAPHAR,
                             page_size=PAGE)
    TC.partition_column(adj.table["<dst>"].encoded, n_parts)
    return adj


def _mesh_of(monkeypatch, dev, entries):
    """A mesh naming the card (the CPU for the torch engine) ``entries``
    times, the multi-device tail forced; ``"cards"``: every card, which
    ``_devices`` gives on its own (skips with fewer than two)."""
    if entries == "cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two or more cards")
        monkeypatch.setattr(PO, "SHARD_MIN_PAGES", 0)
        return torch.cuda.device_count()
    if entries:
        cpu = torch.device("cpu")
        monkeypatch.setattr(PO, "_devices", lambda engine: (
            dev if engine == "cuda" else cpu,) * entries)
        monkeypatch.setattr(PO, "SHARD_MIN_PAGES", 0)
    return entries


@pytest.mark.parametrize("mesh,n_parts", [(0, 2), (0, 8), (8, 8), (4, 8),
                                          (3, 3), ("cards", 8)])
def test_partitioned_tails_cuda_equal_numpy(dev, graph, monkeypatch, mesh,
                                            n_parts):
    """Both tails (``mesh`` 0: the single-shard tail on one card; else the
    multi-device tail on a mesh naming the card ``mesh`` times, ``4, 8``
    two partitions an entry, or over every card) against the numpy engine
    over the same partitioned column: PACs, IOMeter, LRU counters and ``k_hop``; the
    partition counters against the torch engine's (the numpy engine
    counts its own route's dispatches); one launch of kernels 1, 4, 2 per
    mesh entry (``fused_gather_decode*`` count 2 a call)."""
    _, vt = graph
    cards = mesh == "cards"
    mesh = _mesh_of(monkeypatch, dev, mesh)
    out, counters, calls, adjs = {}, {}, {}, {}
    for engine in ("cuda", "torch", "numpy"):
        adj = adjs[engine] = _part_graph(n_parts)
        cache = TC.attach_page_cache(adj.table["<dst>"], 24)
        wrappers = (PK.fused_gather_decode_bitmap_batch,
                    LK.fused_gather_decode_filter_bitmap_batch,
                    PK.gather_decode, K.expand_words, K.merge_hop)
        before = [w.launches for w in wrappers]
        rng = np.random.default_rng(3)
        res = []
        for filt in (None, TC.LabelFilter(vt, TC.L("A") | ~TC.L("B"))):
            for batch in (40, 300, 300):
                m = TC.IOMeter()
                pac = TC.retrieve_neighbors_batch(
                    adj, rng.integers(0, N, batch), 512, m, engine=engine,
                    filter=filt)
                res.append((sorted((p, w.tolist())
                                   for p, w in pac.bitmaps.items()),
                            m.nbytes, m.nrequests, cache.stats()))
        m = TC.IOMeter()
        ids = TC.k_hop(adj, np.array([3, 17, 999]), 3, m, engine=engine,
                       filter=[None, TC.LabelFilter(vt, TC.L("A")), None])
        res.append((ids.tolist(), m.nbytes, m.nrequests, cache.stats()))
        st = TC.live_partitions(adj.table["<dst>"].encoded).stats()
        counters[engine] = {k: st[k] for k in ("dispatches",
                                               "partitions_pruned",
                                               "stats_pruned")}
        out[engine] = res
        calls[engine] = [w.launches - b for w, b in zip(wrappers, before)]
    assert out["cuda"] == out["numpy"] == out["torch"]
    assert counters["cuda"] == counters["torch"]
    parts = TC.live_partitions(adjs["cuda"].table["<dst>"].encoded)
    g = parts.mesh_size(mesh) if mesh else 1
    if cards:   # each card holds its entry's block
        assert parts.stats()["devices"] == [f"cuda:{i}" for i in range(g)]
    fused, filtered, decode, expand, merge = calls["cuda"]
    # 3 unfiltered and 3 filtered fused calls, each one launch (2 kernels)
    # per mesh entry; the plan build's decode one per entry; 3 hops
    assert (fused, filtered) == (2 * 3 * g, 2 * 3 * g)
    assert decode == g
    if g > 1:
        assert (expand, merge) == (3 * g, 3)
    else:
        assert (expand, merge) == (0, 0)


@pytest.mark.parametrize("n_words", [1, 33, 6144 * 32, 6144 * 32 + 1])
@pytest.mark.parametrize("mesh", [1, 8])
def test_merge_hop_kernel_equals_plain(dev, n_words, mesh):
    """``rt_merge_hop`` against its plain version at ``_summary_shape``'s
    edges (the summary's ``g`` steps from 0 to 1 past 196,608 words)."""
    rng = np.random.default_rng(n_words)
    n = 32 * n_words - 7
    g, n_sum = K._summary_shape(n_words)

    def words(shape, p):
        w = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
        w[rng.random(shape) >= p] = 0
        w[..., -1] &= (1 << 25) - 1
        return torch.from_numpy(w.astype(np.int32))
    partial, fw = words((mesh, n_words), 0.05), words(n_words, 0.7)
    vis = words(n_words, 0.5)
    outs = {}
    for where in ("cpu", dev):
        vw = vis.clone().to(where)
        visited = R._filter_bits(vw, n).to(where)
        bufs = [torch.full((k,), -5, dtype=torch.int32, device=where)
                for k in (n_words, n_sum, n)]
        size = torch.zeros(1, dtype=torch.int32, device=where)
        K.merge_hop(partial.to(where), fw.to(where), vw, visited, bufs[0],
                    bufs[1], g, bufs[2], size, n)
        outs[str(where)] = [t.cpu() for t in (*bufs, vw, visited, size)]
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cards", [False, True])
def test_sharded_khop_cuda_equals_khop_scan(dev, graph, cards):
    """The multi-device k-hop on a mesh naming the card 4 times over 8
    partitions (``ppd = 2``), or over every card, against the single-shard
    ``khop_scan`` on the same column: visited plane, hop planes and
    sizes."""
    from repro_torch.kernels import shard
    adj = _part_graph(8)
    _, vt = graph
    plan = TO.traversal_plan(adj, "cuda")
    parts = TC.live_partitions(adj.table["<dst>"].encoded)
    mesh = (dev,) * 4
    if cards:
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two or more cards")
        mesh = parts.mesh_devices(PO._devices("cuda"))
    seeds = torch.tensor([3, 17, 999] + [N] * 61, dtype=torch.int32,
                         device=dev)
    fw = TO._filter_words([None, TC.LabelFilter(vt, TC.L("A")), None], 3,
                          -(-N // 32), N, dev)
    got = shard.sharded_khop(mesh, plan.sharded_arrays(parts, mesh), seeds,
                             fw, N)
    want = K.khop_scan(*plan.device(dev), seeds, fw, n_out=N)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dropped_partitioned_column_frees_device_memory(dev):
    """The partition plane holds its column weakly: a partitioned column
    whose stacked plan was placed on the card gives its device memory back
    when its caller drops it, with the cyclic collector off from before
    the column is built (earlier tests' garbage collected first)."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        adj = _part_graph(8)
        vs = np.arange(0, N, 3)
        assert TC.retrieve_neighbors_batch(adj, vs, 512, TC.IOMeter(),
                                           engine="cuda").count() > 0
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated(dev)
        plane = weakref.ref(TC.live_partitions(adj.table["<dst>"].encoded))
        assert placed > base and plane()._device_plans, (base, placed)
        del adj
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(dev)
        assert plane() is None
        assert after < placed, (base, placed, after)
    finally:
        gc.enable()


# ------------------------- the rest of the LM stack --------------------------

FAMILIES = ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "whisper-small", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_on_the_card_equals_moe_ref(dev, dtype):
    """deepseek's reduced MoE FFN (8 experts, top 2, shared experts) at a
    prefill shape with drops (factor 0.5) and at a decode shape (T = 4,
    capacity 1): ``moe_apply`` against the plain per-expert loop on the
    card, keep masks equal; float32 also against the CPU."""
    from repro_torch.models.moe import moe_apply, moe_init, moe_ref, route
    m = get_config("deepseek-moe-16b").reduced().moe
    gen = torch.Generator(device=dev).manual_seed(3)
    moe = moe_init(gen, 128, m.d_expert, m.num_experts, m.num_shared,
                   m.d_shared, dtype, dev)
    cpu = moe_init(None, 128, m.d_expert, m.num_experts, m.num_shared,
                   m.d_shared, dtype, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in moe.state_dict().items()})
    kw = dict(num_experts=m.num_experts, top_k=m.top_k)
    for shape, factor in (((4, 64), 0.5), ((4, 1), 1.25)):
        x = torch.randn(shape + (128,), generator=gen, device=dev).to(dtype)
        got, aux = moe_apply(moe, x, capacity_factor=factor, **kw)
        want, raux, keep = moe_ref(moe, x, capacity_factor=factor, **kw)
        r = route(moe, x.reshape(-1, 128), capacity_factor=factor, **kw)
        assert torch.equal(keep, r["keep"]) and not bool(keep.all())
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        assert (got.float() - want.float()).abs().max().item() <= tol
        assert abs(aux.item() - raux.item()) <= 1e-6
        if dtype == torch.float32:
            c, caux = moe_apply(cpu, x.cpu(), capacity_factor=factor, **kw)
            assert (got.cpu() - c).abs().max().item() <= 1e-4
            assert abs(aux.item() - caux.item()) <= 1e-5


def test_ssd_chunked_on_the_card_equals_plain(dev):
    """``ssd_chunked`` over three chunks and two groups against the
    sequential ``ssd_reference`` on the card, float32."""
    from repro_torch.models.ssm import ssd_chunked, ssd_reference
    gen = torch.Generator(device=dev).manual_seed(4)
    b, l, h, p, g, n = 2, 96, 4, 16, 2, 16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x, B, C = rand(b, l, h, p), rand(b, l, g, n), rand(b, l, g, n)
    dt = torch.nn.functional.softplus(rand(b, l, h)) * 0.5
    A, D = -torch.exp(rand(h)), rand(h)
    y, s = ssd_chunked(x, dt, A, B, C, D, 32)
    ry, rs = ssd_reference(x, dt, A, B, C, D)
    scale = max(1.0, ry.abs().max().item())
    assert (y - ry).abs().max().item() <= 1e-5 * scale
    assert (s - rs).abs().max().item() <= 1e-5 * max(1.0,
                                                    rs.abs().max().item())


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_families_on_the_card_equal_the_cpu(dev, arch):
    """A reduced model of each new family (every ``x_gate`` at 0.5) on the
    card against the same weights on the CPU, float32: the forward and
    its balance loss, and a prefill with 4 decode steps."""
    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, "cpu").init(0)
    for name, p in cpu.named_parameters():
        if name.endswith("x_gate"):
            p.data.fill_(0.5)
    card = build_model(cfg, dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32))
             .astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (2, cfg.default_encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.num_vision_tokens:
        batch["vision"] = rng.standard_normal(
            (2, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    got, gaux = card(batch)
    want, waux = cpu(batch)
    assert (got.cpu() - want).abs().max().item() <= 2e-4
    assert abs(gaux.item() - waux.item()) <= 2e-4
    ctx = cfg.default_encoder_len if cfg.encoder_layers \
        else cfg.num_vision_tokens
    outs = []
    for model in (card, cpu):
        cache = model.init_cache(2, 40, ctx_len=ctx, dtype=torch.float32)
        first = dict(batch, tokens=batch["tokens"][:, :28])
        logits, cache = model.prefill(first, cache)
        steps = [logits[:, -1].cpu()]
        for t in range(28, 32):
            logits, cache = model.decode_step(batch["tokens"][:, t:t + 1],
                                              cache)
            steps.append(logits[:, -1].cpu())
        outs.append(torch.stack(steps, 1))
    assert (outs[0] - outs[1]).abs().max().item() <= 2e-4


# ------------------------------------------------------------- training

def _train_case(dev, n_micro, **over):
    """One AdamW step of reduced smollm (float32, two units) on ``dev``
    from the CPU model's weights.  Adam's first step moves a parameter by
    lr x g / (|g| + eps): where |g| is of the order of eps, the summation
    order (microbatches, the card's atomics) decides a part of lr, so lr
    is 1e-3 for the reference's atol of 5e-4."""
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import (make_train_step, model_params,
                                              unit_layout)
    cfg = get_config("smollm-360m").reduced().with_(n_units=2, **over)
    cpu = build_model(cfg, "cpu").init(0)
    model = build_model(cfg, dev)
    model.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    params = model_params(model)
    opt = adamw(1e-3)
    return make_train_step(model, opt, n_micro)(
        params, opt.init(params, unit_layout(model)), batch)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_train_step_on_the_card(dev, remat):
    """A reduced train step on the card against the same step on the CPU
    (loss, grad norm and new params within the reference's 2e-4 / 5e-4),
    and n_micro 4 against 1 on the card (the grad norm too: a wrong
    accumulation's scale would hide behind the clip and Adam's scale
    invariance in the params)."""
    p_card, s_card, m_card = _train_case(dev, 1, remat=remat)
    p_cpu, _, m_cpu = _train_case(torch.device("cpu"), 1, remat=remat)
    assert m_card["loss"].device.type == "cuda"
    assert abs(m_card["loss"].item() - m_cpu["loss"].item()) <= \
        1e-5 * abs(m_cpu["loss"].item())
    assert abs(m_card["grad_norm"].item() - m_cpu["grad_norm"].item()) <= \
        1e-4 * m_cpu["grad_norm"].item()
    for k, v in p_cpu.items():
        assert p_card[k].device.type == "cuda"
        torch.testing.assert_close(p_card[k].cpu(), v, rtol=2e-4, atol=5e-4)
    assert s_card["m"]["embed"].device.type == "cuda"
    p4, _, m4 = _train_case(dev, 4, remat=remat)
    assert abs(m4["loss"].item() - m_card["loss"].item()) <= \
        1e-5 * abs(m_card["loss"].item())
    assert abs(m4["grad_norm"].item() - m_card["grad_norm"].item()) <= \
        1e-4 * m_card["grad_norm"].item()
    for k, v in p_card.items():
        torch.testing.assert_close(p4[k], v, rtol=2e-4, atol=5e-4)


def test_bf16_checkpoint_roundtrip_from_the_card(dev, tmp_path):
    from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                     save_checkpoint)
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import model_params, unit_layout
    cfg = get_config("smollm-360m").reduced()
    assert cfg.with_(param_dtype="bfloat16").param_dtype == "bfloat16"
    model = build_model(cfg.with_(param_dtype="bfloat16",
                                  compute_dtype="bfloat16"), dev).init(0)
    params = model_params(model)
    state = adamw(1e-3, moment_dtype="bfloat16").init(params,
                                                      unit_layout(model))
    tree = {"params": params, "opt": state}
    save_checkpoint(str(tmp_path), 7, tree, extra={"next_step": 7})
    back, extra = restore_checkpoint(str(tmp_path), 7, like=tree)
    assert extra == {"next_step": 7}
    for k, v in params.items():
        assert back["params"][k].dtype == torch.bfloat16
        assert back["params"][k].device == v.device
        assert torch.equal(back["params"][k], v)
    assert back["opt"]["m"]["embed"].dtype == torch.bfloat16
    flat, _ = restore_checkpoint(str(tmp_path), 7)
    assert torch.equal(flat["params/embed"], params["embed"].cpu())


def test_flash_route_refuses_autograd_on_the_card(dev):
    cfg = get_config("smollm-360m").reduced().with_(use_flash=True)
    model = build_model(cfg, dev).init(0)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 64), dtype=np.int32)).to(dev)
    before = AK.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward kernel"):
        model.loss({"tokens": tokens, "labels": tokens})
    assert AK.flash_attention.launches == before
    with torch.no_grad():
        model.loss({"tokens": tokens, "labels": tokens})
    assert AK.flash_attention.launches == before + cfg.num_layers


def test_device_put_resharded_on_the_card(dev):
    """A reduced smollm's bf16 parameters placed on the 2x4 mesh naming the
    card 8 times: every leaf's full() equals the host tree, each shard is
    its slice of it, one tensor per distinct slice (the tree's bytes on the
    card, not 8 times them), and the shards are freed after."""
    import repro_torch.distributed.sharding as S
    from repro_torch.checkpoint.reshard import device_put_resharded
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.train_step import model_params
    cfg = get_config("smollm-360m").reduced().with_(param_dtype="bfloat16")
    params = model_params(build_model(cfg, "cpu").init(0))
    mesh = make_test_mesh(device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    placed = device_put_resharded(params, mesh, cfg)
    used = torch.cuda.memory_allocated(dev) - before
    tree_bytes = sum(p.numel() * p.element_size() for p in params.values())
    assert tree_bytes <= used <= tree_bytes + 512 * 8 * len(params)
    specs = S.shard_params(params, mesh, cfg)
    for n, p in params.items():
        sh = placed[n]
        assert sh.spec == specs[n].spec
        assert all(s.device == dev and s.is_contiguous() for s in sh.shards)
        assert torch.equal(sh.full().cpu(), p)
        for idx, s in zip(sh.indices(), sh.shards):
            assert torch.equal(s.cpu(), p[idx])
    del placed, sh, s
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before


def test_serve_cli_on_the_card(dev):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "smollm-360m", "--reduced", "--device",
                      str(dev)])
    assert out["requests"] == 8 and out["tokens"] == 8 * 16
    assert out["ticks"] > 0 and out["steps"] > 0


def test_dryrun_allocates_nothing_on_the_card(dev):
    import repro_torch.launch.dryrun as DR
    from repro_torch.launch.mesh import make_test_mesh
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    row = DR.run_cell("smollm-360m", "train_4k", False,
                      mesh_factory=lambda multi_pod: make_test_mesh(
                          multi_pod=multi_pod, device=dev))
    assert row["status"] == "ok" and row["t_compute_s"] > 0
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before


NCCL_PROBE = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import place, shard_params
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.launch.mesh import distributed_mesh, init_world
from repro_torch.models import build_model
from repro_torch.models.model import shard_model
from repro_torch.train.optimizer import adamw
from repro_torch.train.train_step import (make_train_step, model_params,
                                          unit_layout)
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
dev = init_world(rank, world, f"tcp://localhost:{port}", backend="nccl",
                 timeout_s=120)
shape = (1, 1) if world == 1 else (world // 2, 2)
mesh = distributed_mesh(shape, ("data", "model"))
res = {"device": str(dev), "coordinate": mesh.coordinate()}
rng = np.random.default_rng(4)
# heads-parallel stablelm: the flash route on this rank's local heads
cfg = get_config("stablelm-1.6b").reduced().with_(use_flash=True)
model = build_model(cfg, dev).init(0)
plain = build_model(cfg.with_(use_flash=False), dev)
plain.load_state_dict(model.state_dict())
shard_model(model, mesh)
tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64),
                                       dtype=np.int32)).to(dev)
before = AK.flash_attention.launches
with mesh, torch.no_grad():
    got = model({"tokens": tokens})[0].full_tensor()
res["launches"] = AK.flash_attention.launches - before
with torch.no_grad():
    want = plain({"tokens": tokens})[0]
res["flash_err"] = (got - want).abs().max().item()
# a sequence-parallel smollm train step against the one-card step
cfg = get_config("smollm-360m").reduced()
one = build_model(cfg, dev).init(0)
model = shard_model(build_model(cfg, dev), mesh)
batch = {k: rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
         for k in ("tokens", "labels")}
opt = adamw(1e-4, eps=1e-6)
p1 = model_params(one)
p1, _, m1 = make_train_step(one, opt, 2)(p1, opt.init(p1, unit_layout(one)),
                                         batch)
params = model_params(one)
params = place(params, shard_params(params, mesh, cfg))
state = opt.init(params, unit_layout(model))
state = place(state, shard_params(state, mesh, cfg))
with mesh:
    params, _, m = make_train_step(model, opt, 2)(params, state, batch)
res["loss"], res["loss_one"] = float(m["loss"]), float(m1["loss"])
res["param_err"] = max((params[n].full_tensor() - p1[n]).abs().max().item()
                       for n in p1)
res["loss_device"] = m["loss"].device.type
json.dump(res, open(out, "w"))
dist.barrier()
dist.destroy_process_group()
"""


def _nccl_world(tmp_path, world):
    """``world`` NCCL ranks of ``NCCL_PROBE``, one a card; each must exit
    0 within 300 s.  Returns their results."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parents[1] / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", NCCL_PROBE, str(r), str(world), str(port),
         str(tmp_path / f"rank{r}.json")], env=dict(env, LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


def _check_nccl(res):
    for r, out in enumerate(res):
        assert out["device"] == f"cuda:{r}"
        assert out["launches"] == 2          # one a layer, local heads
        assert out["flash_err"] <= 1e-4
        assert out["loss"] == pytest.approx(out["loss_one"], rel=1e-5)
        assert out["param_err"] <= 1e-5
        assert out["loss_device"] == "cuda"


def test_one_rank_nccl_world_on_the_card(dev, tmp_path):
    """A (1, 1) mesh over a one-rank NCCL world: reduced stablelm's flash
    route (kernel 15 through ``local_map``) against the plain route, and a
    reduced smollm train step of 2 microbatches against the one-card
    step."""
    _check_nccl(_nccl_world(tmp_path, 1))


def test_one_rank_per_card(dev, tmp_path):
    """Every card a rank of a (cards / 2, 2) mesh: kernel 15 on each
    rank's local heads, a sharded train step against the one-card one."""
    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        pytest.skip("needs an even number of two or more cards")
    _check_nccl(_nccl_world(tmp_path, n))
