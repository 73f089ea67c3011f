"""The traversal kernels on the card, at the CPU tests' small sizes.

Each CUDA kernel is held bit for bit against its plain PyTorch version on
the same CUDA tensors, and the cuda engine's ``k_hop``, ``two_hop_pac``
and ``frontier_edge_counts`` against the numpy oracle (ids, counts,
IOMeter and LRU counters).  Every test here needs an NVIDIA GPU and
``nvcc`` and skips without one; run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
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
