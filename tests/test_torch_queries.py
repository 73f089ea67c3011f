"""The LDBC-SNB-style queries (paper §6.5) against the JAX package.

``ldbc_like(scale=1, seed=0)`` must give the JAX package's arrays.  Over
that graph (page size 1024), IS-3, IC-8 (with and without a reply label)
and BI-2 run on the JAX package (engines ``numpy`` and ``jax``) and on
the port (``numpy`` and ``torch``) under both transfer regimes -- the
module switch ``DEVICE_RESIDENT`` on, then off, in both packages -- and
must equal each other (results and IOMeter) and the acero baseline of
both packages (results), bit for bit.  Each regime must also have taken
its own kernels.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro.core import query as RQ
from repro.data.synthetic import ldbc_like as ref_ldbc_like
from repro.kernels.pac_decode import ops as RO
from repro_torch.core import query as TQ
from repro_torch.data.synthetic import ldbc_like
from repro_torch.kernels import _pad
from repro_torch.kernels.pac_decode import ops as O

torch.set_num_threads(1)

PAGE = 1024
ENGINES = [(RC, RQ, "numpy"), (RC, RQ, "jax"), (TC, TQ, "numpy"),
           (TC, TQ, "torch")]


@pytest.fixture(scope="module")
def snb():
    return ldbc_like(scale=1, seed=0)


@pytest.fixture(scope="module")
def graphs(snb):
    ref = ref_ldbc_like(scale=1, seed=0)
    return {RQ: (RQ.build_snb_graphar(ref, PAGE),
                 RQ.build_snb_baseline(ref, PAGE)),
            TQ: (TQ.build_snb_graphar(snb, PAGE),
                 TQ.build_snb_baseline(snb, PAGE))}


@pytest.fixture(params=["resident", "per-dispatch"])
def regime(request, monkeypatch):
    on = request.param == "resident"
    monkeypatch.setattr(RO, "DEVICE_RESIDENT", on)
    monkeypatch.setattr(O, "DEVICE_RESIDENT", on)
    _pad.reset_shape_classes()
    return request.param


def test_ldbc_like_matches_the_reference(snb):
    ref = ref_ldbc_like(scale=1, seed=0)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(snb, f.name)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), f.name
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def _run(graphs, query, *args, **kwargs):
    """``query`` (a graphar form's name) on every engine: results and
    IOMeter, which must all be equal."""
    out = []
    for mod, Q, engine in ENGINES:
        meter = mod.IOMeter()
        r = getattr(Q, query)(graphs[Q][0], *args, meter=meter,
                              engine=engine, **kwargs)
        r = r if isinstance(r, dict) else [x.tolist() for x in r]
        out.append((r, meter.nbytes, meter.nrequests))
    for (mod, _, engine), o in zip(ENGINES[1:], out[1:]):
        assert o == out[0], (mod.__name__, engine)
    return out[0][0]


def _kernels_run():
    return {k for k, v in _pad.shape_class_counts().items() if v}


def test_is3(snb, graphs, regime):
    deg = np.bincount(snb.knows_src, minlength=snb.num_persons)
    for p in (0, 17, int(np.argmax(deg))):
        friends, dates = _run(graphs, "is3_graphar", p)
        for Q in (RQ, TQ):
            f, d = Q.is3_acero(graphs[Q][1], p)
            assert sorted(friends) == np.sort(f).tolist()
            assert dates == d.tolist()
    assert _kernels_run() == {"gather_decode" if regime == "resident"
                              else "delta_decode"}


@pytest.mark.parametrize("label", [None, "TagClass0", "TagClass1"])
def test_ic8(snb, graphs, regime, label):
    msgs = np.bincount(snb.has_creator_person, minlength=snb.num_persons)
    top = int(np.argmax(msgs))
    assert msgs[top] >= O.FUSED_MIN_RANGES    # hop 2 takes the fused path
    creators = np.unique(snb.has_creator_person)
    for p in (top, int(creators[len(creators) // 2])):
        replies, dates = _run(graphs, "ic8_graphar", p, reply_label=label)
        for Q in (RQ, TQ):
            r, d = Q.ic8_acero(graphs[Q][1], p, reply_label=label)
            assert (replies, dates) == (r.tolist(), d.tolist())
    kernels = _kernels_run() - {"cond_bitmap"}
    if regime == "resident":   # a first traversal plan build decodes
        assert kernels - {"gather_decode"} == {"two_hop"}
    else:
        assert kernels == {"delta_decode", "fused_decode_filter_bitmap_batch"
                           if label else "fused_decode_bitmap_batch"}


def test_bi2(graphs, regime):
    for cls in ("TagClass0", "TagClass3"):
        counts = _run(graphs, "bi2_graphar", cls)
        assert counts
        for Q in (RQ, TQ):
            assert Q.bi2_acero(graphs[Q][1], cls) == counts
    kernels = _kernels_run() - {"cond_bitmap"}
    if regime == "resident":
        assert kernels - {"gather_decode"} == {"count_hop"}
    else:
        assert kernels == {"delta_decode"}


@pytest.mark.parametrize("cond", ["single", "not", "mix"])
def test_label_planes_and_host_reads_match_the_reference(graphs, cond):
    """The label baselines and interval filters, and the host reads the
    queries use, against the JAX package on the same tables."""
    def make(m):
        return {"single": m.L("TagClass1"), "not": ~m.L("TagClass2"),
                "mix": (m.L("TagClass0") & m.L("TagClass1"))
                | ~m.L("TagClass5")}[cond]

    from repro.core import labels as RL
    from repro.kernels.label_filter import ops as RLO
    from repro_torch.core import labels as TL
    from repro_torch.kernels.label_filter import ops as TLO
    out = []
    for mod, Q, L, LO, engines in ((RC, RQ, RL, RLO, ("numpy", "jax")),
                                   (TC, TQ, TL, TLO, ("numpy", "torch"))):
        g, base = graphs[Q]
        vt, svt = g.vertex("message"), base.message
        c = make(mod)
        meter = mod.IOMeter()
        row = [L.filter_string(svt, c, meter).tolist(),
               L.filter_binary_columns(vt, c, meter).tolist(),
               [x.tolist() for x in L.evaluate_filter_intervals(vt, c)],
               [x.tolist() for x in L.complex_filter_intervals(vt, c)]]
        for engine in engines:
            iv = L.filter_rle_interval(vt, c, meter, engine=engine)
            row += [[x.tolist() for x in iv], L.intervals_count(iv),
                    [x.tolist() for x in LO.label_filter_intervals(
                        vt, c, meter, engine=engine)],
                    sorted((p, w.tolist()) for p, w in LO.label_filter_pac(
                        vt, c, 512, meter, engine=engine).bitmaps.items())]
        adj = g.adjacency("message-hasTag-tag", mod.BY_SRC)
        rows = np.arange(0, 5000, 37)
        row += [adj.offsets_at(rows, meter).tolist(),
                [r.tolist() for r in adj.table["<dst>"].read_row_ranges(
                    rows, rows + 9, meter)],
                adj.neighbor_ids_scan(77, meter).tolist(),
                adj.topology_nbytes(), vt.labels_nbytes(),
                [(s.vmin, s.vmax) for s in
                 vt.property_column("creationDate").page_stats()],
                meter.nbytes, meter.nrequests]
        a = mod.PAC.from_ids(np.arange(0, 9000, 7), 1024)
        b = mod.PAC.from_ids(np.arange(3, 12000, 11), 1024)
        u = a.union(b)
        row += [sorted((p, w.tolist()) for p, w in u.bitmaps.items()),
                u.select({p: np.arange(p * 1024, p * 1024 + 1024) * 3
                          for p in u.pages()}).tolist()]
        assert row[4:8] == row[8:12]    # the host and the kernel engine
        out.append(row)
    assert out[0] == out[1]
