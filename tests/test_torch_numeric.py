"""Numeric predicate pushdown (``core/numeric.py``) in the port against the
JAX package.

One seeded community-local graph and a vertex table with an id-correlated
``age`` and an uncorrelated ``score`` property are built by both packages
(the rows of the reference's ``tests/test_page_pruning.py``).  A
:class:`NumericFilter` compiles to the same program and kernel plan, reads
and skips the same property pages through the zone maps, replays the same
charge, and pushes down into ``retrieve_neighbors_batch`` on the port's
``numpy`` and ``torch`` engines, resident and per-dispatch, with the PAC,
the IOMeter and the page counters equal to the reference's ``numpy`` and
``jax`` engines.  Label programs compile exactly as before.
"""
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC

torch.set_num_threads(1)

N = 1024
PAGE = 128
TPS = 256
DEG = 6


def _graph(mod):
    """Community-local ring: dst pages have tight id hulls."""
    off = np.concatenate([np.arange(-(DEG // 2), 0),
                          np.arange(1, DEG - DEG // 2 + 1)])
    dst = np.clip(np.arange(N)[:, None] + off[None, :], 0, N - 1).ravel()
    src = np.repeat(np.arange(N), DEG)
    return mod.build_adjacency(src, dst, N, N, mod.BY_SRC, mod.ENC_GRAPHAR,
                               page_size=PAGE)


def _vt(mod):
    rng = np.random.default_rng(3)
    age = (np.arange(N) // 4).astype(np.int64)       # id-correlated
    score = rng.integers(0, 50, N).astype(np.int64)  # uncorrelated
    labels = {"A": np.arange(N) < N // 6,
              "R": rng.random(N) < 0.4,
              "Z": np.zeros(N, bool)}
    return mod.VertexTable.build(
        mod.VertexTypeSchema("v", [mod.PropertySchema("age", "int64"),
                                   mod.PropertySchema("score", "int64")],
                             labels=["A", "R", "Z"], page_size=PAGE),
        {"age": age, "score": score}, labels, num_vertices=N)


@pytest.fixture(scope="module")
def tables():
    return {mod: (_graph(mod), _vt(mod)) for mod in (RC, TC)}


#: the same predicate built from either package's NumProp
CONDS = {
    "range_and": lambda M: (M.NumProp("age").between(30, 90)
                            & (M.NumProp("score") >= 10)),
    "narrow": lambda M: M.NumProp("age").between(0, 16),
    "or_eq": lambda M: (M.NumProp("age").between(40, 60)
                        | (M.NumProp("age") == 207)),
    "not": lambda M: ~(M.NumProp("age") < 100),
    "ne_gt": lambda M: (M.NumProp("score") != 7) & (M.NumProp("age") > 250),
}
BRUTE = {
    "range_and": lambda a, s: (a >= 30) & (a < 90) & (s >= 10),
    "narrow": lambda a, s: (a >= 0) & (a < 16),
    "or_eq": lambda a, s: ((a >= 40) & (a < 60)) | (a == 207),
    "not": lambda a, s: a >= 100,
    "ne_gt": lambda a, s: (s != 7) & (a > 250),
}


def _filters(tables, name):
    return (RC.NumericFilter(tables[RC][1], CONDS[name](RC)),
            TC.NumericFilter(tables[TC][1], CONDS[name](TC)))


def _leaf_tuples(program):
    return [(l.prop, l.lo, l.hi) for l in program.labels]


@pytest.mark.parametrize("name", sorted(CONDS))
def test_numeric_filter_compiles_and_plans_as_the_reference(tables, name):
    rf, tf = _filters(tables, name)
    assert tf.program.ops == rf.program.ops
    assert _leaf_tuples(tf.program) == _leaf_tuples(rf.program)
    rp, tp = rf.plan(), tf.plan()
    np.testing.assert_array_equal(tp.pos, rp.pos)
    np.testing.assert_array_equal(tp.meta, rp.meta)
    assert tp.count == rp.count and tp.qual_range() == rp.qual_range()
    assert (tf.prop_pages_read, tf.prop_pages_skipped) == \
        (rf.prop_pages_read, rf.prop_pages_skipped)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("name", sorted(CONDS))
def test_numeric_filter_matches_bruteforce(tables, name, engine):
    vt = tables[TC][1]
    age = np.asarray(vt.table["age"].values)
    score = np.asarray(vt.table["score"].values)
    _, tf = _filters(tables, name)
    qual = BRUTE[name](age, score)
    np.testing.assert_array_equal(
        np.flatnonzero(tf.mask_ids(np.arange(N), engine)),
        np.flatnonzero(qual))
    np.testing.assert_array_equal(tf.bitmap(engine),
                                  TC.intervals_to_bitmap(
                                      tf.intervals("numpy"), N))


def test_numeric_filter_zone_maps_skip_property_pages(tables):
    rf, tf = _filters(tables, "narrow")
    tf.charge(None)
    assert tf.prop_pages_skipped > 0
    stats = tables[TC][1].table["age"].page_stats()
    assert tf.prop_pages_read < len(stats)
    # the charge replays identically, and as the reference charges
    m1, m2, mr = TC.IOMeter(), TC.IOMeter(), RC.IOMeter()
    tf.charge(m1)
    tf.charge(m2)
    rf.charge(mr)
    assert (m1.nbytes, m1.nrequests) == (m2.nbytes, m2.nrequests) == \
        (mr.nbytes, mr.nrequests)
    assert m1.nbytes > 0
    assert (tf.prop_pages_read, tf.prop_pages_skipped) == \
        (rf.prop_pages_read, rf.prop_pages_skipped)


def test_numeric_filter_rejects_label_leaves(tables):
    with pytest.raises(TypeError):
        TC.NumericFilter(tables[TC][1],
                         TC.L("A") & (TC.NumProp("age") >= 3))


@pytest.mark.parametrize("seed", range(6))
def test_label_programs_compile_as_before(seed):
    rng = np.random.default_rng(seed)

    def tree(mod, r, depth):
        x = r.random()
        if depth <= 1 or x < 0.25:
            return mod.L("ABCD"[r.integers(4)])
        if x < 0.45:
            return mod.Not(tree(mod, r, depth - 1))
        op = mod.And if x < 0.75 else mod.Or
        return op(tree(mod, r, depth - 1), tree(mod, r, depth - 1))

    state = rng.bit_generator.state
    rcond = tree(RC, rng, 4)
    rng.bit_generator.state = state
    tcond = tree(TC, rng, 4)
    got, want = TC.compile_cond(tcond), RC.compile_cond(rcond)
    assert (got.labels, got.ops) == (want.labels, want.ops)
    assert all(isinstance(label, str) for label in got.labels)


_REFERENCE = {}


def _reference_run(tables, name, batch, engine):
    """The JAX package's retrieval with the filter (computed once)."""
    key = (name, batch, engine)
    if key not in _REFERENCE:
        adj, vt = tables[RC]
        filt = RC.NumericFilter(vt, CONDS[name](RC))
        meter = RC.IOMeter()
        vs = np.arange(0, N, N // batch)[:batch]
        pac = RC.retrieve_neighbors_batch(adj, vs, TPS, meter, engine,
                                          filter=filt)
        _REFERENCE[key] = (pac.to_ids(), meter.nbytes, meter.nrequests,
                           filt.prop_pages_read, filt.prop_pages_skipped)
    return _REFERENCE[key]


@pytest.mark.parametrize("route", ["resident", "per_dispatch"])
@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("name", ["range_and", "narrow", "not"])
def test_numeric_filtered_retrieval_equals_reference(tables, name, batch,
                                                     engine, route):
    adj, vt = tables[TC]
    filt = TC.NumericFilter(vt, CONDS[name](TC))
    meter = TC.IOMeter()
    vs = np.arange(0, N, N // batch)[:batch]
    pac = TC.retrieve_neighbors_batch(adj, vs, TPS, meter, engine,
                                      filter=filt,
                                      resident=route == "resident")
    got = (pac.to_ids(), meter.nbytes, meter.nrequests,
           filt.prop_pages_read, filt.prop_pages_skipped)
    for ref_engine in ("numpy", "jax"):
        want = _reference_run(tables, name, batch, ref_engine)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:], ref_engine
    assert len(got[0]) > 0
