"""The label-filter kernels' plain PyTorch versions against the JAX package.

Seeded random condition trees (depth up to 4, with ``Not``) over a vertex
table whose row count is not a multiple of 32 compile to the same postfix
program and plan in both packages; the ``cond_bitmap`` plain version is
held against ``cond_bitmap_ref`` (and once against the Pallas kernel in
interpret mode), and the fused filtered retrieval against
``fused_gather_filter_batch_ref``.  Outputs are integers: exact equality.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _torch_cases import (COND_CASES, DEPTH_64, FWORDS_KINDS, PAGE_SIZES,
                          RESIDENT_CASES, cond_case, resident_case,
                          resident_fwords)

import repro.core as RC
import repro_torch.core as TC
from repro.kernels.label_filter import kernel as RLK
from repro.kernels.label_filter import ops as RLO
from repro.kernels.label_filter import ref as RLR
from repro.kernels.pac_decode import ops as RO
from repro_torch.core.encoding import packed_from_arrays
from repro_torch.kernels.label_filter import kernel as LK
from repro_torch.kernels.label_filter import ops as LO
from repro_torch.kernels.pac_decode import ops as O

torch.set_num_threads(1)

N = 1000 + 13          # not a multiple of 32
NAMES = ["A", "B", "C", "D"]
PAGE = 256


def _tree(mod, rng, depth):
    """Random condition tree of at most ``depth`` levels."""
    r = rng.random()
    if depth <= 1 or r < 0.25:
        return mod.L(NAMES[rng.integers(len(NAMES))])
    if r < 0.45:
        return mod.Not(_tree(mod, rng, depth - 1))
    op = mod.And if r < 0.75 else mod.Or
    return op(_tree(mod, rng, depth - 1), _tree(mod, rng, depth - 1))


def _conds(seed):
    """The same random tree built in both packages."""
    return (_tree(RC, np.random.default_rng(seed), 4),
            _tree(TC, np.random.default_rng(seed), 4))


@pytest.fixture(scope="module")
def tables():
    from repro_torch.data.synthetic import clustered_labels
    labels = clustered_labels(N, NAMES, density=0.4, run_scale=40, seed=6)
    labels["D"][:] = True          # one label column of a single run
    rvt = RC.VertexTable.build(RC.VertexTypeSchema("v", [], labels=NAMES),
                               {}, labels, num_vertices=N)
    tvt = TC.VertexTable.build(TC.VertexTypeSchema("v", [], labels=NAMES),
                               {}, labels, num_vertices=N)
    return rvt, tvt


@pytest.mark.parametrize("seed", range(10))
def test_cond_bitmap_matches_jnp_ref(tables, seed):
    rvt, tvt = tables
    rc, tc = _conds(seed)
    rprog, tprog = RC.compile_cond(rc), TC.compile_cond(tc)
    assert (rprog.labels, rprog.ops) == (tprog.labels, tprog.ops)
    rplan, tplan = RLO.make_plan(rvt, rc), LO.make_plan(tvt, tc)
    np.testing.assert_array_equal(rplan.pos, tplan.pos)
    np.testing.assert_array_equal(rplan.meta, tplan.meta)
    ops = tplan.program.ops
    for n_words in (tplan.n_words, tplan.n_words + 3):
        got = LK.cond_bitmap(torch.from_numpy(tplan.pos),
                             torch.from_numpy(tplan.meta), ops, n_words)
        want = RLR.cond_bitmap_ref(jnp.asarray(rplan.pos),
                                   jnp.asarray(rplan.meta), n_words=n_words,
                                   ops=ops)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    # and the host oracle of both packages, through the public entry
    for engine in ("numpy", "torch"):
        np.testing.assert_array_equal(
            LO.label_filter_bitmap(tvt, tc, engine=engine),
            RLO.label_filter_bitmap(rvt, rc, engine="numpy"))


def test_cond_bitmap_matches_pallas_interpret(tables):
    rvt, tvt = tables
    rc, tc = _conds(3)
    plan = LO.make_plan(tvt, tc)
    n_words = 64      # the Pallas kernel's word tile
    got = LK.cond_bitmap(torch.from_numpy(plan.pos),
                         torch.from_numpy(plan.meta), plan.program.ops,
                         n_words)
    want = RLK.cond_bitmap_pallas(jnp.asarray(plan.pos),
                                  jnp.asarray(plan.meta), n_words=n_words,
                                  ops=plan.program.ops)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_device_bitmap_and_qual_range(tables):
    rvt, tvt = tables
    rc, tc = _conds(7)
    rplan, tplan = RLO.make_plan(rvt, rc), LO.make_plan(tvt, tc)
    assert rplan.qual_range() == tplan.qual_range()
    w = tplan.device_bitmap("cpu", tplan.n_words)
    assert tplan.device_bitmap("cpu", tplan.n_words) is w   # once
    np.testing.assert_array_equal(
        w.numpy().view(np.uint32),
        np.asarray(rplan.device_bitmap("jax", rplan.n_words)))


@pytest.mark.parametrize("want_ids", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_filter_matches_jnp_ref(tables, seed, want_ids):
    rvt, tvt = tables
    rng = np.random.default_rng(seed)
    col = RC.delta_encode_column(np.sort(rng.integers(0, N, 6 * PAGE + 50)),
                                 PAGE)
    rp = RC.pack_column(col)
    tp = packed_from_arrays(*rp.host_arrays(), page_size=PAGE)
    los = rng.integers(0, col.count - 1, 24)
    his = np.minimum(los + rng.integers(0, 400, 24), col.count)
    pages, _ = RO.page_set_for_ranges(los, his, PAGE)
    gidx, total = O._gather_positions(pages, np.arange(len(pages)), los,
                                      his, PAGE)
    p_pad = O._page_class(len(pages), len(col.pages))
    staged = np.zeros(p_pad + len(gidx) + 1, np.int32)
    staged[:len(pages)] = pages
    staged[p_pad:-1] = gidx
    staged[-1] = total
    rc, tc = _conds(seed + 20)
    plan = LO.make_plan(tvt, tc)
    n_words = plan.n_words
    fwords = plan.device_bitmap("cpu", n_words)
    got = LK.fused_gather_decode_filter_bitmap_batch(
        *tp.device_plan("cpu"), torch.from_numpy(staged), fwords,
        torch.empty(n_words, dtype=torch.int32), p_pad=p_pad,
        want_ids=want_ids)
    want = RLR.fused_gather_filter_batch_ref(
        *map(jnp.asarray, rp.unpack_plan()), jnp.asarray(staged),
        jnp.asarray(fwords.numpy().view(np.uint32)),
        jnp.zeros(n_words, jnp.uint32), page_size=PAGE, n_words=n_words,
        p_pad=p_pad, want_ids=want_ids)
    if want_ids:
        (gw, gi), (ww, wi) = got, want
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    else:
        gw, ww = got, want
    np.testing.assert_array_equal(gw.numpy().view(np.uint32), np.asarray(ww))


def test_program_encoding_limits():
    ops = TC.compile_cond((TC.L("A") & ~TC.L("B")) | TC.L("C")).ops
    assert LK.encode_program(ops) == [0, 1, -1, -2, 2, -3]
    deep = TC.L("A")
    for _ in range(70):             # right-leaning: the stack grows by one
        deep = TC.And(TC.L("B"), deep)
    with pytest.raises(ValueError, match="stack"):
        LK.encode_program(TC.compile_cond(deep).ops)
    with pytest.raises(ValueError, match="malformed"):
        LK.encode_program((("and",),))


@pytest.mark.parametrize("past_count", [False, True])
@pytest.mark.parametrize("case", COND_CASES)
def test_cond_bitmap_edge_cases_match_jnp_ref(case, past_count):
    pos, meta, ops = cond_case(case)
    n_words = -(-int(meta[0, 1]) // 32) + (5 if past_count else 0)
    got = LK.cond_bitmap(torch.from_numpy(pos), torch.from_numpy(meta), ops,
                         n_words)
    want = RLR.cond_bitmap_ref(jnp.asarray(pos), jnp.asarray(meta),
                               n_words=n_words, ops=ops)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    assert got.numpy().any()


def test_device_program_is_cached_per_device_and_program():
    ops = (("leaf", 0), ("leaf", 1), ("and",))
    opcodes, depth = LK.device_program(ops, "cpu")
    assert opcodes.tolist() == [0, 1, -2] and depth == 2
    again, _ = LK.device_program(ops, torch.device("cpu"))
    assert again is opcodes
    other, depth = LK.device_program(DEPTH_64, "cpu")
    assert other is not opcodes and depth == 64
    assert LK.device_program(DEPTH_64, "cpu")[0] is other
    deeper = tuple([("leaf", 0)] * 65 + [("or",)] * 64)
    with pytest.raises(ValueError, match="stack of 65 > 64"):
        LK.device_program(deeper, "cpu")
    with pytest.raises(ValueError, match="stack of 65 > 64"):
        LK.encode_program(deeper)


@pytest.mark.parametrize("fwords", FWORDS_KINDS)
@pytest.mark.parametrize("case", RESIDENT_CASES)
@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_fused_filter_resident_cases_match_jnp_ref(page_size, case, fwords):
    plan, staged, p_pad, n_words = resident_case(page_size, case)
    fw = resident_fwords(fwords, n_words)
    tplan = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
             for a in plan]
    for want_ids in (True, False):
        got = LK.fused_gather_decode_filter_bitmap_batch(
            *tplan, torch.from_numpy(staged), torch.from_numpy(fw),
            torch.full((n_words,), -1, dtype=torch.int32), p_pad=p_pad,
            want_ids=want_ids)
        want = RLR.fused_gather_filter_batch_ref(
            *map(jnp.asarray, plan), jnp.asarray(staged),
            jnp.asarray(fw.view(np.uint32)), jnp.zeros(n_words, jnp.uint32),
            page_size=page_size, n_words=n_words, p_pad=p_pad,
            want_ids=want_ids)
        if want_ids:
            (gw, gi), (ww, wi) = got, want
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        else:
            gw, ww = got, want
        np.testing.assert_array_equal(gw.numpy().view(np.uint32),
                                      np.asarray(ww))
        assert gw.numpy().any() == (case == "rows" and fwords != "zeros")
