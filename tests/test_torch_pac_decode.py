"""The pac_decode kernels' plain PyTorch versions against the JAX package.

Both packages are fed one set of numpy arrays: the reference's
``PackedPages.host_arrays()`` go through ``packed_from_arrays`` into the
port, and the staged ``[idx | gidx | total]`` vector is the same int32
array for both.  The ``torch`` engine (what the kernel wrappers run for
CPU tensors) is held against the reference's jnp refs, and one tiny case
each against the Pallas kernels in interpret mode.  Every output is an
integer: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _torch_cases import PAGE_SIZES, RESIDENT_CASES, page_case, resident_case

import repro.core as RC
import repro_torch.core as TC
from repro.core.encoding import PackedPages as RPackedPages
from repro.kernels import _pad as RP
from repro.kernels.pac_decode import kernel as RK
from repro.kernels.pac_decode import ops as RO
from repro.kernels.pac_decode import ref as RR
from repro_torch.core.encoding import packed_from_arrays
from repro_torch.kernels import _pad
from repro_torch.kernels.pac_decode import kernel as K
from repro_torch.kernels.pac_decode import ops as O

torch.set_num_threads(1)

PAGE = 256


def _values(seed: int) -> np.ndarray:
    """Pages of every width: sorted ids, wide unsorted deltas (32-bit
    residuals, int32 wraparound), constants (width 0), a partial tail."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.sort(rng.integers(0, 1 << 22, 3 * PAGE)),
        rng.integers(-(1 << 30), 1 << 30, PAGE),
        np.full(PAGE, 12345),
        np.cumsum(rng.integers(0, 3, 2 * PAGE + 37)),
    ])


@pytest.fixture(scope="module")
def column():
    col = RC.delta_encode_column(_values(5), PAGE)
    rp = RC.pack_column(col)
    tp = packed_from_arrays(*rp.host_arrays(), page_size=PAGE)
    return col, rp, tp


def _staged(col, rng, n_ranges):
    """Staged vector of ``n_ranges`` random (overlapping) row ranges, built
    by both packages' dispatch helpers, which must agree."""
    los = rng.integers(0, col.count - 1, n_ranges)
    his = np.minimum(los + rng.integers(0, 300, n_ranges), col.count)
    pages, _ = O.page_set_for_ranges(los, his, PAGE)
    rpages, _ = RO.page_set_for_ranges(los, his, PAGE)
    np.testing.assert_array_equal(pages, rpages)
    gidx, total = O._gather_positions(pages, np.arange(len(pages)), los,
                                      his, PAGE)
    rgidx, rtotal = RO._gather_positions(pages, np.arange(len(pages)), los,
                                         his, PAGE)
    np.testing.assert_array_equal(gidx, rgidx)
    assert total == rtotal
    p_pad = O._page_class(len(pages), len(col.pages))
    assert p_pad == RO._page_class(len(pages), len(col.pages))
    staged = np.zeros(p_pad + len(gidx) + 1, np.int32)
    staged[:len(pages)] = pages
    staged[p_pad:-1] = gidx
    staged[-1] = total
    return staged, p_pad, total


def test_unpack_plan_decodes_like_the_oracle(column):
    col, rp, tp = column
    for a, b in zip(rp.unpack_plan(), tp.unpack_plan()):
        np.testing.assert_array_equal(a, b)
    idx = torch.arange(tp.n_pages, dtype=torch.int32)
    ids = K.gather_decode(tp.device_pages("cpu"), idx).numpy()
    for i, page in enumerate(col.pages):
        np.testing.assert_array_equal(ids[i, :page.count],
                                      RC.delta_decode_page(page))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_decode_matches_jnp_ref(column, seed):
    col, rp, tp = column
    rng = np.random.default_rng(seed)
    n = tp.n_pages
    idx = np.concatenate([rng.integers(0, n, 11),
                          [-3, n + 2, 0, n - 1, 0]]).astype(np.int32)  # clip
    got = K.gather_decode(tp.device_pages("cpu"), torch.from_numpy(idx))
    want = RR.gather_decode_ref(*map(jnp.asarray, rp.unpack_plan()),
                                jnp.asarray(idx), page_size=PAGE)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_decode_matches_pallas_interpret(column):
    _, rp, tp = column
    idx = np.array([4, 1, 6, 0], np.int32)
    got = K.gather_decode(tp.device_pages("cpu"), torch.from_numpy(idx))
    want = RK.gather_decode_pallas(*map(jnp.asarray, rp.unpack_plan()),
                                   jnp.asarray(idx), page_size=PAGE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("want_ids", [True, False])
@pytest.mark.parametrize("seed,n_ranges", [(3, 5), (4, 40), (5, 130)])
def test_fused_bitmap_matches_jnp_ref(column, seed, n_ranges, want_ids):
    col, rp, tp = column
    staged, p_pad, total = _staged(col, np.random.default_rng(seed),
                                   n_ranges)
    assert len(staged) - p_pad - 1 > total      # gidx padding past total
    n_words = 64
    words = torch.full((n_words,), -1, dtype=torch.int32)  # overwritten
    got = K.fused_gather_decode_bitmap_batch(
        *tp.device_plan("cpu"), torch.from_numpy(staged), words,
        p_pad=p_pad, want_ids=want_ids)
    want = RR.fused_gather_batch_ref(
        *map(jnp.asarray, rp.unpack_plan()), jnp.asarray(staged),
        jnp.zeros(n_words, jnp.uint32), page_size=PAGE, n_words=n_words,
        p_pad=p_pad, want_ids=want_ids)
    if want_ids:
        (gw, gi), (ww, wi) = got, want
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    else:
        gw, ww = got, want
    assert gw is words
    np.testing.assert_array_equal(gw.numpy().view(np.uint32),
                                  np.asarray(ww))


def test_fused_bitmap_matches_pallas_interpret(column):
    col, rp, tp = column
    staged, p_pad, _ = _staged(col, np.random.default_rng(9), 6)
    n_words = 64
    gw, gi = K.fused_gather_decode_bitmap_batch(
        *tp.device_plan("cpu"), torch.from_numpy(staged),
        torch.empty(n_words, dtype=torch.int32), p_pad=p_pad, want_ids=True)
    ww, wi = RK.fused_gather_decode_bitmap_batch(
        *map(jnp.asarray, rp.unpack_plan()), jnp.asarray(staged),
        jnp.zeros(n_words, jnp.uint32), page_size=PAGE, n_words=n_words,
        p_pad=p_pad, want_ids=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gw.numpy().view(np.uint32), np.asarray(ww))


def test_decode_row_ranges_engines_agree(column):
    col, _, _ = column
    tcol = TC.delta_encode_column(_values(5), PAGE)
    rng = np.random.default_rng(12)
    los = rng.integers(0, col.count, 30)
    his = np.minimum(los + rng.integers(0, 600, 30), col.count)
    want = RO.decode_row_ranges(col, los, his, engine="jax")
    for engine in ("numpy", "torch"):
        np.testing.assert_array_equal(
            O.decode_row_ranges(tcol, los, his, engine=engine), want)
    pages = [0, 2, 3, 7]
    np.testing.assert_array_equal(
        O.decode_page_list(tcol, pages, engine="torch"),
        RO.decode_page_list(col, pages, engine="jax"))


def test_wrapper_uses_plain_version_only_for_cpu_tensors(column):
    _, _, tp = column
    pages = tp.device_pages("cpu")
    before = K.gather_decode.launches
    K.gather_decode(pages, torch.zeros(8, dtype=torch.int32))
    assert K.gather_decode.launches == before    # no kernel on the CPU
    with pytest.raises(ValueError):
        K.gather_decode(pages, torch.zeros(8, dtype=torch.int32,
                                           device="meta"))


def test_device_pages_share_first_and_packed_with_the_plan(column):
    _, rp, _ = column
    tp = packed_from_arrays(*rp.host_arrays(), page_size=PAGE)
    pages = tp.device_pages("cpu")
    plan = tp.device_plan(torch.device("cpu"))
    assert tp.device_pages("cpu") is pages and tp.device_transfers == 1
    first, md, bw, wo, packed, counts = pages.arrays
    assert first.data_ptr() == plan[0].data_ptr()
    assert packed.data_ptr() == plan[3].data_ptr()
    for a, b in zip(pages.arrays, tp.host_arrays()):
        np.testing.assert_array_equal(a.numpy(), b.view(np.int32))
    assert pages.shape == (tp.n_pages, PAGE)
    assert tp.device_stats()["engines"] == ["cpu"]


@pytest.mark.parametrize("kind", ["sorted", "wide"])
@pytest.mark.parametrize("page_size", [256, 2048, 8192])
def test_gather_decode_clamps_and_short_last_page(page_size, kind):
    """Padding -7 and n_pages + 5 clamp to the first and last page, and a
    short last page holds its last id past its count."""
    rng = np.random.default_rng(page_size)
    n = 3 * page_size + 37
    vals = np.sort(rng.integers(0, 1 << 24, n)) if kind == "sorted" \
        else rng.integers(-(1 << 30), 1 << 30, n)
    rp = RC.pack_column(RC.delta_encode_column(vals, page_size))
    tp = packed_from_arrays(*rp.host_arrays(), page_size=page_size)
    n_pages = tp.n_pages
    idx = np.array([n_pages - 1, -7, 1, n_pages + 5, 0, n_pages - 1, 2,
                    -7], np.int32)
    got = K.gather_decode(tp.device_pages("cpu"), torch.from_numpy(idx))
    want = RR.gather_decode_ref(*map(jnp.asarray, rp.unpack_plan()),
                                jnp.asarray(idx), page_size=page_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, 37:] == int(vals[-1])).all()


def test_size_classes_match_the_reference():
    for n in (0, 1, 7, 8, 9, 100, 1000):
        for floor in (1, 8, 64):
            assert _pad.size_class(n, floor) == RP.size_class(n, floor)
        assert O._page_class(n, 300) == RO._page_class(n, 300)
    assert O.FUSED_MIN_RANGES == RO.FUSED_MIN_RANGES == 16
    assert (O.PAGE_CLASS_MIN, O.RANGE_CLASS_MIN) == \
        (RO.PAGE_CLASS_MIN, RO.RANGE_CLASS_MIN) == (8, 64)


def _plan_tensors(plan):
    """The resident case's plan as the port's CPU tensors (uint32 words as
    int32 bit patterns)."""
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in plan]


@pytest.mark.parametrize("case", RESIDENT_CASES)
@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_fused_bitmap_resident_cases_match_jnp_ref(page_size, case):
    plan, staged, p_pad, n_words = resident_case(page_size, case)
    for want_ids in (True, False):
        words = torch.full((n_words,), -1, dtype=torch.int32)
        got = K.fused_gather_decode_bitmap_batch(
            *_plan_tensors(plan), torch.from_numpy(staged), words,
            p_pad=p_pad, want_ids=want_ids)
        want = RR.fused_gather_batch_ref(
            *map(jnp.asarray, plan), jnp.asarray(staged),
            jnp.zeros(n_words, jnp.uint32), page_size=page_size,
            n_words=n_words, p_pad=p_pad, want_ids=want_ids)
        if want_ids:
            (gw, gi), (ww, wi) = got, want
            assert gi.shape == (p_pad, page_size)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        else:
            gw, ww = got, want
        np.testing.assert_array_equal(gw.numpy().view(np.uint32),
                                      np.asarray(ww))
        assert gw.numpy().any() == (case == "rows")


@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_gather_decode_resident_cases_match_jnp_ref(page_size):
    """Kernel 2 reads the miniblock arrays of the resident case's pages
    (:func:`page_case`); the reference decodes its own unpack plan of
    them."""
    arrays = page_case(page_size)
    _, staged, p_pad, _ = resident_case(page_size)
    idx = staged[:p_pad]              # with padding -7 and n_pages + 5
    tp = packed_from_arrays(*arrays, page_size=page_size)
    got = K.gather_decode(tp.device_pages("cpu"), torch.from_numpy(idx))
    plan = RPackedPages(*arrays, page_size=page_size).unpack_plan()
    want = RR.gather_decode_ref(*map(jnp.asarray, plan), jnp.asarray(idx),
                                page_size=page_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
