"""The port's codecs and page writes (``repro_torch/core/encoding.py``)
against the JAX package's.

The JAX package's ``test_encoding.py`` on the port, every encoder's and
decoder's output equal to the reference's on the same seeded inputs
(packed words, page headers, range decodes, RLE positions); then the
``set_page``/``append_page`` rows of ``test_device_resident.py`` and
``test_page_cache.py``: an in-place page write re-keys the packed column,
its device plan and the decoded-page LRU, so no read -- on any engine of
either package -- ever serves a stale row.
"""
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.core import encoding as JE
from repro.kernels.pac_decode import ops as JO
from repro_torch.core import encoding as TE
from repro_torch.core.page_cache import attach_page_cache, live_cache
from repro_torch.kernels.pac_decode import ops as TO

torch.set_num_threads(1)

PAGE = 256


def _page(p):
    return (p.count, p.first_value, p.vmin, p.vmax, p.min_deltas.tolist(),
            p.bit_widths.tolist(), p.word_offsets.tolist(),
            p.packed.tolist(), p.nbytes(), p.max_bit_width())


def _column(col):
    return (col.count, col.page_size, [_page(p) for p in col.pages],
            col.nbytes())


@pytest.mark.parametrize("bw", [1, 2, 4, 8, 16, 32])
def test_bitpack_roundtrip(bw):
    rng = np.random.default_rng(bw)
    hi = (1 << bw) - 1
    vals = rng.integers(0, hi + 1, size=101, dtype=np.uint64)
    words = TE.bitpack(vals, bw)
    np.testing.assert_array_equal(words, JE.bitpack(vals, bw))
    out = TE.bitunpack(words, bw, len(vals))
    np.testing.assert_array_equal(out, vals.astype(np.uint32))
    np.testing.assert_array_equal(out, JE.bitunpack(words, bw, len(vals)))
    assert TE.bitunpack(words, 0, 5).tolist() == [0] * 5


def test_bitpack_alignment_no_straddle():
    # power-of-two widths -> whole number of values per 32-bit word
    assert TE.ALLOWED_WIDTHS == JE.ALLOWED_WIDTHS
    assert TE.MINIBLOCK == JE.MINIBLOCK
    for bw in TE.ALLOWED_WIDTHS[1:]:
        assert 32 % bw == 0
    with pytest.raises(ValueError):
        TE.bitpack(np.arange(4), 3)


def test_delta_page_roundtrip_sorted():
    rng = np.random.default_rng(0)
    vals = np.sort(rng.integers(0, 1 << 30, size=2048))
    page = TE.delta_encode_page(vals)
    np.testing.assert_array_equal(TE.delta_decode_page(page), vals)
    assert _page(page) == _page(JE.delta_encode_page(vals))


def test_delta_page_negative_deltas():
    # dst column: sorted within src groups, drops across group boundaries
    vals = np.array([100, 105, 107, 3, 9, 12, 2000, 2001], np.int64)
    page = TE.delta_encode_page(vals)
    np.testing.assert_array_equal(TE.delta_decode_page(page), vals)
    assert _page(page) == _page(JE.delta_encode_page(vals))


def test_delta_page_widths_are_allowed():
    rng = np.random.default_rng(1)
    vals = np.sort(rng.integers(0, 1 << 20, size=4096))
    page = TE.delta_encode_page(vals[:2048])
    for w in page.bit_widths:
        assert int(w) in TE.ALLOWED_WIDTHS
    assert page.max_bit_width() == JE.delta_encode_page(
        vals[:2048]).max_bit_width()
    assert TE.delta_encode_page(np.zeros(0)).max_bit_width() == 0


def test_delta_compression_on_local_ids():
    # clustered neighbor ids => small deltas => far fewer bytes than plain
    rng = np.random.default_rng(2)
    base = np.cumsum(rng.integers(1, 16, size=100_000)).astype(np.int64)
    col = TE.delta_encode_column(base)
    assert col.nbytes() < 0.45 * base.size * 4  # paper: 58.1%-81.0% less
    assert _column(col) == _column(JE.delta_encode_column(base))
    blob = TE.plain_encode(base)
    assert blob == JE.plain_encode(base) and len(blob) == base.nbytes
    np.testing.assert_array_equal(
        TE.plain_decode(blob, np.int64, base.size), base)


def test_delta_column_range_decode():
    rng = np.random.default_rng(3)
    vals = np.sort(rng.integers(0, 1 << 28, size=10_000))
    col = TE.delta_encode_column(vals, page_size=1024)
    jcol = JE.delta_encode_column(vals, page_size=1024)
    for lo, hi in [(0, 1), (1023, 1025), (5000, 5001), (0, 10_000),
                   (9999, 10_000), (2048, 4096), (7, 7)]:
        got = TE.delta_decode_range(col, lo, hi)
        np.testing.assert_array_equal(got, vals[lo:hi])
        np.testing.assert_array_equal(got,
                                      JE.delta_decode_range(jcol, lo, hi))
        assert TE.pages_touched(col, lo, hi) == \
            JE.pages_touched(jcol, lo, hi)


def test_rle_roundtrip():
    v = np.array([1, 1, 0, 0, 0, 1, 0, 1, 1, 1], bool)
    col = TE.rle_encode_bool(v)
    np.testing.assert_array_equal(TE.rle_decode_bool(col), v)
    np.testing.assert_array_equal(col.positions,
                                  JE.rle_encode_bool(v).positions)
    starts, ends = col.interval_starts(True)
    got = []
    for s, e in zip(starts, ends):
        got.extend(range(s, e))
    np.testing.assert_array_equal(np.flatnonzero(v), got)


def test_rle_interval_counts():
    v = np.zeros(1000, bool)
    v[100:200] = True
    v[300:301] = True
    col = TE.rle_encode_bool(v)
    assert col.n_runs == 5
    s, e = col.interval_starts(True)
    assert list(s) == [100, 300] and list(e) == [200, 301]
    s0, e0 = col.interval_starts(False)
    assert list(s0) == [0, 200, 301] and list(e0) == [100, 300, 1000]


# ---------------- property-based (hypothesis) ----------------

@given(st.lists(st.integers(min_value=0, max_value=(1 << 31) - 1),
                min_size=1, max_size=500))
@settings(max_examples=40, deadline=None)
def test_delta_roundtrip_property(xs):
    vals = np.sort(np.array(xs, np.int64))
    page = TE.delta_encode_page(vals)
    np.testing.assert_array_equal(TE.delta_decode_page(page), vals)
    assert _page(page) == _page(JE.delta_encode_page(vals))


@given(st.lists(st.integers(min_value=-(1 << 30), max_value=1 << 30),
                min_size=1, max_size=300))
@settings(max_examples=30, deadline=None)
def test_delta_roundtrip_unsorted_property(xs):
    vals = np.array(xs, np.int64)  # arbitrary order: negatives via min_delta
    page = TE.delta_encode_page(vals)
    np.testing.assert_array_equal(TE.delta_decode_page(page), vals)
    assert _page(page) == _page(JE.delta_encode_page(vals))


@given(st.lists(st.booleans(), min_size=0, max_size=400))
@settings(max_examples=40, deadline=None)
def test_rle_roundtrip_property(bits):
    v = np.array(bits, bool)
    col = TE.rle_encode_bool(v)
    np.testing.assert_array_equal(TE.rle_decode_bool(col), v)
    p = col.positions
    assert p[0] == 0 and p[-1] == len(v)
    assert (np.diff(p) > 0).all() or len(v) == 0
    np.testing.assert_array_equal(p, JE.rle_encode_bool(v).positions)


@given(st.integers(min_value=1, max_value=5000),
       st.integers(min_value=0, max_value=10_000))
@settings(max_examples=20, deadline=None)
def test_delta_column_random_range_property(n, seed):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, 1 << 26, size=n))
    col = TE.delta_encode_column(vals, page_size=256)
    lo = int(rng.integers(0, n))
    hi = int(rng.integers(lo, n)) + 1
    np.testing.assert_array_equal(TE.delta_decode_range(col, lo, hi),
                                  vals[lo:hi])


# ---------------------- page writes re-key every cache ---------------------

def _tail(seed, n):
    return np.sort(np.random.default_rng(seed).integers(0, 1 << 20, n))


def test_mirror_invalidated_on_version_bump():
    col = TE.delta_encode_column(_tail(1, 3 * PAGE + 17), PAGE)
    packed = TE.pack_column(col)
    old_plan = packed.device_plan("cpu")
    new_tail = _tail(2, 17)
    # in-place rewrite of the last partial page: page count unchanged
    col.set_page(len(col.pages) - 1, TE.delta_encode_page(new_tail))
    assert col.version == 1 and col.count == 3 * PAGE + 17
    repacked = TE.pack_column(col)
    assert repacked is not packed                # cache keyed on version
    assert repacked.version == col.version
    fresh = repacked.device_plan("cpu")
    assert fresh is not old_plan                 # the plan died with it
    assert repacked.device_transfers == 1
    assert int(fresh[0][-1, 0]) == new_tail[0]
    assert TE.pack_column(col) is repacked       # stable until next write


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_in_place_page_write_never_serves_stale(engine):
    """``set_page`` of a partial page (the count follows it) and of a full
    one, then ``append_page``: the range decodes, with a warm LRU, equal
    the reference's after the same writes."""
    out = []
    for E, O, eng in ((JE, JO, "numpy" if engine == "numpy" else "jax"),
                      (TE, TO, engine)):
        col = E.delta_encode_column(_tail(3, 3 * PAGE + 29), PAGE)
        if E is TE:
            attach_page_cache(col, 64)
        else:
            from repro.core.page_cache import attach_page_cache as jattach
            jattach(col, 64)
        los = np.array([0, 3 * PAGE])
        his = np.array([PAGE, 3 * PAGE + 29])
        runs = [O.decode_row_ranges(col, los, his, engine=eng)]
        col.set_page(3, E.delta_encode_page(_tail(4, 40)))   # grows by 11
        his = np.array([PAGE, 3 * PAGE + 40])
        runs.append(O.decode_row_ranges(col, los, his, engine=eng))
        col.set_page(0, E.delta_encode_page(_tail(5, PAGE)))
        col.append_page(E.delta_encode_page(_tail(6, 9)))
        runs.append(O.decode_row_ranges(
            col, np.array([0, 3 * PAGE + 40]),
            np.array([PAGE, 3 * PAGE + 49]), engine=eng))
        np.testing.assert_array_equal(runs[1][:PAGE], runs[0][:PAGE])
        np.testing.assert_array_equal(runs[1][PAGE:], _tail(4, 40))
        np.testing.assert_array_equal(runs[2][:PAGE], _tail(5, PAGE))
        assert col.count == 3 * PAGE + 49 and col.version == 3
        cache = col.page_cache
        out.append(([r.tolist() for r in runs], cache.hits, cache.misses,
                     cache.version))
    assert out[0] == out[1]


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_lru_never_serves_stale_after_page_write(engine):
    col = TE.delta_encode_column(_tail(10, 20 * PAGE), PAGE)
    cache = attach_page_cache(col, 64)
    los, his = np.array([15 * PAGE]), np.array([16 * PAGE])
    TO.decode_row_ranges(col, los, his, engine=engine)    # warm page 15
    assert len(cache) == 1
    tail = _tail(12, PAGE)
    col.set_page(15, TE.delta_encode_page(tail))
    assert live_cache(col) is cache and len(cache) == 0   # dropped
    got = TO.decode_row_ranges(col, los, his, engine=engine)
    np.testing.assert_array_equal(got, tail)
    assert cache.version == col.version


SMALL = 32


@given(st.integers(min_value=0, max_value=1000),
       st.lists(st.tuples(st.integers(0, 2), st.integers(0, 500)),
                min_size=1, max_size=12))
@settings(max_examples=25, deadline=None)
def test_staleness_property(seed, ops):
    """Any interleaving of full-page appends, in-place rewrites and
    warm-cache reads serves the mirror's rows on the torch engine."""
    rng = np.random.default_rng(seed)
    mirror = np.sort(rng.integers(0, 1 << 20, 3 * SMALL))
    col = TE.delta_encode_column(np.asarray(mirror, np.int64), SMALL)
    attach_page_cache(col, 64)
    for kind, arg in ops:
        if kind == 0:
            vals = np.sort(rng.integers(0, 1 << 20, SMALL))
            col.append_page(TE.delta_encode_page(vals))
            mirror = np.concatenate([mirror, vals])
        elif kind == 1:
            i = arg % len(col.pages)
            vals = np.sort(rng.integers(0, 1 << 20, SMALL))
            col.set_page(i, TE.delta_encode_page(vals))
            mirror = mirror.copy()
            mirror[i * SMALL:(i + 1) * SMALL] = vals
        else:
            lo = arg % max(col.count, 1)
            hi = min(lo + 1 + (arg % (2 * SMALL)), col.count)
            got = TO.decode_row_ranges(col, np.asarray([lo]),
                                       np.asarray([hi]), None, "torch")
            np.testing.assert_array_equal(got, mirror[lo:hi])
    got = TO.decode_row_ranges(col, np.asarray([0]),
                               np.asarray([col.count]), None, "torch")
    np.testing.assert_array_equal(got, mirror)
