"""The single-range bitmap, RLE-label and selection-pushdown entries of the
port against the JAX package.

``ids_to_bitmap`` and ``decode_range_to_bitmap`` (kernels ``bitmap`` and
``fused_decode_bitmap``), ``rle_filter.ops.rle_to_bitmap`` and
``bitmap_select.ops.select_from_pages`` run on seeded numpy inputs through
the JAX package's jnp references (``use_pallas=False``) and through the
port's ``numpy`` engine (the host oracle) and ``torch`` engine (the
kernels' plain versions).  Outputs are integers or float32 bit patterns:
words, counts and values must be equal bit for bit.  The kernel-level
cases feed the plain versions and the jnp references the same padded
arrays, counts and bases.

One deliberate difference is pinned: the JAX package's ``bitmap`` kernels
sum ``1 << bit`` over ids that are not equal to their predecessor, which
is an OR only when equal ids are adjacent.  Where they are not, the port
gives the set of ids (the numpy oracle) and the reference does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

import repro.core as RC
import repro_torch.core as TC
from repro.core.pac import bitmap_to_ids
from repro.kernels.bitmap_select import ops as RBO
from repro.kernels.bitmap_select import ref as RBR
from repro.kernels.pac_decode import ops as RO
from repro.kernels.pac_decode import ref as RR
from repro.kernels.rle_filter import ops as RFO
from repro.kernels.rle_filter import ref as RFR
from repro_torch.kernels.bitmap_select import kernel as BK
from repro_torch.kernels.bitmap_select import ops as BO
from repro_torch.kernels.pac_decode import kernel as K
from repro_torch.kernels.pac_decode import ops as O
from repro_torch.kernels.rle_filter import kernel as FK
from repro_torch.kernels.rle_filter import ops as FO

torch.set_num_threads(1)

ENGINES = ("numpy", "torch")


def _u32(words) -> np.ndarray:
    return np.asarray(words).astype(np.uint32)


_REFERENCE = {}


def _reference(key, fn):
    """The JAX package's answer for ``key``, computed once for all of the
    port's engines (its jnp references compile per shape)."""
    if key not in _REFERENCE:
        _REFERENCE[key] = fn()
    return _REFERENCE[key]


# ------------------------------ ids_to_bitmap ------------------------------

def _ids_case(name):
    rng = np.random.default_rng(7)
    if name == "empty":
        return np.zeros(0, np.int64), 0, 64
    if name == "sorted_dups":           # adjacent duplicates, 125 words
        return np.sort(rng.integers(0, 4000, 3000)), 0, 125
    if name == "window":                # ids on both sides of the window
        return np.sort(rng.integers(0, 6000, 2500)), 1024, 70
    if name == "last_bit":              # the last bit of the last word
        return np.array([0, 31, 32, 95, 96, 200]), 0, 3
    raise KeyError(name)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["empty", "sorted_dups", "window",
                                  "last_bit"])
def test_ids_to_bitmap_equals_reference(name, engine):
    ids, base, n_words = _ids_case(name)
    want = _reference(("ids", name), lambda: RO.ids_to_bitmap(
        ids, base, n_words, use_pallas=False))
    got = O.ids_to_bitmap(ids, base, n_words, engine=engine)
    assert got.dtype == np.uint32 and got.shape == (n_words,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_ids_to_bitmap_is_a_set_where_the_reference_sums(engine):
    ids = np.array([5, 7, 5, 9])
    got = O.ids_to_bitmap(ids, 0, 64, engine=engine)
    np.testing.assert_array_equal(bitmap_to_ids(got, 0), [5, 7, 9])
    # the recorded difference: non-adjacent duplicates carry in the sum
    ref = _reference("ids_sum", lambda: RO.ids_to_bitmap(
        ids, 0, 64, use_pallas=False))
    np.testing.assert_array_equal(bitmap_to_ids(ref, 0), [6, 7, 9])


@pytest.mark.parametrize("count", [0, 700, 1024, 5000])
def test_bitmap_plain_equals_reference_kernel_inputs(count):
    rng = np.random.default_rng(count)
    ids = np.zeros(1024, np.int32)              # padded as the JAX ops pad
    ids[:900] = np.sort(rng.integers(-300, 9000, 900))
    want = RR.bitmap_ref(jnp.asarray(ids), jnp.int32(count), jnp.int32(256),
                         256)
    got = K.bitmap(torch.from_numpy(ids), count, 256, 256)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _u32(want))


def test_bitmap_rejects_an_unaligned_base():
    with pytest.raises(ValueError, match="32-aligned"):
        K.bitmap(torch.zeros(4, dtype=torch.int32), 4, 16, 8)


# -------------------------- decode_range_to_bitmap --------------------------

def _column(page_size, n=5000, seed=11):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, 30_000, n))      # a partial last page
    return (RC.delta_encode_column(vals, page_size),
            TC.delta_encode_column(vals, page_size))


#: (page size, rows, first page, end row or None for the column's end,
#: base, n_words).  The sub-ranges span as many pages as the whole column
#: of their page size, so the reference compiles one decode per page size.
RANGES = [
    (512, 5000, 0, None, 0, 940),       # whole columns
    (1024, 5000, 0, None, 0, 940),
    (2048, 5000, 0, None, 0, 940),
    (512, 5512, 1, None, 3200, 300),    # p0 > 0, ids on both sides of the
    (1024, 7000, 1, 6144, 0, 1000),     # window; a page-aligned end
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", RANGES)
def test_decode_range_to_bitmap_equals_reference(case, engine):
    page_size, n, p0, end, base, n_words = case
    rcol, tcol = _column(page_size, n)
    lo, hi = p0 * page_size, rcol.count if end is None else end
    want = _reference(("range", case), lambda: RO.decode_range_to_bitmap(
        rcol, lo, hi, base, n_words, use_pallas=False))
    got = O.decode_range_to_bitmap(tcol, lo, hi, base, n_words,
                                   engine=engine)
    assert got.dtype == np.uint32 and got.shape == (n_words,)
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("engine", ENGINES)
def test_decode_range_to_bitmap_rejects_unaligned_ranges(engine):
    _, tcol = _column(512)
    for lo, hi in ((7, tcol.count), (0, 700)):
        with pytest.raises(AssertionError, match="page-aligned"):
            O.decode_range_to_bitmap(tcol, lo, hi, 0, 940, engine=engine)
    with pytest.raises(AssertionError):
        O.decode_range_to_bitmap(tcol, 0, 512, 16, 940, engine=engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_decode_range_to_bitmap_unsorted_column_is_a_set(engine):
    vals = np.array([5, 7, 5, 9, 3, 7] * 100)
    tcol = TC.delta_encode_column(vals, 512)
    got = O.decode_range_to_bitmap(tcol, 0, tcol.count, 0, 64,
                                   engine=engine)
    np.testing.assert_array_equal(bitmap_to_ids(got, 0), [3, 5, 7, 9])
    # the recorded difference: the reference sums non-adjacent duplicates
    rcol = RC.delta_encode_column(vals, 512)
    ref = _reference("unsorted", lambda: RO.decode_range_to_bitmap(
        rcol, 0, rcol.count, 0, 64, use_pallas=False))
    np.testing.assert_array_equal(bitmap_to_ids(ref, 0),
                                  [3, 4, 7, 8, 9, 10, 12, 13, 16])


def test_decode_range_to_bitmap_dst_like_column_equals_oracle():
    # a by_src adjacency's <dst>: sorted within each key's segment only
    rng = np.random.default_rng(3)
    segs = [np.sort(rng.integers(0, 3000, rng.integers(1, 40)))
            for _ in range(300)]
    vals = np.concatenate(segs)
    tcol = TC.delta_encode_column(vals, 256)
    got = {e: O.decode_range_to_bitmap(tcol, 0, tcol.count, 0, 94, engine=e)
           for e in ENGINES}
    np.testing.assert_array_equal(got["torch"], got["numpy"])
    np.testing.assert_array_equal(bitmap_to_ids(got["numpy"], 0),
                                  np.unique(vals))


@pytest.mark.parametrize("base", [0, 64])
def test_fused_decode_bitmap_plain_equals_reference_kernel_inputs(base):
    rcol, _ = _column(1024)
    args = RO.pack_pages(rcol, 0, len(rcol.pages))
    want = RR.fused_ref(*[jnp.asarray(a) for a in args], jnp.int32(base),
                        page_size=1024, words_out=960)
    got = K.fused_decode_bitmap(
        *[torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
          for a in args], base=base, page_size=1024, words_out=960)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _u32(want))


# ------------------------------ rle_to_bitmap ------------------------------

def _dense(n, kind, seed=0):
    rng = np.random.default_rng(seed + n)
    if kind == "random":
        return rng.random(n) < 0.3
    if kind == "all_true":
        return np.ones(n, bool)
    if kind == "all_false":
        return np.zeros(n, bool)
    return np.arange(n) % 2 == 1          # alternating: a run per row


def _rle_check(dense, want, engine):
    ref = _reference(("rle", dense.tobytes(), len(dense), want),
                     lambda: RFO.rle_to_bitmap(RC.rle_encode_bool(dense),
                                               want, use_pallas=False))
    got = FO.rle_to_bitmap(TC.rle_encode_bool(dense), want, engine=engine)
    assert got.dtype == np.uint32 and got.shape == (-(-len(dense) // 32),)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(bitmap_to_ids(got, 0),
                                  np.flatnonzero(dense == want))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("want", [True, False])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 2048, 50_000])
def test_rle_to_bitmap_equals_reference(n, want, engine):
    _rle_check(_dense(n, "random"), want, engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("want", [True, False])
@pytest.mark.parametrize("kind", ["all_true", "all_false", "alternating"])
@pytest.mark.parametrize("n", [33, 2048])
def test_rle_to_bitmap_uniform_and_alternating(n, kind, want, engine):
    _rle_check(_dense(n, kind), want, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_rle_to_bitmap_empty_column(engine):
    col = TC.rle_encode_bool(np.zeros(0, bool))
    assert (col.count, col.first_value, col.positions.tolist()) == \
        (0, False, [0])
    got = FO.rle_to_bitmap(col, True, engine=engine)
    assert got.dtype == np.uint32 and got.shape == (0,)


@pytest.mark.parametrize("first", [0, 1])
def test_rle_plain_equals_reference_kernel_inputs(first):
    # positions not starting at 0: lanes before positions[0] lie in run -1
    pos = np.full((1, 128), 300, np.int32)
    pos[0, :6] = [5, 40, 41, 100, 250, 300]
    meta = np.array([[first, 1, 300]], np.int32)
    want = RFR.rle_to_bitmap_ref(jnp.asarray(pos), jnp.asarray(meta), 64)
    got = FK.rle_to_bitmap(torch.from_numpy(pos), torch.from_numpy(meta), 64)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _u32(want))


@given(st.lists(st.booleans(), min_size=1, max_size=500))
@settings(max_examples=20, deadline=None)
def test_rle_to_bitmap_property(bits):
    dense = np.array(bits, bool)
    got = FO.rle_to_bitmap(TC.rle_encode_bool(dense), True, engine="torch")
    np.testing.assert_array_equal(bitmap_to_ids(got, 0),
                                  np.flatnonzero(dense))


# ----------------------------- select_from_pages -----------------------------

#: NaN payloads, -0.0, denormals and ordinary values, as bit patterns
SPECIAL = np.array([0x7FC01234, 0x80000000, 0x00000001, 0x007FFFFF,
                    0xFFC00001, 0x3F800000, 0x80000001], np.uint32)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n).astype(np.float32)
    vals.view(np.uint32)[::7][:len(SPECIAL)] = SPECIAL[:len(vals[::7])]
    return vals


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("page_size", [32, 256, 2048])
def test_select_from_pages_equals_reference(page_size, engine):
    n = 5 * page_size + page_size // 2      # a short last page
    vals = _values(n, page_size)
    rng = np.random.default_rng(page_size)
    ids = np.unique(np.concatenate([rng.integers(0, n, n // 5),
                                    np.arange(0, 50, 7), [n - 1]]))
    ids = ids[ids // page_size != 2]
    rpac = RC.PAC.from_ids(ids, page_size)
    tpac = TC.PAC.from_ids(ids, page_size)
    # a page present in the PAC whose words select nothing
    for pac in (rpac, tpac):
        pac.bitmaps[2] = np.zeros(page_size // 32, np.uint32)
    pages = {p: vals[p * page_size:(p + 1) * page_size]
             for p in tpac.pages()}
    ref = _reference(("select", page_size), lambda:
                     RBO.select_from_pages(rpac, pages, use_pallas=False))
    got = BO.select_from_pages(tpac, pages, engine=engine)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(ref, np.float32).view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  vals[ids].view(np.int32))
    if engine == "torch":
        # the kernel's plain version against the jnp reference: the whole
        # compacted matrix (zeros past each count) and the counts
        v, w = BO.stage_pages(tpac, pages)
        want_out, want_cnt = RBR.bitmap_select_ref(jnp.asarray(v),
                                                   jnp.asarray(w), page_size)
        out, cnt = BK.bitmap_select(torch.from_numpy(v),
                                    torch.from_numpy(w.view(np.int32)),
                                    page_size)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
        assert int(cnt[2, 0]) == 0
        np.testing.assert_array_equal(out.numpy().view(np.int32),
                                      np.asarray(want_out).view(np.int32))


@pytest.mark.parametrize("engine", ENGINES)
def test_select_from_pages_empty_pac(engine):
    got = BO.select_from_pages(TC.PAC(256), {}, engine=engine)
    assert got.dtype == np.float32 and got.shape == (0,)
