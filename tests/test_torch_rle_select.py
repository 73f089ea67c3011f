"""The plain versions of kernels 13 (``rle_to_bitmap``) and 14
(``bitmap_select``) on their edge cases, against the JAX package's jnp
references (``repro.kernels.rle_filter.ref``,
``repro.kernels.bitmap_select.ref``).

The cases (``_torch_cases.rle_case``/``select_case``, which the card tests
share) cover, for kernel 13, a boundary at every lane across several
blocks, thousands of padding copies inside the last word, a late start,
positions below 0, an empty column, a single run, counts that are no
multiple of 32, words past the count and positions past the words, each
with ``want`` 0 and 1; for kernel 14, page sizes 32, 64, 2048, 8192 and
2^18, pages that select nothing, everything, only the first or the last
lane or one word, NaN payloads, -0.0 and denormals, and 5,000 pages.
Every output is integer words or raw float32 patterns: equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import (RLE_CASES, SELECT_CASES, SPECIAL_BITS, rle_case,
                          select_case)

from repro.kernels.bitmap_select import ref as RBR
from repro.kernels.rle_filter import ref as RFR
from repro_torch.kernels.bitmap_select import kernel as BK
from repro_torch.kernels.rle_filter import kernel as FK

torch.set_num_threads(1)


@pytest.mark.parametrize("want", [0, 1])
@pytest.mark.parametrize("case", RLE_CASES)
def test_rle_to_bitmap_plain_equals_jnp_ref(case, want):
    pos, meta, n_words = rle_case(case, want)
    expect = np.asarray(RFR.rle_to_bitmap_ref(jnp.asarray(pos),
                                              jnp.asarray(meta), n_words))
    got = FK.rle_to_bitmap(torch.from_numpy(pos), torch.from_numpy(meta),
                           n_words)
    assert got.dtype == torch.int32 and got.shape == (n_words,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), expect)
    count = int(meta[0, 2])
    # nothing at or past the count, and the case is not all zeros
    # (one_run with want opposite to its value is)
    tail = np.unpackbits(expect.view(np.uint8), bitorder="little")[count:]
    assert not tail.any()
    assert expect.any() or case in ("empty_column", "one_run", "past_end")


@pytest.mark.parametrize("kind,page_size", SELECT_CASES)
def test_bitmap_select_plain_equals_jnp_ref(kind, page_size):
    vals, words = select_case(kind, page_size)
    want_out, want_cnt = RBR.bitmap_select_ref(jnp.asarray(vals),
                                               jnp.asarray(words), page_size)
    out, cnt = BK.bitmap_select(torch.from_numpy(vals),
                                torch.from_numpy(words.view(np.int32)),
                                page_size)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  np.asarray(want_out).view(np.int32))
    counts = cnt.numpy()[:, 0]
    if kind == "pages":
        # nothing, everything, the first lane, the last lane
        assert counts[1] == 0 and counts[2] == page_size
        assert out.numpy().view(np.uint32)[3, 0] == \
            vals.view(np.uint32)[3, 0]
        assert out.numpy().view(np.uint32)[4, 0] == \
            vals.view(np.uint32)[4, -1]
        np.testing.assert_array_equal(
            out.numpy().view(np.uint32)[0, :len(SPECIAL_BITS)],
            np.array(SPECIAL_BITS, np.uint32))
    else:
        assert counts.min() < counts.max()
