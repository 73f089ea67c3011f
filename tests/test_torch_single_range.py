"""The plain versions of the single-range kernels (``bitmap``, kernel 11,
and ``fused_decode_bitmap``, kernel 12) on their edge cases, against a
numpy oracle everywhere and against the JAX package's jnp references where
the reference's sum of bits equals the OR (sorted ids, or equal ids
adjacent within a page).

The cases (``_torch_cases.single_range_case``/``single_ids_case``, which
the card tests share) cover page sizes 32 to 16384, every width the packer
writes and widths it never writes, word offsets past the row, counts 0, 1,
``page_size - 1``, ``page_size`` and above it, int32 wraparound, no page,
one page and 9,000 pages, windows of 1 word, 64 words, one word more than
a warp's window in shared memory and 409,601 words at negative and positive
bases, ids below the window, at
its last id and past its end, all ids in one word and each in its own
word; for kernel 11 also ``count`` below the length, long runs of repeats,
unsorted ids and a length of 7 mod 16.  Every output is integer words:
equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import (SINGLE_IDS_KINDS, SINGLE_RANGE_KINDS,
                          SINGLE_RANGE_PAGE_SIZES, SINGLE_RANGE_WINDOWS,
                          ids_oracle, single_ids_case, single_range_case,
                          single_range_oracle)

from repro.kernels.pac_decode import ref as RR
from repro_torch.kernels.pac_decode import kernel as K
from repro_torch.kernels.pac_decode import ref as PR

torch.set_num_threads(1)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in arrays]


def _fused(pages, base, page_size, n_words):
    return K.fused_decode_bitmap(*_torch(pages), base=base,
                                 page_size=page_size, words_out=n_words)


#: (page size, window, kind): 9,000 pages only at page sizes 32 and 33
CASES = [(ps, w, k) for ps in SINGLE_RANGE_PAGE_SIZES
         for w in sorted(SINGLE_RANGE_WINDOWS) for k in SINGLE_RANGE_KINDS
         if k != "many_pages" or ps <= 33]


@pytest.mark.parametrize("page_size,window,kind", CASES)
def test_fused_decode_bitmap_plain_equals_oracle(page_size, window, kind):
    pages, base, n_words = single_range_case(page_size, window, kind)
    want = single_range_oracle(pages, base, page_size, n_words)
    got = _fused(pages, base, page_size, n_words)
    assert got.dtype == torch.int32 and got.shape == (n_words,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if kind in ("pages", "many_pages"):
        # ids at the window's first and last id
        assert want[0] & 1 and want[-1] >> 31


def _adjacent_duplicates(pages, page_size):
    """True when every page's equal valid ids are adjacent (the
    reference's sum is then an OR)."""
    ids = PR.decode_pages(*_torch(pages), page_size).numpy()
    for p in range(ids.shape[0]):
        x = ids[p, :max(0, min(int(pages[5][p, 0]), page_size))]
        if len(x) and len(np.unique(x)) != 1 + int((x[1:] != x[:-1]).sum()):
            return False
    return True


@pytest.mark.parametrize("window", ["64_words", "wide"])
@pytest.mark.parametrize("page_size", [99, 2048])
def test_fused_decode_bitmap_plain_equals_jnp_ref(page_size, window):
    pages, base, n_words = single_range_case(page_size, window)
    assert _adjacent_duplicates(pages, page_size)
    want = RR.fused_ref(*map(jnp.asarray, pages), jnp.int32(base),
                        page_size=page_size, words_out=n_words)
    got = _fused(pages, base, page_size, n_words)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("window", sorted(SINGLE_RANGE_WINDOWS))
@pytest.mark.parametrize("kind", SINGLE_IDS_KINDS)
def test_bitmap_plain_equals_oracle(kind, window):
    ids, count, base, n_words = single_ids_case(kind, window)
    assert len(ids) % 8 and len(ids) % 16 and count < len(ids)
    want = ids_oracle(ids[:count], base, n_words)
    t = torch.from_numpy(np.concatenate([[7], ids]).astype(np.int32))
    for view in (t[1:].clone(), t[1:]):       # aligned, and at offset 1
        got = K.bitmap(view, count, base, n_words)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert want.any()


@pytest.mark.parametrize("window", ["64_words", "wide"])
@pytest.mark.parametrize("kind", ["sorted_runs", "own_word"])
def test_bitmap_plain_equals_jnp_ref(kind, window):
    ids, count, base, n_words = single_ids_case(kind, window)
    want = RR.bitmap_ref(jnp.asarray(ids), jnp.int32(count), jnp.int32(base),
                         n_words)
    got = K.bitmap(torch.from_numpy(ids), count, base, n_words)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
