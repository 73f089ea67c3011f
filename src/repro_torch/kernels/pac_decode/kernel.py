"""Wrappers of the pac_decode CUDA kernels (``csrc/gather_decode.cu``,
``csrc/bitmap_scatter.cu``, the per-dispatch pack route's
``csrc/per_dispatch.cu``, and the single-range entries of
``csrc/single_range.cu``).

A wrapper given CUDA tensors checks them, allocates its outputs with
``torch.empty`` and launches the kernel on the current stream; given CPU
tensors it runs the plain version in :mod:`.ref`.  There is no fallback
from one to the other.  Each wrapper counts its launches in a plain
integer attribute, ``launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels._pad import note_shape

from . import ref as R


def check_plan(first, pos, mind, packed, device: torch.device) -> None:
    """Validate a device unpack plan ``(first, pos, mind, packed)``."""
    for name, t in (("first", first), ("pos", pos), ("mind", mind),
                    ("packed", packed)):
        B.check(t, name, device, 2)
    n = first.shape[0]
    if first.shape[1] != 1 or pos.shape != mind.shape or pos.shape[0] != n \
            or packed.shape[0] != n or n == 0:
        raise ValueError(
            f"inconsistent plan shapes: first {tuple(first.shape)}, pos "
            f"{tuple(pos.shape)}, mind {tuple(mind.shape)}, packed "
            f"{tuple(packed.shape)}")


def _plan_args(first, pos, mind, packed):
    return (B.ptr(first), B.ptr(pos), B.ptr(mind), B.ptr(packed),
            first.shape[0], pos.shape[1], packed.shape[1])


def gather_decode(first, pos, mind, packed, idx: torch.Tensor
                  ) -> torch.Tensor:
    """Decode the plan rows named by ``idx`` (clamped to the column):
    int32[len(idx), page_size]."""
    note_shape("gather_decode", idx.shape[0], tuple(pos.shape))
    if not B.on_cuda(idx):
        return R.gather_decode(first, pos, mind, packed, idx)
    dev = idx.device
    check_plan(first, pos, mind, packed, dev)
    B.check(idx, "idx", dev, 1)
    out = torch.empty((idx.shape[0], pos.shape[1] + 1), dtype=torch.int32,
                      device=dev)
    B.launch("rt_gather_decode", *_plan_args(first, pos, mind, packed),
             B.ptr(idx), idx.shape[0], B.ptr(out), B.stream(dev))
    gather_decode.launches += 1
    return out


gather_decode.launches = 0


def check_staged(staged: torch.Tensor, words: torch.Tensor, p_pad: int,
                 device: torch.device) -> int:
    """Validate the staged vector and the words buffer; returns ``t``,
    the length of the padded requested-row vector."""
    B.check(staged, "staged", device, 1)
    B.check(words, "words", device, 1)
    t = staged.shape[0] - p_pad - 1
    if p_pad < 1 or t < 0:
        raise ValueError(f"staged has {staged.shape[0]} entries, too few "
                         f"for p_pad={p_pad}")
    return t


#: kernel launches of one resident fused call (``csrc/bitmap_scatter.cu``:
#: the mark, then the decode that ORs the requested ids' bits)
FUSED_LAUNCHES = 2


def fused_gather_decode_bitmap_batch(
        first, pos, mind, packed, staged: torch.Tensor, words: torch.Tensor,
        p_pad: int, want_ids: bool
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Resident fused retrieval: ``staged = [idx | gidx | total]`` -> the
    target bitmap, written into ``words`` (int32[n_words], fully
    overwritten).  Returns ``words``, or ``(words, ids)`` with the decoded
    int32[p_pad, page_size] matrix under ``want_ids``."""
    note_shape("fused_gather_decode_bitmap_batch", staged.shape[0], p_pad,
               words.shape[0], want_ids, tuple(pos.shape))
    if not B.on_cuda(staged):
        w, ids = R.fused_gather_batch(first, pos, mind, packed, staged,
                                      words.shape[0], p_pad)
        words.copy_(w)
        return (words, ids) if want_ids else words
    ids = fused_launch("rt_fused_gather_decode_bitmap", first, pos, mind,
                       packed, staged, words, p_pad, None, want_ids)
    fused_gather_decode_bitmap_batch.launches += FUSED_LAUNCHES
    return (words, ids) if want_ids else words


fused_gather_decode_bitmap_batch.launches = 0


def fused_launch(name: str, first, pos, mind, packed, staged, words,
                 p_pad: int, fwords: Optional[torch.Tensor],
                 want_ids: bool) -> Optional[torch.Tensor]:
    """Check and launch one resident fused C entry; returns the decoded
    int32[p_pad, page_size] matrix under ``want_ids``, else None (no
    matrix is written)."""
    dev = staged.device
    check_plan(first, pos, mind, packed, dev)
    t = check_staged(staged, words, p_pad, dev)
    page_size = pos.shape[1] + 1
    if p_pad * page_size >= 1 << 31 or 32 * words.shape[0] >= 1 << 31:
        raise ValueError(f"p_pad={p_pad} rows of {page_size} or "
                         f"{words.shape[0]} words overflow int32 indices")
    extra = ()
    if fwords is not None:
        B.check(fwords, "fwords", dev, 1)
        if fwords.shape != words.shape:
            raise ValueError(f"fwords {tuple(fwords.shape)} != words "
                             f"{tuple(words.shape)}")
        extra = (B.ptr(fwords),)
    # each row's last requested position + 1, then its request mask
    work = torch.zeros(p_pad * (1 + -(-page_size // 32)), dtype=torch.int32,
                       device=dev)
    ids = torch.empty((p_pad, page_size), dtype=torch.int32, device=dev) \
        if want_ids else None
    B.launch(name, *_plan_args(first, pos, mind, packed), B.ptr(staged),
             p_pad, t, None if ids is None else B.ptr(ids), B.ptr(work),
             B.ptr(words), words.shape[0], *extra, B.stream(dev))
    return ids


# --------------------------------------------------------------------------
# per-dispatch pack route: pages shipped as raw miniblock arrays
# --------------------------------------------------------------------------

def check_pages(first, min_deltas, bit_widths, word_offsets, packed, counts,
                device: torch.device) -> None:
    """Validate a batch of shipped pages (the six arrays of
    ``PackedPages.gather``, uint32 words as int32 bit patterns)."""
    arrays = (("first", first), ("min_deltas", min_deltas),
              ("bit_widths", bit_widths), ("word_offsets", word_offsets),
              ("packed", packed), ("counts", counts))
    for name, t in arrays:
        B.check(t, name, device, 2)
    n, n_mini = min_deltas.shape
    if first.shape != (n, 1) or counts.shape != (n, 1) \
            or bit_widths.shape != (n, n_mini) \
            or word_offsets.shape != (n, n_mini) or packed.shape[0] != n \
            or n_mini == 0 or packed.shape[1] == 0:
        raise ValueError("inconsistent page shapes: " + ", ".join(
            f"{name} {tuple(t.shape)}" for name, t in arrays))


def _page_args(first, min_deltas, bit_widths, word_offsets, packed, counts,
               page_size: int):
    return (B.ptr(first), B.ptr(min_deltas), B.ptr(bit_widths),
            B.ptr(word_offsets), B.ptr(packed), B.ptr(counts),
            first.shape[0], min_deltas.shape[1], packed.shape[1], page_size)


def delta_decode(first, min_deltas, bit_widths, word_offsets, packed, counts,
                 page_size: int) -> torch.Tensor:
    """Decode a batch of shipped pages: int32[n, page_size]; positions past
    a page's count hold the running last id."""
    note_shape("delta_decode", tuple(packed.shape), page_size)
    if not B.on_cuda(first):
        return R.decode_pages(first, min_deltas, bit_widths, word_offsets,
                              packed, counts, page_size)
    dev = first.device
    check_pages(first, min_deltas, bit_widths, word_offsets, packed, counts,
                dev)
    out = torch.empty((first.shape[0], page_size), dtype=torch.int32,
                      device=dev)
    B.launch("rt_delta_decode",
             *_page_args(first, min_deltas, bit_widths, word_offsets, packed,
                         counts, page_size), B.ptr(out), B.stream(dev))
    delta_decode.launches += 1
    return out


delta_decode.launches = 0


def decode_launch(name: str, first, min_deltas, bit_widths, word_offsets,
                  packed, counts, cached, gidx, gcount, n_words: int,
                  *extra) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check and launch one per-dispatch fused C entry (``extra``: the
    filter's arguments); returns ``(words, ids)``."""
    dev = first.device
    check_pages(first, min_deltas, bit_widths, word_offsets, packed, counts,
                dev)
    B.check(cached, "cached", dev, 2)
    B.check(gidx, "gidx", dev, 1)
    B.check(gcount, "gcount", dev, 2)
    m, ps = first.shape[0], cached.shape[1]
    if gcount.shape != (1, 1) or cached.shape[0] == 0 or ps == 0:
        raise ValueError(f"gcount {tuple(gcount.shape)} must be (1, 1) and "
                         f"cached {tuple(cached.shape)} non-empty")
    if (m + cached.shape[0]) * ps >= 1 << 31 or 32 * n_words >= 1 << 31:
        raise ValueError("matrix or target space overflows int32 indices")
    ids = torch.empty((m, ps), dtype=torch.int32, device=dev)
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    B.launch(name, *_page_args(first, min_deltas, bit_widths, word_offsets,
                               packed, counts, ps),
             B.ptr(cached), cached.shape[0], B.ptr(gidx), gidx.shape[0],
             B.ptr(gcount), B.ptr(ids), B.ptr(words), n_words, *extra,
             B.stream(dev))
    return words, ids


def fused_decode_bitmap_batch(first, min_deltas, bit_widths, word_offsets,
                              packed, counts, cached, gidx, gcount,
                              n_words: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dispatch fused retrieval: the shipped miss pages decode to
    ``ids`` (int32[m, page_size]); the ``gcount`` requested rows, flat
    positions ``gidx`` into ``[ids | cached]`` (page_size = the width of
    ``cached``), set their ids' bits in the int32[n_words] target bitmap.
    Returns ``(words, ids)``."""
    note_shape("fused_decode_bitmap_batch", tuple(packed.shape),
               tuple(cached.shape), gidx.shape[0], n_words)
    if not B.on_cuda(first):
        return R.fused_batch(first, min_deltas, bit_widths, word_offsets,
                             packed, counts, cached, gidx, gcount, n_words)
    out = decode_launch("rt_fused_decode_bitmap_batch", first, min_deltas,
                        bit_widths, word_offsets, packed, counts, cached,
                        gidx, gcount, n_words)
    fused_decode_bitmap_batch.launches += 1
    return out


fused_decode_bitmap_batch.launches = 0


# --------------------------------------------------------------------------
# single-range entries: ids -> bitmap, one page range -> bitmap
# --------------------------------------------------------------------------

#: largest page the fused single-range kernel takes
MAX_FUSED_PAGE = 1 << 15


def check_window(base: int, n_words: int) -> None:
    """Raise unless ``[base, base + 32 * n_words)`` is a 32-aligned window
    whose offsets fit int32."""
    if base % 32 or not -(1 << 31) <= base < (1 << 31):
        raise ValueError(f"base {base} must be a 32-aligned int32")
    if not 0 <= 32 * n_words < 1 << 31:
        raise ValueError(f"n_words {n_words} overflows int32 bit offsets")


def bitmap(ids: torch.Tensor, count: int, base: int,
           n_words: int) -> torch.Tensor:
    """ids (int32[n]) -> int32[n_words] over ``[base, base + 32 *
    n_words)`` with the bit of each of ``ids[:count]`` in range set, under
    any order and multiplicity; ``base`` is 32-aligned."""
    note_shape("bitmap", ids.shape[0], n_words)
    check_window(base, n_words)
    count = max(0, min(int(count), ids.shape[0]))
    if not B.on_cuda(ids):
        return R.bitmap(ids, count, base, n_words)
    dev = ids.device
    B.check(ids, "ids", dev, 1)
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    B.launch("rt_ids_bitmap", B.ptr(ids), count, base, B.ptr(words),
             n_words, B.stream(dev))
    bitmap.launches += 1
    return words


bitmap.launches = 0


def fused_decode_bitmap(first, min_deltas, bit_widths, word_offsets, packed,
                        counts, base: int, page_size: int,
                        words_out: int) -> torch.Tensor:
    """A batch of shipped pages -> int32[words_out] over ``[base, base +
    32 * words_out)``: the bits of every page's rows ``[0, count)``, the
    decoded ids kept on chip."""
    note_shape("fused_decode_bitmap", tuple(packed.shape), page_size,
               words_out)
    check_window(base, words_out)
    if not B.on_cuda(first):
        return R.fused_decode_bitmap(first, min_deltas, bit_widths,
                                     word_offsets, packed, counts, base,
                                     page_size, words_out)
    dev = first.device
    check_pages(first, min_deltas, bit_widths, word_offsets, packed, counts,
                dev)
    if not 1 <= page_size <= MAX_FUSED_PAGE \
            or first.shape[0] * page_size >= 1 << 31:
        raise ValueError(f"{first.shape[0]} pages of {page_size} rows: "
                         f"want 1 <= page_size <= {MAX_FUSED_PAGE} and "
                         "fewer than 2**31 rows")
    words = torch.empty(words_out, dtype=torch.int32, device=dev)
    B.launch("rt_fused_decode_bitmap",
             *_page_args(first, min_deltas, bit_widths, word_offsets, packed,
                         counts, page_size), base, B.ptr(words), words_out,
             B.stream(dev))
    fused_decode_bitmap.launches += 1
    return words


fused_decode_bitmap.launches = 0
