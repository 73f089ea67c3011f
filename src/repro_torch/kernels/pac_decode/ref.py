"""Plain PyTorch versions of the pac_decode CUDA kernels.

The same functions as ``csrc/gather_decode.cu``,
``csrc/bitmap_scatter.cu``, ``csrc/per_dispatch.cu`` and
``csrc/single_range.cu``, written as tensor code.  The kernel wrappers
run them for CPU tensors (the CPU tests), and ``chip_smoke.py`` holds the
kernels against them on the card.  They work on any device.

Packed words are uint32 bit patterns held in int32 tensors.  PyTorch's
``>>`` on int32 is arithmetic and its integer ``cumsum`` returns int64, so
everything is widened to int64 (words masked to their 32 bits), and the
int32 wraparound of the kernels is applied once at the end: addition mod
2**32 gives the same low 32 bits whether it wraps at every step or once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.encoding import (MINIBLOCK, POS_BW_MASK,
                                       POS_SHIFT_SHIFT, POS_WIDX_SHIFT)

MASK32 = 0xFFFFFFFF


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def gather_rows(idx: torch.Tensor, *arrays: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Rows of ``arrays`` at ``idx``, indices clamped to the row range."""
    i = idx.long().clamp(0, arrays[0].shape[0] - 1)
    return tuple(a.index_select(0, i) for a in arrays)


def decode_plan_rows(first, pos, mind, packed) -> torch.Tensor:
    """Decode unpack-plan rows -> int32[n, d + 1] ids (see
    ``PackedPages.unpack_plan``); positions past a page's count hold the
    running last id."""
    p = pos.long()
    widx = (p >> POS_WIDX_SHIFT).clamp(max=packed.shape[1] - 1)
    shift = (p >> POS_SHIFT_SHIFT) & 31
    bw = p & POS_BW_MASK
    mask = (torch.ones_like(bw) << bw) - 1     # bw <= 32: fits in int64
    words = torch.gather(packed.long() & MASK32, 1, widx)
    deltas = ((words >> shift) & mask) + mind.long()
    f = first.long()
    return wrap_int32(torch.cat([f, f + torch.cumsum(deltas, 1)], 1))


def gather_decode(first, pos, mind, packed, idx) -> torch.Tensor:
    """Plain version of ``gather_decode``: int32[len(idx), d + 1]."""
    return decode_plan_rows(*gather_rows(idx, first, pos, mind, packed))


def set_bits(ids: torch.Tensor, valid: torch.Tensor, base: int,
             n_words: int) -> torch.Tensor:
    """int32[n_words] over ``[base, base + 32 * n_words)`` with the bit of
    every valid in-range id set: an OR, exact under any order and
    multiplicity of the ids."""
    rel = ids.reshape(-1).long() - base
    keep = valid.reshape(-1) & (rel >= 0) & (rel < 32 * n_words)
    plane = torch.zeros(32 * n_words, dtype=torch.bool, device=ids.device)
    plane[rel[keep]] = True
    return pack_bits(plane)


def bitmap_scatter(ids: torch.Tensor, gidx: torch.Tensor,
                   total: torch.Tensor, n_words: int) -> torch.Tensor:
    """Requested rows -> int32[n_words] bitmap of their distinct ids.

    Row ``k < total`` reads ``ids.flat[clamp(gidx[k])]``; ids outside
    ``[0, 32 * n_words)`` are dropped."""
    flat = ids.reshape(-1)
    vals = flat[gidx.long().clamp(0, flat.numel() - 1)]
    k = torch.arange(gidx.numel(), device=gidx.device)
    return set_bits(vals, k < total, 0, n_words)


def fused_gather_batch(first, pos, mind, packed, staged: torch.Tensor,
                       n_words: int, p_pad: int,
                       fwords: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused resident retrieval: ``staged`` is
    ``[idx (p_pad) | gidx | total]``.  Returns ``(words, ids)``; with
    ``fwords`` the words are ANDed with the predicate plane."""
    idx, gidx, total = staged[:p_pad], staged[p_pad:-1], staged[-1]
    ids = gather_decode(first, pos, mind, packed, idx)
    words = bitmap_scatter(ids, gidx, total, n_words)
    if fwords is not None:
        words = words & fwords
    return words, ids


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[n_words * 32] -> int32[n_words] (little-endian bit order)."""
    b = bits.reshape(-1, 32).long()
    shifts = torch.arange(32, device=bits.device)
    return wrap_int32((b << shifts).sum(1))


def decode_pages(first, min_deltas, bit_widths, word_offsets, packed,
                 counts, page_size: int) -> torch.Tensor:
    """Plain version of ``delta_decode``: shipped pages -> int32[n,
    page_size].  Delta j of a page lives in miniblock j // 32 at bit
    (j % 32) * width; deltas at or past ``count - 1`` are 0, so positions
    past a page's count hold the running last id.  Word and miniblock
    indices are clamped: the clamp only moves reads of zeroed deltas."""
    n, n_mini = min_deltas.shape
    dev = min_deltas.device
    j = torch.arange(page_size - 1, device=dev)
    mini = (j // MINIBLOCK).clamp(max=n_mini - 1)
    bw = bit_widths.long()[:, mini]                       # [n, d]
    bit = (j % MINIBLOCK) * bw
    widx = (word_offsets.long()[:, mini] + (bit >> 5)) \
        .clamp(0, packed.shape[1] - 1)
    words = torch.gather(packed.long() & MASK32, 1, widx)
    mask = torch.where(bw >= 32, torch.full_like(bw, MASK32),
                       (torch.ones_like(bw) << bw.clamp(max=32)) - 1)
    deltas = ((words >> (bit & 31)) & mask) + min_deltas.long()[:, mini]
    deltas = torch.where(j < counts.long() - 1, deltas,
                         torch.zeros_like(deltas))
    f = first.long()
    return wrap_int32(torch.cat([f, f + torch.cumsum(deltas, 1)], 1))


def rank_bitmap(full: torch.Tensor, gidx: torch.Tensor, gcount: torch.Tensor,
                n_words: int) -> torch.Tensor:
    """The TPU kernels' bitmap tail: the ``gcount`` requested rows (flat
    positions ``gidx`` into ``full``, clamped) are sorted with a sentinel
    past the target space for the padding, and bit ``t`` is set iff some
    sorted id equals ``t`` (a rank lookup).  Returns int32[n_words]."""
    n_slots = 32 * n_words
    if gidx.numel() == 0 or n_words == 0:
        return torch.zeros(n_words, dtype=torch.int32, device=full.device)
    flat = full.reshape(-1)
    vals = flat[gidx.long().clamp(0, flat.numel() - 1)].long()
    k = torch.arange(gidx.numel(), device=gidx.device)
    s, _ = torch.sort(torch.where(k < gcount.reshape(()).long(), vals,
                                  torch.full_like(vals, n_slots)))
    targets = torch.arange(n_slots, device=full.device)
    pos = torch.searchsorted(s, targets).clamp(max=s.numel() - 1)
    return pack_bits(s[pos] == targets)


def fused_batch(first, min_deltas, bit_widths, word_offsets, packed, counts,
                cached, gidx, gcount, n_words: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the per-dispatch fused retrieval: the shipped miss
    pages decode to ``ids``, the requested rows of ``[ids | cached]`` make
    the target bitmap.  Returns ``(words, ids)``."""
    ids = decode_pages(first, min_deltas, bit_widths, word_offsets, packed,
                       counts, cached.shape[1])
    full = torch.cat([ids, cached], 0)
    return rank_bitmap(full, gidx, gcount, n_words), ids


def bitmap(ids: torch.Tensor, count: int, base: int,
           n_words: int) -> torch.Tensor:
    """Plain version of ``ids_bitmap``: the bits of ``ids[:count]``."""
    k = torch.arange(ids.numel(), device=ids.device)
    return set_bits(ids, k < count, base, n_words)


def fused_decode_bitmap(first, min_deltas, bit_widths, word_offsets, packed,
                        counts, base: int, page_size: int,
                        words_out: int) -> torch.Tensor:
    """Plain version of ``fused_decode_bitmap``: the pages decode as in
    :func:`decode_pages`, and the bits of rows ``[0, count)`` of every
    page are set (vectorised over the pages)."""
    ids = decode_pages(first, min_deltas, bit_widths, word_offsets, packed,
                       counts, page_size)
    lane = torch.arange(page_size, device=ids.device)
    return set_bits(ids, lane[None, :] < counts.long(), base, words_out)
