"""Plain PyTorch versions of the pac_decode CUDA kernels.

The same functions as ``csrc/gather_decode.cu`` and
``csrc/bitmap_scatter.cu``, written as tensor code.  The kernel wrappers
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

from repro_torch.core.encoding import (POS_BW_MASK, POS_SHIFT_SHIFT,
                                       POS_WIDX_SHIFT)

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


def bitmap_scatter(ids: torch.Tensor, gidx: torch.Tensor,
                   total: torch.Tensor, n_words: int) -> torch.Tensor:
    """Requested rows -> int32[n_words] bitmap of their distinct ids.

    Row ``k < total`` reads ``ids.flat[clamp(gidx[k])]``; ids outside
    ``[0, 32 * n_words)`` are dropped.  There is no OR-reduce scatter, so
    the ids are deduplicated and distinct powers of two summed."""
    flat = ids.reshape(-1)
    vals = flat[gidx.long().clamp(0, flat.numel() - 1)].long()
    k = torch.arange(gidx.numel(), device=gidx.device)
    keep = (k < total) & (vals >= 0) & (vals < 32 * n_words)
    u = torch.unique(vals[keep])
    out = torch.zeros(n_words, dtype=torch.int64, device=ids.device)
    out.scatter_add_(0, u >> 5, torch.ones_like(u) << (u & 31))
    return wrap_int32(out)


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
