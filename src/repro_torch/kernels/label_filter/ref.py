"""Plain PyTorch versions of the ``cond_bitmap`` CUDA kernel
(``csrc/cond_bitmap.cu``) and of the filtered per-dispatch retrieval
(``csrc/per_dispatch.cu``).  The resident fused filtered retrieval's
plain version is :func:`repro_torch.kernels.pac_decode.ref.fused_gather_batch`
with ``fwords``."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.labels import eval_program
from repro_torch.kernels.pac_decode.ref import fused_batch, pack_bits


def eval_cond_bits(pos, meta, lanes, ops: Sequence[Tuple]) -> torch.Tensor:
    """The compiled program at bit positions ``lanes``: bool[len(lanes)].

    ``pos`` int32[k, n_pos] holds each label's interval position list,
    padded with the row count; ``meta`` int32[k, 2] = (first_value,
    count).  Lanes at or past the count are False, so NOT never sets bits
    past the rows."""
    leaves = []
    for i in range(pos.shape[0]):
        run = torch.searchsorted(pos[i].contiguous(), lanes, right=True) - 1
        leaves.append((meta[i, 0] ^ (run & 1)) == 1)
    return eval_program(ops, leaves) & (lanes < meta[0, 1])


def cond_bitmap(pos, meta, ops: Sequence[Tuple], n_words: int
                ) -> torch.Tensor:
    """Predicate bitmap over ``[0, 32 * n_words)``: int32[n_words]."""
    lanes = torch.arange(n_words * 32, dtype=torch.int32, device=pos.device)
    return pack_bits(eval_cond_bits(pos, meta, lanes, ops))


def fused_filter_batch(first, min_deltas, bit_widths, word_offsets, packed,
                       counts, cached, gidx, gcount, fpos, fmeta,
                       ops: Sequence[Tuple], n_words: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the filtered per-dispatch fused retrieval:
    :func:`fused_batch`'s words ANDed with the predicate evaluated over
    every lane of the target space.  Returns ``(words, ids)``."""
    words, ids = fused_batch(first, min_deltas, bit_widths, word_offsets,
                             packed, counts, cached, gidx, gcount, n_words)
    return words & cond_bitmap(fpos, fmeta, ops, n_words), ids
