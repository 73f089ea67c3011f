"""Plain PyTorch version of the ``rle_to_bitmap`` CUDA kernel
(``csrc/rle_filter.cu``), run by the wrapper for CPU tensors and held
against the kernel on the card by ``chip_smoke.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.pac_decode.ref import pack_bits


def rle_to_bitmap(positions: torch.Tensor, meta: torch.Tensor,
                  n_words: int) -> torch.Tensor:
    """``positions`` int32[1, n_pos] (sorted, padded with the row count),
    ``meta`` int32[1, 3] = (first_value, want, count) -> int32[n_words]:
    lane l lies in run ``searchsorted(positions, l, right) - 1``, its value
    is ``first_value ^ (run & 1)``, and its bit is ``value == want`` for
    lanes below the count."""
    pos = positions[0].contiguous()
    first_value, want, count = meta[0, 0], meta[0, 1], meta[0, 2]
    lanes = torch.arange(32 * n_words, dtype=torch.int32, device=pos.device)
    run = torch.searchsorted(pos, lanes, right=True) - 1
    return pack_bits(((first_value ^ (run & 1)) == want) & (lanes < count))
