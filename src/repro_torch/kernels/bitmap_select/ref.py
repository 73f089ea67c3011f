"""Plain PyTorch version of the ``bitmap_select`` CUDA kernel
(``csrc/bitmap_select.cu``), run by the wrapper for CPU tensors and held
against the kernel on the card by ``chip_smoke.py``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.pac_decode.ref import MASK32


def bitmap_select(vals: torch.Tensor, words: torch.Tensor,
                  page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vals`` f32[n, page_size], ``words`` int32[n, page_size / 32] (the
    pages' bitmaps) -> (f32[n, page_size] with each page's selected values
    compacted to the front in lane order and zeros after them, int32[n, 1]
    counts).  Values move as raw 32-bit patterns."""
    n = vals.shape[0]
    lanes = torch.arange(page_size, device=vals.device)
    w = words.long() & MASK32
    bit = (w[:, lanes >> 5] >> (lanes & 31)) & 1
    mask = bit.bool()
    slot = torch.cumsum(bit, 1) - 1
    rows = torch.arange(n, device=vals.device)[:, None].expand(n, page_size)
    out = torch.zeros((n, page_size), dtype=torch.int32, device=vals.device)
    out[rows[mask], slot[mask]] = vals.view(torch.int32)[mask]
    return (out.view(torch.float32),
            mask.sum(1, dtype=torch.int32).reshape(n, 1))
