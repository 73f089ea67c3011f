"""Wrapper of the ``bitmap_select`` CUDA kernel
(``csrc/bitmap_select.cu``).

CUDA tensors launch the kernel, CPU tensors run the plain version in
:mod:`.ref`; there is no fallback from one to the other.  The wrapper
counts its launches in ``launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels._pad import note_shape

from . import ref as R

#: the largest page the wrapper takes; the kernel walks a page in tiles of
#: 1024 lanes with a carry, so its shared memory does not grow with the page
MAX_PAGE = 1 << 18


def bitmap_select(vals: torch.Tensor, words: torch.Tensor,
                  page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selection pushdown over a batch of pages: (f32[n, page_size]
    compacted values, int32[n, 1] counts); see :func:`.ref.bitmap_select`.
    ``page_size`` is a multiple of 32."""
    note_shape("bitmap_select", tuple(vals.shape), page_size)
    if not B.on_cuda(vals):
        return R.bitmap_select(vals, words, page_size)
    dev = vals.device
    if vals.dtype != torch.float32:
        raise ValueError(f"vals has dtype {vals.dtype}, expected float32")
    raw = vals.view(torch.int32)
    B.check(raw, "vals", dev, 2)
    B.check(words, "words", dev, 2)
    n = vals.shape[0]
    if page_size % 32 or not 32 <= page_size <= MAX_PAGE \
            or vals.shape != (n, page_size) \
            or words.shape != (n, page_size // 32):
        raise ValueError(f"vals {tuple(vals.shape)} and words "
                         f"{tuple(words.shape)} do not fit pages of "
                         f"{page_size} (a multiple of 32, at most "
                         f"{MAX_PAGE})")
    out = torch.empty((n, page_size), dtype=torch.int32, device=dev)
    counts = torch.empty((n, 1), dtype=torch.int32, device=dev)
    B.launch("rt_bitmap_select", B.ptr(raw), B.ptr(words), n, page_size,
             B.ptr(out), B.ptr(counts), B.stream(dev))
    bitmap_select.launches += 1
    return out.view(torch.float32), counts


bitmap_select.launches = 0
