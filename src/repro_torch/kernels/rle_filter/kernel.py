"""Wrapper of the ``rle_to_bitmap`` CUDA kernel (``csrc/rle_filter.cu``).

CUDA tensors launch the kernel, CPU tensors run the plain version in
:mod:`.ref`; there is no fallback from one to the other.  The wrapper
counts its launches in ``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels._pad import note_shape

from . import ref as R


def rle_to_bitmap(positions: torch.Tensor, meta: torch.Tensor,
                  n_words: int) -> torch.Tensor:
    """One RLE label column -> int32[n_words], the bits of the rows whose
    label equals ``want`` (see :func:`.ref.rle_to_bitmap`)."""
    note_shape("rle_to_bitmap", tuple(positions.shape), n_words)
    if not B.on_cuda(positions):
        return R.rle_to_bitmap(positions, meta, n_words)
    dev = positions.device
    B.check(positions, "positions", dev, 2)
    B.check(meta, "meta", dev, 2)
    if positions.shape[0] != 1 or positions.shape[1] == 0 \
            or meta.shape != (1, 3):
        raise ValueError(f"positions {tuple(positions.shape)} must be "
                         f"(1, n_pos) and meta {tuple(meta.shape)} (1, 3)")
    if not 0 <= 32 * n_words < 1 << 31:
        raise ValueError(f"n_words {n_words} overflows int32 lanes")
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    B.launch("rt_rle_to_bitmap", B.ptr(positions), positions.shape[1],
             B.ptr(meta), B.ptr(words), n_words, B.stream(dev))
    rle_to_bitmap.launches += 1
    return words


rle_to_bitmap.launches = 0
