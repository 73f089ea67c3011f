"""Wrappers of the pac_decode CUDA kernels (``csrc/gather_decode.cu``,
``csrc/bitmap_scatter.cu``).

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
                       packed, staged, words, p_pad, None)
    fused_gather_decode_bitmap_batch.launches += 1
    return (words, ids) if want_ids else words


fused_gather_decode_bitmap_batch.launches = 0


def fused_launch(name: str, first, pos, mind, packed, staged, words,
                 p_pad: int, fwords: Optional[torch.Tensor]) -> torch.Tensor:
    """Check and launch one fused C entry; returns the decoded matrix
    (the ids output, or the scratch the bitmap is scattered from)."""
    dev = staged.device
    check_plan(first, pos, mind, packed, dev)
    t = check_staged(staged, words, p_pad, dev)
    extra = ()
    if fwords is not None:
        B.check(fwords, "fwords", dev, 1)
        if fwords.shape != words.shape:
            raise ValueError(f"fwords {tuple(fwords.shape)} != words "
                             f"{tuple(words.shape)}")
        extra = (B.ptr(fwords),)
    ids = torch.empty((p_pad, pos.shape[1] + 1), dtype=torch.int32,
                      device=dev)
    B.launch(name, *_plan_args(first, pos, mind, packed), B.ptr(staged),
             p_pad, t, B.ptr(ids), B.ptr(words), words.shape[0], *extra,
             B.stream(dev))
    return ids
