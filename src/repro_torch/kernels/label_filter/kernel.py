"""Wrappers of the label-filter CUDA kernels: ``cond_bitmap``
(``csrc/cond_bitmap.cu``) and the filtered fused retrieval
(``csrc/bitmap_scatter.cu``).

As in :mod:`repro_torch.kernels.pac_decode.kernel`: CUDA tensors launch
the kernel, CPU tensors run the plain version, and each wrapper counts
its launches in ``launches``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from repro_torch.core.labels import OP_AND, OP_LEAF, OP_NOT, OP_OR
from repro_torch.kernels import _build as B
from repro_torch.kernels._pad import note_shape
from repro_torch.kernels.pac_decode import kernel as PK
from repro_torch.kernels.pac_decode import ref as PR

from . import ref as R

#: deepest program the kernel's 64-bit stack register holds
MAX_DEPTH = 64
_OPCODES = {OP_NOT: -1, OP_AND: -2, OP_OR: -3}


def encode_program(ops: Sequence[Tuple]) -> List[int]:
    """Postfix program -> the kernel's int32 opcodes (i >= 0: push leaf i,
    -1 NOT, -2 AND, -3 OR).  Raises for a malformed program or one deeper
    than :data:`MAX_DEPTH`."""
    codes, depth, deepest = [], 0, 0
    for op in ops:
        if op[0] == OP_LEAF:
            codes.append(int(op[1]))
            depth += 1
        elif op[0] in _OPCODES:
            need = 1 if op[0] == OP_NOT else 2
            if depth < need:
                raise ValueError(f"malformed program: {op[0]} on a stack of "
                                 f"{depth}")
            codes.append(_OPCODES[op[0]])
            depth -= need - 1
        else:
            raise ValueError(f"unknown op {op!r}")
        deepest = max(deepest, depth)
    if depth != 1:
        raise ValueError(f"malformed program: {depth} planes left")
    if deepest > MAX_DEPTH:
        raise ValueError(f"program needs a stack of {deepest} > {MAX_DEPTH}")
    return codes


def cond_bitmap(pos: torch.Tensor, meta: torch.Tensor, ops: Sequence[Tuple],
                n_words: int) -> torch.Tensor:
    """Evaluate the postfix program ``ops`` over the RLE position lists
    -> int32[n_words] predicate words over ``[0, 32 * n_words)``."""
    note_shape("cond_bitmap", tuple(pos.shape), n_words, tuple(ops))
    codes = encode_program(ops)
    if not B.on_cuda(pos):
        return R.cond_bitmap(pos, meta, ops, n_words)
    dev = pos.device
    B.check(pos, "pos", dev, 2)
    B.check(meta, "meta", dev, 2)
    if meta.shape != (pos.shape[0], 2):
        raise ValueError(f"meta {tuple(meta.shape)} does not match pos "
                         f"{tuple(pos.shape)}")
    if max(codes) >= pos.shape[0]:
        raise ValueError(f"program reads leaf {max(codes)} of "
                         f"{pos.shape[0]}")
    if 32 * n_words >= 1 << 31:
        raise ValueError(f"n_words={n_words} overflows int32 bit lanes")
    opcodes = torch.tensor(codes, dtype=torch.int32).to(dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    B.launch("rt_cond_bitmap", B.ptr(pos), B.ptr(meta), pos.shape[1],
             B.ptr(opcodes), len(codes), B.ptr(out), n_words, B.stream(dev))
    cond_bitmap.launches += 1
    return out


cond_bitmap.launches = 0


def fused_gather_decode_filter_bitmap_batch(
        first, pos, mind, packed, staged: torch.Tensor, fwords: torch.Tensor,
        words: torch.Tensor, p_pad: int, want_ids: bool
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``fused_gather_decode_bitmap_batch`` with the resident predicate
    plane ``fwords`` ANDed into the target bitmap."""
    note_shape("fused_gather_decode_filter_bitmap_batch", staged.shape[0],
               p_pad, words.shape[0], want_ids, tuple(pos.shape))
    if not B.on_cuda(staged):
        w, ids = PR.fused_gather_batch(first, pos, mind, packed, staged,
                                       words.shape[0], p_pad, fwords)
        words.copy_(w)
        return (words, ids) if want_ids else words
    ids = PK.fused_launch("rt_fused_gather_decode_filter_bitmap", first,
                          pos, mind, packed, staged, words, p_pad, fwords)
    fused_gather_decode_filter_bitmap_batch.launches += 1
    return (words, ids) if want_ids else words


fused_gather_decode_filter_bitmap_batch.launches = 0
