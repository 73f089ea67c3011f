"""Wrappers of the label-filter CUDA kernels: ``cond_bitmap``
(``csrc/cond_bitmap.cu``) and the filtered fused retrievals, resident
(``csrc/bitmap_scatter.cu``) and per-dispatch (``csrc/per_dispatch.cu``).

As in :mod:`repro_torch.kernels.pac_decode.kernel`: CUDA tensors launch
the kernel, CPU tensors run the plain version, and each wrapper counts
its launches in ``launches``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

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
    return _encode(ops)[0]


def _encode(ops: Sequence[Tuple]) -> Tuple[List[int], int]:
    """:func:`encode_program`'s opcodes and the program's deepest stack."""
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
    return codes, deepest


#: (device, program) -> (the opcodes on that device, the program's depth,
#: its highest leaf), so a launch copies no program to the card
_PROGRAMS: Dict[Tuple[torch.device, Tuple], Tuple[torch.Tensor, int, int]] = {}


def device_program(ops: Sequence[Tuple], device
                   ) -> Tuple[torch.Tensor, int]:
    """``(opcodes, depth)``: the program's opcodes as an int32 tensor on
    ``device``, one tensor per ``(device, program)`` made on first use and
    kept, and its deepest stack.  Raises as :func:`encode_program`."""
    opcodes, depth, _ = _program(ops, torch.device(device))
    return opcodes, depth


def _program(ops: Sequence[Tuple], device: torch.device
             ) -> Tuple[torch.Tensor, int, int]:
    key = (device, tuple(ops))
    hit = _PROGRAMS.get(key)
    if hit is None:
        codes, depth = _encode(ops)
        hit = (torch.tensor(codes, dtype=torch.int32).to(device), depth,
               max(codes))
        _PROGRAMS[key] = hit
    return hit


def program_args(pos: torch.Tensor, meta: torch.Tensor, ops: Sequence[Tuple],
                 n_words: int) -> Tuple[torch.Tensor, int]:
    """Check the filter inputs of a launch; returns :func:`device_program`
    on the filter's device."""
    dev = pos.device
    B.check(pos, "pos", dev, 2)
    B.check(meta, "meta", dev, 2)
    if meta.shape != (pos.shape[0], 2):
        raise ValueError(f"meta {tuple(meta.shape)} does not match pos "
                         f"{tuple(pos.shape)}")
    opcodes, depth, top_leaf = _program(ops, dev)
    if top_leaf >= pos.shape[0]:
        raise ValueError(f"program reads leaf {top_leaf} of {pos.shape[0]}")
    if 32 * n_words >= 1 << 31:
        raise ValueError(f"n_words={n_words} overflows int32 bit lanes")
    return opcodes, depth


def cond_bitmap(pos: torch.Tensor, meta: torch.Tensor, ops: Sequence[Tuple],
                n_words: int) -> torch.Tensor:
    """Evaluate the postfix program ``ops`` over the RLE position lists
    -> int32[n_words] predicate words over ``[0, 32 * n_words)``."""
    note_shape("cond_bitmap", tuple(pos.shape), n_words, tuple(ops))
    if not B.on_cuda(pos):
        encode_program(ops)
        return R.cond_bitmap(pos, meta, ops, n_words)
    dev = pos.device
    opcodes, depth = program_args(pos, meta, ops, n_words)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    B.launch("rt_cond_bitmap", B.ptr(pos), B.ptr(meta), pos.shape[0],
             pos.shape[1], B.ptr(opcodes), opcodes.shape[0], depth,
             B.ptr(out), n_words, B.stream(dev))
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
                          pos, mind, packed, staged, words, p_pad, fwords,
                          want_ids)
    fused_gather_decode_filter_bitmap_batch.launches += PK.FUSED_LAUNCHES
    return (words, ids) if want_ids else words


fused_gather_decode_filter_bitmap_batch.launches = 0


def fused_decode_filter_bitmap_batch(
        first, min_deltas, bit_widths, word_offsets, packed, counts, cached,
        gidx, gcount, fpos: torch.Tensor, fmeta: torch.Tensor,
        ops: Sequence[Tuple], n_words: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_decode_bitmap_batch`` with the label predicate ``ops`` over
    the shipped RLE lists ``fpos``/``fmeta`` ANDed into the words.
    Returns ``(words, ids)``."""
    note_shape("fused_decode_filter_bitmap_batch", tuple(packed.shape),
               tuple(cached.shape), gidx.shape[0], n_words,
               tuple(fpos.shape), tuple(ops))
    if not B.on_cuda(first):
        encode_program(ops)
        return R.fused_filter_batch(first, min_deltas, bit_widths,
                                    word_offsets, packed, counts, cached,
                                    gidx, gcount, fpos, fmeta, ops, n_words)
    if fpos.device != first.device:
        raise ValueError(f"fpos is on {fpos.device}, expected "
                         f"{first.device}")
    opcodes, _ = program_args(fpos, fmeta, ops, n_words)
    out = PK.decode_launch("rt_fused_decode_filter_bitmap_batch", first,
                           min_deltas, bit_widths, word_offsets, packed,
                           counts, cached, gidx, gcount, n_words,
                           B.ptr(fpos), B.ptr(fmeta), fpos.shape[1],
                           B.ptr(opcodes), opcodes.shape[0])
    fused_decode_filter_bitmap_batch.launches += 1
    return out


fused_decode_filter_bitmap_batch.launches = 0
