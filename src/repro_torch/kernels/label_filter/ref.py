"""Plain PyTorch version of the ``cond_bitmap`` CUDA kernel
(``csrc/cond_bitmap.cu``).  The fused filtered retrieval's plain version
is :func:`repro_torch.kernels.pac_decode.ref.fused_gather_batch` with
``fwords``."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.labels import eval_program
from repro_torch.kernels.pac_decode.ref import wrap_int32


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


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[n_words * 32] -> int32[n_words] (little-endian bit order)."""
    b = bits.reshape(-1, 32).long()
    shifts = torch.arange(32, device=bits.device)
    return wrap_int32((b << shifts).sum(1))


def cond_bitmap(pos, meta, ops: Sequence[Tuple], n_words: int
                ) -> torch.Tensor:
    """Predicate bitmap over ``[0, 32 * n_words)``: int32[n_words]."""
    lanes = torch.arange(n_words * 32, dtype=torch.int32, device=pos.device)
    return pack_bits(eval_cond_bits(pos, meta, lanes, ops))
