"""RLE label column -> bitmap words (paper §5.1), engine-dispatched.

``numpy`` expands the runs on the host (the oracle); ``torch`` and
``cuda`` run the ``rle_to_bitmap`` kernel's plain version and the kernel
over the interval position list, padded as the JAX package pads it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.encoding import RleColumn, rle_decode_bool
from repro_torch.kernels._pad import next_multiple
from repro_torch.kernels.pac_decode.ops import (WORD_TILE, _to_device,
                                                engine_device)

from . import kernel as K


def stage_rle(col: RleColumn, want: bool) -> Tuple[np.ndarray, np.ndarray,
                                                   int]:
    """The kernel inputs of one column, padded as the JAX package pads
    them: positions int32[1, n_pos] (filled with the count up to a multiple
    of 128), meta int32[1, 3] = (first_value, want, count) and the word
    count, a multiple of ``WORD_TILE``."""
    n_pos = next_multiple(col.positions.size, 128)
    pos = np.full((1, n_pos), col.count, np.int32)
    pos[0, :col.positions.size] = col.positions
    meta = np.array([[int(col.first_value), int(want), col.count]], np.int32)
    return pos, meta, next_multiple(-(-col.count // 32) or 1, WORD_TILE)


def rle_to_bitmap(col: RleColumn, want: bool = True,
                  engine: str = "cuda") -> np.ndarray:
    """Whole-column bitmap of ``label == want``: uint32[ceil(count / 32)]."""
    n_out = -(-col.count // 32)
    if engine == "numpy":
        plane = np.zeros(32 * n_out, bool)
        plane[:col.count] = rle_decode_bool(col) == want
        return np.packbits(plane, bitorder="little").view(np.uint32)
    device = engine_device(engine)
    pos, meta, n_words = stage_rle(col, want)
    words = K.rle_to_bitmap(_to_device(pos, device), _to_device(meta, device),
                            n_words)
    return words.cpu().numpy().view(np.uint32)[:n_out]
