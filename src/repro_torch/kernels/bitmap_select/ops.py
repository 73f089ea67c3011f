"""Selection pushdown (paper §4.3): a PAC and its pages' property values
-> the selected values, engine-dispatched.

``numpy`` selects on the host (the oracle); ``torch`` and ``cuda`` run the
``bitmap_select`` kernel's plain version and the kernel over all of the
PAC's non-empty pages in one dispatch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.pac import PAC
from repro_torch.kernels.pac_decode.ops import _to_device, engine_device

from . import kernel as K


def stage_pages(pac: PAC, page_values: Dict[int, np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel inputs over the PAC's pages in order: values
    float32[n, page_size] (a short page zero-padded) and words
    uint32[n, page_size / 32]."""
    pages = pac.pages()
    ps = pac.page_size
    wpp = ps // 32
    vals = np.zeros((len(pages), ps), np.float32)
    words = np.zeros((len(pages), wpp), np.uint32)
    for i, p in enumerate(pages):
        pv = np.asarray(page_values[p], np.float32)
        vals[i, :len(pv)] = pv
        words[i, :] = pac.bitmaps[p][:wpp]
    return vals, words


def select_from_pages(pac: PAC, page_values: Dict[int, np.ndarray],
                      engine: str = "cuda") -> np.ndarray:
    """float32 values of the PAC's ids, page by page in id order; a short
    page reads as zero-padded to the page size."""
    if not pac.pages():
        return np.zeros(0, np.float32)
    vals, words = stage_pages(pac, page_values)
    if engine == "numpy":
        return vals[np.unpackbits(words.view(np.uint8), axis=1,
                                  bitorder="little").astype(bool)]
    device = engine_device(engine)
    ps = pac.page_size
    out, counts = K.bitmap_select(_to_device(vals, device),
                                  _to_device(words.view(np.int32), device),
                                  ps)
    counts = counts.cpu().numpy()
    return out.cpu().numpy()[np.arange(ps)[None, :] < counts]
