"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``).

CUDA tensors launch the kernel, CPU tensors run the plain version in
:mod:`.ref`; there is no fallback from one to the other.  The wrapper
counts its launches in ``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels._pad import note_shape

from . import ref as R

#: head dims the kernel is compiled for (reduced configs; smollm and
#: stablelm; mistral and the reference's tests; gemma3)
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` on what the reference kernel refuses: q, k and
    v of one shape ``[bh, seq, d]`` (the same seq for queries and keys)
    with ``seq % min(128, seq) == 0``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must share one [bh, seq, d] "
                         f"shape")
    seq = q.shape[1]
    if seq == 0 or seq % min(128, seq):
        raise ValueError(f"seq {seq} must be a multiple of "
                         f"min(128, seq) (the reference's block)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v: [bh, seq, d] -> [bh, seq, d] in ``q.dtype`` (see
    :func:`.ref.attention_ref`)."""
    check_shapes(q, k, v)
    note_shape("flash_attention", tuple(q.shape), str(q.dtype), causal)
    if not B.on_cuda(q):
        return R.attention_ref(q, k, v, causal=causal)
    dev = q.device
    bh, seq, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected "
                             f"{q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, "
                         f"bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported ({HEAD_DIMS})")
    if bh * seq >= 1 << 31:
        raise ValueError(f"bh * seq = {bh * seq} overflows int32")
    out = torch.empty_like(q)
    B.launch("rt_flash_attention", B.ptr(q), B.ptr(k), B.ptr(v), B.ptr(out),
             bh, seq, d, _DTYPES[q.dtype], int(causal), B.stream(dev))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
