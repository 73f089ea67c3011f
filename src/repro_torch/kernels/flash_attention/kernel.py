"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``).

CUDA tensors launch the kernel (bfloat16 the tensor-core kernel, float32
the FMA kernel), CPU tensors run the plain version in :mod:`.ref`; there
is no fallback from one to the other.  The kernel reads q, k and v and
writes the output through their strides, and reads a query head's KV head
by index (GQA), so the wrapper copies nothing.  The grouped entry takes
queries that are a stretch of the keys' sequence (``q_start``: a rank's
rows on a sequence-parallel mesh).  Launches are counted in
``flash_attention.launches``, whichever entry launched.
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
#: every stride but the innermost (which is 1) is a multiple of this many
#: elements: the tensor-memory accelerator takes 16-byte row strides
STRIDE_MULTIPLE = 8


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` on what the reference kernel refuses: q, k and
    v of one shape ``[bh, seq, d]`` (the same seq for queries and keys)
    with ``seq % min(128, seq) == 0``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must share one [bh, seq, d] "
                         f"shape")
    _check_seq(q.shape[1])


def _check_seq(seq: int) -> None:
    if seq == 0 or seq % min(128, seq):
        raise ValueError(f"seq {seq} must be a multiple of "
                         f"min(128, seq) (the reference's block)")


def check_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, q_start: int = 0) -> None:
    """Raise ``ValueError`` unless q and out are ``[b, h, s_q, d]`` and k
    and v ``[b, h_kv, s_k, d]`` with ``h_kv`` dividing ``h`` and the
    queries rows ``q_start .. q_start + s_q`` of the keys' sequence, both
    lengths as :func:`check_shapes` takes a length, and each tensor laid
    out as the kernel reads it (see :func:`check_layout`)."""
    if q.dim() != 4 or out.shape != q.shape or k.shape != v.shape or \
            k.dim() != 4 or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, out {tuple(out.shape)} "
                         f"[b, h, s_q, d] and k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} [b, h_kv, s_k, d] do not fit")
    if q_start < 0 or q_start + q.shape[2] > k.shape[2]:
        raise ValueError(f"queries at rows {q_start}..{q_start + q.shape[2]}"
                         f" of a sequence of {k.shape[2]} keys")
    h, h_kv = q.shape[1], k.shape[1]
    if h_kv == 0 or h % h_kv:
        raise ValueError(f"{h_kv} KV heads do not divide {h} heads")
    _check_seq(q.shape[2])
    _check_seq(k.shape[2])
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_layout(t, name)


def check_layout(t: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` unless the last dim of ``t`` has stride 1 and
    every other dim longer than 1 a stride that is a multiple of
    ``STRIDE_MULTIPLE`` elements."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} has innermost stride {t.stride(-1)}, "
                         f"expected 1")
    if any(st % STRIDE_MULTIPLE for n, st in zip(t.shape[:-1], t.stride())
           if n > 1):
        raise ValueError(f"{name} has strides {t.stride()}: each but the "
                         f"last must be a multiple of {STRIDE_MULTIPLE}")


def _strides(t: torch.Tensor) -> tuple:
    """Batch, head and sequence strides of a 4-d tensor; a dim of length 1
    is never stepped, and gets the row length as a valid stride."""
    return tuple(st if n > 1 else t.shape[-1]
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v: [bh, seq, d] -> [bh, seq, d] in ``q.dtype`` (see
    :func:`.ref.attention_ref`)."""
    check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_layout(t, name)
    note_shape("flash_attention", tuple(q.shape), str(q.dtype), causal)
    if not B.on_cuda(q):
        return R.attention_ref(q, k, v, causal=causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q[None], k[None], v[None], out[None], causal, 0)
    return out


def flash_attention_into(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, causal: bool = True,
                         q_start: int = 0) -> torch.Tensor:
    """q: [b, h, s_q, d]; k/v: [b, h_kv, s_k, d] with ``h_kv`` dividing h
    (head i reads KV head ``i // (h // h_kv)``); query row ``row`` is the
    sequence's row ``q_start + row`` (under ``causal`` it sees keys up to
    that row).  Writes the attention of each query head into ``out`` [b,
    h, s_q, d] and returns it.  Any views that :func:`check_grouped`
    takes: nothing is copied."""
    check_grouped(q, k, v, out, q_start)
    note_shape("flash_attention", tuple(q.shape), tuple(k.shape),
               str(q.dtype), causal, q_start)
    if not B.on_cuda(q):
        return out.copy_(R.attention_ref(q, k, v, causal=causal,
                                         kv_group=q.shape[1] // k.shape[1],
                                         q_start=q_start))
    _launch(q, k, v, out, causal, q_start)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, causal: bool, q_start: int) -> None:
    """Launch the kernel on 4-d tensors that :func:`check_grouped`
    takes."""
    dev = q.device
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected "
                             f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, "
                         f"bfloat16)")
    b, h, seq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported ({HEAD_DIMS})")
    if b * h * max(seq, k.shape[2]) >= 1 << 31:
        raise ValueError(f"b * h * seq = {b * h * k.shape[2]} overflows "
                         f"int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    B.launch("rt_flash_attention", B.ptr(q), B.ptr(k), B.ptr(v), B.ptr(out),
             b, h, k.shape[1], seq, k.shape[2], int(q_start), d,
             *_strides(q), *_strides(k),
             *_strides(v), *_strides(out), _DTYPES[q.dtype], int(causal),
             B.stream(dev))
    flash_attention.launches += 1


flash_attention.launches = 0
