"""Plain PyTorch version of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``), run by the wrapper for CPU tensors and held
against the kernel on the card by ``chip_smoke.py``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention; q/k/v: [bh, seq, d], float32 math, the
    causal mask ``row >= col`` as ``-1e30``, the result cast to
    ``q.dtype``."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) / (q.shape[-1] ** 0.5)
    if causal:
        seq_q, seq_k = s.shape[-2], s.shape[-1]
        rows = torch.arange(seq_q, device=s.device)[:, None]
        cols = torch.arange(seq_k, device=s.device)[None, :]
        s = torch.where((rows >= cols)[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)
