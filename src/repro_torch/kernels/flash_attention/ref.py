"""Plain PyTorch version of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``), run by the wrapper for CPU tensors and held
against the kernel on the card by ``chip_smoke.py``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, kv_group: int = 1,
                  q_start: int = 0) -> torch.Tensor:
    """Naive softmax attention; q: [..., H, sq, d], k/v: [..., H /
    kv_group, sk, d] (query head i reads KV head ``i // kv_group``, by
    index; ``[bh, seq, d]`` with ``kv_group=1`` is the reference's form),
    float32 math, the causal mask ``q_start + row >= col`` as ``-1e30``
    (query row ``row`` is the sequence's row ``q_start + row``), the
    result [..., H, sq, d] cast to ``q.dtype``."""
    qf = q.float().unflatten(-3, (-1, kv_group))      # [..., H_kv, g, sq, d]
    kf, vf = (x.float().unsqueeze(-3) for x in (k, v))  # [..., H_kv, 1, sk, d]
    s = torch.einsum("...qd,...kd->...qk", qf, kf) / (q.shape[-1] ** 0.5)
    if causal:
        seq_q, seq_k = s.shape[-2], s.shape[-1]
        rows = q_start + torch.arange(seq_q, device=s.device)[:, None]
        cols = torch.arange(seq_k, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("...qk,...kd->...qd", p, vf)
    return out.flatten(-4, -3).to(q.dtype)
