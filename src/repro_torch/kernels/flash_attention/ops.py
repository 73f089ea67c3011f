"""Flash attention over ``[batch, heads, seq, d]`` with grouped KV heads."""
from __future__ import annotations

import torch

from . import kernel as K
from . import ref as R


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, use_kernel: bool = True) -> torch.Tensor:
    """q: [b, h, sq, d]; k/v: [b, h_kv, sk, d] with h_kv dividing h (GQA:
    head i reads KV head ``i // (h // h_kv)``).  ``use_kernel=False`` runs
    the plain version on any device (the reference's
    ``use_pallas=False``), which takes any shapes; the kernel route
    raises ``ValueError`` on the shapes the reference kernel asserts
    against."""
    b, h, sq, d = q.shape
    h_kv = k.shape[1]
    if h % h_kv:
        raise ValueError(f"{h_kv} KV heads do not divide {h} heads")
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    qf = q.reshape(b * h, sq, d).contiguous()
    kf = k.reshape(b * h, -1, d).contiguous()
    vf = v.reshape(b * h, -1, d).contiguous()
    if use_kernel:
        o = K.flash_attention(qf, kf, vf, causal=causal)
    else:
        o = R.attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(b, h, sq, d)
