"""Flash attention over ``[batch, heads, seq, d]`` with grouped KV heads."""
from __future__ import annotations

import torch

from . import kernel as K
from . import ref as R


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, use_kernel: bool = True,
        q_start: int = 0) -> torch.Tensor:
    """q: [b, h, sq, d]; k/v: [b, h_kv, sk, d] with h_kv dividing h (GQA:
    head i reads KV head ``i // (h // h_kv)`` by index; nothing is
    repeated or made contiguous).  Query row ``row`` is the sequence's row
    ``q_start + row`` (a sequence-parallel rank's stretch of the queries
    against the whole keys; 0 for the whole sequence).  The result is a [b, h, sq, d] view of
    a [b, sq, h, d] tensor, so ``transpose(1, 2).reshape(b, sq, -1)``
    copies nothing.  ``use_kernel=False`` runs the plain version on any
    device (the reference's ``use_pallas=False``), which takes any shapes;
    the kernel route raises ``ValueError`` on the shapes the reference
    kernel asserts against and on layouts the kernel cannot read
    (:func:`.kernel.check_grouped`), and raises ``RuntimeError`` under
    autograd (grad mode on and an input that requires a gradient): the
    kernel has no backward, as the reference's Pallas kernel has none, and
    its output would carry no gradient."""
    if use_kernel and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention has no backward kernel (neither has the "
            "reference's): train with use_flash=False, or run the forward "
            "under torch.no_grad()")
    b, h, sq, _ = q.shape
    h_kv = k.shape[1]
    if h % h_kv:
        raise ValueError(f"{h_kv} KV heads do not divide {h} heads")
    out = q.new_empty((b, sq, h, v.shape[-1])).transpose(1, 2)
    if use_kernel:
        return K.flash_attention_into(q, k, v, out, causal=causal,
                                      q_start=q_start)
    return out.copy_(R.attention_ref(q, k, v, causal=causal,
                                     kv_group=h // h_kv, q_start=q_start))
