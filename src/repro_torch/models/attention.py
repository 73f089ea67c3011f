"""Attention: GQA, sliding-window and cross attention with KV-cache decode.

The JAX package's ``models/attention.py`` on PyTorch.  The full-sequence
self-attention with ``use_flash`` goes through the flash attention kernel
(``kernels/flash_attention``); every other call -- a cached one, or cross
attention over given keys and values (``kv_override``) -- runs the plain
tensor code of :func:`sdpa`, as the reference leaves its einsums to XLA.  The reference's GSPMD sharding hints have no effect on one device
and are dropped.

The KV cache is written in place (the reference returns new arrays); the
returned cache holds the same ``k``/``v`` tensors and a new ``index``.  A
scalar ``index`` is a 0-dim CPU tensor, so positions and slices cost no
device round trip; a per-slot vector ``index`` lives on the cache's
device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .layers import Norm, apply_rope, linear_init, matmul, param

NEG_INF = -1e30


class Attention(nn.Module):
    """Projections ``q``/``k``/``v``/``o`` (``[d_in, d_out]``) and, with
    ``qk_norm``, per-head RMS norms of q and k."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, qk_norm: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.q = param((d_model, num_heads * head_dim), dtype, device)
        self.k = param((d_model, num_kv_heads * head_dim), dtype, device)
        self.v = param((d_model, num_kv_heads * head_dim), dtype, device)
        self.o = param((num_heads * head_dim, d_model), dtype, device)
        if qk_norm:
            self.q_norm = Norm("rms", head_dim, dtype, device)
            self.k_norm = Norm("rms", head_dim, dtype, device)

    def init_(self, gen: Optional[torch.Generator]) -> None:
        for w in (self.q, self.k, self.v, self.o):
            w.data.copy_(linear_init(gen, *w.shape, w.dtype,
                                     device=w.device))
        if hasattr(self, "q_norm"):
            self.q_norm.init_()
            self.k_norm.init_()


def attention_init(gen: Optional[torch.Generator], d_model: int,
                   num_heads: int, num_kv_heads: int, head_dim: int,
                   qk_norm: bool = False, dtype=torch.float32,
                   device=None) -> Attention:
    attn = Attention(d_model, num_heads, num_kv_heads, head_dim, qk_norm,
                     dtype, device)
    attn.init_(gen)
    return attn


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
         causal: bool) -> torch.Tensor:
    """q: [B,S,H,dh]; k/v: [B,T,KV,dh]; positions int32 [B,S]/[B,T].

    Under ``causal``, key t attends iff ``0 <= q_pos - k_pos < window``.
    Logits and softmax in float32; the probabilities are cast to
    ``v.dtype`` before the PV product, as the reference casts them."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    scale = 1.0 / (dh ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        diff = q_pos[:, None, :, None] - k_pos[:, None, None, :]
        mask = (diff >= 0) & (diff < window)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
    return out.reshape(b, s, h * dh)


def _write_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Write this call's k/v [B, s, KV, dh] into the cache at ``index``.

    A scalar index writes one slice for every slot, its start clamped so
    the slice fits (``dynamic_update_slice``); a vector index writes slot
    b at ``index[b] + arange(s)`` and drops the positions past the cache's
    end (``.at[].set(mode="drop")``).

    The drop takes no host sync (a boolean mask would: its ``nonzero``
    reads the mask's count back): every position is written at its column
    clamped to ``t - 1``, and a dropped one writes the value that column
    receives anyway -- the row's own write at ``t - 1`` if it has one, else
    the cache's current value there -- so repeated indices carry equal
    values and the result is the drop's."""
    ck, cv, idx = cache["k"], cache["v"], cache["index"]
    b, s = k.shape[:2]
    t = ck.shape[1]
    if idx.dim() == 0:
        start = min(max(int(idx), 0), t - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
    else:
        rows = torch.arange(b, device=ck.device)[:, None].expand(b, s)
        base = idx.to(ck.device).long()[:, None]
        cols = (base + torch.arange(s, device=ck.device)[None, :]) \
            .clamp(max=t - 1)
        src = cols - base               # the call's position at that column
        own = (src >= 0)[:, :, None, None]
        src = src.clamp(min=0)[:, :, None, None].expand(k.shape)
        for c, new in ((ck, k), (cv, v)):
            vals = torch.where(own, new.gather(1, src).to(c.dtype),
                               c[rows, cols])
            c[rows, cols] = vals
    return {"k": ck, "v": cv, "index": idx + s}


def attention_apply(attn: Attention, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int,
                    positions: torch.Tensor, window: int,
                    rope_theta: float = 10_000.0, causal: bool = True,
                    use_rope: bool = True,
                    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]] = None,
                    cache: Optional[Dict] = None, use_flash: bool = False
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self or cross attention with an optional KV cache.

    * forward / training: ``cache=None`` -> (out, None);
    * prefill / decode: ``cache={'k','v','index'}`` -> writes this call's
      k/v at ``index``, attends over the whole cache (entries past
      ``index + s`` are masked by causality w.r.t. the query positions),
      returns (out, cache);
    * cross attention: ``kv_override=(k, v, k_pos)``, already split into
      heads: no K/V projection, no k norm, no rope on k, no cache write.

    ``use_flash`` on a self-attention with no cache takes the flash
    kernel, which masks by sequence order alone: like the reference's
    flash route, it ignores ``window`` and ``positions``."""
    b, s, _ = x.shape
    q = matmul(x, attn.q).view(b, s, num_heads, head_dim)
    if kv_override is None:
        k = matmul(x, attn.k).view(b, s, num_kv_heads, head_dim)
        v = matmul(x, attn.v).view(b, s, num_kv_heads, head_dim)
        k_pos = positions
    else:
        k, v, k_pos = kv_override
    if hasattr(attn, "q_norm"):
        q = attn.q_norm(q)
        if kv_override is None:
            k = attn.k_norm(k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        if kv_override is None:
            k = apply_rope(k, k_pos, rope_theta)

    new_cache = None
    if cache is not None and kv_override is None:
        new_cache = _write_cache(cache, k, v)
        k, v = new_cache["k"], new_cache["v"]
        t = k.shape[1]
        k_pos = torch.arange(t, dtype=torch.int32,
                             device=x.device).expand(b, t)

    if use_flash and cache is None and kv_override is None:
        # [b, h, s, d] views: the kernel reads them and the KV heads in
        # place and writes a [b, s, h, d] tensor, so neither side copies
        from repro_torch.kernels.flash_attention import ops as fa
        out = fa.mha(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal=causal)
        out = out.transpose(1, 2).reshape(b, s, -1)
    else:
        out = sdpa(q, k, v, positions, k_pos, window, causal)
    return matmul(out, attn.o), new_cache


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16,
                  vector_index: bool = False, device=None) -> Dict:
    return {
        "k": torch.zeros((batch, max_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "index": (torch.zeros((batch,), dtype=torch.int32, device=device)
                  if vector_index else torch.zeros((), dtype=torch.int32)),
    }
