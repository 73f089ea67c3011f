"""Primitive layers: norms, projections, rotary embeddings, MLPs.

The JAX package's ``models/layers.py`` on PyTorch.  Weights keep the JAX
layout (a projection is ``[d_in, d_out]`` and applies as ``x @ w``), so a
parameter tree of the JAX package loads as it is (``models/convert.py``).
Each ``*_init`` draws from an explicit ``torch.Generator`` with the JAX
package's distributions (normal x ``1/sqrt(d_in)``, embeddings normal x
0.02, norms ones/zeros); the two frameworks draw different numbers from
the same seed.  Norms, rotary angles and the cross-entropy compute in
float32 and cast back to the input's type, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def linear_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
                dtype=torch.float32, scale: Optional[float] = None,
                device=None) -> torch.Tensor:
    """A ``[d_in, d_out]`` projection: normal x ``scale`` (default
    ``1/sqrt(d_in)``), drawn in float32 and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp`` promotes (a
    float32 model reading a bfloat16 KV cache computes in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised trainable parameter (filled by its module's
    ``init_``, which writes it under ``torch.no_grad()``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------- norms -----------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """``rms`` (a scale) or ``layer`` (a scale and a bias) norm."""

    def __init__(self, kind: str, d: int, dtype=torch.float32, device=None):
        super().__init__()
        if kind not in ("rms", "layer"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind
        self.scale = param((d,), dtype, device)
        if kind == "layer":
            self.bias = param((d,), dtype, device)

    def init_(self, gen: Optional[torch.Generator] = None) -> None:
        self.scale.data.fill_(1)
        if self.kind == "layer":
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rms":
            return rmsnorm(x, self.scale)
        return layernorm(x, self.scale, self.bias)


# ------------------------------- rotary -----------------------------------

def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] (int32).  Rotates the two
    halves of the head dimension (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # [dh/2]
    angles = positions[..., None].float() * freqs                # [B,S,dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------- MLP ------------------------------------

def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":       # jax.nn.gelu's default is the tanh form
        return F.gelu(x, approximate="tanh")
    if act == "relu":
        return F.relu(x)
    raise ValueError(act)


def mlp(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
        gate: Optional[torch.Tensor] = None,
        act: str = "silu") -> torch.Tensor:
    """Gated (``act(x @ gate) * (x @ up)``) or plain MLP."""
    h = matmul(x, up)
    h = activation(matmul(x, gate), act) * h if gate is not None \
        else activation(h, act)
    return matmul(h, down)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool = True,
                 act: str = "silu", dtype=torch.float32, device=None):
        super().__init__()
        self.act = act
        self.up = param((d_model, d_ff), dtype, device)
        self.down = param((d_ff, d_model), dtype, device)
        self.gate = param((d_model, d_ff), dtype, device) if gated else None

    def init_(self, gen: Optional[torch.Generator]) -> None:
        for w in (self.up, self.down, self.gate):
            if w is not None:
                w.data.copy_(linear_init(gen, *w.shape, w.dtype,
                                         device=w.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.up, self.down, self.gate, self.act)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean cross-entropy in float32.  Returns (loss, n_tokens)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / total, total
