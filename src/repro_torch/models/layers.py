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


def _split_classes(logits) -> bool:
    """A DTensor whose last (class) dim is split over a mesh axis."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(logits, DTensor) and any(
        isinstance(p, Shard) and p.dim == logits.dim() - 1
        for p in logits.placements)


def _rows(x, logits):
    """``x`` (one value a row of ``logits``) placed as ``logits``' rows
    are, whole over the axes that split the classes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import _Constrain
    last = logits.dim() - 1
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last else p
               for p in logits.placements)
    return _Constrain.apply(x, logits.device_mesh, pl)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim.  Over split classes it is written
    out (a max, then a sum of exponentials: partial reductions that
    all-reduce a value a row); DTensor's own gathers every class."""
    if not _split_classes(logits):
        return torch.logsumexp(logits, dim=-1)
    m = _rows(logits.detach().amax(dim=-1, keepdim=True), logits)
    se = _rows(torch.exp(logits - m).sum(dim=-1, keepdim=True), logits)
    return (m + torch.log(se))[..., 0]


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  On a DTensor whose class dim is split
    (vocab-parallel logits) each rank picks the labels that fall in its
    own stretch of the classes, 0 elsewhere, and the parts are a partial
    sum over the axes that split it (``local_map``: DTensor's own gather
    rule does not hold for a split class dim)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = logits.dim() - 1

    def split(p) -> bool:
        return isinstance(p, Shard) and p.dim == last

    if not _split_classes(logits):
        return logits.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import local_range
    dm, pl = logits.device_mesh, list(logits.placements)
    lo, n = local_range(logits, last)
    lab_pl = [Replicate() if split(p) else p for p in pl]
    out_pl = [Partial() if split(p) else p for p in pl]

    def pick(lg, lab):
        rel = lab - lo
        ok = (rel >= 0) & (rel < n)
        got = lg.gather(-1, rel.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(ok, got, torch.zeros_like(got))

    return local_map(pick, out_placements=out_pl,
                     in_placements=(pl, lab_pl), device_mesh=dm)(
        logits, labels.redistribute(dm, lab_pl))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean cross-entropy in float32.  Returns (loss, n_tokens)."""
    logits = logits.float()
    logz = _logsumexp(logits)
    gold = _gold(logits, labels.long())
    if _split_classes(logits):
        # a row's values whole where its classes were split, their
        # gradients alike (else DTensor meets the two in differing layouts)
        logz, gold = _rows(logz, logits), _rows(gold, logits)
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / total, total
