"""Mixture-of-Experts: top-k routing with capacity-based dispatch.

The JAX package's ``models/moe.py`` on PyTorch.  Tokens are ranked into
per-expert slots of a fixed capacity ``C = max(1, round(T * top_k / E *
factor))`` (Python's ``round``, half to even, as the reference's), gathered
into an ``[E, C, d]`` buffer, transformed by batched per-expert SwiGLUs
(three batched matrix products over the ``[E, d_in, d_out]`` banks) and
combined back weighted by the renormalised router probabilities.
Assignments past an expert's capacity are dropped.  DeepSeek-style shared
experts and the Switch load-balance loss are kept.

Two points where the frameworks differ are made explicit:

* ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities and ``torch.topk`` promises no order, so the top-k is a
  stable descending sort;
* ``.at[addr].set(..., mode="drop")`` drops the assignments whose address
  is ``E * C`` (the dropped ones): here they scatter into one spare row
  past the buffer, which is cut off, so the scatter takes no host sync.

The reference's sharding hints (``constrain``) have no effect on one
device and are dropped.  :func:`moe_ref` is the plain per-expert loop the
tests and ``chip_smoke.py`` hold :func:`moe_apply` against; nothing on the
model's path calls it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, linear_init, matmul, param


class MoE(nn.Module):
    """``router`` ``[d, E]``, the expert banks ``w_gate``/``w_up``
    ``[E, d, d_expert]`` and ``w_down`` ``[E, d_expert, d]`` and, with
    shared experts, ``shared`` (a gated SiLU ``MLP``)."""

    def __init__(self, d_model: int, d_expert: int, num_experts: int,
                 num_shared: int = 0, d_shared: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.router = param((d_model, num_experts), dtype, device)
        self.w_gate = param((num_experts, d_model, d_expert), dtype, device)
        self.w_up = param((num_experts, d_model, d_expert), dtype, device)
        self.w_down = param((num_experts, d_expert, d_model), dtype, device)
        if num_shared:
            self.shared = MLP(d_model, d_shared or d_expert * num_shared,
                              gated=True, act="silu", dtype=dtype,
                              device=device)

    def init_(self, gen: Optional[torch.Generator]) -> None:
        """The reference's distributions: the router normal x 0.02, each
        bank normal x ``1/sqrt(d_in)``."""
        self.router.data.copy_(linear_init(gen, *self.router.shape,
                                           self.router.dtype, scale=0.02,
                                           device=self.router.device))
        for w in (self.w_gate, self.w_up, self.w_down):
            bank = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                               device=w.device)
            w.data.copy_((bank / math.sqrt(w.shape[1])).to(w.dtype))
        if hasattr(self, "shared"):
            self.shared.init_(gen)


def moe_init(gen: Optional[torch.Generator], d_model: int, d_expert: int,
             num_experts: int, num_shared: int = 0,
             d_shared: Optional[int] = None, dtype=torch.float32,
             device=None) -> MoE:
    moe = MoE(d_model, d_expert, num_experts, num_shared, d_shared, dtype,
              device)
    moe.init_(gen)
    return moe


def capacity_of(tokens: int, num_experts: int, top_k: int,
                capacity_factor: float) -> int:
    """Slots per expert, as the reference computes them in Python."""
    return int(max(1, round(tokens * top_k / num_experts * capacity_factor)))


def route(moe: MoE, xf: torch.Tensor, *, num_experts: int, top_k: int,
          capacity_factor: float = 1.25) -> Dict[str, torch.Tensor]:
    """Router probabilities, the top-k experts and gates of each token
    [T, d], and each assignment's slot in its expert (tokens ranked by
    flat index ``token * top_k + j``) and whether it fits the capacity.

    Returns ``probs`` [T, E] float32, ``gates`` [T, k] (renormalised),
    ``experts`` [T, k] int64, ``slot`` and ``keep`` [T * k] and the
    ``capacity``."""
    t = xf.shape[0]
    logits = matmul(xf, moe.router).float()           # the parameter type
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: ties go to the lower expert, as lax.top_k's
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    capacity = capacity_of(t, num_experts, top_k, capacity_factor)
    flat = experts.reshape(-1)
    n_flat = flat.numel()
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        num_experts, dtype=sorted_e.dtype, device=xf.device))
    ranks = torch.arange(n_flat, device=xf.device) - starts[sorted_e]
    slot = torch.empty_like(ranks).scatter_(0, order, ranks)
    return {"probs": probs, "gates": gates, "experts": experts,
            "slot": slot, "keep": slot < capacity, "capacity": capacity}


def _swiglu(moe: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The batched per-expert SwiGLU over [E, C, d]."""
    g = F.silu(matmul(buf, moe.w_gate))
    return matmul(g * matmul(buf, moe.w_up), moe.w_down)


def _aux_loss(probs: torch.Tensor, experts: torch.Tensor,
              num_experts: int) -> torch.Tensor:
    """Switch's load-balance loss ``E * sum_e f_e * p_e`` (every
    assignment counted, dropped or not, as the reference counts)."""
    flat = experts.reshape(-1)
    # a scatter rather than ``bincount``, which has no meta kernel (the
    # dry-run traces the layer on the meta device)
    counts = torch.zeros(num_experts, dtype=torch.int64,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float()
    ce = counts / max(experts.numel(), 1)
    return num_experts * (probs.mean(dim=0) * ce).sum()


def moe_apply(moe: MoE, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss float32 scalar)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    r = route(moe, xf, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    keep, cap = r["keep"], r["capacity"]
    flat = r["experts"].reshape(-1)
    n_flat = flat.numel()
    n_slots = num_experts * cap
    addr = torch.where(keep, flat * cap + r["slot"], n_slots)
    # invert the slot permutation: slot -> flat assignment (n_flat where
    # empty); the dropped assignments land in the spare row n_slots
    inv = torch.full((n_slots + 1,), n_flat, dtype=torch.long,
                     device=x.device)
    inv.scatter_(0, addr, torch.arange(n_flat, device=x.device))
    inv = inv[:n_slots]
    valid = inv < n_flat
    token_src = torch.where(valid, inv // top_k, 0)
    buf = xf[token_src] * valid[:, None].to(xf.dtype)
    y = _swiglu(moe, buf.view(num_experts, cap, d)).reshape(n_slots, d)
    w = r["gates"].reshape(-1) * keep
    gathered = y[torch.where(keep, addr, 0)] * w[:, None].to(x.dtype)
    out = gathered.reshape(t, top_k, d).sum(dim=1)
    if hasattr(moe, "shared"):
        out = out + moe.shared(xf)
    return out.reshape(b, s, d), _aux_loss(r["probs"], r["experts"],
                                           num_experts)


def moe_ref(moe: MoE, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`moe_apply`: the same router and top-k,
    then a loop over experts, each keeping its first ``C`` assignments in
    flat order and running its own SwiGLU over them.

    Returns (y [B, S, d], aux_loss, keep [T * k])."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    r = route(moe, xf, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    flat = r["experts"].reshape(-1)
    keep = torch.zeros_like(flat, dtype=torch.bool)
    parts = torch.zeros((t * top_k, d), dtype=torch.promote_types(
        x.dtype, moe.w_down.dtype), device=x.device)
    w = r["gates"].reshape(-1)
    for e in range(num_experts):
        mine = torch.nonzero(flat == e)[:, 0][:r["capacity"]]
        keep[mine] = True
        rows = xf[mine // top_k]
        h = F.silu(matmul(rows, moe.w_gate[e])) * matmul(rows, moe.w_up[e])
        parts[mine] = matmul(h, moe.w_down[e]) * w[mine, None].to(x.dtype)
    out = parts.reshape(t, top_k, d).sum(dim=1)
    if hasattr(moe, "shared"):
        out = out + moe.shared(xf)
    return (out.reshape(b, s, d),
            _aux_loss(r["probs"], r["experts"], num_experts), keep)
