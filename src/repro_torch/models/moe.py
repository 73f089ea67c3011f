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

On a distributed mesh (:func:`_moe_sharded`) the layer runs the
reference's expert parallelism: the buffer is placed ``("model", "dp",
None)`` (experts over ``model``, capacity over the data axes) as the
reference constrains it, each rank runs the SwiGLU of its own experts
over its own slots, and the expert banks keep their spec (``P("model",
dp, None)``: only FSDP's gather of ``d_in`` over the data axes, never
one over ``model``).  The capacity and every slot come from the global
microbatch, as GSPMD sees the global array: the tokens are gathered over
the data axes and every rank ranks the same ``T * k`` assignments, so the
same assignments drop as on one device (a capacity per rank would drop
others).  :func:`moe_ref` is the plain per-expert loop the tests and
``chip_smoke.py`` hold :func:`moe_apply` against; nothing on the model's
path calls it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (NamedSharding, _context_mesh,
                                              constrain, constraint_spec,
                                              is_distributed, placements,
                                              rank_slices)

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
    logits = matmul(xf, moe.router).float()           # the parameter type
    probs = torch.softmax(logits, dim=-1)
    return {"probs": probs, **assign(probs, num_experts=num_experts,
                                     top_k=top_k,
                                     capacity_factor=capacity_factor)}


def assign(probs: torch.Tensor, *, num_experts: int, top_k: int,
           capacity_factor: float = 1.25) -> Dict[str, torch.Tensor]:
    """:func:`route` from the router probabilities [T, E]: everything but
    ``probs``."""
    t = probs.shape[0]
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
        num_experts, dtype=sorted_e.dtype, device=probs.device))
    ranks = torch.arange(n_flat, device=probs.device) - starts[sorted_e]
    slot = torch.empty_like(ranks).scatter_(0, order, ranks)
    return {"gates": gates, "experts": experts, "slot": slot,
            "keep": slot < capacity, "capacity": capacity}


def _slot_sources(r: Dict, num_experts: int, top_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(addr [T * k], token_src [E * C], valid [E * C]): each assignment's
    slot address (``E * C`` where dropped), and each slot's token and
    whether an assignment fills it (the slot permutation inverted with a
    small int scatter; the dropped assignments land in a spare row past
    the slots, cut off)."""
    flat, keep, cap = r["experts"].reshape(-1), r["keep"], r["capacity"]
    n_flat, n_slots = flat.numel(), num_experts * cap
    addr = torch.where(keep, flat * cap + r["slot"], n_slots)
    inv = torch.full((n_slots + 1,), n_flat, dtype=torch.long,
                     device=flat.device)
    inv.scatter_(0, addr, torch.arange(n_flat, device=flat.device))
    inv = inv[:n_slots]
    valid = inv < n_flat
    return addr, torch.where(valid, inv // top_k, 0), valid


def _swiglu(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """The batched per-expert SwiGLU over [E, C, d]."""
    g = F.silu(matmul(buf, w_gate))
    return matmul(g * matmul(buf, w_up), w_down)


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
    # a replicated DTensor on a distributed mesh (the product's backward
    # reads it outside the forward's implicit replication)
    ce = constrain(counts / max(experts.numel(), 1), None)
    return num_experts * (probs.mean(dim=0) * ce).sum()


def moe_apply(moe: MoE, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss float32 scalar)."""
    mesh = _context_mesh()
    if mesh is not None and is_distributed(mesh):
        return _moe_sharded(moe, x, mesh, num_experts=num_experts,
                            top_k=top_k, capacity_factor=capacity_factor)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    r = route(moe, xf, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    keep, cap = r["keep"], r["capacity"]
    n_slots = num_experts * cap
    addr, token_src, valid = _slot_sources(r, num_experts, top_k)
    buf = xf[token_src] * valid[:, None].to(xf.dtype)
    y = _swiglu(buf.view(num_experts, cap, d), moe.w_gate, moe.w_up,
                moe.w_down).reshape(n_slots, d)
    w = r["gates"].reshape(-1) * keep
    gathered = y[torch.where(keep, addr, 0)] * w[:, None].to(x.dtype)
    out = gathered.reshape(t, top_k, d).sum(dim=1)
    if hasattr(moe, "shared"):
        out = out + moe.shared(xf)
    return out.reshape(b, s, d), _aux_loss(r["probs"], r["experts"],
                                           num_experts)


def route_global(moe: MoE, x: torch.Tensor, mesh, *, num_experts: int,
                 top_k: int, capacity_factor: float = 1.25):
    """The routing of a distributed mesh's global microbatch: (the tokens
    [T, d] gathered over the data axes, a replicated DTensor; the router
    probabilities [T, E], the same; the renormalised gates [T, k], the
    same; :func:`assign`'s ``experts``, ``slot``, ``keep`` and
    ``capacity`` as plain tensors, equal on every rank).  ``route``'s
    sort, ``searchsorted`` and scatter have no DTensor rule: they run on
    each rank's copy of the probabilities, and the gates are read back
    from the DTensor by index (the same values the sort gave)."""
    from torch.distributed.tensor import Replicate
    b, s, d = x.shape
    dm = mesh.device_mesh
    rep = [Replicate()] * dm.ndim
    xf = constrain(x, "dp", None, None).reshape(b * s, d)
    # every token on every rank: an all-gather over the data axes (its
    # gradient a reduce-scatter); the router gathered alike (FSDP)
    xg = xf.redistribute(dm, rep)
    probs = torch.softmax(matmul(xg, moe.router.redistribute(dm, rep))
                          .float(), dim=-1)
    with torch.no_grad():
        r = assign(probs.to_local(), num_experts=num_experts, top_k=top_k,
                   capacity_factor=capacity_factor)
    del r["gates"]
    # the ids as a replicated DTensor: the gather's backward scatters by
    # them outside the forward's implicit replication
    gates = probs.gather(-1, constrain(r["experts"], None, None))
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return xf, xg, probs, gates, r


def _moe_sharded(moe: MoE, x: torch.Tensor, mesh, *, num_experts: int,
                 top_k: int, capacity_factor: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` on a distributed mesh, three ``local_map`` steps
    around the global routing (:func:`route_global`):

    * dispatch: each rank fills its part of the ``[E, C, d]`` buffer
      (placed ``("model", "dp", None)``, validated) from the gathered
      tokens, no collective;
    * experts: the SwiGLU over the rank's experts and slots, the banks
      gathered over the data axes only (FSDP), their gradients partial
      sums over the data ranks that split the slots;
    * combine: each rank's kept assignments weighted by their gates and
      summed over k into a partial [T, d] (zero for the others'), reduced
      to the tokens' own placement (a reduce-scatter over the data axes,
      an all-reduce over ``model``).

    Where the buffer is split over a mesh dim, a rank's gradient of the
    gathered tokens and of the gates is a partial sum over that dim, and
    the combine's output too; where it is whole, complete."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    b, s, d = x.shape
    t = b * s
    dm = mesh.device_mesh
    rep = [Replicate()] * dm.ndim
    xf, xg, probs, gates, r = route_global(
        moe, x, mesh, num_experts=num_experts, top_k=top_k,
        capacity_factor=capacity_factor)
    cap = r["capacity"]
    addr, token_src, valid = _slot_sources(r, num_experts, top_k)
    spec = constraint_spec((num_experts, cap, d), ("model", "dp", None),
                           mesh)
    buf_pl = placements(spec, mesh)
    split = [Partial() if isinstance(p, Shard) else Replicate()
             for p in buf_pl]
    es, cs, _ = rank_slices(NamedSharding(mesh, spec),
                            (num_experts, cap, d))
    src = token_src.view(num_experts, cap)[es, cs]
    ok = valid.view(num_experts, cap)[es, cs]
    # this rank's kept assignments and their rows of its buffer
    e_of, c_of = addr // cap, addr % cap
    e0, c0 = es.start or 0, cs.start or 0
    n_c = src.shape[1]
    mine = r["keep"] & (e_of >= e0) & (e_of < e0 + src.shape[0]) & \
        (c_of >= c0) & (c_of < c0 + n_c)
    row = torch.where(mine, (e_of - e0) * n_c + (c_of - c0), 0)

    def dispatch(xg):
        return xg[src] * ok[..., None].to(xg.dtype)

    buf = local_map(dispatch, out_placements=buf_pl, in_placements=(rep,),
                    in_grad_placements=(split,), device_mesh=dm)(xg)
    model = mesh.mesh_dims.index(("model",))
    banks = []
    for w in (moe.w_gate, moe.w_up, moe.w_down):
        pl = [p if i == model else Replicate()
              for i, p in enumerate(w.placements)]
        banks.append(w.redistribute(dm, pl))
    bank_pl = tuple(tuple(w.placements) for w in banks)
    bank_grad = tuple(tuple(split[i] if i != model else p
                            for i, p in enumerate(pl)) for pl in bank_pl)

    y = local_map(_swiglu, out_placements=buf_pl,
                  in_placements=(buf_pl,) + bank_pl,
                  in_grad_placements=(buf_pl,) + bank_grad,
                  device_mesh=dm)(buf, *banks)

    def combine(y, gates):
        w = gates.reshape(-1) * mine
        rows = y.reshape(-1, d)[row] * w[:, None].to(y.dtype)
        return rows.reshape(t, top_k, d).sum(dim=1)

    out = local_map(combine, out_placements=split,
                    in_placements=(buf_pl, rep),
                    in_grad_placements=(buf_pl, split),
                    device_mesh=dm)(y, gates)
    out = out.redistribute(dm, xf.placements)
    if hasattr(moe, "shared"):
        out = out + moe.shared(xf)
    return out.reshape(b, s, d), _aux_loss(probs, r["experts"], num_experts)


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
