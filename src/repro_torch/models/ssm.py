"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

The JAX package's ``models/ssm.py`` on PyTorch.  Chunked SSD: the sequence
is split into chunks of ``chunk_len``; the intra-chunk term is a masked
quadratic form, and the inter-chunk term passes a ``[b, h, p, n]`` float32
state from chunk to chunk (the reference's ``lax.scan``, here a loop over
the chunks).  :func:`ssd_reference` is the naive sequential oracle.

Parameters follow mamba2: a fused ``in_proj`` -> (z, x, B, C, dt), a
depthwise causal conv over (x, B, C), per-head ``A_log``/``D``/``dt_bias``,
a gated RMSNorm and ``out_proj``.  Where the reference uses
``jnp.split`` (split *indices*) the port uses ``tensor_split``, and where
it uses ``jnp.repeat`` (each group's copies adjacent) ``repeat_interleave``.

The cache ``{"conv": [B, W-1, conv_dim], "state": [B, H, P, N] float32}``
is written in place, as the KV cache is, and keeps its type.  A prefill
(``L > 1``) starts from the cache's conv tail and from a zero state; a
one-token call with a cache takes the decode step (the reference's
behaviour, kept).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (_context_mesh, constrain,
                                              constraint_spec,
                                              is_distributed, local_range,
                                              placed_like, placements)

from .layers import linear_init, matmul, param


class SSM(nn.Module):
    """``in_proj`` ``[d, 2*d_inner + 2*g*n + h]``, ``conv_w`` ``[W,
    conv_dim]``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` ``[h]``,
    ``norm_scale`` ``[d_inner]`` and ``out_proj`` ``[d_inner, d]``."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 state_dim: int, n_groups: int = 1, conv_width: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()
        d_inner = num_heads * head_dim
        conv_dim = d_inner + 2 * n_groups * state_dim
        d_in_proj = 2 * d_inner + 2 * n_groups * state_dim + num_heads
        self.in_proj = param((d_model, d_in_proj), dtype, device)
        self.conv_w = param((conv_width, conv_dim), dtype, device)
        self.conv_b = param((conv_dim,), dtype, device)
        self.A_log = param((num_heads,), dtype, device)
        self.D = param((num_heads,), dtype, device)
        self.dt_bias = param((num_heads,), dtype, device)
        self.norm_scale = param((d_inner,), dtype, device)
        self.out_proj = param((d_inner, d_model), dtype, device)

    def init_(self, gen: Optional[torch.Generator]) -> None:
        for w in (self.in_proj, self.out_proj):
            w.data.copy_(linear_init(gen, *w.shape, w.dtype,
                                     device=w.device))
        width = self.conv_w.shape[0]
        conv = torch.randn(self.conv_w.shape, generator=gen,
                           dtype=torch.float32, device=self.conv_w.device)
        self.conv_w.data.copy_((conv * (1.0 / width)).to(self.conv_w.dtype))
        self.conv_b.data.zero_()
        h = self.A_log.shape[0]
        self.A_log.data.copy_(torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float32, device=self.A_log.device)))
        self.D.data.fill_(1)
        self.dt_bias.data.zero_()
        self.norm_scale.data.fill_(1)


def ssm_init(gen: Optional[torch.Generator], d_model: int, num_heads: int,
             head_dim: int, state_dim: int, n_groups: int = 1,
             conv_width: int = 4, dtype=torch.float32, device=None) -> SSM:
    ssm = SSM(d_model, num_heads, head_dim, state_dim, n_groups, conv_width,
              dtype, device)
    ssm.init_(gen)
    return ssm


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: [B, L, C]; w: [W, C].

    Returns (silu(y + b), new_state), the state being the trailing (W-1)
    inputs (in the promoted type of ``state`` and ``x``)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    # y[t] = sum_i w[i] * xp[t + i], summed in the reference's order
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return F.silu(y + b), new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., t, s] = sum_{s < r <= t} a[..., r].

    Lower-triangular (t >= s); -inf above the diagonal, so its ``exp``
    is 0 there."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def _heads(t: torch.Tensor, hpg: int, dim: int) -> torch.Tensor:
    """Broadcast groups over heads: ``jnp.repeat`` (each group's heads
    adjacent), a no-op when every head has its own group."""
    return t.repeat_interleave(hpg, dim=dim) if hpg != 1 else t


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                chunk_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.

    x: [b, l, h, p]; dt: [b, l, h] (post-softplus, float32); A: [h]
    (negative); B, C: [b, l, g, n] (g groups broadcast over h).  ``l``
    must be a multiple of ``chunk_len``.  Returns (y in x's type,
    final_state [b, h, p, n] float32)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    if l % chunk_len:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk length {chunk_len}")
    nc, q = l // chunk_len, chunk_len
    f32 = torch.float32

    xb = (x * dt[..., None]).reshape(b, nc, q, h, p).to(f32)
    a = (dt * A[None, None, :]).reshape(b, nc, q, h)        # log-decay
    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)

    a_t = a.permute(0, 1, 3, 2)                             # [b,nc,h,q]
    L = torch.exp(_segsum(a_t))                              # [b,nc,h,q,q]
    a_cum = torch.cumsum(a_t, dim=-1)                        # [b,nc,h,q]

    # intra-chunk: the masked quadratic form within each chunk
    CB = _heads(torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc), hpg, 2)
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", CB.to(f32) * L, xb)

    # each chunk's right state: sum_s exp(a_cum[-1] - a_cum[s]) B_s xb_s^T
    decay_r = torch.exp(a_cum[..., -1:] - a_cum)             # [b,nc,h,q]
    Bh = _heads(Bc, hpg, 3).to(f32) * decay_r.permute(0, 1, 3, 2)[..., None]
    S = torch.einsum("bcshn,bcshp->bchpn", Bh, xb)           # [b,nc,h,p,n]

    # inter-chunk: the state entering each chunk, carried in float32
    chunk_decay = torch.exp(a_t.sum(-1))                     # [b,nc,h]
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S[:, c]
    hprev = torch.stack(before, dim=1)                       # [b,nc,h,p,n]

    # y_t += exp(a_cum[t]) C_t . h_prev
    Ch = torch.einsum("bcqhn,bchpn->bcqhp", _heads(Cc, hpg, 3).to(f32),
                      hprev)
    y_inter = Ch * torch.exp(a_cum).permute(0, 1, 3, 2)[..., None]

    y = (y_intra + y_inter).reshape(b, l, h, p)
    y = y + x.to(f32) * D[None, None, :, None]
    return y.to(x.dtype), state


def _mix(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
         state: Optional[torch.Tensor], chunk_len: int, out_dtype
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD of whole (or one rank's local) heads: x [b, l, h, p]; dt
    [b, l, h] float32; A, D [h]; B, C [b, l, g, n] (g dividing h).  With
    ``state`` [b, h, p, n] float32 one decode step (``l == 1``, y in
    ``out_dtype``), else the chunked scan from zero (padded to a multiple
    of ``chunk_len``, y in x's type).  Returns (y [b, l, h, p], the final
    state)."""
    b, l, h, p = x.shape
    g = B.shape[2]
    f32 = torch.float32
    if state is not None:
        # one step: h' = exp(dt*A) h + dt * B x^T ; y = C h' + D x
        dt1 = dt[:, 0]                                       # [b,h]
        decay = torch.exp(dt1 * A[None, :])
        B1 = _heads(B[:, 0], h // g, 1).to(f32)
        C1 = _heads(C[:, 0], h // g, 1).to(f32)
        # products and a sum, not einsums: DTensor places these per
        # element on a mesh, where its einsum would merge a split head dim
        # into the batch, which it refuses
        xdt = (x[:, 0] * dt1[..., None]).to(f32)
        Bx = B1[:, :, None, :] * xdt[..., None]
        state = state * decay[..., None, None] + Bx
        y = (C1[:, :, None, :] * state).sum(-1)
        y = y + x[:, 0].to(f32) * D[None, :, None]
        return y[:, None].to(out_dtype), state               # [b,1,h,p]
    pad = (-l) % chunk_len
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    y, state = ssd_chunked(x, dt, A, B, C, D, chunk_len)
    return y[:, :l], state


def _local_groups(h0: int, hl: int, heads_per_group: int) -> List[int]:
    """The groups of B and C that heads ``h0 .. h0 + hl`` read, one entry
    per group of the local heads (each local group serving the same
    number of them): the groups themselves where the stretch holds whole
    groups or lies in one, else one entry per head."""
    of = [(h0 + i) // heads_per_group for i in range(hl)]
    groups = sorted(set(of))
    per = hl // len(groups)
    if hl % len(groups) == 0 and of == [x for x in groups
                                        for _ in range(per)]:
        return groups
    return of


def _mix_sharded(x, dt, A, B, C, D, state, mesh, *, p: int, n: int,
                 g: int, chunk_len: int, out_dtype):
    """:func:`_mix` on a distributed mesh: the SSD heads over ``model``
    (where they divide it), the batch over the data axes, in
    ``local_map``; B and C whole on every rank (each rank reads the
    groups of its own heads).  x [b, l, h * p], dt [b, l, h], A, D [h],
    B, C [b, l, g * n], state (decode) [b, h, p, n].  Returns (y [b, l,
    h * p] with its heads over ``model``, the state placed as
    ``cache_spec`` places it: heads over ``model``)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    h = dt.shape[-1]
    heads = "model" if h % mesh.shape["model"] == 0 else None
    x, dt = (constrain(t, "dp", None, heads) for t in (x, dt))
    A, D = (constrain(t, heads) for t in (A, D))
    B, C = (constrain(t, "dp", None, None) for t in (B, C))
    pl = [tuple(t.placements) for t in (x, dt, A, B, C, D)]
    st_pl = tuple(placements(constraint_spec(
        (x.shape[0], h, p, n), ("dp", heads, None, None), mesh), mesh))
    model = mesh.mesh_dims.index(("model",))
    # a rank's gradient of what it holds whole is a partial sum over the
    # dims that split what it reads: B and C over the heads' split, A and
    # D over the batch's
    split = [isinstance(q, Shard) for q in x.placements]
    bc_grad = tuple(Partial() if i == model and split[i] else q
                    for i, q in enumerate(pl[3]))
    ad_grad = tuple(Partial() if i != model and split[i] else q
                    for i, q in enumerate(pl[2]))
    h0, hl = local_range(dt, 2)
    groups = _local_groups(h0, hl, h // g)

    def run(x, dt, A, B, C, D, *state):
        b, l = x.shape[:2]
        Bl, Cl = (t.reshape(b, l, g, n)[:, :, groups] for t in (B, C))
        y, st = _mix(x.reshape(b, l, hl, p), dt, A, Bl, Cl, D,
                     state[0] if state else None, chunk_len, out_dtype)
        return y.reshape(b, l, hl * p), st

    ins = (x, dt, A, B, C, D)
    if state is not None:
        ins += (constrain(state, "dp", heads, None, None),)
    in_pl = tuple(pl) + ((st_pl,) if state is not None else ())
    grads = (pl[0], pl[1], ad_grad, bc_grad, bc_grad, ad_grad) + \
        ((st_pl,) if state is not None else ())
    return local_map(run, out_placements=(pl[0], st_pl), in_placements=in_pl,
                     in_grad_placements=grads,
                     device_mesh=mesh.device_mesh)(*ins)


def ssm_apply(ssm: SSM, xin: torch.Tensor, *, num_heads: int, head_dim: int,
              state_dim: int, n_groups: int = 1, chunk_len: int = 256,
              cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The full mamba2 mixer.  xin: [B, L, d_model].

    ``cache={'conv', 'state'}`` is written in place and returned; with
    ``L == 1`` it takes the single-step decode, else the chunked scan
    (padded to a multiple of ``chunk_len``) from a zero state.

    On a distributed mesh (the reference's ``ssm.py`` has no constraint:
    GSPMD propagates from ``in_proj`` ``P(dp, "model")`` and ``conv_w``
    ``P(None, "model")``) the placement is stated once at each of the two
    splits, whose pieces do not line up with the shards over ``model``:
    the fused projection is gathered over ``model``, its conv channels
    put back over ``model`` through the depthwise (channel-local) conv,
    as ``conv_w`` and the conv cache are placed; the conv's output
    gathered again, the SSD heads over ``model`` through the scan or the
    decode step (:func:`_mix_sharded`; the state cache's heads are over
    ``model`` too), the gated RMSNorm's mean over ``d_inner`` one small
    reduction, ``out_proj`` row-parallel."""
    b, l, _ = xin.shape
    h, p, n, g = num_heads, head_dim, state_dim, n_groups
    d_inner = h * p
    mesh = _context_mesh()
    sharded = mesh is not None and is_distributed(mesh)
    zxbcdt = matmul(xin, ssm.in_proj)
    if sharded:
        zxbcdt = constrain(zxbcdt, "dp", None, None)
    z, xbc, dt_raw = torch.tensor_split(
        zxbcdt, [d_inner, d_inner + d_inner + 2 * g * n], dim=-1)
    conv = None if cache is None else cache["conv"]
    if sharded:
        heads = "model" if h % mesh.shape["model"] == 0 else None
        z, dt_raw = (constrain(t, "dp", None, heads) for t in (z, dt_raw))
        xbc = constrain(xbc, "dp", None, "model")
        if conv is None:
            conv = constrain(torch.zeros(
                (b, ssm.conv_w.shape[0] - 1, xbc.shape[-1]),
                dtype=xbc.dtype, device=ssm.conv_b.device), "dp", None,
                "model")
    xbc, new_conv = _causal_conv(xbc, ssm.conv_w, ssm.conv_b, conv)
    if sharded:
        xbc = constrain(xbc, "dp", None, None)
    x, B, C = torch.tensor_split(xbc, [d_inner, d_inner + g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + ssm.dt_bias.float())
    A = -torch.exp(ssm.A_log.float())
    state = cache["state"] if cache is not None and l == 1 else None
    if sharded:
        y, state = _mix_sharded(x, dt, A, B, C, ssm.D, state, mesh, p=p,
                                n=n, g=g, chunk_len=chunk_len,
                                out_dtype=xin.dtype)
    else:
        y, state = _mix(x.reshape(b, l, h, p), dt, A, B.reshape(b, l, g, n),
                        C.reshape(b, l, g, n), ssm.D, state, chunk_len,
                        xin.dtype)
    if cache is not None:
        cache["conv"].copy_(placed_like(new_conv, cache["conv"]))
        cache["state"].copy_(placed_like(state, cache["state"]))

    # gated RMSNorm (mamba2): y * silu(z), normalised
    yf = y.reshape(b, l, d_inner).float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * ssm.norm_scale.float()
    return matmul(yf.to(xin.dtype), ssm.out_proj), cache


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The naive sequential oracle of :func:`ssd_chunked`: one step a
    position, the state in float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    f32 = torch.float32
    s = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(l):
        Bt = _heads(B[:, t], hpg, 1).to(f32)
        Ct = _heads(C[:, t], hpg, 1).to(f32)
        decay = torch.exp(dt[:, t] * A[None, :])             # [b,h]
        Bx = torch.einsum("bhn,bhp->bhpn", Bt,
                          (x[:, t] * dt[:, t][..., None]).to(f32))
        s = s * decay[..., None, None] + Bx
        y = torch.einsum("bhn,bhpn->bhp", Ct, s)
        ys.append(y + x[:, t].to(f32) * D[None, :, None])
    return torch.stack(ys, dim=1).to(x.dtype), s


def init_ssm_cache(batch: int, num_heads: int, head_dim: int,
                   state_dim: int, n_groups: int, conv_width: int,
                   dtype=torch.bfloat16, device=None) -> Dict:
    conv_dim = num_heads * head_dim + 2 * n_groups * state_dim
    return {
        "conv": torch.zeros((batch, conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, num_heads, head_dim, state_dim),
                             dtype=torch.float32, device=device),
    }
