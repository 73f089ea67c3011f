"""Attention: GQA, sliding-window and cross attention with KV-cache decode.

The JAX package's ``models/attention.py`` on PyTorch.  The full-sequence
self-attention with ``use_flash`` goes through the flash attention kernel
(``kernels/flash_attention``); every other call -- a cached one, or cross
attention over given keys and values (``kv_override``) -- runs the plain
tensor code of :func:`sdpa`, as the reference leaves its einsums to XLA.
Self and cross attention take the reference's three sharded branches on
a distributed mesh (heads, the queries' sequence, or at decode the KV
length over ``model``); on one device there is nothing to place.

The KV cache is written in place (the reference returns new arrays); the
returned cache holds the same ``k``/``v`` tensors and a new ``index``.  A
scalar ``index`` is a 0-dim CPU tensor, so positions and slices cost no
device round trip; a per-slot vector ``index`` lives on the cache's
device.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed.sharding import (_context_mesh, constrain,
                                              is_distributed, local_range)

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


def heads_parallel(num_heads: int) -> bool:
    """The reference's test: the ambient mesh has a ``model`` axis that
    divides the heads."""
    mesh = _context_mesh()
    return (mesh is not None and "model" in mesh.axis_names
            and num_heads % mesh.shape["model"] == 0)


def repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """[B, T, KV, dh] -> [B, T, H, dh], KV head j serving heads
    ``j * H/KV ..`` (``repeat_interleave``), as a broadcast and a merge
    of the two head dims: a KV-head sharding becomes the same split of
    the query heads."""
    b, t, kv, dh = k.shape
    if kv == h:
        return k
    return k[:, :, :, None, :].expand(b, t, kv, h // kv, dh) \
        .reshape(b, t, h, dh)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
            causal: bool) -> torch.Tensor:
    """The plain attention on whole (or one rank's local) tensors:
    q [B,S,H,dh], k/v [B,T,KV,dh] -> [B,S,H,dh]."""
    h, dh = q.shape[2], q.shape[3]
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    scale = 1.0 / (dh ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        diff = q_pos[:, None, :, None] - k_pos[:, None, None, :]
        mask = (diff >= 0) & (diff < window)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
         causal: bool) -> torch.Tensor:
    """q: [B,S,H,dh]; k/v: [B,T,KV,dh]; positions int32 [B,S]/[B,T].

    Under ``causal``, key t attends iff ``0 <= q_pos - k_pos < window``.
    Logits and softmax in float32; the probabilities are cast to
    ``v.dtype`` before the PV product, as the reference casts them.  On a
    distributed mesh the reference's three branches (``attention.py:
    64-89``) place q, k and v, and each rank attends over its part
    (:func:`_sdpa_sharded`)."""
    b, s, h, dh = q.shape
    mesh = _context_mesh()
    if mesh is not None and is_distributed(mesh):
        out = _sdpa_sharded(q, k, v, q_pos, k_pos, window, causal, mesh)
    else:
        out = _attend(q, k, v, q_pos, k_pos, window, causal)
    # heads stay split for the row-parallel output projection; the
    # sequence-parallel and decode outputs are gathered whole (the
    # gradient of the merged heads meets the split on head boundaries)
    heads = "model" if heads_parallel(h) and s > 1 else None
    return constrain(out.reshape(b, s, h * dh), "dp", None, heads)


def _sdpa_sharded(q, k, v, q_pos, k_pos, window, causal, mesh):
    """The reference's branches on a distributed mesh, each a local
    attention through ``local_map`` with its placements stated (DTensor's
    own rules for the batched products would have to merge a split head
    dim with the batch, which it refuses):

    * s > 1, heads dividing ``model``: q, k, v split by heads; every
      rank attends over its own heads;
    * s > 1 otherwise: queries split by sequence over ``model``, K/V
      whole; a rank's K/V gradients are partial sums over ``model``;
    * decode (s == 1): the KV length split over ``model`` (flash-decode):
      each rank's partial softmax is combined by a max and two sums over
      ``model``."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    b, s, h, dh = q.shape
    hp = heads_parallel(h)

    if s > 1 and hp:
        if k.shape[2] % mesh.shape["model"]:
            k, v = _repeat_whole(k, h), _repeat_whole(v, h)
        ax = ("dp", None, "model", None)
        q, k, v = (constrain(t, *ax) for t in (q, k, v))
        q_pos, k_pos = constrain(q_pos, "dp", None), \
            constrain(k_pos, "dp", None)
        grads = (q.placements, k.placements, v.placements)
        fn = functools.partial(_local_attend, window=window, causal=causal)
        out_pl = tuple(q.placements)
    elif s > 1:
        q = constrain(q, "dp", "model", None, None)
        k, v = (constrain(t, "dp", None, None, None) for t in (k, v))
        q_pos, k_pos = constrain(q_pos, "dp", "model"), \
            constrain(k_pos, "dp", None)
        model = mesh.mesh_dims.index(("model",))
        partial = [Partial() if i == model else p
                   for i, p in enumerate(k.placements)]
        grads = (q.placements, partial, partial)
        fn = functools.partial(_local_attend, window=window, causal=causal)
        out_pl = tuple(q.placements)
    else:
        k, v = (constrain(t, "dp", "model", None, None) for t in (k, v))
        q = constrain(q, "dp", None, None, None)
        q_pos, k_pos = constrain(q_pos, "dp", None), \
            constrain(k_pos, "dp", "model")
        grads = (q.placements, k.placements, v.placements)
        model = mesh.mesh_dims.index(("model",))
        if isinstance(k.placements[model], Replicate) \
                or mesh.shape["model"] == 1:          # T whole on a rank
            fn = functools.partial(_local_attend, window=window,
                                   causal=causal)
        else:
            fn = functools.partial(
                _local_decode, window=window, causal=causal,
                group=mesh.device_mesh.get_group(model))
        out_pl = tuple(q.placements)
    ins = tuple(tuple(t.placements) for t in (q, k, v, q_pos, k_pos))
    grads = tuple(tuple(g) for g in grads) + ins[3:]   # positions: none
    return local_map(fn, out_placements=list(out_pl), in_placements=ins,
                     in_grad_placements=grads,
                     device_mesh=mesh.device_mesh)(q, k, v, q_pos, k_pos)


def _repeat_whole(k: torch.Tensor, h: int) -> torch.Tensor:
    """KV heads that do not divide ``model`` repeated to the query heads
    while whole, so that a rank's KV heads are the ones its query heads
    read; the gradient is made whole before the repeat's backward, which
    cannot cut a head dim split over ``model`` into KV heads that do not
    divide it."""
    return constrain(repeat_kv(constrain(k, "dp", None, None, None), h),
                     "dp", None, None, None)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: with one local
    head the einsums' gradients come back transposed, and the DTensor
    reshape of the projection's backward cannot view a rank's part of
    them."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_attend(q, k, v, q_pos, k_pos, *, window, causal):
    q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
    return _attend(q, k, v, q_pos, k_pos, window, causal)


def _local_decode(q, k, v, q_pos, k_pos, *, window, causal, group):
    """One rank's stretch of the KV length at decode, combined over
    ``group`` (the ``model`` axis): the global max of the logits, then
    the sums of the exponentials and of their products with V."""
    from torch.distributed import _functional_collectives as funcol
    h, dh = q.shape[2], q.shape[3]
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * (1.0 / (dh ** 0.5))
    if causal:
        diff = q_pos[:, None, :, None] - k_pos[:, None, None, :]
        logits = torch.where((diff >= 0) & (diff < window), logits, NEG_INF)
    m = funcol.all_reduce(logits.amax(-1, keepdim=True), "max", group)
    p = torch.exp(logits - m)
    den = funcol.all_reduce(p.sum(-1, keepdim=True), "sum", group)
    num = funcol.all_reduce(torch.einsum("bhst,bthd->bhsd",
                                         p.to(v.dtype), v).float(),
                            "sum", group)
    return (num / den).to(v.dtype).transpose(1, 2)


def _write_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Write this call's k/v [B, s, KV, dh] into the cache at ``index``.

    A scalar index writes one slice for every slot, its start clamped so
    the slice fits (``dynamic_update_slice``); a vector index writes slot
    b at ``index[b] + arange(s)`` and drops the positions past the cache's
    end (``.at[].set(mode="drop")``), through :func:`_scatter_rows`.  A
    scalar index is a 0-dim CPU tensor (``place`` leaves it as it is on a
    mesh), so its start costs no device round trip."""
    ck, cv, idx = cache["k"], cache["v"], cache["index"]
    if hasattr(ck, "device_mesh"):
        return _write_sharded_cache(cache, k, v)
    s, t = k.shape[1], ck.shape[1]
    if idx.dim() == 0:
        start = min(max(int(idx), 0), t - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
    else:
        for c, new in ((ck, k), (cv, v)):
            _scatter_rows(c, new, idx)
    return {"k": ck, "v": cv, "index": idx + s}


def _scatter_rows(c: torch.Tensor, new: torch.Tensor, base: torch.Tensor,
                  first: int = 0) -> None:
    """Write row r of ``new`` [b, s, ...] at columns ``base[r] + arange(s)``
    of ``c`` [b, n, ...], in place, where ``c`` holds the cache's columns
    ``first .. first + n - 1`` (the whole length on one card, a rank's
    stretch of it on a mesh); a column outside the stretch (past the
    cache's end among them) is dropped.

    The drop takes no host sync (a boolean mask would: its ``nonzero``
    reads the mask's count back): every position is written at its column
    clamped into the stretch, and a dropped one writes the value that
    column receives anyway -- the row's own write there if it has one,
    else the cache's current value -- so repeated indices carry equal
    values and the result is the drop's."""
    b, s = new.shape[:2]
    dev = c.device
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    base = base.to(dev).long()[:, None]
    cols = (base + torch.arange(s, device=dev)[None, :]) \
        .clamp(first, first + c.shape[1] - 1)
    src = cols - base                   # the call's position at that column
    tail = (1,) * (new.dim() - 2)
    own = ((src >= 0) & (src < s)).view(b, s, *tail)
    src = src.clamp(0, s - 1).view(b, s, *tail).expand(new.shape)
    local = cols - first
    c[rows, local] = torch.where(own, new.gather(1, src).to(c.dtype),
                                 c[rows, local])


def _write_sharded_cache(cache: Dict, k: torch.Tensor,
                         v: torch.Tensor) -> Dict:
    """The write into a cache of DTensors (placed by ``shard_cache``):
    the new entries are placed as the cache is but whole along its length
    (the length split over ``model``, or over every axis at batch 1; where
    it does not divide, the head dim is split instead and the entries go
    to that placement), and each rank writes, in place, the part of every
    one of its rows' columns ``index .. index + s - 1`` that falls in its
    own stretch of the length.  A scalar index (on the host) writes a
    slice; a per-slot index (replicated, as ``cache_spec`` gives it
    ``P()``) goes through :func:`_scatter_rows` over the rank's rows and
    stretch, dropping past the cache's end as one card does.  Neither
    reads a device value on the host."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ck, cv, idx = cache["k"], cache["v"], cache["index"]
    s, t = k.shape[1], ck.shape[1]
    dm, pl = ck.device_mesh, list(ck.placements)
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
             for p in pl]
    first, length = local_range(ck, 1)
    news = []
    for new in (k, v):
        if not isinstance(new, DTensor):
            new = DTensor.from_local(new, dm, [Replicate()] * dm.ndim,
                                     run_check=False)
        news.append(new.redistribute(dm, whole).to_local())
    if idx.dim() == 0:
        start = min(max(int(idx), 0), t - s)
        lo, hi = max(start, first), min(start + s, first + length)
        if lo < hi:
            for c, new in zip((ck, cv), news):
                c.to_local()[:, lo - first:hi - first] = \
                    new[:, lo - start:hi - start].to(c.dtype)
    else:
        row0, rows = local_range(ck, 0)
        starts = idx.to_local() if isinstance(idx, DTensor) else idx
        for c, new in zip((ck, cv), news):
            _scatter_rows(c.to_local(), new, starts[row0:row0 + rows], first)
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
    hp = heads_parallel(num_heads)
    q = _split_heads(matmul(x, attn.q), num_heads, head_dim,
                     "model" if hp else None)
    if kv_override is None:
        k, v = project_kv(attn, x, num_heads, num_kv_heads, head_dim)
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
        out = _flash(q, k, v, causal, hp).reshape(b, s, -1)
    else:
        out = sdpa(q, k, v, positions, k_pos, window, causal)
    return matmul(out, attn.o), new_cache


def project_kv(attn: Attention, x: torch.Tensor, num_heads: int,
               num_kv_heads: int, head_dim: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x``'s keys and values through ``attn``'s ``k``/``v``, split into
    heads [B, T, KV, dh] (self attention's, and a cross layer's over its
    context).  On a distributed mesh the KV heads are split over
    ``model`` where the query heads are heads-parallel and the KV heads
    divide the axis too, and kept whole otherwise (the split then never
    falls inside a head; :func:`_sdpa_sharded` repeats whole KV heads to
    the query heads)."""
    kv_model = "model" if heads_parallel(num_heads) and \
        num_kv_heads % _context_mesh().shape["model"] == 0 else None
    return tuple(_split_heads(matmul(x, w), num_kv_heads, head_dim,
                              kv_model) for w in (attn.k, attn.v))


def _split_heads(y: torch.Tensor, n: int, head_dim: int,
                 model) -> torch.Tensor:
    """A projection [B, S, n * dh] as [B, S, n, dh].  On a distributed
    mesh it is first constrained to ``("dp", None, model)``: ``model``
    where the heads divide the axis (the split then falls on head
    boundaries), replicated otherwise."""
    b, s, _ = y.shape
    mesh = _context_mesh()
    if mesh is not None and is_distributed(mesh):
        y = constrain(y, "dp", None, model)
    return y.view(b, s, n, head_dim)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, hp: bool) -> torch.Tensor:
    """Kernel 15 on [b, h, s, d] views of q, k, v [b, s, h, d] (the
    kernel reads them and the KV heads in place and writes a [b, s, h, d]
    tensor, so neither side copies); returns [b, s, h, d].  On a
    distributed mesh it runs in ``local_map`` on the reference's two
    branches: heads-parallel, each rank's local heads; otherwise
    sequence-parallel, each rank's contiguous stretch of the query rows
    (the queries' S over ``model``) against the whole K/V, the kernel told
    where its rows start (``q_start``).  Under ``causal`` rank r of m then
    does 2r + 1 of m^2 units of the work: a contiguous split, not a
    balanced one."""
    from repro_torch.kernels.flash_attention import ops as fa

    def run(q, k, v, q_start=0):
        return fa.mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal,
                      q_start=q_start).transpose(1, 2)

    mesh = _context_mesh()
    if mesh is None or not is_distributed(mesh):
        return run(q, k, v)
    from torch.distributed.tensor.experimental import local_map
    if hp:
        if k.shape[2] % mesh.shape["model"]:
            k, v = _repeat_whole(k, q.shape[2]), \
                _repeat_whole(v, q.shape[2])
        q, k, v = (constrain(t, "dp", None, "model", None)
                   for t in (q, k, v))
        fn = run
    else:
        q = constrain(q, "dp", "model", None, None)
        k, v = (constrain(t, "dp", None, None, None) for t in (k, v))
        fn = functools.partial(run, q_start=local_range(q, 1)[0])
    q_pl, kv_pl = list(q.placements), list(k.placements)
    out = local_map(fn, out_placements=q_pl,
                    in_placements=(q_pl, kv_pl, kv_pl),
                    device_mesh=mesh.device_mesh)(q, k, v)
    # the query rows gathered whole, as :func:`sdpa` gathers them (the
    # output projection's product cannot fold a split sequence into its
    # rows)
    return out if hp else constrain(out, "dp", None, None, None)


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
