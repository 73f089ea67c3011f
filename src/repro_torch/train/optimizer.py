"""Optimizers built from scratch (no ``torch.optim``): AdamW + Adafactor.

The JAX package's ``train/optimizer.py`` on PyTorch, step for step:

* **moment dtype policy** -- AdamW first/second moments in float32,
  bfloat16, or **int8 block-quantized** (128-value blocks along the last
  axis with a float32 scale each; ``torch.round`` rounds half to even, as
  ``jnp.round`` does);
* global-norm clipping, decoupled weight decay, bias correction;
* Adafactor (factored second moment) for memory-constrained fallbacks.

``torch.optim`` has no int8 moments and orders its update differently, so
the update is written out on tensors (``torch._foreach_*`` for the
elementwise chain).  Parameters, gradients and moments are flat mappings
of name -> tensor; states are plain dicts of tensors, so they checkpoint
like the parameters.  ``update`` returns ``(new_params, new_state, stats)``
with new tensors and leaves its inputs as they were.

The reference's rank tests read its own layout, where a repeating unit's
parameters are stacked on a leading ``n_units`` axis.  ``init`` and
``update`` take that layout for the port's unstacked parameters
(``layout``: name -> (the reference's leaf, unit index), which
:func:`~repro_torch.train.train_step.unit_layout` computes from a model
and the train step passes), so:

* weight decay applies where the reference's leaf has rank >= 2 (a unit's
  norm scale ``[d]`` is ``[n_units, d]`` there, and is decayed);
* Adafactor factors the reference's stacked vector ``[n_units, d]``
  across its units (``row`` one entry a unit, ``col`` shared, the
  normaliser the mean over the units), and a stacked matrix unit by unit.

An empty layout makes every tensor its own leaf.  Without one, a unit's
parameter (``layers.{i}.*``, ``enc_layers.{i}.*``) raises rather than be
updated by its own rank.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple)

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import placed_like
from repro_torch.models.convert import UNIT_HEADS

QBLOCK = 128
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


#: name -> (the reference's stacked leaf, unit index)
Layout = Mapping[str, Tuple[str, int]]


def _layout(names, layout: Optional[Layout]) -> Layout:
    """``layout``; without one, {} unless a unit's parameter is among
    ``names``, which raises."""
    if layout is not None:
        return layout
    unit = next((n for n in names if n.partition(".")[0] in UNIT_HEADS),
                None)
    if unit is not None:
        raise ValueError(
            f"{unit} is a repeating unit's parameter, which the reference "
            f"stacks: pass the layout (train_step.unit_layout(model)), or "
            f"{{}} to update every tensor by its own rank")
    return {}


# ---------------------------------------------------------------------------
# int8 blockwise quantization for optimizer moments
# ---------------------------------------------------------------------------

def _whole(x, dims):
    """``x`` with ``dims`` whole on every rank where it is a DTensor split
    along them (the blocks of the int8 moments cut across a rank's part
    of a split last dim, and its padding belongs to the whole dim);
    anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _quantize_int8(x: torch.Tensor) -> Dict:
    """Blockwise int8 along the LAST axis only (odd last dims zero-padded),
    as the reference quantises."""
    x = _whole(x, [-1]) if x.dim() else x
    if x.dim() == 0:
        x = x[None]
    pad = (-x.shape[-1]) % QBLOCK
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(x.shape[:-1] + (-1, QBLOCK))
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequantize_int8(s: Dict, like: torch.Tensor) -> torch.Tensor:
    full = _whole(s["q"], [-2]).float() * _whole(s["scale"], [-2])
    full = full.reshape(full.shape[:-2] + (-1,))
    shape = like.shape if like.dim() else (1,)
    return full[..., :shape[-1]].reshape(like.shape)


def _int8_zeros(shape, device) -> Dict:
    """``_quantize_int8`` of zeros of ``shape``, built directly: q 0 and
    every block's scale the clamp's 1e-12."""
    shape = tuple(shape) or (1,)
    blocks = shape[:-1] + (-(-shape[-1] // QBLOCK),)
    return {"q": torch.zeros(blocks + (QBLOCK,), dtype=torch.int8,
                             device=device),
            "scale": torch.full(blocks + (1,), 1e-12, dtype=torch.float32,
                                device=device)}


def _moment_init(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _int8_zeros(p.shape, p.device)
    return torch.zeros(p.shape, dtype=_DTYPES[dtype], device=p.device)


def _moment_read(m, like: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize_int8(m, like)
    return m.float()


def _moment_write(x: torch.Tensor, dtype: str, old=None):
    """``x`` as a moment of ``dtype``, placed as the ``old`` moment is."""
    if dtype == "int8":
        q = _quantize_int8(x)
        return q if old is None else {k: placed_like(v, old[k])
                                      for k, v in q.items()}
    return placed_like(x.to(_DTYPES[dtype]), old)


# ---------------------------------------------------------------------------
# Optimizer interface
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable[..., Any]
    update: Callable[..., Tuple[Any, Any, Dict]]
    # init(params, layout=None) -> state
    # update(grads, state, params, layout=None)
    #     -> (new_params, new_state, stats)


def _leaves(tree) -> List[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    leaves = [g.float() for g in _leaves(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(leaves, 2)))


def _scaled(leaves: List[torch.Tensor], scale: torch.Tensor) -> List:
    """Each leaf times ``scale`` cast to the leaf's own type."""
    out = list(leaves)
    by_type: Dict[torch.dtype, List[int]] = {}
    for i, g in enumerate(leaves):
        by_type.setdefault(g.dtype, []).append(i)
    for dt, idx in by_type.items():
        got = torch._foreach_mul([leaves[i] for i in idx], scale.to(dt))
        for i, g in zip(idx, got):
            out[i] = g
    return out


def clip_by_global_norm(grads, max_norm: float):
    """Dtype-preserving clip: the norm is a float32 reduction, the scale is
    applied in each leaf's own type.  Returns (clipped, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    if isinstance(grads, Mapping):
        return dict(zip(grads, _scaled(list(grads.values()), scale))), norm
    return _scaled(list(grads), scale), norm


def _lr(lr_fn, step: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(lr_fn(step), dtype=torch.float32,
                           device=step.device)


def _step_init(params) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


#: elements of the leaves one chunk of an update holds (float32 GiB / 4)
CHUNK_ELEMENTS = 1 << 28


def _chunks(names: List[str], params: Mapping) -> List[List[str]]:
    """``names`` in order, cut into runs of at most ``CHUNK_ELEMENTS``
    elements (a larger leaf alone)."""
    out, size = [[]], 0
    for n in names:
        k = params[n].numel()
        if out[-1] and size + k > CHUNK_ELEMENTS:
            out.append([])
            size = 0
        out[-1].append(n)
        size += k
    return [c for c in out if c]


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0,
          moment_dtype: str = "float32") -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params, layout: Optional[Layout] = None):
        _layout(params, layout)
        return {"m": {n: _moment_init(p, moment_dtype)
                      for n, p in params.items()},
                "v": {n: _moment_init(p, moment_dtype)
                      for n, p in params.items()},
                "step": _step_init(params)}

    def update(grads, state, params, layout: Optional[Layout] = None):
        names = list(params)
        layout = _layout(names, layout)
        step = state["step"] + 1
        g, gnorm = clip_by_global_norm([grads[n] for n in names],
                                       max_grad_norm)
        lr_t = _lr(lr_fn, step)
        sf = step.float()
        bc1 = 1.0 - torch.pow(b1, sf)
        bc2 = 1.0 - torch.pow(b2, sf)
        g = dict(zip(names, g))
        new_p, new_m, new_v = {}, {}, {}
        # in chunks of leaves, so that the update's float32 temporaries
        # stay near a chunk's size (an MoE layer's expert banks are a
        # card's gigabytes each)
        for chunk in _chunks(names, params):
            gc = [g.pop(n).float() for n in chunk]
            p32 = [params[n].float() for n in chunk]
            m = [_moment_read(state["m"][n], params[n], moment_dtype)
                 for n in chunk]
            v = [_moment_read(state["v"][n], params[n], moment_dtype)
                 for n in chunk]
            # mf = b1 m + (1 - b1) g ; vf = b2 v + (1 - b2) g g
            mf = torch._foreach_mul(m, b1)
            torch._foreach_add_(mf, torch._foreach_mul(gc, 1 - b1))
            gg = torch._foreach_mul(gc, 1 - b2)
            torch._foreach_mul_(gg, gc)
            vf = torch._foreach_mul(v, b2)
            torch._foreach_add_(vf, gg)
            del gg, gc, m, v
            # delta = (mf / bc1) / (sqrt(vf / bc2) + eps)
            delta = torch._foreach_div(mf, bc1)
            den = torch._foreach_div(vf, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(delta, den)
            del den
            decay = [i for i, n in enumerate(chunk)
                     if params[n].dim() + (n in layout) >= 2]
            if decay:  # decoupled weight decay on the reference's matrices
                torch._foreach_add_([delta[i] for i in decay],
                                    torch._foreach_mul(
                                        [p32[i] for i in decay],
                                        weight_decay))
            torch._foreach_mul_(delta, lr_t)
            new = torch._foreach_sub(p32, delta)
            del delta, p32
            for n, x, mx, vx in zip(chunk, new, mf, vf):
                new_p[n] = placed_like(x.to(params[n].dtype), params[n])
                new_m[n] = _moment_write(mx, moment_dtype, state["m"][n])
                new_v[n] = _moment_write(vx, moment_dtype, state["v"][n])
            del new, mf, vf
        return new_p, {"m": new_m, "v": new_v, "step": step}, \
            {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


def adafactor(lr: Callable | float = 1e-3, eps: float = 1e-30,
              decay: float = 0.8, max_grad_norm: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (rows+cols for the reference's
    rank >= 2 leaves; full for rank 1)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params, layout: Optional[Layout] = None):
        layout = _layout(params, layout)

        def one(n, p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if n in layout and p.dim() == 1:    # a stacked vector's unit
                return {"row": torch.zeros((), **f32),
                        "col": torch.zeros(p.shape, **f32)}
            if p.dim() >= 2:
                return {"row": torch.zeros(p.shape[:-1], **f32),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           **f32)}
            return {"full": torch.zeros(p.shape, **f32)}
        return {"v": {n: one(n, p) for n, p in params.items()},
                "step": _step_init(params)}

    def factored(g, row, col, beta):
        """One factored leaf (the reference's rank >= 2): g [..., a, b],
        row [..., a], col [..., b] -> (delta, row, col)."""
        g2 = g * g + eps
        row = beta * row + (1 - beta) * g2.mean(-1)
        col = beta * col + (1 - beta) * g2.mean(-2)
        rms = (row[..., :, None] * col[..., None, :]
               / torch.clamp(row.mean(-1, keepdim=True)[..., None],
                             min=eps))
        return g * torch.rsqrt(torch.clamp(rms, min=eps)), row, col

    def update(grads, state, params, layout: Optional[Layout] = None):
        names = list(params)
        layout = _layout(names, layout)
        step = state["step"] + 1
        g, gnorm = clip_by_global_norm([grads[n] for n in names],
                                       max_grad_norm)
        g = dict(zip(names, (x.float() for x in g)))
        lr_t = _lr(lr_fn, step)
        beta = 1.0 - torch.pow(step.float(), -decay)
        sv = state["v"]
        delta, new_v, groups = {}, {}, {}
        for n in names:
            p = params[n]
            if n in layout and p.dim() == 1:
                groups.setdefault(layout[n][0], []).append(n)
            elif p.dim() >= 2:
                delta[n], row, col = factored(g[n], sv[n]["row"],
                                              sv[n]["col"], beta)
                new_v[n] = {"row": row, "col": col}
            else:
                full = beta * sv[n]["full"] + (1 - beta) * (g[n] * g[n] + eps)
                delta[n] = g[n] * torch.rsqrt(torch.clamp(full, min=eps))
                new_v[n] = {"full": full}
        for members in groups.values():
            # the reference's [n_units, d] leaf, factored across its units
            members.sort(key=lambda n: layout[n][1])
            d, row, col = factored(
                torch.stack([g[n] for n in members]),
                torch.stack([sv[n]["row"] for n in members]),
                sv[members[0]]["col"], beta)
            for u, n in enumerate(members):
                delta[n] = d[u]
                new_v[n] = {"row": row[u], "col": col}
        new_p = {n: placed_like((params[n].float() - lr_t * delta[n])
                          .to(params[n].dtype), params[n]) for n in names}
        return new_p, {"v": {n: new_v[n] for n in names}, "step": step}, \
            {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)
