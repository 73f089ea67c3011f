"""Train-step builder: grad accumulation, mixed precision, clipping.

The JAX package's ``train/train_step.py`` on PyTorch.
``make_train_step(model, opt, n_micro)`` returns a function
``(params, opt_state, batch) -> (params, opt_state, metrics)`` that leaves
its inputs as they were.  The global batch is split into ``n_micro``
microbatches run one after another, so activation memory is bounded by one
microbatch while the arithmetic matches large-batch training: each
microbatch's gradients are cast to ``accum_dtype`` (float32) and summed
into buffers of that type (never into a bfloat16 parameter's ``.grad``),
and the sum is divided by ``n_micro``, as the reference's ``lax.scan``
does.  The reference's sharding constraints (``constrain``) place the
microbatches (batch over the data axes after the split) and each
microbatch's gradients (as the parameters) on the ambient mesh; without
one they do nothing.  On a distributed mesh (``launch/mesh.py``) the
parameters, states and gradients are DTensors, the step runs one rank's
part of the SPMD program, and its metrics are the global values (the
loss the mean over every data rank's tokens), the same on every rank.

The model holds the parameters its forward reads.  A step points them at
the given ``params`` for the forward and backward (no copy) and back at
the model's own storage after, so a step never writes a caller's tensor
and the model's own parameters keep whatever ``init`` or
``load_state_dict`` gave them.  :func:`model_params` gives a model's
parameters by name; :func:`unit_layout` gives the reference's stacked
layout of them, which the step computes once and hands to the
optimizer's ``update`` (weight decay and Adafactor's factoring read it).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping

import contextlib

import numpy as np
import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.distributed.sharding import (constrain,
                                              constrain_like_params, spmd)
from repro_torch.models.convert import reference_leaf
from repro_torch.models.model import LM

from .optimizer import Layout, Optimizer


def model_params(model: LM) -> Dict[str, torch.Tensor]:
    """Copies of ``model``'s parameters by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def unit_layout(model: LM) -> Layout:
    """The reference's stacked layout of ``model``'s parameters: each
    repeating unit's parameter -> (its stacked leaf, unit index)."""
    out = {}
    for name, _ in model.named_parameters():
        leaf, unit = reference_leaf(model.cfg, name)
        if unit is not None:
            out[name] = (leaf, unit)
    return out


@torch.no_grad()
def load_params(model: LM, params: Mapping[str, torch.Tensor]) -> LM:
    """Copy ``params`` into the model's own parameters."""
    named = dict(model.named_parameters())
    for n, t in params.items():
        named[n].copy_(torch.as_tensor(t))
    return model


def to_device(batch: Mapping, device) -> Dict:
    """The batch's arrays (numpy or torch) on ``device``; a DTensor (a
    batch already placed on a distributed mesh) or anything else as it
    is."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device, non_blocking=True) \
            if isinstance(v, torch.Tensor) and \
            not hasattr(v, "device_mesh") else v
    return out


def _split_micro(batch: Dict, n_micro: int) -> List[Dict]:
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        b = x.shape[0]
        assert b % n_micro == 0, f"batch {b} % micro {n_micro}"
        out = x.reshape((n_micro, b // n_micro) + x.shape[1:])
        # keep microbatches batch-sharded over data axes after the reshape
        return constrain(out, None, "dp", *([None] * (out.dim() - 2)))
    split = {k: one(v) for k, v in batch.items()}
    return [{k: v[i] if isinstance(v, torch.Tensor) else v
             for k, v in split.items()} for i in range(n_micro)]


def _replicated(x):
    """A metric as a plain tensor: a DTensor (a partial sum, say) made
    whole on every rank."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


@contextlib.contextmanager
def _pointed(model: LM, names: List[str], leaves: List, params: Mapping):
    """The model's parameters pointed at ``params`` for one step; yields
    the tensors to differentiate.  For plain ``params`` each parameter
    keeps its object and has its ``data`` swapped (no copy); a DTensor
    cannot be put in a parameter's ``data``, so for DTensor ``params``
    the modules hold detached leaves of them for the step instead (the
    model's own parameters, plain or placed, stay as they are)."""
    if not any(hasattr(params[n], "device_mesh") for n in names):
        own = [p.data for p in leaves]
        try:
            for p, n in zip(leaves, names):
                p.data = params[n].detach()
            yield leaves
        finally:
            for p, data in zip(leaves, own):
                p.data = data
        return
    new = {n: params[n].detach().requires_grad_(p.requires_grad)
           for n, p in zip(names, leaves)}
    with _reparametrize_module(model, new):
        yield [new[n] for n in names]


def make_train_step(model: LM, opt: Optimizer, n_micro: int = 1,
                    accum_dtype=torch.float32) -> Callable:
    named = dict(model.named_parameters())
    layout = unit_layout(model)

    def grads_of(names, leaves, mb):
        loss, inner = model.loss(mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        grads = constrain_like_params(
            {n: g.to(accum_dtype) for n, g in zip(names, grads)}, model.cfg)
        inner = {k: _replicated(v.detach()) if isinstance(v, torch.Tensor)
                 else v for k, v in inner.items()}
        return _replicated(loss.detach()), inner, list(grads.values())

    def train_step(params, opt_state, batch):
        names = list(params)
        batch = to_device(batch, model.device)
        with spmd(), torch.enable_grad(), \
                _pointed(model, names, [named[n] for n in names],
                         params) as leaves:
            if n_micro == 1:
                loss, inner, grads = grads_of(names, leaves, batch)
            else:
                gsum = [torch.zeros_like(p, dtype=accum_dtype)
                        for p in leaves]
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for mb in _split_micro(batch, n_micro):
                    l, inner, g = grads_of(names, leaves, mb)
                    torch._foreach_add_(gsum, g)
                    lsum = lsum + l
                    del g
                grads = torch._foreach_div(gsum, n_micro)
                loss = lsum / n_micro
        with spmd():
            new_params, new_state, stats = opt.update(
                dict(zip(names, grads)), opt_state, params, layout)
        metrics = {"loss": loss, **{k: _replicated(v)
                                    for k, v in stats.items()},
                   "ce": inner.get("ce", loss), "aux": inner.get("aux", 0.0)}
        return new_params, new_state, metrics

    return train_step
