"""Carry a parameter tree of the JAX package across to the port.

``params_from_jax(cfg, tree)`` takes the JAX package's ``LM.init`` tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the state dict of the port's ``LM`` for the same config.  The
stacked ``units`` (leading axis ``n_units``) are split into the unrolled
``layers`` (unit ``u``'s layer ``j`` is ``layers.{u * unit_size + j}``),
and the encoder's stacked ``enc_units`` (leading axis ``encoder_layers``)
into ``enc_layers.{u}``; ``prefix_{i}`` is ``prefix.{i}``; every other
name (``enc_norm``, the MoE banks, the SSM leaves) is the same.  Arrays
of JAX's bfloat16 (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses) are carried bit for bit through their 16-bit patterns.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def to_tensor(a) -> torch.Tensor:
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _unstack(state: Dict[str, torch.Tensor], name: str, arr, n: int,
             key) -> None:
    """Split the stacked leaf ``name`` (leading axis ``n``) into
    ``key(u)`` for each ``u``."""
    arr = np.asarray(arr)
    if arr.shape[0] != n:
        raise ValueError(f"{name}: leading axis {arr.shape[0]} is not {n}")
    for u in range(n):
        state[key(u)] = to_tensor(arr[u])


def params_from_jax(cfg: ModelConfig, tree: Mapping) -> Dict[str,
                                                            torch.Tensor]:
    """The port's state dict for the JAX parameter ``tree`` of ``cfg``."""
    state: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree).items():
        head, _, rest = name.partition(".")
        unit, _, leaf = rest.partition(".")            # l{j}.<leaf>
        if head == "units":
            j = int(unit[1:])
            _unstack(state, name, arr, cfg.n_units,
                     lambda u: f"layers.{u * cfg.unit_size + j}.{leaf}")
        elif head == "enc_units":
            _unstack(state, name, arr, cfg.encoder_layers,
                     lambda u: f"enc_layers.{u}.{leaf}")
        elif head.startswith("prefix_"):
            state[f"prefix.{head[len('prefix_'):]}.{rest}"] = to_tensor(arr)
        else:
            state[name] = to_tensor(arr)
    return state
