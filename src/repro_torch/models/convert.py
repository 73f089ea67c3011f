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

:func:`reference_leaf` is the map back: a port parameter's name to the
reference's leaf and unit index (``layers.{i}.<leaf>`` is unit ``i //
unit_size`` of ``units.l{i % unit_size}.<leaf>``).  The optimizers need it
where the reference's update depends on a leaf's rank (weight decay,
Adafactor's factoring), and :func:`opt_state_from_jax` carries an
optimizer state of the JAX package across with the same split.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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


#: the heads of the port's names that the reference stacks: the repeating
#: units (``layers.{i}``) and the encoder's (``enc_layers.{i}``)
UNIT_HEADS = ("layers", "enc_layers")


def reference_leaf(cfg: ModelConfig, name: str) -> Tuple[str, Optional[int]]:
    """(the reference's leaf path, the unit index) of the port's parameter
    ``name``; the index is None for a leaf that is not stacked (its head
    not in :data:`UNIT_HEADS`)."""
    head, _, rest = name.partition(".")
    idx, _, leaf = rest.partition(".")
    if head == "layers":
        i = int(idx)
        return f"units.l{i % cfg.unit_size}.{leaf}", i // cfg.unit_size
    if head == "enc_layers":
        return f"enc_units.l0.{leaf}", int(idx)
    if head == "prefix":
        return f"prefix_{idx}.{leaf}", None
    return name, None


def _is_state(node) -> bool:
    """An optimizer state leaf: int8 ``{q, scale}`` or Adafactor's
    ``{row, col}`` / ``{full}``."""
    return isinstance(node, Mapping) and bool(node) and (
        set(node) == {"q", "scale"} or set(node) <= {"row", "col", "full"})


def _flatten_states(tree: Mapping, prefix: str = "") -> Dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping) and not _is_state(val):
            out.update(_flatten_states(val, name + "."))
        else:
            out[name] = val
    return out


def _port_names(cfg: ModelConfig, ref_name: str, n: int):
    """The port's names of the ``n`` units of the stacked leaf
    ``ref_name`` (``units.l{j}.<leaf>`` or ``enc_units.l0.<leaf>``)."""
    head, _, rest = ref_name.partition(".")
    unit, _, leaf = rest.partition(".")
    if head == "units":
        j = int(unit[1:])
        return [f"layers.{u * cfg.unit_size + j}.{leaf}" for u in range(n)]
    return [f"enc_layers.{u}.{leaf}" for u in range(n)]


def opt_state_from_jax(cfg: ModelConfig, opt_tree: Mapping,
                       kind: str) -> Dict:
    """The port's optimizer state for the JAX package's ``opt_tree`` (as
    nested dicts of numpy arrays) of ``kind`` ``"adamw"`` (``m``/``v`` in
    float32 or bfloat16, or int8 ``{q, scale}``) or ``"adafactor"``
    (``row``/``col``/``full``), and ``step``.

    Stacked leaves are split by unit as :func:`params_from_jax` splits the
    parameters.  An int8 leaf quantises along its last axis, so its
    ``q``/``scale`` split the same way.  Adafactor's state of a stacked
    vector (the reference's ``[n_units, d]``) has ``row`` ``[n_units]``,
    one entry a unit (a 0-dim ``row`` each), and a ``col`` ``[d]`` shared
    by the units, given to each of them."""
    if kind not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer kind {kind!r}")
    state: Dict = {"step": to_tensor(opt_tree["step"])}
    for key in ("m", "v") if kind == "adamw" else ("v",):
        out: Dict = {}
        for name, val in _flatten_states(opt_tree[key]).items():
            head = name.partition(".")[0]
            if head not in ("units", "enc_units"):
                if head.startswith("prefix_"):
                    name = f"prefix.{head[len('prefix_'):]}." \
                        + name.partition(".")[2]
                out[name] = _state_leaf(val, None)
                continue
            n = cfg.n_units if head == "units" else cfg.encoder_layers
            for u, port in enumerate(_port_names(cfg, name, n)):
                out[port] = _state_leaf(val, u)
        state[key] = out
    return state


def _state_leaf(val, u: Optional[int]):
    """One port state leaf: unit ``u`` of a stacked leaf's state (all of
    it when ``u`` is None)."""
    if not isinstance(val, Mapping):
        return to_tensor(val if u is None else np.asarray(val)[u])
    if u is None:
        return {k: to_tensor(v) for k, v in val.items()}
    out = {}
    for k, v in val.items():
        v = np.asarray(v)
        # a stacked vector's col is across the units: every unit holds it
        out[k] = to_tensor(v) if k == "col" and "row" in val and \
            np.asarray(val["row"]).ndim == 1 else to_tensor(v[u])
    return out
