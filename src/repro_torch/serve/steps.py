"""Serving steps (prefill / decode) and the slot write of a
continuous-batching cache."""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from repro_torch.models.model import LM


def make_prefill_step(model: LM) -> Callable:
    def prefill_step(batch, cache):
        return model.prefill(batch, cache)
    return prefill_step


def make_decode_step(model: LM) -> Callable:
    def decode_step(tokens, cache):
        return model.decode_step(tokens, cache)
    return decode_step


def write_slots(cache: Dict, prefill_cache: Dict,
                slots: Sequence[int]) -> Dict:
    """Write row j of a scalar-index ``prefill_cache`` (one prefill of
    same-length prompts) into slot ``slots[j]`` of a vector-index
    ``cache``, in place, and set those slots' index to the prefill's: the
    port of the reference engine's ``_write_slots``, which admits a group
    of prompts into a continuous batch.  Every leaf of a layer's cache is
    written: ``kv`` (k, v and index), ``ssm`` (conv and state) and
    ``cross`` (k, v)."""
    if cache["index"].dim() != 1 or prefill_cache["index"].dim() != 0:
        raise ValueError("write_slots takes a vector-index cache and a "
                         "scalar-index prefill cache")
    dev = cache["index"].device
    rows = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
    n = int(prefill_cache["index"])
    for dst, src in zip(cache["layers"], prefill_cache["layers"]):
        if "kv" in dst:
            dkv, skv = dst["kv"], src["kv"]
            t = min(dkv["k"].shape[1], skv["k"].shape[1])
            dkv["k"][rows, :t] = skv["k"][:, :t].to(dkv["k"].dtype)
            dkv["v"][rows, :t] = skv["v"][:, :t].to(dkv["v"].dtype)
            dkv["index"][rows] = n
        for part, leaves in (("ssm", ("conv", "state")),
                             ("cross", ("k", "v"))):
            if part in dst:
                for leaf in leaves:
                    d = dst[part][leaf]
                    d[rows] = src[part][leaf].to(d.dtype)
    cache["index"][rows] = n
    return cache
