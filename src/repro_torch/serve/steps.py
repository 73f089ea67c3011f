"""Serving steps (prefill / decode) and the slot write of a
continuous-batching cache."""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

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
    ``cross`` (k, v).  On a distributed mesh the leaves are DTensors, and
    each rank writes the rows among ``slots`` that it holds
    (:func:`_write_rows`)."""
    if cache["index"].dim() != 1 or prefill_cache["index"].dim() != 0:
        raise ValueError("write_slots takes a vector-index cache and a "
                         "scalar-index prefill cache")
    slots = list(slots)
    n = int(prefill_cache["index"])
    for dst, src in zip(cache["layers"], prefill_cache["layers"]):
        if "kv" in dst:
            dkv, skv = dst["kv"], src["kv"]
            _write_rows(dkv["k"], skv["k"], slots)
            _write_rows(dkv["v"], skv["v"], slots)
            _set_rows(dkv["index"], slots, n)
        for part, leaves in (("ssm", ("conv", "state")),
                             ("cross", ("k", "v"))):
            if part in dst:
                for leaf in leaves:
                    _write_rows(dst[part][leaf], src[part][leaf], slots)
    _set_rows(cache["index"], slots, n)
    return cache


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _set_rows(index: torch.Tensor, slots: List[int], n: int) -> None:
    """``index[slots] = n``: a per-slot index is replicated on a mesh, so
    every rank writes its whole copy."""
    local = _local(index)
    local[torch.as_tensor(slots, dtype=torch.long, device=local.device)] = n


def _write_rows(dst: torch.Tensor, src: torch.Tensor,
                slots: List[int]) -> None:
    """``dst[slots[j]] = src[j]`` over the leading ``min`` of the two
    leaves' other dims (a prefill cache may be shorter than the slots').
    A DTensor ``dst`` takes the rows among ``slots`` in this rank's
    stretch of the batch, each cut to the rank's stretch of every other
    dim, from ``src`` made whole (a prefill group's cache is placed for
    its own batch, so its placements are not ``dst``'s); which rows and
    stretches is known on the host from the rank's coordinate."""
    if not hasattr(dst, "device_mesh"):
        rows = torch.as_tensor(slots, dtype=torch.long, device=dst.device)
        cut = tuple(slice(0, min(a, b)) for a, b in
                    zip(dst.shape[1:], src.shape[1:]))
        dst[(rows,) + cut] = src[(slice(None),) + cut].to(dst.dtype)
        return
    from repro_torch.distributed.sharding import local_range
    # every rank takes part in the gather, whether it holds a slot or not
    whole = src.full_tensor() if hasattr(src, "full_tensor") else src
    row0, n_rows = local_range(dst, 0)
    pairs = [(j, r - row0) for j, r in enumerate(slots)
             if row0 <= r < row0 + n_rows]
    if not pairs:
        return
    local = dst.to_local()
    to_cut, from_cut = [], []
    for dim in range(1, dst.dim()):
        first, size = local_range(dst, dim)
        hi = max(min(first + size, whole.shape[dim]), first)
        to_cut.append(slice(0, hi - first))
        from_cut.append(slice(first, hi))
    j, r = (torch.as_tensor(x, dtype=torch.long, device=local.device)
            for x in zip(*pairs))
    local[(r, *to_cut)] = whole[(j.to(whole.device), *from_cut)] \
        .to(local.dtype)
