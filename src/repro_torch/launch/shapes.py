"""Assigned input-shape set and stand-in inputs on the ``meta`` device.

The JAX package's ``launch/shapes.py`` on PyTorch.  LM shapes (per the
assignment):
  train_4k     seq=4,096   global_batch=256   -> train_step
  prefill_32k  seq=32,768  global_batch=32    -> prefill_step
  decode_32k   seq=32,768  global_batch=128   -> serve (decode) step
  long_500k    seq=524,288 global_batch=1     -> serve step, SSM/hybrid/
                                                 local-attn archs only

``batch_specs`` and ``cache_specs`` build the arguments each step is
traced with as tensors on the ``meta`` device: the reference's shapes and
dtypes, with no storage behind them (the counterpart of its
``ShapeDtypeStruct`` stand-ins and ``jax.eval_shape``).  A cache comes
from the port's own ``LM.init_cache`` on a model built on ``meta``; its
scalar index is the port's 0-dim host int, as every cache of the port
holds it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str           # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeDef] = {
    "train_4k": ShapeDef("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeDef("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeDef("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeDef("long_500k", "decode", 524_288, 1),
}


def supported_shapes(cfg: ModelConfig) -> List[str]:
    """long_500k only for sub-quadratic archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long:
        out.append("long_500k")
    return out


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeDef,
                with_labels: bool) -> Dict:
    b, s = shape.batch, shape.seq
    if shape.kind == "decode":
        batch = {"tokens": _sds((b, 1), torch.int32)}
        return batch
    batch = {"tokens": _sds((b, s), torch.int32)}
    if with_labels:
        batch["labels"] = _sds((b, s), torch.int32)
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if cfg.encoder_layers:
        batch["frames"] = _sds((b, s, cfg.d_model), dt)
    if cfg.num_vision_tokens:
        batch["vision"] = _sds((b, cfg.num_vision_tokens, cfg.d_model), dt)
    return batch


def cache_specs(model, cfg: ModelConfig, shape: ShapeDef) -> Dict:
    """The cache of a prefill/decode cell from ``model.init_cache`` on a
    model built on ``meta`` (no allocation)."""
    if model.device.type != "meta":
        raise ValueError(f"cache_specs takes a model on meta, not "
                         f"{model.device}: it must allocate nothing")
    ctx_len = 0
    if cfg.encoder_layers:
        ctx_len = shape.seq
    elif cfg.num_vision_tokens:
        ctx_len = cfg.num_vision_tokens
    return model.init_cache(shape.batch, max_len=shape.seq, ctx_len=ctx_len,
                            dtype=torch.bfloat16)
