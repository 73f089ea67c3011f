"""Distributed-optimization utilities: gradient compression.

The JAX package's ``distributed/collectives.py`` on PyTorch.  Cross-pod
links are slower than the links inside a pod and carry the pure
data-parallel gradient reduction.  ``compress_with_feedback`` /
``decompress`` implement int8 blockwise quantization (256-value blocks
along the last axis, a float32 scale each) with **error feedback** (the
quantization residual is carried into the next step), the standard trick
that keeps convergence while cutting cross-pod bytes 4x vs float32 / 2x
vs bfloat16.  Gradients and the error-feedback state are flat mappings
of name -> tensor.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

QBLOCK = 256


def _q(x: torch.Tensor) -> Dict:
    if x.dim() == 0:
        x = x[None]
    pad = (-x.shape[-1]) % QBLOCK
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(x.shape[:-1] + (-1, QBLOCK))
    scale = torch.clamp(blocks.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dq(s: Dict, like: torch.Tensor) -> torch.Tensor:
    full = s["q"].float() * s["scale"]
    full = full.reshape(full.shape[:-2] + (-1,))
    if like.dim() == 0:
        return full[0].reshape(())
    return full[..., :like.shape[-1]].reshape(like.shape)


def init_error_feedback(grads: Mapping) -> Dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def compress_with_feedback(grads: Mapping, error: Mapping
                           ) -> Tuple[Dict, Dict]:
    """Returns (compressed mapping, new error feedback state)."""
    comp, new_e = {}, {}
    for k, g in grads.items():
        corrected = g.float() + error[k]
        comp[k] = _q(corrected)
        new_e[k] = corrected - _dq(comp[k], corrected)
    return comp, new_e


def decompress(compressed: Mapping, like: Mapping) -> Dict:
    return {k: _dq(compressed[k], l).to(l.dtype) for k, l in like.items()}


def compressed_bytes(compressed: Mapping) -> int:
    return sum(t.numel() * t.element_size()
               for c in compressed.values() for t in c.values())
