"""Pre-norm residual decoder block driven by ``LayerSpec``.

The JAX package's ``models/blocks.py`` for the dense attention family: an
attention sub-layer (full, windowed, GQA) and a dense MLP.  A spec that
needs an SSM mixer, a MoE FFN or a cross-attention sub-layer raises
``NotImplementedError``: those modules are not ported yet (ROADMAP item
10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import FULL_WINDOW, LayerSpec, ModelConfig

from .attention import Attention, attention_apply, init_kv_cache
from .layers import MLP, Norm

BIG_WINDOW = 1 << 30  # "full attention" as a window size


def check_spec(cfg: ModelConfig, spec: LayerSpec) -> None:
    """Raise ``NotImplementedError`` for what the port cannot build yet."""
    missing = [what for what, needed in (
        ("an SSM mixer (models/ssm.py)", spec.kind != "attn"),
        ("a MoE FFN (models/moe.py)", spec.moe),
        ("cross-attention", spec.cross),
        ("an encoder", cfg.encoder_layers > 0),
        ("vision inputs", cfg.num_vision_tokens > 0)) if needed]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} is not ported to repro_torch "
            f"yet (ROADMAP item 10); the dense attention family is")


class Block(nn.Module):
    """``ln1``, ``attn``, then (if ``spec.mlp``) ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 d_ff_override: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        check_spec(cfg, spec)
        self.ln1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.attn = Attention(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, cfg.qk_norm, dtype, device)
        if spec.mlp:
            self.ln2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.mlp = MLP(cfg.d_model, d_ff_override or cfg.d_ff,
                           cfg.gated_mlp, cfg.act, dtype, device)

    def init_(self, gen: Optional[torch.Generator]) -> None:
        self.ln1.init_()
        self.attn.init_(gen)
        if hasattr(self, "mlp"):
            self.ln2.init_()
            self.mlp.init_(gen)


def layer_init(gen: Optional[torch.Generator], cfg: ModelConfig,
               spec: LayerSpec, d_ff_override: int = 0, dtype=torch.float32,
               device=None) -> Block:
    block = Block(cfg, spec, d_ff_override, dtype, device)
    block.init_(gen)
    return block


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype=torch.bfloat16,
                     vector_index: bool = False, device=None) -> Dict:
    check_spec(cfg, spec)
    return {"kv": init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                cfg.head_dim, dtype, vector_index, device)}


def layer_apply(cfg: ModelConfig, block: Block, x: torch.Tensor, *,
                positions: torch.Tensor, window: int, causal: bool = True,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict], float]:
    """Returns (x, new_cache, aux_loss); a dense block adds no auxiliary
    loss (0.0; the reference's MoE balance loss comes with item 10)."""
    win = BIG_WINDOW if window == FULL_WINDOW else window
    out, kvc = attention_apply(
        block.attn, block.ln1(x), num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        positions=positions, window=win, rope_theta=cfg.rope_theta,
        causal=causal, use_rope=cfg.use_rope,
        cache=cache["kv"] if cache is not None else None,
        use_flash=cfg.use_flash)
    x = x + out
    if hasattr(block, "mlp"):
        x = x + block.mlp(block.ln2(x))
    return x, ({"kv": kvc} if cache is not None else None), 0.0
