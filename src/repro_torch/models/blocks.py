"""Pre-norm residual decoder block driven by ``LayerSpec``.

The JAX package's ``models/blocks.py`` on PyTorch.  One ``Block`` covers
every registered family: an attention mixer (full, windowed, GQA) or a
Mamba-2 SSD mixer, an optional tanh-gated cross-attention sub-layer (VLM,
encoder-decoder decoders), and a dense-MLP or MoE FFN (or none).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import FULL_WINDOW, LayerSpec, ModelConfig
from repro_torch.distributed.sharding import placed_like

from .attention import (Attention, attention_apply, init_kv_cache,
                        project_kv)
from .layers import MLP, Norm, param
from .moe import MoE, moe_apply
from .ssm import SSM, init_ssm_cache, ssm_apply

BIG_WINDOW = 1 << 30  # "full attention" as a window size


class Block(nn.Module):
    """``ln1`` and ``attn`` or ``ssm``; with ``spec.cross`` ``ln_x``,
    ``xattn`` and ``x_gate``; with ``spec.mlp`` ``ln2`` and ``mlp`` or
    ``moe``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 d_ff_override: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        self.spec = spec
        self.ln1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        if spec.kind == "attn":
            self.attn = Attention(cfg.d_model, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim,
                                  cfg.qk_norm, dtype, device)
        else:
            s = cfg.ssm
            self.ssm = SSM(cfg.d_model, s.num_heads, s.head_dim, s.state_dim,
                           s.n_groups, s.conv_width, dtype, device)
        if spec.cross:
            self.ln_x = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.xattn = Attention(cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim, False,
                                   dtype, device)
            self.x_gate = param((1,), dtype, device)
        if spec.mlp:
            self.ln2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            if spec.moe:
                m = cfg.moe
                self.moe = MoE(cfg.d_model, m.d_expert, m.num_experts,
                               m.num_shared, m.d_shared, dtype, device)
            else:
                self.mlp = MLP(cfg.d_model, d_ff_override or cfg.d_ff,
                               cfg.gated_mlp, cfg.act, dtype, device)

    def init_(self, gen: Optional[torch.Generator]) -> None:
        """Every sub-module from ``gen``; ``x_gate`` starts at 0, so an
        initialised cross sub-layer adds nothing (tanh(0) = 0)."""
        for name, module in self.named_children():
            module.init_(gen)
        if self.spec.cross:
            self.x_gate.data.zero_()


def layer_init(gen: Optional[torch.Generator], cfg: ModelConfig,
               spec: LayerSpec, d_ff_override: int = 0, dtype=torch.float32,
               device=None) -> Block:
    block = Block(cfg, spec, d_ff_override, dtype, device)
    block.init_(gen)
    return block


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype=torch.bfloat16,
                     vector_index: bool = False, device=None,
                     ctx_len: int = 0) -> Dict:
    """``kv`` (attention) or ``ssm``, and ``cross`` (the context's keys
    and values, ``ctx_len`` long, filled at prefill)."""
    c: Dict = {}
    if spec.kind == "attn":
        c["kv"] = init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                cfg.head_dim, dtype, vector_index, device)
    else:
        s = cfg.ssm
        c["ssm"] = init_ssm_cache(batch, s.num_heads, s.head_dim,
                                  s.state_dim, s.n_groups, s.conv_width,
                                  dtype, device)
    if spec.cross:
        shape = (batch, ctx_len, cfg.num_kv_heads, cfg.head_dim)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


def _cross_kv(block: Block, ctx: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The context's keys and values, split into heads as self
    attention's are (:func:`~.attention.project_kv`)."""
    return project_kv(block.xattn, ctx, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)


def layer_apply(cfg: ModelConfig, block: Block, x: torch.Tensor, *,
                positions: torch.Tensor, window: int, causal: bool = True,
                cross_ctx: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss): the MoE balance loss as a float32
    scalar tensor (0 without a MoE FFN).

    The cross sub-layer attends over ``cross_ctx``'s keys and values; a
    call with a cache and no context (decode) reads them from the cache,
    where a call with both (prefill) stores them, as computed (the
    reference's choice: their type is the compute type, not the
    cache's)."""
    spec = block.spec
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Optional[Dict] = {} if cache is not None else None
    h = block.ln1(x)
    if spec.kind == "attn":
        win = BIG_WINDOW if window == FULL_WINDOW else window
        out, kvc = attention_apply(
            block.attn, h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, window=win, rope_theta=cfg.rope_theta,
            causal=causal, use_rope=cfg.use_rope,
            cache=cache["kv"] if cache is not None else None,
            use_flash=cfg.use_flash)
        if cache is not None:
            new_cache["kv"] = kvc
    else:
        s = cfg.ssm
        out, sc = ssm_apply(block.ssm, h, num_heads=s.num_heads,
                            head_dim=s.head_dim, state_dim=s.state_dim,
                            n_groups=s.n_groups, chunk_len=s.chunk_len,
                            cache=cache["ssm"] if cache is not None else None)
        if cache is not None:
            new_cache["ssm"] = sc
    x = x + out

    if spec.cross:
        hx = block.ln_x(x)
        if cache is not None and cross_ctx is None:
            kx, vx = cache["cross"]["k"], cache["cross"]["v"]
        else:
            kx, vx = _cross_kv(block, cross_ctx, cfg)
        if cache is not None:
            # stored under the cache's own placement (the reference's
            # ``/cross/`` rule), where decode reads it
            new_cache["cross"] = {n: placed_like(t, cache["cross"][n])
                                  for n, t in (("k", kx), ("v", vx))}
        t = kx.shape[1]
        k_pos = torch.arange(t, dtype=torch.int32,
                             device=x.device).expand(x.shape[0], t)
        out, _ = attention_apply(
            block.xattn, hx, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, window=BIG_WINDOW, causal=False,
            use_rope=False, kv_override=(kx, vx, k_pos))
        x = x + torch.tanh(block.x_gate).to(x.dtype) * out

    if spec.mlp:
        h2 = block.ln2(x)
        if spec.moe:
            m = cfg.moe
            out2, a = moe_apply(block.moe, h2, num_experts=m.num_experts,
                                top_k=m.top_k,
                                capacity_factor=m.capacity_factor)
            aux = aux + a
        else:
            out2 = block.mlp(h2)
        x = x + out2
    return x, new_cache, aux
