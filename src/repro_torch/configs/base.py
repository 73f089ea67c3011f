"""Model configuration schema + arch registry.

A config fully describes an architecture as a *layer program*:

* ``prefix``  -- explicitly-parameterized leading layers (unrolled), e.g.
  deepseek-moe's dense first layer;
* ``unit``    -- the repeating block pattern (scan unit), e.g. jamba's
  8-layer [7x mamba + 1x attn, MoE on odd positions] unit;
* ``n_units`` -- scan length; total layers = len(prefix) + n_units*len(unit);
* ``window_pattern`` -- per-scanned-layer attention window (0 = full), e.g.
  gemma3's 5 local : 1 global interleave, kept *traced* so the scan stays
  homogeneous.

``reduced()`` produces the CPU smoke-test configuration of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

FULL_WINDOW = 0  # sentinel: full (unwindowed) attention


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    d_shared: Optional[int] = None
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    num_heads: int
    head_dim: int
    state_dim: int
    n_groups: int = 1
    conv_width: int = 4
    chunk_len: int = 256


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"      # "attn" | "ssm"
    moe: bool = False       # FFN is a MoE
    cross: bool = False     # followed by a cross-attention sub-layer
    mlp: bool = True        # has an FFN at all (mamba2 blocks do not)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str             # dense | moe | ssm | hybrid | encdec | vlm
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    norm: str = "rms"
    act: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    # layer program
    prefix: Tuple[LayerSpec, ...] = ()
    unit: Tuple[LayerSpec, ...] = (LayerSpec(),)
    n_units: int = 0
    window_pattern: Tuple[int, ...] = ()   # per scanned layer; () = all full
    prefix_d_ff: int = 0                   # d_ff override for prefix layers
    # specs
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # encoder-decoder (whisper): encoder is a homogeneous attn stack
    encoder_layers: int = 0
    default_encoder_len: int = 1500
    # vlm
    num_vision_tokens: int = 0
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"                    # none | full | dots
    use_flash: bool = False
    # shape support
    supports_long: bool = False            # sub-quadratic -> run long_500k
    # microbatching for train_4k (grad accumulation inside train_step)
    train_microbatches: int = 1
    # execution: unroll the unit scan (used by roofline cost probes --
    # XLA's cost_analysis counts while-loop bodies ONCE, so per-unit costs
    # are measured on unrolled 1/2-unit probes and extrapolated affinely)
    unroll_units: bool = False

    # ---- derived -----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.prefix) + self.n_units * len(self.unit)

    @property
    def unit_size(self) -> int:
        return len(self.unit)

    def windows(self) -> Tuple[int, ...]:
        """Per-scanned-layer window sizes (0 = full)."""
        n = self.n_units * self.unit_size
        if not self.window_pattern:
            return tuple([FULL_WINDOW] * n)
        assert len(self.window_pattern) == n, \
            f"{self.name}: window_pattern len {len(self.window_pattern)} != {n}"
        return self.window_pattern

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def probe(self, n_units: int) -> "ModelConfig":
        """Cost-probe variant: full layer dims, ``n_units`` unrolled units,
        single microbatch.  See launch/dryrun.py roofline methodology."""
        wp = self.window_pattern
        if wp:
            wp = tuple(wp[: n_units * self.unit_size])
        return self.with_(n_units=n_units, window_pattern=wp,
                          unroll_units=True, train_microbatches=1,
                          encoder_layers=min(self.encoder_layers, n_units),
                          remat=self.remat)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        scale_heads = max(self.num_heads // 4, 2) if self.num_heads else 0
        scale_kv = max(self.num_kv_heads // 4, 1) if self.num_kv_heads else 0
        if self.num_heads and scale_heads % scale_kv:
            scale_heads = scale_kv * max(scale_heads // scale_kv, 1)
        n_units = min(self.n_units, 2)
        wp = self.window_pattern
        if wp:
            wp = tuple(min(w, 64) if w else 0
                       for w in wp[: n_units * self.unit_size])
        moe = self.moe
        if moe:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, 8),
                top_k=min(moe.top_k, 2), d_expert=64,
                d_shared=64 if moe.num_shared else None)
        ssm = self.ssm
        if ssm:
            ssm = dataclasses.replace(ssm, num_heads=4, head_dim=16,
                                      state_dim=16, n_groups=min(ssm.n_groups, 2),
                                      chunk_len=32)
        return self.with_(
            d_model=128, vocab_size=512,
            num_heads=scale_heads, num_kv_heads=scale_kv,
            head_dim=32 if self.head_dim else 0,
            d_ff=256 if self.d_ff else 0, prefix_d_ff=256 if self.prefix_d_ff else 0,
            n_units=n_units, window_pattern=wp, moe=moe, ssm=ssm,
            encoder_layers=min(self.encoder_layers, 2),
            default_encoder_len=64,
            num_vision_tokens=min(self.num_vision_tokens, 16) or 0,
            param_dtype="float32", compute_dtype="float32",
            remat="none", train_microbatches=1)


# ----------------------------- registry -------------------------------------

_REGISTRY: Dict[str, object] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str, **overrides) -> ModelConfig:
    from . import _load_all  # noqa: F401  (populate registry)
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[arch_id]()
    return cfg.with_(**overrides) if overrides else cfg


def list_archs():
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
