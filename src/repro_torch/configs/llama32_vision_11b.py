"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, gated cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision].

The vision tower is a STUB: ``input_specs()`` supplies pre-projected patch
embeddings [B, n_vision, d_model].  Cross layers sit at position 3 of each
5-layer unit (real model: layers 3, 8, 13, ..., 38).
"""
from .base import LayerSpec, ModelConfig, register


@register("llama-3.2-vision-11b")
def make_config() -> ModelConfig:
    unit = tuple(LayerSpec(kind="attn", cross=(j == 3)) for j in range(5))
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        d_model=4096, vocab_size=128256,
        num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336,
        unit=unit, n_units=8,
        num_vision_tokens=1600,
        rope_theta=500_000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", supports_long=False, train_microbatches=4)
