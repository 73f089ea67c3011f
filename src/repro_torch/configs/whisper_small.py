"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H d_ff=3072
vocab=51865, encoder-decoder [arXiv:2212.04356].

The conv frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings [B, frames, d_model].  Deviations noted in DESIGN.md: rotary
positions instead of learned/sinusoidal.  Full attention -> long_500k
skipped; decode shapes exercise self-KV + cross-KV caches.
"""
from .base import LayerSpec, ModelConfig, register


@register("whisper-small")
def make_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        d_model=768, vocab_size=51865,
        num_heads=12, num_kv_heads=12, head_dim=64,
        d_ff=3072, norm="layer", act="gelu", gated_mlp=False,
        unit=(LayerSpec(kind="attn", cross=True),), n_units=12,
        encoder_layers=12, default_encoder_len=1500,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", supports_long=False, train_microbatches=2)
