"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-architecture small model [hf:HuggingFaceTB/SmolLM-360M].
Pure full attention -> long_500k skipped (DESIGN.md §Arch-applicability).
"""
from .base import LayerSpec, ModelConfig, register


@register("smollm-360m")
def make_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        d_model=960, vocab_size=49152,
        num_heads=15, num_kv_heads=5, head_dim=64,
        d_ff=2560,
        unit=(LayerSpec(kind="attn"),), n_units=32,
        tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", supports_long=False, train_microbatches=4)
