"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import LayerSpec, ModelConfig, register


@register("mistral-large-123b")
def make_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        d_model=12288, vocab_size=32768,
        num_heads=96, num_kv_heads=8, head_dim=128,
        d_ff=28672,
        unit=(LayerSpec(kind="attn"),), n_units=88,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", supports_long=False, train_microbatches=4)
