"""stablelm-1.6b [dense]: 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b]."""
from .base import LayerSpec, ModelConfig, register


@register("stablelm-1.6b")
def make_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        d_model=2048, vocab_size=100352,
        num_heads=32, num_kv_heads=32, head_dim=64,
        d_ff=5632,
        unit=(LayerSpec(kind="attn"),), n_units=24,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", supports_long=False, train_microbatches=4)
