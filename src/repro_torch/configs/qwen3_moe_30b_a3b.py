"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4, head_dim 128)
128 experts top-8, d_expert=768, vocab=151936 [hf:Qwen/Qwen3-30B-A3B]."""
from .base import LayerSpec, ModelConfig, MoESpec, register


@register("qwen3-moe-30b-a3b")
def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        d_model=2048, vocab_size=151936,
        num_heads=32, num_kv_heads=4, head_dim=128,
        d_ff=768,
        qk_norm=True,
        unit=(LayerSpec(kind="attn", moe=True),), n_units=48,
        moe=MoESpec(num_experts=128, top_k=8, d_expert=768),
        rope_theta=1_000_000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", supports_long=False, train_microbatches=4)
