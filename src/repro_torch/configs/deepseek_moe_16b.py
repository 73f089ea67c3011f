"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) fine-grained
MoE: 64 routed experts top-6 (d_expert=1408) + 2 shared experts, dense
first layer (d_ff=10944) [arXiv:2401.06066].

Layer program: prefix = 1 dense-FFN attention layer (unrolled), then a
27-unit scan of attention+MoE layers.
"""
from .base import LayerSpec, ModelConfig, MoESpec, register


@register("deepseek-moe-16b")
def make_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        d_model=2048, vocab_size=102400,
        num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=1408, prefix_d_ff=10944,
        prefix=(LayerSpec(kind="attn", moe=False),),
        unit=(LayerSpec(kind="attn", moe=True),), n_units=27,
        moe=MoESpec(num_experts=64, top_k=6, d_expert=1408,
                    num_shared=2, d_shared=2816),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", supports_long=False, train_microbatches=4)
