"""mamba2-2.7b [ssm]: 64L d_model=2560 attn-free, ssm_state=128
[arXiv:2405.21060].  d_inner = 2*d_model, 64-dim SSD heads (80 heads),
no FFN sub-layer (pure mixer stack).  Runs long_500k (O(1)-state decode).
"""
from .base import LayerSpec, ModelConfig, SSMSpec, register


@register("mamba2-2.7b")
def make_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        d_model=2560, vocab_size=50280,
        unit=(LayerSpec(kind="ssm", mlp=False),), n_units=64,
        ssm=SSMSpec(num_heads=80, head_dim=64, state_dim=128, n_groups=1,
                    conv_width=4, chunk_len=256),
        tie_embeddings=True, use_rope=False,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", supports_long=True, train_microbatches=4)
