"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attn 7:1 [arXiv:2403.19887].

Layer program: repeating 8-layer unit -- attention at position 4, Mamba
elsewhere; MoE FFN on odd positions, dense FFN on even (MoE every 2nd
layer).  72 = 9 units x 8.  Runs long_500k (hybrid: only 9/72 layers
keep a KV cache).
"""
from .base import LayerSpec, ModelConfig, MoESpec, SSMSpec, register


@register("jamba-1.5-large-398b")
def make_config() -> ModelConfig:
    unit = tuple(
        LayerSpec(kind=("attn" if j == 4 else "ssm"), moe=(j % 2 == 1))
        for j in range(8))
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        d_model=8192, vocab_size=65536,
        num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=24576,
        unit=unit, n_units=9,
        moe=MoESpec(num_experts=16, top_k=2, d_expert=24576),
        ssm=SSMSpec(num_heads=256, head_dim=64, state_dim=64, n_groups=8,
                    conv_width=4, chunk_len=256),
        use_rope=False,  # jamba uses no positional encoding in attn layers
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", supports_long=True, train_microbatches=4)
