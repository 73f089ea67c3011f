"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (1024-token sliding windows, every 6th layer
global), qk-norm, tied + scaled embeddings [hf:google/gemma-3-4b-pt].
The per-layer window pattern is carried as a traced array so the 34-layer
stack scans homogeneously.  Runs long_500k: decode is O(L) and 29/34 layers
are O(window) -- see DESIGN.md §Arch-applicability.
"""
from .base import LayerSpec, ModelConfig, register

LOCAL_WINDOW = 1024


@register("gemma3-4b")
def make_config() -> ModelConfig:
    n_layers = 34
    # pattern: L L L L L G repeated (global at indices 5, 11, 17, 23, 29)
    windows = tuple(0 if (i % 6) == 5 else LOCAL_WINDOW
                    for i in range(n_layers))
    return ModelConfig(
        name="gemma3-4b", family="dense",
        d_model=2560, vocab_size=262144,
        num_heads=8, num_kv_heads=4, head_dim=256,
        d_ff=10240, act="gelu",
        qk_norm=True, tie_embeddings=True, scale_embeddings=True,
        unit=(LayerSpec(kind="attn"),), n_units=n_layers,
        window_pattern=windows,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", supports_long=True, train_microbatches=4)
