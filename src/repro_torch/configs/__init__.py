"""Architecture registry: ``get_config("<arch-id>")`` / ``list_archs()``.

The configurations are data, copied from the JAX package's ``configs``
(not imported), so both packages build the same architectures, and the
port builds every one of them (``repro_torch.models``): the dense, MoE,
SSM, hybrid, encoder-decoder and VLM families.  ``graphar_paper`` holds
the paper's own workload knobs, outside the registry."""
from .base import (FULL_WINDOW, LayerSpec, ModelConfig, MoESpec, SSMSpec,
                   get_config, list_archs, register)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (deepseek_moe_16b, gemma3_4b, jamba_1_5_large_398b,  # noqa
                   llama32_vision_11b, mamba2_2_7b, mistral_large_123b,
                   qwen3_moe_30b_a3b, smollm_360m, stablelm_1_6b,
                   whisper_small)


ASSIGNED_ARCHS = (
    "jamba-1.5-large-398b", "gemma3-4b", "smollm-360m", "stablelm-1.6b",
    "mistral-large-123b", "whisper-small", "llama-3.2-vision-11b",
    "qwen3-moe-30b-a3b", "deepseek-moe-16b", "mamba2-2.7b",
)
