"""Shared pieces of the LM family parity suites: reduced configs of the
MoE, SSM, hybrid, encoder-decoder and VLM families in both packages, the
port's carrying the reference's ``init(0)`` weights through
``params_from_jax`` with every ``x_gate`` at 0.5 (at its initial 0,
tanh(0) = 0 and the cross sub-layer, and with it whisper's whole encoder,
adds nothing to the logits, so a broken cross route would pass), and
seeded batches with their frames or vision embeddings."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import build_model as jbuild
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

B, S = 2, 32
TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "whisper-small", "llama-3.2-vision-11b"]
NOT_MOE = ["mamba2-2.7b", "whisper-small", "llama-3.2-vision-11b"]
X_GATE = 0.5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def open_gates(tree):
    """Every ``x_gate`` leaf set to ``X_GATE``."""
    def gate(path, leaf):
        return jnp.full_like(leaf, X_GATE) \
            if any(getattr(k, "key", None) == "x_gate" for k in path) \
            else leaf
    return jax.tree_util.tree_map_with_path(gate, tree)


class _Jitted:
    def __init__(self, model):
        self.init_cache = model.init_cache
        for name in ("apply", "loss", "prefill", "decode_step"):
            setattr(self, name, jax.jit(getattr(model, name)))


_MODELS = {}


def models(arch, **overrides):
    """(the JAX ``LM``, its params, the port's CPU model with them) for
    ``arch``'s reduced config, built once."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        jcfg = JC.get_config(arch).reduced().with_(**overrides)
        tcfg = TC.get_config(arch).reduced().with_(**overrides)
        model = jbuild(jcfg)
        jp = open_gates(model.init(0))
        tm = build_model(tcfg, "cpu")
        tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                              jp)))
        _MODELS[key] = (model, jp, tm, _Jitted(model))
    return _MODELS[key][:3]


def pair(arch, **overrides):
    """(the jitted JAX model, its params, the port's CPU model)."""
    _, jp, tm = models(arch, **overrides)
    return _MODELS[(arch, tuple(sorted(overrides.items())))][3], jp, tm


def ctx_len(cfg):
    return cfg.default_encoder_len if cfg.encoder_layers \
        else cfg.num_vision_tokens


def batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (B, cfg.default_encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.num_vision_tokens:
        out["vision"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b):
    return {k: _t(v) for k, v in b.items()}


def _context(b):
    return {k: v for k, v in b.items() if k in ("frames", "vision")}
