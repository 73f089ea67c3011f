"""The language-model stack of the dense family on PyTorch (the JAX
package's ``models``); MoE, SSM, cross-attention and encoders are not
ported yet (ROADMAP item 10)."""
from .model import LM, build_model, param_count
