"""The language-model stack on PyTorch (the JAX package's ``models``):
every registered family -- dense, MoE, SSM, hybrid, encoder-decoder and
VLM."""
from .model import LM, build_model, param_count
