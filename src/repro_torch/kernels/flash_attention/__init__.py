"""Flash attention: a hand-written CUDA kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version (``ref.py``)."""
