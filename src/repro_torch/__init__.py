"""repro_torch: the GraphAr storage scheme and its batched, label-filtered
neighbor retrieval on PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper.  The JAX package ``repro`` is its reference; see README.md."""
__version__ = "0.1.0"
