"""Checkpoints on PyTorch (the JAX package's ``checkpoint``): atomic
sharded saves, the reshard plan and elastic restore onto a mesh."""
