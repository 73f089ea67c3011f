"""Checkpoints on PyTorch (the JAX package's ``checkpoint``): atomic
sharded saves and the reshard plan."""
