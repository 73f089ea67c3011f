"""Distributed-optimisation pieces on PyTorch (the JAX package's
``distributed``): gradient compression with error feedback, the 1F1B
pipeline schedule and the sharding rules."""
