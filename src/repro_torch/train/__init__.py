"""Training on PyTorch (the JAX package's ``train``): optimizers,
schedules, the accumulating train step and the restartable trainer."""
