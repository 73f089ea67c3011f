"""Launchers on PyTorch (the JAX package's ``launch``)."""
