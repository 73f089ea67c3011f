"""Synthetic data generators and the toy tokenizer."""
