"""Serving steps and token sampling (the JAX package's ``serve/steps.py``
and ``serve/sampling.py``); the engine, retrieval, tenancy and overload
planes are ROADMAP item 11."""
