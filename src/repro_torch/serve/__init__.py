"""Serving: the continuous-batching engine (``engine.py``), its batched
lake retriever (``retrieval.py``), multi-tenant admission
(``tenancy.py``), overload degradation (``overload.py``), the prefill and
decode steps with the slot write (``steps.py``) and token sampling
(``sampling.py``) -- the JAX package's ``serve/`` on the port."""
