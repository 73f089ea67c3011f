"""Fault-tolerance primitives: backoff, retry, liveness, strikes, and the
deterministic fault-injection harness."""
