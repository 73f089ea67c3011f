"""Per-slot (continuous-batching) prefill and decode for the gloo worlds:
the cases the workers run (``tests/_torch_dist_worker.py:run_slots``) and
the reference's side of them.

Two prefill groups of different prompt lengths are written into a 4-slot
vector-index cache, slot 1 left empty (its index stays 0 and it decodes
token 0, as an idle slot of the engine does), then ``decode`` steps of
every slot at its own position.  The reference prefills each group into a
fresh scalar-index cache of its width and writes it with its engine's own
``_write_slots``; the worker does the same with ``serve.steps.write_slots``
on the mesh."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np

from repro.serve.engine import ServeEngine as JEngine

#: (slots, prompt length) of each prefill group, in admission order: a
#: group as wide as the data axes and one that is narrower (its cache's
#: batch then stays whole and its length takes every axis)
GROUPS = (((2, 0), 10), ((3,), 6))


def slot_case(decode: int, max_len: int, groups=GROUPS) -> dict:
    return {"groups": groups, "decode": decode, "max_len": max_len}


def reference_slots(jm, jp, tokens: np.ndarray, case: dict) -> dict:
    """The reference's per-group prefill logits, each decode step's
    logits and the greedy tokens [B, 1 + decode] (the first column the
    prefills' picks, 0 on the empty slot)."""
    b = tokens.shape[0]
    write = jax.jit(functools.partial(
        JEngine._write_slots, types.SimpleNamespace(max_slots=b)))
    cache = jm.init_cache(b, case["max_len"], dtype=jnp.float32,
                          vector_index=True)
    prefill = jax.jit(jm.prefill)
    first = np.zeros((b, 1), np.int32)
    pre = []
    for slots, n in case["groups"]:
        tmpl = jm.init_cache(len(slots), case["max_len"], dtype=jnp.float32)
        lg, tmp = prefill(jp, {"tokens": jnp.asarray(tokens[list(slots),
                                                            :n])}, tmpl)
        cache = write(cache, tmp, jnp.asarray(slots, jnp.int32))
        pre.append(np.asarray(lg))
        first[list(slots), 0] = np.asarray(jnp.argmax(lg[:, -1], -1))
    decode = jax.jit(jm.decode_step)
    tok, toks, steps = jnp.asarray(first), [first], []
    for _ in range(case["decode"]):
        lg, cache = decode(jp, tok, cache)
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    return {"prefill": pre, "decode": steps,
            "greedy": np.concatenate(toks, 1)}
