"""The MoE, SSM, hybrid, encoder-decoder and VLM families of the port
against the JAX package's ``LM``: prefill and decode.

Reduced configs in float32 with the reference's weights and every
``x_gate`` at 0.5 (``tests/_torch_families.py``).  Prefill and
teacher-forced decode (scalar and per-slot index) must match the
reference within 2e-4 at every step, and, except for MoE (capacity
depends on the batch shape, so the reference leaves it out too), the
reference's full forward; greedy tokens exactly.  The SSM conv tails and
states and the cross keys the caches end with equal the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (B, FAMILIES, NOT_MOE, S, TOL, _np, _t, batch,
                             ctx_len, jb, pair, tb)


# ------------------------------------------------------- prefill, decode

def _caches(jm, tm, vector):
    cfg = tm.cfg
    kw = dict(ctx_len=ctx_len(cfg), vector_index=vector)
    return (jm.init_cache(B, max_len=S + 8, dtype=jnp.float32, **kw),
            tm.init_cache(B, max_len=S + 8, dtype=torch.float32, **kw))


def _prefill_decode(arch, vector, seed):
    """Prefill half of a batch, then teacher-forced decode of the rest on
    both packages; every step held against the reference (and, except
    for MoE, the reference's full forward).  Returns the port's cache."""
    jm, jp, tm = pair(arch)
    b = batch(tm.cfg, seed)
    split = S // 2
    jcache, tcache = _caches(jm, tm, vector)
    first = dict(b, tokens=b["tokens"][:, :split])
    jlog, jcache = jm.prefill(jp, jb(first), jcache)
    tlog, tcache = tm.prefill(tb(first), tcache)
    full = _np(jm.apply(jp, jb(b))[0]) if arch in NOT_MOE else None
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    if full is not None:
        np.testing.assert_allclose(_np(tlog)[:, 0], full[:, split - 1],
                                   **TOL)
    for t in range(split, S):
        tok = b["tokens"][:, t:t + 1]
        jlog, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache)
        tlog, tcache = tm.decode_step(_t(tok), tcache)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL,
                                   err_msg=f"{arch} step {t}")
        if full is not None:
            np.testing.assert_allclose(_np(tlog)[:, 0], full[:, t], **TOL,
                                       err_msg=f"{arch} step {t} vs forward")
    assert np.asarray(tcache["index"]).tolist() == \
        np.asarray(jcache["index"]).tolist()
    return tcache, jcache


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_scalar_index(arch):
    tcache, jcache = _prefill_decode(arch, False, 2)
    assert int(tcache["index"]) == S
    cfg = pair(arch)[2].cfg
    for i, spec in enumerate(cfg.unit):
        layer = tcache["layers"][i]
        jl = jcache["units"][f"l{i}"]
        if spec.kind == "ssm":
            np.testing.assert_allclose(_np(layer["ssm"]["conv"]),
                                       _np(jl["ssm"]["conv"][0]), **TOL)
            np.testing.assert_allclose(_np(layer["ssm"]["state"]),
                                       _np(jl["ssm"]["state"][0]), **TOL)
        if spec.cross:
            assert layer["cross"]["k"].shape[1] == ctx_len(cfg)
            np.testing.assert_allclose(_np(layer["cross"]["k"]),
                                       _np(jl["cross"]["k"][0]), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_vector_index(arch):
    tcache, _ = _prefill_decode(arch, True, 4)
    assert tcache["index"].tolist() == [S] * B


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_tokens_equal(arch):
    """``test_arch_prefill_decode_shapes``'s row: prefill the whole batch
    into a cache of S + 8, then 3 greedy steps; tokens equal."""
    jm, jp, tm = pair(arch)
    b = batch(tm.cfg, 1)
    jcache, tcache = _caches(jm, tm, False)
    jlog, jcache = jm.prefill(jp, jb(b), jcache)
    tlog, tcache = tm.prefill(tb(b), tcache)
    for _ in range(3):
        jt = jnp.argmax(jlog[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tlog[:, -1], dim=-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jlog, jcache = jm.decode_step(jp, jt, jcache)
        tlog, tcache = tm.decode_step(tt, tcache)
        assert tlog.shape == (B, 1, tm.cfg.vocab_size)
        assert bool(torch.isfinite(tlog).all())
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    assert int(tcache["index"]) == int(jcache["index"]) == S + 3
