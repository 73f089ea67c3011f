"""The LM stack in the port against the JAX package.

The configs of both packages must be equal field by field.  The port's
layers run on the same seeded numpy inputs as the reference's, and its
models (reduced configs at ``B, S = 2, 32``, as ``test_archs_smoke.py``
runs them, in float32) take the reference's own ``LM.init`` weights
through ``convert.params_from_jax``: forward, loss, prefill and
teacher-forced decode (scalar and per-slot index) must match the
reference within 2e-4, the layers within 1e-6, and greedy tokens
exactly.  Gemma3 also runs at ``S = 160``, past its reduced window of 64,
so that the sliding window bites.  The other families are held in
``test_torch_lm_families.py`` and ``test_torch_lm_decode_families.py``.  The flash route runs the kernel's plain version here; the
reference's runs its Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro.serve import sampling as JS
from repro_torch.data.tokenizer import BOS, EOS, PAD, HashTokenizer
from repro_torch.models import build_model, param_count
from repro_torch.models import layers as TL
from repro_torch.models.attention import attention_init
from repro_torch.models.blocks import layer_init
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.serve import sampling as TS
from repro_torch.serve.steps import (make_decode_step, make_prefill_step,
                                     write_slots)

torch.set_num_threads(1)

B, S = 2, 32
TOL = dict(rtol=2e-4, atol=2e-4)
DENSE = ["smollm-360m", "stablelm-1.6b", "gemma3-4b"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


_PAIRS = {}


class _Jitted:
    """The reference ``LM`` with its entry points jitted (one compile per
    shape instead of op-by-op dispatch)."""

    def __init__(self, model):
        self.init_cache = model.init_cache
        for name in ("apply", "loss", "prefill", "decode_step"):
            setattr(self, name, jax.jit(getattr(model, name)))


def pair(arch, **overrides):
    """(JAX model, JAX params, port model on the CPU with those params)
    for ``arch``'s reduced config."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        jcfg = JC.get_config(arch).reduced().with_(**overrides)
        tcfg = TC.get_config(arch).reduced().with_(**overrides)
        model = jbuild(jcfg)
        jp = model.init(0)
        jm = _Jitted(model)
        tm = build_model(tcfg, "cpu")
        tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                              jp)))
        _PAIRS[key] = (jm, jp, tm)
    return _PAIRS[key]


def batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: _t(v) for k, v in b.items()}


# ------------------------------------------------------------- configs

def test_registries_equal():
    assert TC.list_archs() == JC.list_archs()
    assert TC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS
    assert TC.FULL_WINDOW == JC.FULL_WINDOW


@pytest.mark.parametrize("arch", JC.list_archs())
def test_config_fields_equal(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced()),
                   (j.probe(1), t.probe(1)),
                   (j.with_(use_flash=True), t.with_(use_flash=True))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.num_layers == jc.num_layers
        assert tc.windows() == jc.windows()


def test_graphar_paper_config_equal():
    """``configs/graphar_paper.py``: the paper's workload knobs, copied,
    equal field by field."""
    from repro.configs import graphar_paper as JG
    from repro_torch.configs import graphar_paper as TG
    assert [f.name for f in dataclasses.fields(TG.GraphArConfig)] == \
        [f.name for f in dataclasses.fields(JG.GraphArConfig)]
    assert dataclasses.asdict(TG.default_config()) == \
        dataclasses.asdict(JG.default_config())
    assert dataclasses.asdict(TG.GraphArConfig("x", page_size=99)) == \
        dataclasses.asdict(JG.GraphArConfig("x", page_size=99))
    assert TG.PAPER_WORKLOADS == JG.PAPER_WORKLOADS


# -------------------------------------------------------------- layers

@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    if kind == "rms":
        want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
        got = TL.rmsnorm(_t(x), _t(scale))
    else:
        want = JL.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jnp.asarray(x))
        got = TL.layernorm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    norm = TL.Norm(kind, 48)
    norm.init_()
    want = JL.apply_norm(kind, JL.norm_init(kind, 48), jnp.asarray(x))
    np.testing.assert_allclose(_np(norm(_t(x))), _np(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(_np(TL.rope_frequencies(32, theta)),
                               _np(JL.rope_frequencies(32, theta)),
                               rtol=1e-6, atol=0)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches(act, gated):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = {n: rng.standard_normal(shape).astype(np.float32) / 4
         for n, shape in (("up", (16, 24)), ("down", (24, 16)),
                          ("gate", (16, 24)))}
    if not gated:
        del w["gate"]
    want = JL.mlp({n: jnp.asarray(a) for n, a in w.items()},
                  jnp.asarray(x), act)
    got = TL.mlp(_t(x), _t(w["up"]), _t(w["down"]),
                 _t(w["gate"]) if gated else None, act)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.6).astype(np.float32) if masked else None
    want = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None
                                    else jnp.asarray(mask))
    got = TL.softmax_cross_entropy(_t(logits), _t(labels),
                                   None if mask is None else _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)


def test_inits_have_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = TL.linear_init(gen, 256, 512)
    e = TL.embed_init(gen, 512, 256, torch.bfloat16)
    assert w.shape == (256, 512) and e.dtype == torch.bfloat16
    assert abs(float(w.std()) - 1 / 16) < 2e-3 and abs(float(w.mean())) < 1e-3
    assert abs(float(e.float().std()) - 0.02) < 1e-3
    m = build_model(TC.get_config("gemma3-4b").reduced(), "cpu").init(0)
    assert torch.equal(m.lm_head, m.embed.t())            # tied
    assert torch.equal(m.layers[0].ln1.scale, torch.ones(128))
    assert torch.equal(m.layers[1].attn.q_norm.scale, torch.ones(32))
    again = build_model(TC.get_config("gemma3-4b").reduced(), "cpu").init(0)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                  again.state_dict().values()))
    untied = build_model(TC.get_config("stablelm-1.6b").reduced(),
                         "cpu").init(0)
    assert not torch.equal(untied.lm_head, untied.embed.t())
    cfg = TC.get_config("gemma3-4b").reduced()
    block = layer_init(gen, cfg, cfg.unit[0])
    attn = attention_init(gen, 128, 4, 2, 32, qk_norm=False)
    assert block.mlp.gate.shape == (128, 256) and attn.o.shape == (128, 128)
    assert abs(float(attn.q.std()) - 128 ** -0.5) < 0.01
    assert torch.equal(block.ln2.scale, torch.ones(128))


# -------------------------------------------------------------- models

@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match(arch):
    jm, jp, tm = pair(arch)
    b = batch(tm.cfg, 0)
    jl, jaux = jm.apply(jp, jbatch(b))
    tl, taux = tm(tbatch(b))
    assert tl.shape == (B, S, tm.cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert float(taux) == float(jaux) == 0.0
    (jloss, jm_), (tloss, tm_) = jm.loss(jp, jbatch(b)), tm.loss(tbatch(b))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(float(tm_["ce"]), float(jm_["ce"]), **TOL)
    assert float(tm_["tokens"]) == float(jm_["tokens"]) == B * S
    # explicit positions, as the reference takes them
    pos = np.broadcast_to(np.arange(3, 3 + S, dtype=np.int32), (B, S))
    jl, _ = jm.apply(jp, dict(jbatch(b), positions=jnp.asarray(pos)))
    tl, _ = tm(dict(tbatch(b), positions=_t(pos)))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_params_carry_across_in_bf16():
    cfg = JC.get_config("smollm-360m").reduced().with_(param_dtype="bfloat16")
    jp = jbuild(cfg).init(0)
    state = params_from_jax(TC.get_config("smollm-360m").reduced().with_(
        param_dtype="bfloat16"), jax.tree.map(np.asarray, jp))
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(state["embed"]), _np(jp["embed"]))
    np.testing.assert_array_equal(_np(state["layers.1.attn.q"]),
                                  _np(jp["units"]["l0"]["attn"]["q"][1]))
    assert to_tensor(np.asarray(jp["lm_head"])).shape == (128, 512)


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-4b"])
def test_flash_route_matches_reference_flash_route(arch):
    """The reference's ``use_flash=True`` route (its Pallas kernel in
    interpret mode) against the port's (the kernel's plain version on the
    CPU).  Both mask by sequence order alone: gemma3's local windows (cut
    here to 8 < S) are ignored by both flash routes, as the reference's
    ``attention_apply`` does, while the plain route applies them."""
    over = dict(use_flash=True)
    if arch == "gemma3-4b":
        over["window_pattern"] = (8, 0)
    jm, jp, tm = pair(arch, **over)
    b = batch(tm.cfg, 5)
    jl, _ = jm.apply(jp, jbatch(b))
    with torch.no_grad():           # the kernel has no backward
        tl, _ = tm(tbatch(b))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _, _, plain = pair(arch, **dict(over, use_flash=False))
    pl, _ = plain(tbatch(b))
    if arch == "gemma3-4b":
        assert np.abs(_np(pl) - _np(tl)).max() > 1e-2
    else:
        np.testing.assert_allclose(_np(pl), _np(tl), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_scalar_index(arch):
    jm, jp, tm = pair(arch)
    b = batch(tm.cfg, 2)
    split = S // 2
    jcache = jm.init_cache(B, max_len=S, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_len=S, dtype=torch.float32)
    assert tm.init_cache(B, 8)["layers"][0]["kv"]["k"].dtype == torch.bfloat16
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(
        b["tokens"][:, :split])}, jcache)
    tlog, tcache = make_prefill_step(tm)({"tokens": _t(
        b["tokens"][:, :split])}, tcache)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    step = make_decode_step(tm)
    for t in range(split, S):
        tok = b["tokens"][:, t:t + 1]
        jlog, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache)
        tlog, tcache = step(_t(tok), tcache)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL,
                                   err_msg=f"{arch} step {t}")
    assert int(tcache["index"]) == int(jcache["index"]) == S
    np.testing.assert_allclose(
        _np(tcache["layers"][1]["kv"]["k"]),
        _np(jcache["units"]["l0"]["kv"]["k"][1]), **TOL)


def test_default_bf16_cache_matches():
    """``init_cache``'s default type is bfloat16 even for a float32 model;
    the reference then computes the attention output in float32 (``jnp``
    promotion), and so does the port."""
    jm, jp, tm = pair("smollm-360m")
    b = batch(tm.cfg, 3)
    jcache, tcache = jm.init_cache(B, max_len=S), tm.init_cache(B, S)
    assert tcache["layers"][0]["kv"]["k"].dtype == torch.bfloat16
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(
        b["tokens"][:, :20])}, jcache)
    tlog, tcache = tm.prefill({"tokens": _t(b["tokens"][:, :20])}, tcache)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    for t in range(20, 24):
        tok = b["tokens"][:, t:t + 1]
        jlog, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache)
        tlog, tcache = tm.decode_step(_t(tok), tcache)
        assert tlog.dtype == torch.float32
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    np.testing.assert_array_equal(_np(tcache["layers"][0]["kv"]["k"]),
                                  _np(jcache["units"]["l0"]["kv"]["k"][0]))


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-4b"])
def test_prefill_and_decode_match_vector_index(arch):
    """Per-slot write positions: slots start at 0 and at 5 (so slot 1's
    last writes fall past ``max_len`` and are dropped) and advance
    independently."""
    jm, jp, tm = pair(arch)
    b = batch(tm.cfg, 6)
    max_len = S // 2 + 4
    jcache = jm.init_cache(B, max_len=max_len, dtype=jnp.float32,
                           vector_index=True)
    tcache = tm.init_cache(B, max_len=max_len, dtype=torch.float32,
                           vector_index=True)
    start = np.array([0, 5], np.int32)
    jcache["index"] = jnp.asarray(start)
    jcache["units"]["l0"]["kv"]["index"] = jnp.broadcast_to(
        jnp.asarray(start), (tm.cfg.n_units, B))
    tcache["index"] = _t(start)
    for layer in tcache["layers"]:
        layer["kv"]["index"] = _t(start)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(
        b["tokens"][:, :S // 2])}, jcache)
    tlog, tcache = tm.prefill({"tokens": _t(b["tokens"][:, :S // 2])}, tcache)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    for t in range(S // 2, S // 2 + 6):
        tok = b["tokens"][:, t:t + 1]
        jlog, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache)
        tlog, tcache = tm.decode_step(_t(tok), tcache)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL,
                                   err_msg=f"{arch} step {t}")
        np.testing.assert_allclose(_np(tcache["layers"][0]["kv"]["v"]),
                                   _np(jcache["units"]["l0"]["kv"]["v"][0]),
                                   **TOL)
    assert tcache["index"].tolist() == np.asarray(jcache["index"]).tolist()


def test_write_slots_then_vector_decode_matches_full_forward():
    """Prompts of different lengths, each prefilled on its own and
    written into one vector-index cache, decode together as the reference
    engine runs them: every step equals the reference's full forward over
    that slot's tokens."""
    jm, jp, tm = pair("smollm-360m")
    rng = np.random.default_rng(8)
    lens = (5, 12, 9)
    steps = 4
    seqs = [rng.integers(0, tm.cfg.vocab_size, n + steps).astype(np.int32)
            for n in lens]
    cache = tm.init_cache(len(lens), 24, dtype=torch.float32,
                          vector_index=True)
    first = []
    for slot, (n, seq) in enumerate(zip(lens, seqs)):
        logits, one = tm.prefill({"tokens": _t(seq[None, :n])},
                                 tm.init_cache(1, 24, dtype=torch.float32))
        write_slots(cache, one, [slot])
        first.append(logits[0, -1])
    assert cache["index"].tolist() == list(lens)
    got = [torch.stack(first)]
    for i in range(steps):
        tok = np.array([[seq[n + i]] for n, seq in zip(lens, seqs)], np.int32)
        logits, cache = tm.decode_step(_t(tok), cache)
        got.append(logits[:, -1])
    for slot, (n, seq) in enumerate(zip(lens, seqs)):
        full, _ = jm.apply(jp, {"tokens": jnp.asarray(seq[None])})
        want = _np(full)[0, n - 1:n + steps]
        have = np.stack([_np(g[slot]) for g in got])
        np.testing.assert_allclose(have, want, **TOL, err_msg=f"slot {slot}")
    with pytest.raises(ValueError, match="vector-index"):
        write_slots(tm.init_cache(1, 8), tm.init_cache(1, 8), [0])


def test_greedy_tokens_equal_over_8_steps():
    jm, jp, tm = pair("stablelm-1.6b")
    b = batch(tm.cfg, 7)
    jcache = jm.init_cache(B, max_len=S, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_len=S, dtype=torch.float32)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(b["tokens"][:, :20])},
                              jcache)
    tlog, tcache = tm.prefill({"tokens": _t(b["tokens"][:, :20])}, tcache)
    jtoks, ttoks = [], []
    for _ in range(8):
        jt = JS.sample(None, jlog[:, -1])[:, None].astype(jnp.int32)
        tt = TS.sample(tlog[:, -1])[:, None].to(torch.int32)
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
        jlog, jcache = jm.decode_step(jp, jt, jcache)
        tlog, tcache = tm.decode_step(tt, tcache)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))


LONG = 160      # past the reduced gemma3's window of 64


def test_sliding_window_bites_forward():
    """Gemma3 at ``S = 160``: the forward and the loss match the
    reference, and differ from the same weights with no window."""
    jm, jp, tm = pair("gemma3-4b")
    b = batch(tm.cfg, 11, LONG)
    jl, _ = jm.apply(jp, jbatch(b))
    tl, _ = tm(tbatch(b))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(float(tm.loss(tbatch(b))[0]),
                               float(jm.loss(jp, jbatch(b))[0]), **TOL)
    _, _, full = pair("gemma3-4b", window_pattern=(0, 0))
    assert np.abs(_np(full(tbatch(b))[0]) - _np(tl)).max() > 1e-3


@pytest.mark.parametrize("vector", [False, True])
def test_sliding_window_bites_prefill_and_decode(vector):
    """Gemma3 at ``S = 160``: a prefill of 140 tokens and 20 decode steps
    (every query more than 64 positions past the first keys) match the
    reference and its full forward at every step."""
    jm, jp, tm = pair("gemma3-4b")
    b = batch(tm.cfg, 12, LONG)
    split = LONG - 20
    jcache = jm.init_cache(B, max_len=LONG, dtype=jnp.float32,
                           vector_index=vector)
    tcache = tm.init_cache(B, max_len=LONG, dtype=torch.float32,
                           vector_index=vector)
    full = _np(jm.apply(jp, jbatch(b))[0])
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(
        b["tokens"][:, :split])}, jcache)
    tlog, tcache = tm.prefill({"tokens": _t(b["tokens"][:, :split])}, tcache)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    np.testing.assert_allclose(_np(tlog)[:, 0], full[:, split - 1], **TOL)
    for t in range(split, LONG):
        tok = b["tokens"][:, t:t + 1]
        jlog, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache)
        tlog, tcache = tm.decode_step(_t(tok), tcache)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(tlog)[:, 0], full[:, t], **TOL,
                                   err_msg=f"step {t} vs forward")


# ------------------------------------------------------------ sampling

@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (4, 1.0), (0, 0.7),
                                         (6, 0.8)])
def test_sampling_masks_match_reference_draws(top_k, top_p):
    """``jax.random`` and ``torch.Generator`` draw different streams, so
    the masks are held, not the draws: every one of many reference draws
    lies in the port's unmasked set and covers the tokens it gives over
    2% probability, and so do the port's draws."""
    rng = np.random.default_rng(10)
    logits = (rng.standard_normal((2, 12)) * 1.5).astype(np.float32)
    kept = TS.filter_logits(_t(logits), 0.8, top_k, top_p)
    allowed = torch.isfinite(kept).numpy()
    likely = (torch.softmax(kept, -1) > 0.02).numpy()   # ~8 of 400 draws
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    jdraws = np.stack([np.asarray(JS.sample(k, jnp.asarray(logits), 0.8,
                                            top_k, top_p)) for k in keys])
    gen = torch.Generator().manual_seed(0)
    tdraws = np.stack([TS.sample(_t(logits), 0.8, top_k, top_p,
                                 generator=gen).numpy() for _ in range(400)])
    for row in range(2):
        want = set(np.flatnonzero(allowed[row]).tolist())
        must = set(np.flatnonzero(likely[row]).tolist())
        for draws in (jdraws[:, row], tdraws[:, row]):
            assert must <= set(draws.tolist()) <= want
    if top_k:
        assert allowed.sum(axis=1).max() <= top_k
    np.testing.assert_array_equal(TS.sample(_t(logits)).numpy(),
                                  np.asarray(JS.sample(None,
                                                       jnp.asarray(logits))))


def test_tokenizer_matches():
    texts = ["graph data in data lakes", "", "ünïcode wörds 123"]
    for vocab in (4096, 49152):
        t, j = HashTokenizer(vocab), JTokenizer(vocab)
        for a, b in zip(t.encode_batch(texts), j.encode_batch(texts)):
            np.testing.assert_array_equal(a, b)
    assert (BOS, EOS, PAD) == (1, 2, 0)


# ------------------------------------------------------ sizes and errors

def _analytic(cfg):
    """``test_archs_smoke.py``'s analytic count for dense configs (embed +
    head + per-layer matmuls)."""
    d = cfg.d_model
    per_layer = d * cfg.head_dim * (cfg.num_heads * 2 + cfg.num_kv_heads * 2) \
        + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    return cfg.vocab_size * d * 2 + cfg.num_layers * per_layer


@pytest.mark.parametrize("arch", JC.list_archs())
def test_param_count_of_full_configs(arch):
    """Every registered architecture at full size on the ``meta`` device
    (no memory): the reference's ``eval_shape`` count, and for the plain
    dense ones the analytic count."""
    cfg = TC.get_config(arch)
    model = build_model(cfg, "meta")
    n = param_count(model)
    shapes = jax.eval_shape(jbuild(JC.get_config(arch)).init, 0)
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    if arch in ("smollm-360m", "stablelm-1.6b"):
        norms = (2 * cfg.num_layers + 1) * cfg.d_model  # ln1, ln2, final
        assert n == _analytic(cfg) + norms
    assert model.embed.dtype == torch.bfloat16


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_model(cfg, "cuda")


def test_flash_route_refuses_autograd(monkeypatch):
    """The kernel has no backward (nor has the reference's Pallas kernel):
    with gradients on, a ``use_flash=True`` loss raises instead of
    training everything but attention; under ``torch.no_grad()`` the
    forward still takes the kernel route (its plain version on the CPU)
    and gives the plain route's logits."""
    from repro_torch.kernels.flash_attention import kernel as K
    _, _, tm = pair("smollm-360m", use_flash=True)
    _, _, plain = pair("smollm-360m")
    b = tbatch(batch(tm.cfg, 6))
    with pytest.raises(RuntimeError, match="no backward kernel"):
        tm.loss(b)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        tm(b)
    calls = []
    real = K.flash_attention_into

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(K, "flash_attention_into", counted)
    with torch.no_grad():
        tl, _ = tm(b)
    assert len(calls) == tm.cfg.num_layers
    np.testing.assert_allclose(_np(tl), _np(plain(b)[0]), **TOL)
    # the plain route trains: its loss has a gradient for every parameter
    loss, _ = plain.loss(b)
    grads = torch.autograd.grad(loss, list(plain.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
