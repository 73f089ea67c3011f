"""The MoE FFN and the Mamba-2 SSD mixer of the port against the JAX
package's, on the same seeded numpy weights and inputs, in float32.

MoE: ``moe_apply`` with capacity drops, shared experts, the balance loss,
decode shapes (T = 4, capacity 1), a capacity of exactly x.5 (Python's
``round`` is half to even) and router logits with exact ties (the
reference's ``lax.top_k`` takes the lower expert first); and the plain
per-expert loop ``moe_ref`` against ``moe_apply``, keep masks equal.  SSM:
``_causal_conv`` with and without a state, ``_segsum``, ``ssd_chunked``
against the reference's ``ssd_chunked`` and ``ssd_reference`` at lengths
of one chunk, several chunks and several chunks with padding, with 1 and
2 groups; ``ssm_apply`` prefill and decode through a cache.  Layers match
within 1e-6; what runs through the SSD scan within 1e-6 of the largest
|value| (its einsums contract in other orders: the reference's own
chunked and sequential paths differ by up to 5e-7 of it here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def close_scan(got, want, err_msg=""):
    """Within 1e-6 of the largest |want| (see the module docstring)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(want).max())),
        err_msg=err_msg)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _module(cls, params, *args):
    """A port module of ``cls(*args)`` holding the numpy ``params``."""
    m = cls(*args)
    m.load_state_dict({k: _t(v) for k, v in params.items()}, strict=True)
    return m


# ---------------------------------------------------------------- MoE

D, DE = 16, 24


def moe_params(rng, e, shared):
    p = {"router": rng.standard_normal((D, e)).astype(np.float32) * 0.5,
         "w_gate": rng.standard_normal((e, D, DE)).astype(np.float32) / 4,
         "w_up": rng.standard_normal((e, D, DE)).astype(np.float32) / 4,
         "w_down": rng.standard_normal((e, DE, D)).astype(np.float32) / 5}
    if shared:
        p["shared"] = {
            "up": rng.standard_normal((D, 32)).astype(np.float32) / 4,
            "gate": rng.standard_normal((D, 32)).astype(np.float32) / 4,
            "down": rng.standard_normal((32, D)).astype(np.float32) / 6}
    return p


def _flat(p):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def moe_pair(seed, e, shared):
    rng = np.random.default_rng(seed)
    p = moe_params(rng, e, shared)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in p.items()}
    tm = _module(TM.MoE, _flat(p), D, DE, e, 2 if shared else 0, 32)
    return p, jp, tm


# (batch, seq, experts, top_k, capacity factor, shared): drops at 0.5, a
# capacity of exactly 2.5 (half to even: 2), the decode shapes T = 4 with
# capacity 1, and deepseek's routing shape at decode (64 experts, top 6:
# round(4 * 6 / 64 * 1.25) = 0 -> 1)
MOE_CASES = [(2, 16, 8, 2, 1.25, True), (2, 16, 8, 2, 0.5, False),
             (8, 1, 8, 2, 1.25, True), (4, 1, 8, 2, 1.25, False),
             (4, 1, 64, 6, 1.25, True), (1, 40, 16, 4, 1.0, True)]


@pytest.mark.parametrize("b,s,e,k,factor,shared", MOE_CASES)
def test_moe_apply_matches(b, s, e, k, factor, shared):
    p, jp, tm = moe_pair(b * 100 + s + e, e, shared)
    x = np.random.default_rng(s).standard_normal((b, s, D)).astype(
        np.float32)
    want, jaux = JM.moe_apply(jp, jnp.asarray(x), num_experts=e, top_k=k,
                              capacity_factor=factor)
    got, taux = TM.moe_apply(tm, _t(x), num_experts=e, top_k=k,
                             capacity_factor=factor)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    cap = TM.capacity_of(b * s, e, k, factor)
    assert cap == int(max(1, round(b * s * k / e * factor)))
    r = TM.route(tm, _t(x).reshape(b * s, D), num_experts=e, top_k=k,
                 capacity_factor=factor)
    if factor == 0.5 or s == 1:
        assert not bool(r["keep"].all())        # some assignments dropped
    ref, raux, keep = TM.moe_ref(tm, _t(x), num_experts=e, top_k=k,
                                 capacity_factor=factor)
    assert torch.equal(keep, r["keep"])
    np.testing.assert_allclose(_np(ref), _np(got), **TOL)
    assert float(raux) == float(taux)


def test_capacity_rounds_half_to_even():
    assert TM.capacity_of(8, 8, 2, 1.25) == 2          # 2.5 -> 2
    assert TM.capacity_of(24, 8, 2, 1.25) == 8         # 7.5 -> 8
    assert TM.capacity_of(4, 64, 6, 1.25) == 1         # 0.47 -> 0 -> 1


def test_moe_tied_router_logits_take_the_lower_expert():
    """Experts 1, 2, 3, 5 and 6 have zero router columns and every other
    column scores below zero, so for every token those five tie exactly
    at the top; the port picks the lower indices first, as ``lax.top_k``
    does, and drops the same assignments."""
    p, jp, tm = moe_pair(7, 8, False)
    router = -np.abs(p["router"])
    router[:, [1, 2, 3, 5, 6]] = 0.0
    p["router"] = router
    jp["router"] = jnp.asarray(router)
    tm.router.data.copy_(_t(router))
    x = np.abs(np.random.default_rng(8).standard_normal((3, 12, D))).astype(
        np.float32)
    for k, factor in ((2, 1.25), (3, 0.6)):
        want, jaux = JM.moe_apply(jp, jnp.asarray(x), num_experts=8, top_k=k,
                                  capacity_factor=factor)
        got, taux = TM.moe_apply(tm, _t(x), num_experts=8, top_k=k,
                                 capacity_factor=factor)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
        r = TM.route(tm, _t(x).reshape(-1, D), num_experts=8, top_k=k,
                     capacity_factor=factor)
        assert bool((r["probs"][:, [1, 2, 3, 5, 6]]
                     == r["probs"][:, 1:2]).all())
        assert r["experts"].tolist() == [[1, 2, 3][:k]] * 36
        if factor < 1:
            assert not bool(r["keep"].all())


def test_moe_init_distributions():
    gen = torch.Generator().manual_seed(0)
    m = TM.moe_init(gen, 256, 128, 8, num_shared=2, d_shared=64)
    assert m.w_gate.shape == (8, 256, 128) and m.w_down.shape == (8, 128, 256)
    assert abs(float(m.router.std()) - 0.02) < 1e-3
    assert abs(float(m.w_up.std()) - 256 ** -0.5) < 2e-3
    assert abs(float(m.w_down.std()) - 128 ** -0.5) < 2e-3
    assert m.shared.gate.shape == (256, 64)


# ---------------------------------------------------------------- SSM

def _jt(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32) / 4
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    jy, js = JS._causal_conv(_jt(x), _jt(w), _jt(b),
                             None if st is None else _jt(st))
    ty, ts = TS._causal_conv(_t(x), _t(w), _t(b),
                             None if st is None else _t(st))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_array_equal(_np(ts), _np(js))


def test_segsum_matches():
    a = -np.abs(np.random.default_rng(12).standard_normal((2, 3, 7))).astype(
        np.float32)
    want, got = _np(JS._segsum(_jt(a))), _np(TS._segsum(_t(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all()
    assert not np.isinf(got[..., 1, 0]).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    np.testing.assert_array_equal(np.exp(got)[~fin], 0.0)


def ssd_inputs(seed, l, h=4, p=8, g=1, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, l, h)))).astype(
        np.float32) * 0.5
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((2, l, g, n)).astype(np.float32)
    C = rng.standard_normal((2, l, g, n)).astype(np.float32)
    D_ = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D_


def _pad(arrays, pad):
    """Zero-pad the sequence axis (1) as ``ssm_apply`` pads it."""
    return [a if a.ndim == 1 else
            np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
            for a in arrays]


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("l", [32, 96, 100])
def test_ssd_chunked_matches_both_references(l, g):
    """One chunk (32), three (96), and four with padding (100): the
    inter-chunk loop and the padding run."""
    q = 32
    arrays = ssd_inputs(l + g, l, g=g)
    pad = (-l) % q
    padded = _pad(arrays, pad)
    jy, js = JS.ssd_chunked(*[_jt(a) for a in padded], q)
    ty, ts = TS.ssd_chunked(*[_t(a) for a in padded], q)
    close_scan(_np(ty), _np(jy))
    close_scan(_np(ts), _np(js))
    ry, rs = JS.ssd_reference(*[_jt(a) for a in arrays])
    close_scan(_np(ty)[:, :l], _np(ry))
    close_scan(_np(ts), _np(rs))
    oy, os_ = TS.ssd_reference(*[_t(a) for a in arrays])
    close_scan(_np(oy), _np(ry))
    close_scan(_np(os_), _np(rs))
    if pad:
        with pytest.raises(ValueError, match="multiple"):
            TS.ssd_chunked(*[_t(a) for a in arrays], q)


def test_ssd_groups_repeat_interleave():
    """With 2 groups over 4 heads, heads 0-1 read group 0 and heads 2-3
    group 1 (``jnp.repeat``), not 0, 1, 0, 1 (``Tensor.repeat``)."""
    x, dt, A, B, C, D_ = ssd_inputs(3, 32, g=2)
    y, _ = TS.ssd_chunked(*[_t(a) for a in (x, dt, A, B, C, D_)], 32)
    only0 = B.copy()
    only0[:, :, 1] = 0
    y0, _ = TS.ssd_chunked(*[_t(a) for a in (x, dt, A, only0, C, D_)], 32)
    skip = _np(_t(x) * _t(D_)[None, None, :, None])
    np.testing.assert_allclose(_np(y0)[:, :, :2], _np(y)[:, :, :2], **TOL)
    np.testing.assert_allclose(_np(y0)[:, :, 2:], skip[:, :, 2:], **TOL)


H, P, N, G, W, DM = 4, 8, 6, 2, 4, 24


def ssm_params(seed):
    rng = np.random.default_rng(seed)
    d_inner = H * P
    conv_dim = d_inner + 2 * G * N
    return {
        "in_proj": rng.standard_normal((DM, 2 * d_inner + 2 * G * N + H))
        .astype(np.float32) / 5,
        "conv_w": rng.standard_normal((W, conv_dim)).astype(np.float32) / 4,
        "conv_b": rng.standard_normal(conv_dim).astype(np.float32) / 10,
        "A_log": np.log(np.linspace(1, 16, H)).astype(np.float32),
        "D": rng.standard_normal(H).astype(np.float32),
        "dt_bias": rng.standard_normal(H).astype(np.float32) / 4,
        "norm_scale": 1 + rng.standard_normal(d_inner).astype(np.float32) / 4,
        "out_proj": rng.standard_normal((d_inner, DM)).astype(np.float32) / 5,
    }


def _ssm_kw(chunk):
    return dict(num_heads=H, head_dim=P, state_dim=N, n_groups=G,
                chunk_len=chunk)


@pytest.mark.parametrize("prompt", [1, 16, 40])
def test_ssm_apply_prefill_and_decode_with_a_cache(prompt):
    """A prefill from a non-zero conv tail (and a state it ignores, as the
    reference does), then 3 decode steps; outputs, conv tails and states
    equal the reference's at every call.  A one-token prompt takes the
    decode branch (it reads the state)."""
    p = ssm_params(prompt)
    jp = {k: _jt(v) for k, v in p.items()}
    tm = _module(TS.SSM, p, DM, H, P, N, G, W)
    rng = np.random.default_rng(prompt + 1)
    conv = rng.standard_normal((2, W - 1, H * P + 2 * G * N)).astype(
        np.float32)
    state = rng.standard_normal((2, H, P, N)).astype(np.float32)
    jc = {"conv": _jt(conv), "state": _jt(state)}
    tc = TS.init_ssm_cache(2, H, P, N, G, W, torch.float32)
    tc["conv"].copy_(_t(conv))
    tc["state"].copy_(_t(state))
    conv_t, state_t = tc["conv"], tc["state"]
    for step, length in enumerate((prompt, 1, 1, 1)):
        x = rng.standard_normal((2, length, DM)).astype(np.float32)
        jy, jc = JS.ssm_apply(jp, _jt(x), cache=jc, **_ssm_kw(16))
        ty, tc = TS.ssm_apply(tm, _t(x), cache=tc, **_ssm_kw(16))
        close_scan(_np(ty), _np(jy), err_msg=f"call {step}")
        np.testing.assert_allclose(_np(tc["conv"]), _np(jc["conv"]), **TOL)
        close_scan(_np(tc["state"]), _np(jc["state"]))
    assert tc["conv"] is conv_t and tc["state"] is state_t   # in place


@pytest.mark.parametrize("l", [32, 100])
def test_ssm_apply_without_a_cache(l):
    p = ssm_params(l)
    tm = _module(TS.SSM, p, DM, H, P, N, G, W)
    x = np.random.default_rng(l).standard_normal((2, l, DM)).astype(
        np.float32)
    jy, jc = JS.ssm_apply({k: _jt(v) for k, v in p.items()}, _jt(x),
                          **_ssm_kw(32))
    ty, tc = TS.ssm_apply(tm, _t(x), **_ssm_kw(32))
    assert jc is None and tc is None
    close_scan(_np(ty), _np(jy))


def test_ssm_init_matches_the_reference_layout():
    import jax
    want = JS.ssm_init(jax.random.PRNGKey(0), DM, H, P, N, G, W)
    got = TS.ssm_init(torch.Generator().manual_seed(0), DM, H, P, N, G, W)
    shapes = {k: tuple(v.shape) for k, v in got.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in want.items()}
    for name in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(want[name]), **TOL)
    cache = TS.init_ssm_cache(3, H, P, N, G, W)
    jcache = JS.init_ssm_cache(3, H, P, N, G, W)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["state"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == jcache["conv"].shape
    assert tuple(cache["state"].shape) == jcache["state"].shape
