"""The port's train step against the JAX package's.

Reduced smollm with ``n_units=2`` in float32, the port's model carrying
the reference's ``init(0)`` weights (``params_from_jax``): one step of
``make_train_step`` on both packages from the same parameters and batch,
``n_micro`` 1 and 4, AdamW and Adafactor: loss within rel 1e-5,
``grad_norm`` within rel 1e-4, new params within the reference's own
rtol 2e-4 / atol 5e-4 (``test_train_infra.py``'s accumulation bound).
The weight-decay case (wd 0.1, lr 0.5) and the Adafactor case hold the
unit parameters that the reference stacks (rank 2 where the port's are
rank 1): a per-tensor rank rule, the port's optimizer under an empty
layout, misses them.  A second step from the reference's optimizer state carried
across (``opt_state_from_jax``) checks the state's layout (int8: each
unit's codes its slice of the stacked leaf's).  ``remat``
``"none"``, ``"full"`` and ``"dots"`` give identical gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.train.optimizer as JO
import repro_torch.configs as TC
import repro_torch.train.optimizer as TO
from repro.models import build_model as jbuild
from repro.train.train_step import make_train_step as jmake
from repro_torch.models import build_model
from repro_torch.models.convert import (opt_state_from_jax, params_from_jax,
                                        reference_leaf)
from repro_torch.train.train_step import (load_params, make_train_step,
                                          model_params, unit_layout)

torch.set_num_threads(1)

ARCH = "smollm-360m"
TOL = dict(rtol=2e-4, atol=5e-4)
_PAIR = {}


def pair(**over):
    key = tuple(sorted(over.items()))
    if key not in _PAIR:
        jcfg = JC.get_config(ARCH).reduced().with_(n_units=2, **over)
        tcfg = TC.get_config(ARCH).reduced().with_(n_units=2, **over)
        jm = jbuild(jcfg)
        jp = jm.init(0)
        tm = build_model(tcfg, "cpu")
        load_params(tm, params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
        _PAIR[key] = (jm, jp, tm)
    return _PAIR[key]


def batch(cfg, seed=0, b=8, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _np(x):
    return x.detach().float().numpy()


def ref_state_dict(cfg, tree):
    return params_from_jax(cfg, jax.tree.map(np.asarray, tree))


def both_steps(make_opt, n_micro, b, params=None, states=None, **over):
    """One step of each package; returns (ref metrics, ref new params as
    the port's state dict, ref state, port metrics, port params, port
    state)."""
    jm, jp, tm = pair(**over)
    jo, to = make_opt(JO), make_opt(TO)
    jparams, tparams = params or (jp, model_params(tm))
    jstate, tstate = states or (jo.init(jparams),
                                to.init(tparams, unit_layout(tm)))
    jstep = jax.jit(jmake(jm, jo, n_micro))
    jp1, js1, jmet = jstep(jparams, jstate,
                           {k: jnp.asarray(v) for k, v in b.items()})
    tp1, ts1, tmet = make_train_step(tm, to, n_micro)(tparams, tstate, b)
    return jmet, jp1, js1, tmet, tp1, ts1


def assert_step_equal(jmet, jp1, tmet, tp1, cfg, tol=TOL):
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(tmet["ce"]) == pytest.approx(float(jmet["ce"]), rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-4)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    want = ref_state_dict(cfg, jp1)
    assert set(want) == set(tp1)
    for k, v in want.items():
        np.testing.assert_allclose(_np(tp1[k]), _np(v), **tol, err_msg=k)


OPTS = {"adamw": lambda M: M.adamw(1e-2),
        "adafactor": lambda M: M.adafactor(1e-2)}


@pytest.mark.parametrize("n_micro", [1, 4])
@pytest.mark.parametrize("kind", list(OPTS))
def test_train_step_matches_reference(kind, n_micro):
    _, _, tm = pair()
    b = batch(tm.cfg)
    jmet, jp1, _, tmet, tp1, _ = both_steps(OPTS[kind], n_micro, b)
    assert_step_equal(jmet, jp1, tmet, tp1, tm.cfg)


def test_train_step_micro_accumulation_matches_full_batch():
    """The reference's own check on the port: n_micro=4 reproduces the
    n_micro=1 update (mean-accumulated in float32)."""
    _, _, tm = pair()
    params = model_params(tm)
    opt = TO.adamw(1e-2)
    b = batch(tm.cfg)
    state = opt.init(params, unit_layout(tm))
    p1, _, m1 = make_train_step(tm, opt, 1)(params, state, b)
    p4, _, m4 = make_train_step(tm, opt, 4)(params, state, b)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m4["grad_norm"]),
                                                   rel=1e-4)
    for k in p1:
        np.testing.assert_allclose(_np(p4[k]), _np(p1[k]), **TOL)


def test_step_leaves_its_inputs_and_the_model_as_they_were():
    _, _, tm = pair()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    params = model_params(tm)
    kept = {k: v.clone() for k, v in params.items()}
    opt = TO.adamw(1e-1)
    state = opt.init(params, unit_layout(tm))
    p1, s1, _ = make_train_step(tm, opt, 2)(params, state, batch(tm.cfg))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]) and v.data_ptr() != p1[k].data_ptr()
    for k, v in params.items():
        assert torch.equal(v, kept[k])
    assert int(state["step"]) == 0 and int(s1["step"]) == 1
    assert all(p.grad is None for p in tm.parameters())


def test_stack_layout_of_the_unit_parameters():
    """``reference_leaf`` names every unit parameter's stacked leaf, which
    ``unit_layout`` hands the optimizers."""
    _, jp, tm = pair()
    params = model_params(tm)
    layout = unit_layout(tm)
    assert layout["layers.1.ln1.scale"] == ("units.l0.ln1.scale", 1)
    assert "final_norm.scale" not in layout
    cfg = tm.cfg
    for name, p in params.items():
        leaf, unit = reference_leaf(cfg, name)
        arr = jp
        for part in leaf.split("."):
            arr = arr[part]
        assert tuple(arr.shape) == ((cfg.n_units,) if unit is not None
                                    else ()) + tuple(p.shape)


@pytest.mark.parametrize("kind", ["decay", "adafactor"])
def test_unit_vectors_follow_the_stacked_rank(kind):
    """wd 0.1 at lr 0.5 decays the unit norm scales (``[n_units, d]`` in
    the reference); Adafactor factors them across the units.  The same
    update under an empty layout (each parameter its own rank) misses
    the reference's norm scales."""
    # eps 1e-3: at lr 0.5, Adam's g / (|g| + eps) would otherwise blow the
    # frameworks' rounding noise in the near-zero gradients of rare vocab
    # columns up to whole steps
    make = (lambda M: M.adamw(0.5, weight_decay=0.1, eps=1e-3)) \
        if kind == "decay" else (lambda M: M.adafactor(0.5))
    _, _, tm = pair()
    b = batch(tm.cfg, 3)
    jmet, jp1, _, tmet, tp1, _ = both_steps(make, 1, b)
    assert_step_equal(jmet, jp1, tmet, tp1, tm.cfg)
    params = model_params(tm)
    to = make(TO)
    plain = TO.Optimizer(lambda p, layout=None: to.init(p, {}),
                         lambda g, s, p, layout=None: to.update(g, s, p, {}))
    tq, _, _ = make_train_step(tm, plain, 1)(params, plain.init(params), b)
    want = ref_state_dict(tm.cfg, jp1)
    scales = [k for k in want if k.startswith("layers.")
              and k.endswith("ln1.scale")]
    miss = max(float((tq[k].float() - want[k].float()).abs().max())
               for k in scales)
    assert miss > 1e-2


CARRIED = {"adamw": lambda M: M.adamw(1e-2),
           "adamw-bfloat16": lambda M: M.adamw(1e-2,
                                               moment_dtype="bfloat16"),
           "adafactor": lambda M: M.adafactor(1e-2)}


@pytest.mark.parametrize("kind", list(CARRIED))
def test_second_step_from_the_carried_state(kind):
    """The reference's state after one step, carried across with
    ``opt_state_from_jax``, gives the reference's second step."""
    make = CARRIED[kind]
    _, _, tm = pair()
    cfg = tm.cfg
    b1, b2 = batch(cfg, 1), batch(cfg, 2)
    _, jp1, js1, _, _, _ = both_steps(make, 1, b1)
    params = ref_state_dict(cfg, jp1)
    state = opt_state_from_jax(cfg, jax.tree.map(np.asarray, js1),
                               kind.split("-")[0])
    assert int(state["step"]) == 1
    jmet, jp2, _, tmet, tp2, _ = both_steps(make, 1, b2,
                                            params=(jp1, params),
                                            states=(js1, state))
    assert_step_equal(jmet, jp2, tmet, tp2, cfg)


def test_int8_state_carries_unit_by_unit():
    """An int8 AdamW state of the reference, carried across: each unit's
    ``{q, scale}`` is its slice of the stacked leaf's, shaped as the
    port's own ``init`` shapes it, and a step from it runs.  (A second
    step is not held against the reference's here: where a block's
    quantised ``v`` is 0, ``m / sqrt(v)`` magnifies the frameworks'
    rounding noise in near-zero gradients into whole steps.)"""
    make = lambda M: M.adamw(1e-2, moment_dtype="int8")   # noqa: E731
    _, _, tm = pair()
    cfg = tm.cfg
    _, jp1, js1, _, _, _ = both_steps(make, 1, batch(cfg, 1))
    state = opt_state_from_jax(cfg, jax.tree.map(np.asarray, js1), "adamw")
    params = ref_state_dict(cfg, jp1)
    own = make(TO).init(params, unit_layout(tm))
    for mom in ("m", "v"):
        assert set(state[mom]) == set(own[mom])
        for name, s in state[mom].items():
            leaf, unit = reference_leaf(cfg, name)
            ref = js1[mom]
            for part in leaf.split("."):
                ref = ref[part]
            for part in ("q", "scale"):
                want = np.asarray(ref[part])
                want = want if unit is None else want[unit]
                assert s[part].shape == own[mom][name][part].shape
                assert s[part].dtype == own[mom][name][part].dtype
                np.testing.assert_array_equal(s[part].numpy(), want)
    b2 = batch(cfg, 2)
    p2, _, m2 = make_train_step(tm, make(TO), 1)(params, state, b2)
    assert all(bool(torch.isfinite(v).all()) for v in p2.values())
    jloss, _ = jbuild(JC.get_config(ARCH).reduced().with_(n_units=2)).loss(
        jp1, {k: jnp.asarray(v) for k, v in b2.items()})
    assert float(m2["loss"]) == pytest.approx(float(jloss), rel=1e-5)


def test_remat_modes_give_identical_grads():
    _, _, tm = pair()
    state = {k: v for k, v in tm.state_dict().items()}
    b = batch(tm.cfg, 4)
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    grads = {}
    for remat in ("none", "full", "dots"):
        m = build_model(tm.cfg.with_(remat=remat), "cpu")
        m.load_state_dict(state)
        loss, _ = m.loss(b)
        grads[remat] = torch.autograd.grad(loss, list(m.parameters()))
    for remat in ("full", "dots"):
        for a, g in zip(grads["none"], grads[remat]):
            assert torch.equal(a, g), remat


def test_remat_dots_saves_the_projections_only(monkeypatch):
    """The ``"dots"`` policy keeps the outputs of ``aten.mm`` (the
    projections) and recomputes everything else, the attention's batched
    products among them."""
    import repro_torch.models.model as M
    seen = []
    real = M._save_dots

    def spy(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((str(op), decision))
        return decision
    monkeypatch.setattr(M, "_save_dots", spy)
    _, _, tm = pair()
    m = build_model(tm.cfg.with_(remat="dots"), "cpu")
    m.load_state_dict(tm.state_dict())
    b = {k: torch.from_numpy(v) for k, v in batch(tm.cfg, 4).items()}
    loss, _ = m.loss(b)
    loss.backward()
    saved = {op for op, d in seen if d == M.ckpt.CheckpointPolicy.MUST_SAVE}
    assert saved == {"aten.mm.default"}
    # q, k, v, o, gate, up, down: seven projections a layer
    assert sum(op == "aten.mm.default" for op, _ in seen) == \
        7 * tm.cfg.num_layers
    assert any(op == "aten.bmm.default" for op, _ in seen)
