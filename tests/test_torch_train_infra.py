"""The training infrastructure in the port against the JAX package:
optimizers, schedules, checkpoints, the reshard plan and the FT
coordinator.

Every test of ``tests/test_train_infra.py`` that needs no model runs here
on both packages (``pkg``), and the port's optimizers take the reference's
own steps on the same seeded inputs: AdamW (float32, bfloat16 and int8
moments) and Adafactor over 10 steps from the same state, params within
rtol 1e-5; int8 moment codes and bfloat16 moments equal but at rounding
ties (at most one step apart, on at most 0.1% of the elements; the
frameworks' float32 chains differ by an ulp, so a value at a tie may round
either way), and where such a moment moved its parameter, at most 0.1% of
the elements, within 1e-3; schedules within 1e-7.  The stacked case
holds the port's unstacked unit parameters (their layout passed to
``init`` and ``update``) against the reference's stacked leaves, with
weight decay on the stacked vectors and Adafactor factoring them across
their units; the same tensors under an empty layout (each its own rank)
are shown to miss, and under none the optimizers raise.  The
model-sized tests (the accumulating train step, the trainer) are in
``test_torch_train_step.py`` and ``test_torch_trainer.py``.
"""
import glob
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpointer as JK
import repro.checkpoint.reshard as JR
import repro.ft.coordinator as JF
import repro.train.optimizer as JO
import repro.train.schedule as JS
import repro_torch.checkpoint.checkpointer as TK
import repro_torch.checkpoint.reshard as TR
import repro_torch.ft.coordinator as TF
import repro_torch.train.optimizer as TO
import repro_torch.train.schedule as TS

torch.set_num_threads(1)

PKGS = {
    "jax": SimpleNamespace(
        opt=JO, sched=JS, ckpt=JK, reshard=JR, ft=JF,
        arr=lambda a: jnp.asarray(np.asarray(a, np.float32)),
        step=jnp.asarray, int8=jnp.int8),
    "torch": SimpleNamespace(
        opt=TO, sched=TS, ckpt=TK, reshard=TR, ft=TF,
        arr=lambda a: torch.tensor(np.asarray(a, np.float32)),
        step=torch.tensor, int8=torch.int8),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ----------------------------- optimizers ---------------------------------

def quad_params(P):
    return {"w": P.arr([1.0, -2.0, 3.0]), "b": P.arr(0.5)}


def quad_loss(p):
    return (p["w"] ** 2).sum() + p["b"] ** 2


def quad_grads(p):
    return {k: 2 * v for k, v in p.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges_quadratic(pkg, moment_dtype):
    opt = pkg.opt.adamw(0.1, weight_decay=0.0, moment_dtype=moment_dtype)
    params = quad_params(pkg)
    state = opt.init(params)
    for _ in range(200):
        params, state, stats = opt.update(quad_grads(params), state, params)
    assert float(quad_loss(params)) < 1e-2, moment_dtype
    assert np.isfinite(float(stats["grad_norm"]))


def test_adamw_int8_state_is_quantized(pkg):
    opt = pkg.opt.adamw(0.1, moment_dtype="int8")
    state = opt.init({"w": pkg.arr(np.ones(300))})
    assert state["m"]["w"]["q"].dtype == pkg.int8
    # blocks of 128 -> ceil(300/128) = 3 blocks
    assert tuple(state["m"]["w"]["q"].shape) == (3, 128)


def test_adafactor_converges_and_is_factored(pkg):
    opt = pkg.opt.adafactor(0.5)
    params = {"w": pkg.arr(np.full((8, 4), 3.0))}
    state = opt.init(params)
    assert tuple(state["v"]["w"]["row"].shape) == (8,)
    assert tuple(state["v"]["w"]["col"].shape) == (4,)
    for _ in range(300):
        params, state, _ = opt.update(quad_grads(params), state, params)
    assert float(abs(params["w"]).max()) < 0.2


def test_grad_clipping(pkg):
    opt = pkg.opt.adamw(0.0, max_grad_norm=1.0)  # lr 0: only inspect stats
    params = {"w": pkg.arr(np.ones(4))}
    _, _, stats = opt.update({"w": pkg.arr(np.full(4, 100.0))},
                             opt.init(params), params)
    assert float(stats["grad_norm"]) == pytest.approx(200.0, rel=1e-3)


def test_schedules_shapes(pkg):
    S = pkg.sched
    for fn in (S.warmup_cosine(1e-3, 10, 100), S.warmup_linear(1e-3, 10, 100),
               S.warmup_rsqrt(1e-3, 10)):
        v0 = float(fn(pkg.step(0)))
        v10 = float(fn(pkg.step(10)))
        v90 = float(fn(pkg.step(90)))
        assert v0 <= v10 and v90 <= v10
        assert v10 == pytest.approx(1e-3, rel=1e-2)


# --------------------------------- parity ---------------------------------

SHAPES = {"mat": (12, 300), "vec": (300,), "cube": (2, 4, 130), "one": (7,),
          "scalar": ()}
STEPS = 10


def _grads(rng, shapes):
    return {k: np.asarray(rng.standard_normal(s) * (1.0 + 3.0 * (k == "mat")),
                          np.float32) for k, s in shapes.items()}


def _run_both(make, params, grads_at, steps=STEPS, port_params=None,
              port_grads=None):
    """``steps`` updates of the reference's optimizer and the port's from
    the same parameters, fed the same seeded gradients."""
    jo, to = make(JO), make(TO)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = port_params(params) if port_params else \
        {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(steps):
        g = grads_at(i)
        jp, js, jst = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
        tg = port_grads(g) if port_grads else \
            {k: torch.from_numpy(v) for k, v in g.items()}
        tp, ts, tst = to.update(tg, ts, tp)
        assert float(tst["grad_norm"]) == pytest.approx(
            float(jst["grad_norm"]), rel=1e-5)
        assert float(tst["lr"]) == pytest.approx(float(jst["lr"]), rel=1e-6)
    return jp, js, tp, ts


def _params_close_but_ties(got, want):
    """Within rtol 1e-5 but where a moment rounded the other way at a tie
    (a bfloat16 or int8 moment one step apart moves its parameter by about
    lr x 1%): at most 0.1% of the elements, each within 1e-3."""
    off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert off.mean() <= 1e-3, off.sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _bf16_close_but_ties(got, want):
    """bfloat16 moments equal but at rounding ties: at most one bfloat16
    step apart, on at most 0.1% of the elements."""
    off = got != want
    assert off.mean() <= 1e-3, off.sum()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def _int8_codes_close(jq, tq):
    jq, tq = np.asarray(jq).astype(np.int32), tq.numpy().astype(np.int32)
    assert jq.shape == tq.shape
    diff = np.abs(jq - tq)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8",
                                  "adafactor"])
def test_optimizer_matches_reference_over_ten_steps(kind):
    rng = np.random.default_rng(7)
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in SHAPES.items()}
    grads = [_grads(rng, SHAPES) for _ in range(STEPS)]
    sched = (lambda M: M.warmup_cosine(3e-2, 3, STEPS))
    if kind == "adafactor":
        def make(M):
            return M.adafactor(sched(JS if M is JO else TS))
    else:
        def make(M):
            return M.adamw(sched(JS if M is JO else TS), weight_decay=0.1,
                           moment_dtype=kind)
    jp, js, tp, ts = _run_both(make, params, lambda i: grads[i])
    for k in SHAPES:
        if kind in ("float32", "adafactor"):
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-5,
                                       atol=1e-6)
        else:
            _params_close_but_ties(_np(tp[k]), _np(jp[k]))
    assert int(ts["step"]) == int(js["step"]) == STEPS
    if kind == "int8":
        for mom in ("m", "v"):
            for k in SHAPES:
                _int8_codes_close(js[mom][k]["q"], ts[mom][k]["q"])
                np.testing.assert_allclose(
                    ts[mom][k]["scale"].numpy(), np.asarray(js[mom][k]["scale"]),
                    rtol=1e-5, atol=1e-12)
    elif kind == "adafactor":
        for k in SHAPES:
            for part, want in js["v"][k].items():
                np.testing.assert_allclose(_np(ts["v"][k][part]),
                                           np.asarray(want), rtol=1e-4,
                                           atol=1e-12)
    elif kind == "bfloat16":
        for mom in ("m", "v"):
            for k in SHAPES:
                assert ts[mom][k].dtype == torch.bfloat16
                _bf16_close_but_ties(_np(ts[mom][k]), _np(js[mom][k]))
    else:
        for mom in ("m", "v"):
            for k in SHAPES:
                np.testing.assert_allclose(_np(ts[mom][k]), _np(js[mom][k]),
                                           rtol=1e-5, atol=1e-9)


N_UNITS = 3
STACKED = {"norm": (96,), "proj": (96, 40), "gate": (1,)}


def _stacked_case(rng):
    """The reference's stacked tree (``units`` leaves with a leading unit
    axis, a top-level vector and matrix) and seeded gradients for it,
    the units' scales differing so that factoring across them shows."""
    ref = {"units": {k: rng.standard_normal((N_UNITS,) + s).astype(
        np.float32) for k, s in STACKED.items()},
        "top": rng.standard_normal(96).astype(np.float32),
        "head": rng.standard_normal((96, 24)).astype(np.float32)}
    scale = np.arange(1, N_UNITS + 1, dtype=np.float32)

    def grads(_):
        g = _grads(rng, {"top": (96,), "head": (96, 24)})
        g["units"] = {k: rng.standard_normal((N_UNITS,) + s).astype(
            np.float32) * scale.reshape((-1,) + (1,) * len(s))
            for k, s in STACKED.items()}
        return g
    return ref, grads


def _unstack(tree):
    out = {"top": torch.from_numpy(tree["top"].copy()),
           "head": torch.from_numpy(tree["head"].copy())}
    for k, v in tree["units"].items():
        for u in range(N_UNITS):
            out[f"layers.{u}.{k}"] = torch.from_numpy(v[u].copy())
    return out


def _layout():
    return {f"layers.{u}.{k}": (f"units.{k}", u) for k in STACKED
            for u in range(N_UNITS)}


def _flat_ref(tree):
    return {"top": tree["top"], "head": tree["head"],
            **{f"layers.{u}.{k}": np.asarray(v)[u]
               for k, v in tree["units"].items() for u in range(N_UNITS)}}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_stacked_units_follow_the_reference_layout(kind):
    """Weight decay reaches the stacked vectors (rank 2 in the reference)
    and Adafactor factors them across their units; an empty layout (each
    tensor its own rank) misses the reference, and no layout raises."""
    rng = np.random.default_rng(3)
    ref, grads = _stacked_case(rng)
    gs = [grads(i) for i in range(STEPS)]

    def make(M):
        return M.adamw(0.3, weight_decay=0.1) if kind == "adamw" else \
            M.adafactor(0.3)

    def as_jax(tree):
        return jax.tree.map(jnp.asarray, tree)

    def run(layout):
        jo, to = make(JO), make(TO)
        jp, tp = as_jax(ref), _unstack(ref)
        js, ts = jo.init(jp), to.init(tp, layout)
        for g in gs:
            jp, js, _ = jo.update(as_jax(g), js, jp)
            tp, ts, _ = to.update(_unstack(g), ts, tp, layout)
        return _flat_ref(jax.tree.map(np.asarray, jp)), tp, ts

    want, got, ts = run(_layout())
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), v, rtol=1e-5, atol=1e-6)
    if kind == "adafactor":      # one col a stacked vector, a row a unit
        assert ts["v"]["layers.0.norm"]["row"].shape == ()
        assert torch.equal(ts["v"]["layers.0.norm"]["col"],
                           ts["v"]["layers.2.norm"]["col"])
    _, plain, _ = run({})
    miss = max(np.abs(_np(plain[f"layers.{u}.norm"])
                      - want[f"layers.{u}.norm"]).max()
               for u in range(N_UNITS))
    assert miss > 1e-2
    opt, tp = make(TO), _unstack(ref)
    with pytest.raises(ValueError, match="layers.0.norm is a repeating"):
        opt.init(tp)
    with pytest.raises(ValueError, match="pass the layout"):
        opt.update(_unstack(gs[0]), opt.init(tp, _layout()), tp)


def test_global_norm_and_clip_match():
    rng = np.random.default_rng(1)
    g = {k: np.asarray(rng.standard_normal(s) * 10, np.float32)
         for k, s in SHAPES.items()}
    jn = JO.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    tn = TO.global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    jc, _ = JO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                   1.0)
    tc, _ = TO.clip_by_global_norm({k: torch.from_numpy(v)
                                    for k, v in g.items()}, 1.0)
    for k in g:
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=1e-5,
                                   atol=1e-8)


def test_schedules_equal():
    cases = [("warmup_cosine", (1e-3, 10, 100)),
             ("warmup_cosine", (3e-4, 5, 20)),
             ("warmup_linear", (1e-3, 10, 100)),
             ("warmup_rsqrt", (1e-3, 10))]
    steps = np.arange(0, 130)
    for name, args in cases:
        jf, tf = getattr(JS, name)(*args), getattr(TS, name)(*args)
        want = np.asarray(jf(jnp.asarray(steps, jnp.int32)))
        got = tf(torch.from_numpy(steps.astype(np.int32))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert float(tf(7)) == pytest.approx(float(want[7]), abs=1e-7)


# ------------------------------ checkpoint ---------------------------------

def test_checkpoint_roundtrip_and_atomicity(pkg, tmp_path):
    C = pkg.ckpt
    tree = {"a": np.arange(10, dtype=np.float32),
            "b": {"c": np.ones((3, 4), np.int32)}}
    d = str(tmp_path)
    C.save_checkpoint(d, 5, tree, extra={"next_step": 5})
    C.save_checkpoint(d, 10, tree, extra={"next_step": 10})
    assert C.list_checkpoints(d) == [5, 10]
    got, extra = C.restore_checkpoint(d, 10, like=tree)
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert extra["next_step"] == 10
    # corrupt a shard -> checksum failure
    shard = sorted(glob.glob(os.path.join(d, "step_00000010", "*.npy")))[0]
    with open(shard, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    with pytest.raises(IOError):
        C.restore_checkpoint(d, 10, like=tree)
    # step 5 still intact (atomic commits are independent)
    got5, _ = C.restore_checkpoint(d, 5, like=tree)
    np.testing.assert_array_equal(got5["b"]["c"], tree["b"]["c"])


def test_checkpoint_prune(pkg, tmp_path):
    for s in range(5):
        pkg.ckpt.save_checkpoint(str(tmp_path), s, {"a": np.zeros(3)})
    pkg.ckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert pkg.ckpt.list_checkpoints(str(tmp_path)) == [3, 4]


def test_checkpoint_tensors_restore_like(tmp_path):
    """Tensor leaves come back as tensors of the like's type; a ``.tmp``
    directory is never listed."""
    params = {"w": torch.arange(6.0).reshape(2, 3),
              "s": torch.ones(3, dtype=torch.bfloat16)}
    state = TO.adamw(1e-3, moment_dtype="int8").init(params)
    tree = {"params": params, "opt": state}
    TK.save_checkpoint(str(tmp_path), 3, tree, extra={"next_step": 3})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert TK.list_checkpoints(str(tmp_path)) == [3]
    got, extra = TK.restore_checkpoint(str(tmp_path), 3, like=tree)
    assert extra == {"next_step": 3}
    for k, v in params.items():
        assert got["params"][k].dtype == v.dtype
        assert torch.equal(got["params"][k], v)
    assert got["opt"]["m"]["w"]["q"].dtype == torch.int8
    assert got["opt"]["step"].dtype == torch.int32


def test_reshard_plan(pkg):
    plan = pkg.reshard.plan_reshard((128, 64), old_spec_shards=4,
                                    new_spec_shards=8)
    assert len(plan) == 8
    assert sum(p["bytes_factor"] for p in plan) == pytest.approx(1.0)
    plan2 = pkg.reshard.plan_reshard((128, 64), 8, 2)
    assert all(len(p["reads"]) == 4 for p in plan2)


@pytest.mark.parametrize("case", [((128, 64), 4, 8, 0), ((128, 64), 8, 2, 0),
                                  ((96, 30), 3, 4, 0), ((5, 60), 6, 4, 1),
                                  ((64,), 1, 64, 0), ((48,), 16, 3, 0)])
def test_reshard_plan_equal(case):
    shape, old, new, axis = case
    assert TR.plan_reshard(shape, old, new, axis) == \
        JR.plan_reshard(shape, old, new, axis)


# ------------------------------- FT ----------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_coordinator_detects_failure_and_restarts(pkg):
    clock = FakeClock()
    c = pkg.ft.Coordinator(4, heartbeat_timeout=10.0, spares=1, clock=clock)
    for w in range(4):
        c.heartbeat(w, 0, 1.0)
    d = c.tick(latest_committed_step=100)
    assert d.action == pkg.ft.Action.CONTINUE
    clock.t = 20.0                  # worker 2 goes silent
    for w in (0, 1, 3):
        c.heartbeat(w, 1, 1.0)
    d = c.tick(latest_committed_step=100)
    assert d.action == pkg.ft.Action.RESTART_FROM_CHECKPOINT
    assert d.failed_workers == [2]
    assert d.restore_step == 100
    assert c.healthy_count() == 4  # spare promoted


def test_coordinator_elastic_scale_down_without_spares(pkg):
    clock = FakeClock()
    c = pkg.ft.Coordinator(4, heartbeat_timeout=10.0, spares=0, clock=clock)
    clock.t = 20.0
    for w in (0, 1):
        c.heartbeat(w, 1, 1.0)
    d = c.tick(latest_committed_step=40)
    assert d.action == pkg.ft.Action.ELASTIC_SCALE_DOWN
    assert set(d.failed_workers) == {2, 3}
    assert set(d.surviving_workers) == {0, 1}


def test_coordinator_straggler_detection_and_promotion(pkg):
    clock = FakeClock()
    c = pkg.ft.Coordinator(4, heartbeat_timeout=1e9, straggler_factor=2.0,
                           strike_limit=2, spares=1, clock=clock)
    for step in range(3):
        clock.t += 1
        for w in range(4):
            c.heartbeat(w, step, 10.0 if w == 3 else 1.0)
        d = c.tick(latest_committed_step=None)
        if d.action == pkg.ft.Action.PROMOTE_SPARE:
            break
    assert d.action == pkg.ft.Action.PROMOTE_SPARE
    assert 3 in [wid for wid, w in c.workers.items()
                 if w.state.value == "evicted"]


def test_coordinator_decisions_equal():
    """A seeded run of heartbeats, silences and slow steps over 6 workers
    with 2 spares: every decision and worker state equal."""
    rng = np.random.default_rng(5)
    script = [(rng.random(6) < 0.85, rng.choice([1.0, 1.1, 5.0], 6,
                                                p=[0.6, 0.3, 0.1]))
              for _ in range(40)]
    trails = []
    for F in (JF, TF):
        clock = FakeClock()
        c = F.Coordinator(6, heartbeat_timeout=3.0, straggler_factor=2.0,
                          strike_limit=2, spares=2, clock=clock)
        trail = []
        for step, (alive, lat) in enumerate(script):
            clock.t += 1.0
            for w in list(c.workers):
                if w < 6 and alive[w] or w >= 6:
                    c.heartbeat(w, step, float(lat[w % 6]))
            d = c.tick(latest_committed_step=step // 4 * 4)
            trail.append((d.action.value, d.failed_workers, d.stragglers,
                          d.restore_step, d.surviving_workers,
                          sorted((k, w.state.value, w.slow_strikes)
                                 for k, w in c.workers.items())))
        trails.append(trail)
    assert trails[0] == trails[1]
