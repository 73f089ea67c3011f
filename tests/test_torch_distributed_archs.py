"""gemma3-4b, qwen3-moe-30b-a3b and mistral-large-123b on a gloo world of
CPU ranks: the three architectures the other worlds leave out.

One world of 4 ranks for the module, a 2x2 ``(data, model)`` mesh
(``tests/_torch_dist_worker.py``; every process group times out after
120 s and every rank is joined with a timeout that fails the test),
spawned before the references are computed so that the two overlap.
Their reduced configs, float32, with the reference's ``init(0)`` weights
carried across by ``params_from_jax``, against the reference's
single-device ``LM``:

* gemma3 (2 heads over 1 KV head: heads-parallel, its KV head repeated
  whole to the local heads) at S = 96, past its reduced window of 64, so
  that the window masks keys on the mesh in the forward, the loss, the
  prefill of 80 and the decode after it;
* qwen3-moe (8 experts, top-2, 8 heads over 1 KV head) and mistral
  (24 heads over 2 KV heads, split over ``model``) at S = 16;
* forward logits, the loss and one AdamW step's parameters within
  ``1e-5 x max|ref|`` (the largest over the updated parameters for the
  step), prefill + 4 greedy ``decode_step``s with a scalar index, and two
  ``write_slots`` groups of different lengths into a vector-index cache
  followed by 4 decode steps at each slot's own position
  (``tests/_torch_slots.py``), each step's logits within the same bound
  and the greedy tokens equal;
* no rank imported JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.train.optimizer as JO
import repro_torch.configs as TC
from _torch_slots import GROUPS, reference_slots, slot_case
from repro.models import build_model as jbuild
from repro.train.train_step import make_train_step as jmake
from repro_torch.models.convert import params_from_jax
from test_torch_distributed import _close, _np, check_slots
from test_torch_distributed_families import _join, _spawn

torch.set_num_threads(1)

ARCHS = {"gemma3": "gemma3-4b", "qwen3moe": "qwen3-moe-30b-a3b",
         "mistral": "mistral-large-123b"}
B, DECODE = 4, 4
#: key -> (sequence, prompt): gemma3's sequence and prompt past its window
LENGTHS = {"gemma3": (96, 80), "qwen3moe": (16, 12), "mistral": (16, 12)}
#: gemma3's per-slot groups reach past the window too
SLOT_GROUPS = {"gemma3": (((2, 0), 80), ((3,), 70))}
LR, EPS = 1e-4, 1e-6


def _cfg(arch, jax_side=False):
    return (JC if jax_side else TC).get_config(arch).reduced()


def _slots(key):
    s, prompt = LENGTHS[key]
    return slot_case(DECODE, prompt + DECODE, SLOT_GROUPS.get(key, GROUPS))


def _inputs(root):
    """The port's weights (the reference's) and the cases, written for the
    world; returns {key: (JAX model, params)}."""
    jaxside, models = {}, {}
    for key, arch in ARCHS.items():
        jcfg, tcfg = _cfg(arch, True), _cfg(arch)
        jm = jbuild(jcfg)
        jp = jm.init(0)
        jaxside[key] = (jm, jp)
        s, prompt = LENGTHS[key]
        rng = np.random.default_rng(3)
        b = {k: rng.integers(0, tcfg.vocab_size, (B, s)).astype(np.int32)
             for k in ("tokens", "labels")}
        models[key] = {"arch": arch, "batch": b, "prompt": prompt,
                       "decode": DECODE, "eps": EPS, "slots": _slots(key),
                       "state": params_from_jax(tcfg, jax.tree.map(
                           np.asarray, jp)),
                       "train": {"adamw": ("float32", LR, 1, 1)}}
    inp = {"models": models}
    torch.save(inp, root / "inputs.pt")
    return inp, jaxside


def _reference(key, jm, jp, b):
    """The reference's single-device results of one case."""
    tcfg = _cfg(ARCHS[key])
    s, prompt = LENGTHS[key]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    logits, _ = jax.jit(jm.apply)(jp, jb)
    loss, _ = jax.jit(jm.loss)(jp, jb)
    cache = jm.init_cache(B, max_len=prompt + DECODE, dtype=jnp.float32)
    lg, cache = jax.jit(jm.prefill)(jp, {"tokens": jb["tokens"][:, :prompt]},
                                    cache)
    steps, toks = [np.asarray(lg)], []
    decode = jax.jit(jm.decode_step)
    for _ in range(DECODE):
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        lg, cache = decode(jp, tok, cache)
        steps.append(np.asarray(lg))
    opt = JO.adamw(LR, eps=EPS)
    p, _, _ = jax.jit(jmake(jm, opt, 1))(jp, opt.init(jp), jb)
    return {"logits": np.asarray(logits), "loss": float(loss),
            "decode": steps, "greedy": np.concatenate(toks, 1),
            "slots": reference_slots(jm, jp, b["tokens"], _slots(key)),
            "params": params_from_jax(tcfg, jax.tree.map(np.asarray, p))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, each rank's results, the references): the world runs
    while the single-device references are computed."""
    root = tmp_path_factory.mktemp("archs22")
    inp, jaxside = _inputs(root)
    procs = _spawn(root)
    try:
        ref = {key: _reference(key, *jaxside[key],
                               inp["models"][key]["batch"])
               for key in ARCHS}
    finally:
        ranks = _join(root, procs)
    return inp, ranks, ref


def test_gemma3_window_is_shorter_than_its_sequence():
    """The reduced window (``min(w, 64)``) masks keys at S = 96 and in the
    prefill of 80: the mesh runs the sliding window, not a full one."""
    cfg = _cfg(ARCHS["gemma3"])
    windows = [w for w in cfg.windows() if w]
    assert windows and max(windows) < LENGTHS["gemma3"][1]
    assert min(n for _, n in SLOT_GROUPS["gemma3"]) > max(windows)


@pytest.mark.parametrize("key", list(ARCHS))
def test_forward_matches_the_reference(world, key):
    _, ranks, ref = world
    for res in ranks:
        _close(res[key]["logits"], ref[key]["logits"], f"{key} logits")


@pytest.mark.parametrize("key", list(ARCHS))
def test_loss_matches_the_reference(world, key):
    _, ranks, ref = world
    for res in ranks:
        assert res[key]["loss"] == pytest.approx(ref[key]["loss"], rel=1e-5,
                                                 abs=0)


@pytest.mark.parametrize("key", list(ARCHS))
def test_adamw_step_matches_the_reference(world, key):
    inp, ranks, ref = world
    got = ranks[0][key]["train"]["adamw"]["params"]
    want = ref[key]["params"]
    start = inp["models"][key]["state"]
    top = max(float(np.abs(_np(v)).max()) for v in want.values())
    moved = max(float((want[n] - start[n]).abs().max()) for n in start)
    assert moved > 2 * 1e-5 * top      # the step moves the parameters
    assert set(got) == set(want)
    for n, w in want.items():
        _close(got[n], _np(w), f"{key} adamw {n}", top)


@pytest.mark.parametrize("key", list(ARCHS))
def test_prefill_and_greedy_decode_match_the_reference(world, key):
    _, ranks, ref = world
    res = ranks[0][key]
    np.testing.assert_array_equal(res["greedy"].numpy(), ref[key]["greedy"])
    for i, (got, want) in enumerate(zip(res["decode_logits"],
                                        ref[key]["decode"])):
        _close(got, want, f"{key} decode step {i}")


@pytest.mark.parametrize("key", list(ARCHS))
def test_per_slot_prefill_and_decode_match_the_reference(world, key):
    _, ranks, ref = world
    for res in ranks:
        check_slots(res[key]["slots"], ref[key]["slots"], key)


def test_no_rank_imported_jax(world):
    _, ranks, _ = world
    for res in ranks:
        assert res["jax_loaded"] is False
        assert all(res[k]["jax_loaded"] is False for k in ARCHS)
