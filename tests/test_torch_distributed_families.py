"""Sharded execution of the port's MoE, SSM, hybrid, encoder-decoder and
VLM families on a gloo world of CPU ranks.

One world of 4 ranks for the module, a 2x2 ``(data, model)`` mesh
(``tests/_torch_dist_worker.py``; every process group times out after
120 s and every rank is joined with a timeout that fails the test),
spawned before the references are computed so that the two overlap.
Reduced deepseek-moe (8 experts, top-2), jamba (MoE, SSM and attention
in one model), mamba2, whisper (3 heads: sequence-parallel on ``model``
2; an encoder over 64 frames) and llama-vision (8 heads over 2 KV heads,
16 vision tokens), float32, every ``x_gate`` at 0.5, with the
reference's ``init(0)`` weights carried across by ``params_from_jax``,
against the reference's single-device ``LM``:

* forward logits, loss, the gathered gradients, and one AdamW step's
  parameters within ``1e-5 x max|ref|`` (the largest over the model's
  gradients, or over its updated parameters), prefill + 4 greedy
  ``decode_step``s within the same bound of each step's logits and the
  greedy tokens equal; for deepseek, jamba and mamba2 also two
  ``write_slots`` groups of different lengths into a vector-index cache
  and decode steps at each slot's own position, against the reference's
  engine write (``tests/_torch_slots.py``);
* the first MoE layer's routing of a skewed global batch (some
  assignments dropped): the expert ids and the ``keep`` mask equal, bit
  for bit, to the reference's routing (``jax.lax.top_k`` and its slot
  ranking, ``src/repro/models/moe.py``) of the same batch, with the
  capacity of the global batch; the layer's output that of the port's
  one-device layer;
* deepseek's updated parameters against the reference's own jitted step
  on a (2, 2) mesh of 4 forced host devices (its GSPMD expert
  parallelism; in a subprocess);
* ``elastic_restore`` of a reduced deepseek checkpoint gives each rank
  its ``indices()`` slice of every leaf, the expert banks' experts split
  over ``model``;
* the flash route (kernel 15's plain version here) on deepseek and
  llama-vision (heads-parallel), whisper and reduced smollm (3 heads:
  sequence-parallel, each rank's query rows through the kernel's
  ``q_start``) equal to the one-device flash route's logits;
* the cache's SSM state and conv tail, and the cross keys, placed by
  the reference's ``cache_spec``;
* no rank imported JAX.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.train.optimizer as JO
import repro_torch.configs as TC
from _torch_families import open_gates
from repro.models import build_model as jbuild
from repro.train.train_step import make_train_step as jmake
from repro_torch.checkpoint.checkpointer import save_checkpoint
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.moe import moe_apply
from _torch_slots import reference_slots
from test_torch_distributed import (JOIN_S, SLOTS, SRC, _close, _np,
                                    _free_port, check_slots)

torch.set_num_threads(1)

WORKER = Path(__file__).with_name("_torch_dist_worker.py")
ARCHS = {"deepseek": "deepseek-moe-16b", "jamba": "jamba-1.5-large-398b",
         "mamba2": "mamba2-2.7b", "whisper": "whisper-small",
         "vision": "llama-3.2-vision-11b"}
#: the flash route on the mesh: heads-parallel (deepseek 4 heads, vision
#: 8 over 2 KV heads) or sequence-parallel (whisper and smollm, 3 heads)
FLASH = ("deepseek", "vision", "whisper", "smollm")
MOE = ("deepseek", "jamba")
#: the families that also run the per-slot case (``tests/_torch_slots.py``)
SLOTTED = ("deepseek", "jamba", "mamba2")
B, S, PROMPT, DECODE = 4, 16, 12, 4
LR, EPS = 1e-4, 1e-6


def _cfg(arch, jax_side=False):
    return (JC if jax_side else TC).get_config(arch).reduced()


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (B, cfg.default_encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.num_vision_tokens:
        out["vision"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _ctx_len(cfg):
    return cfg.default_encoder_len if cfg.encoder_layers \
        else cfg.num_vision_tokens


def _skewed(cfg, seed):
    """[B, S, d] whose tokens share a direction, so that they crowd the
    same experts and some assignments drop."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return x * 0.5 + 2.0 * u


def _moe_params(state, cfg):
    """The port's name of the first MoE layer's module."""
    blocks = [f"prefix.{i}" for i in range(len(cfg.prefix))] + \
        [f"layers.{i}" for i in range(cfg.n_units * cfg.unit_size)]
    specs = list(cfg.prefix) + list(cfg.unit) * cfg.n_units
    return next(b for b, sp in zip(blocks, specs) if sp.moe)


def _reference_routing(x, router, cfg):
    """The reference's routing (``src/repro/models/moe.py:61-86``) of the
    global batch ``x`` [B, S, d]: (expert ids [T, k], keep [T * k])."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax((xf @ jnp.asarray(router)).astype(jnp.float32),
                           axis=-1)
    _, expert_idx = jax.lax.top_k(probs, m.top_k)
    capacity = int(max(1, round(t * m.top_k / m.num_experts
                                * m.capacity_factor)))
    flat = expert_idx.reshape(-1)
    n = flat.shape[0]
    sort_idx = jnp.argsort(flat, stable=True)
    sorted_e = flat[sort_idx]
    starts = jnp.searchsorted(sorted_e, jnp.arange(m.num_experts,
                                                   dtype=sorted_e.dtype))
    slot_sorted = jnp.arange(n, dtype=jnp.int32) - \
        jnp.take(starts, sorted_e).astype(jnp.int32)
    slot = jnp.zeros((n,), jnp.int32).at[sort_idx].set(slot_sorted)
    return np.asarray(expert_idx), np.asarray(slot < capacity), capacity


# ----------------------------------------------------------------- world

def _inputs(root: Path):
    """The port's weights (the reference's, ``x_gate`` at 0.5) and the
    cases, written for the world; returns {key: (JAX model, params)}."""
    jaxside, models = {}, {}
    for key, arch in list(ARCHS.items()) + [("smollm", "smollm-360m")]:
        jcfg, tcfg = _cfg(arch, True), _cfg(arch)
        jm = jbuild(jcfg)
        jp = open_gates(jm.init(0))
        jaxside[key] = (jm, jp)
        state = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
        b = _batch(tcfg, 1)
        case = {"arch": arch, "state": state, "batch": b, "prompt": PROMPT,
                "decode": DECODE, "ctx_len": _ctx_len(tcfg), "eps": EPS,
                "train": {"adamw": ("float32", LR, 1, 1)},
                "flash": key in FLASH, "flash_only": key == "smollm"}
        if key in MOE:
            case["routing"] = torch.from_numpy(_skewed(tcfg, 7))
        if key in SLOTTED:
            case["slots"] = SLOTS
        models[key] = case
    d = models["deepseek"]
    save_checkpoint(str(root / "ckpt"), 1, d["state"])
    inp = {"models": models,
           "elastic": {"arch": ARCHS["deepseek"], "dir": str(root / "ckpt"),
                       "step": 1, "like": d["state"]}}
    torch.save(inp, root / "inputs.pt")
    return inp, jaxside


def _spawn(root: Path, world: int = 4):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    port = _free_port()
    procs = []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(port),
             str(root), "2,2", "data,model"], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _join(root: Path, procs):
    try:
        for p, _ in procs:
            p.wait(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the 2x2 world did not finish in {JOIN_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()[-4000:]
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


REF_SHARDED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    import repro.train.optimizer as O
    from repro.configs import get_config
    from repro.distributed.sharding import shard_batch, shard_params
    from repro.models import build_model
    from repro.train.train_step import make_train_step
    out, arch, B, S, lr, eps = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
        int(sys.argv[4]), float(sys.argv[5]), float(sys.argv[6])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    p = m.init(0)
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    opt = O.adamw(lr, eps=eps)
    st = opt.init(p)
    psh, ssh = shard_params(p, mesh), shard_params(st, mesh)
    bsh = shard_batch(b, mesh, B)
    p, st = jax.device_put(p, psh), jax.device_put(st, ssh)
    b = jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, bsh)
    step = jax.jit(make_train_step(m, opt, 1), in_shardings=(psh, ssh, bsh))
    with mesh:
        p, st, met = step(p, st, b)
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    np.savez(out, **{jax.tree_util.keystr(kp): np.asarray(v)
                     for kp, v in flat})
    print("RESULT ok")
""")


def _ref_sharded(out: Path):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", REF_SHARDED, str(out), ARCHS["deepseek"],
         str(B), str(S), str(LR), str(EPS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _reference(jm, jp, b, tcfg):
    """The reference's single-device results of one case."""
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ctx = {k: v for k, v in jb.items() if k in ("frames", "vision")}
    logits, _ = jax.jit(jm.apply)(jp, jb)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    cache = jm.init_cache(B, max_len=PROMPT + DECODE, ctx_len=_ctx_len(tcfg),
                          dtype=jnp.float32)
    lg, cache = jax.jit(jm.prefill)(
        jp, {"tokens": jb["tokens"][:, :PROMPT], **ctx}, cache)
    steps, toks = [np.asarray(lg)], []
    decode = jax.jit(jm.decode_step)
    for _ in range(DECODE):
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        lg, cache = decode(jp, tok, cache)
        steps.append(np.asarray(lg))
    opt = JO.adamw(LR, eps=EPS)
    p, _, _ = jax.jit(jmake(jm, opt, 1))(jp, opt.init(jp), jb)
    sd = lambda tree: params_from_jax(tcfg, jax.tree.map(np.asarray, tree))
    return {"logits": np.asarray(logits), "loss": float(loss),
            "grads": sd(grads), "decode": steps,
            "greedy": np.concatenate(toks, 1), "params": sd(p)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, each rank's results, the references, the reference's
    sharded deepseek step): the world and the reference's sharded step
    run while the single-device references are computed."""
    root = tmp_path_factory.mktemp("families22")
    inp, jaxside = _inputs(root)
    procs = _spawn(root)
    sharded = _ref_sharded(root / "ref_sharded.npz")
    try:
        ref = {key: _reference(*jaxside[key], inp["models"][key]["batch"],
                               _cfg(ARCHS[key])) for key in ARCHS}
        for key in SLOTTED:
            ref[key]["slots"] = reference_slots(
                *jaxside[key], inp["models"][key]["batch"]["tokens"], SLOTS)
        out, err = sharded.communicate(timeout=JOIN_S)
    finally:
        if sharded.poll() is None:
            sharded.kill()
            sharded.wait()
    assert sharded.returncode == 0 and "RESULT ok" in out, err[-3000:]
    ranks = _join(root, procs)
    z = np.load(root / "ref_sharded.npz")
    tree = {}
    for k in z.files:            # "['units']['l0']['attn']['q']" -> nested
        node, parts = tree, [p.strip("'") for p in k[2:-2].split("']['")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[k]
    ref_sharded = params_from_jax(_cfg(ARCHS["deepseek"]), tree)
    return inp, ranks, ref, ref_sharded


def _top(tree):
    return max(float(np.abs(_np(v)).max()) for v in tree.values())


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("key", list(ARCHS))
def test_forward_matches_the_reference(world, key):
    _, ranks, ref, _ = world
    for res in ranks:
        _close(res[key]["logits"], ref[key]["logits"], f"{key} logits")


@pytest.mark.parametrize("key", list(ARCHS))
def test_loss_and_gathered_gradients_match_the_reference(world, key):
    _, ranks, ref, _ = world
    res = ranks[0][key]
    assert res["loss"] == pytest.approx(ref[key]["loss"], rel=1e-5, abs=0)
    want = ref[key]["grads"]
    assert set(res["grads"]) == set(want)
    top = _top(want)
    for n, g in want.items():
        _close(res["grads"][n], _np(g), f"{key} grad {n}", top)


@pytest.mark.parametrize("key", list(ARCHS))
def test_prefill_and_greedy_decode_match_the_reference(world, key):
    _, ranks, ref, _ = world
    res = ranks[0][key]
    np.testing.assert_array_equal(res["greedy"].numpy(), ref[key]["greedy"])
    for i, (got, want) in enumerate(zip(res["decode_logits"],
                                        ref[key]["decode"])):
        _close(got, want, f"{key} decode step {i}")


@pytest.mark.parametrize("key", SLOTTED)
def test_per_slot_prefill_and_decode_match_the_reference(world, key):
    """Two ``write_slots`` groups of different lengths into a
    vector-index cache on the mesh (the SSM state and conv tail by rows,
    the KV cache by rows and stretches of its length), then decode steps
    at each slot's own position, against the reference's engine write and
    ``LM`` on one device."""
    _, ranks, ref, _ = world
    for res in ranks:
        check_slots(res[key]["slots"], ref[key]["slots"], key)


@pytest.mark.parametrize("key", list(ARCHS))
def test_adamw_step_matches_the_reference(world, key):
    inp, ranks, ref, _ = world
    got = ranks[0][key]["train"]["adamw"]["params"]
    want = ref[key]["params"]
    start = inp["models"][key]["state"]
    top = _top(want)
    moved = max(float((want[n] - start[n]).abs().max()) for n in start)
    # the step moves the parameters (lr 1e-4) past the bound
    assert moved > 2 * 1e-5 * top
    assert set(got) == set(want)
    for n, w in want.items():
        _close(got[n], _np(w), f"{key} adamw {n}", top)


def test_deepseek_step_matches_the_references_sharded_run(world):
    """The port's 4-rank AdamW step against the reference's jitted step
    on a (2, 2) mesh of forced host devices, where GSPMD places the
    dispatch buffer experts over ``model`` and capacity over ``data``."""
    _, ranks, _, want = world
    got = ranks[0]["deepseek"]["train"]["adamw"]["params"]
    assert set(got) == set(want)
    top = _top(want)
    for n, w in want.items():
        _close(got[n], _np(w), f"deepseek sharded {n}", top)


@pytest.mark.parametrize("key", MOE)
def test_routing_of_the_global_batch_is_the_references(world, key):
    """Expert ids and ``keep`` bit for bit the reference's routing of the
    whole global batch (the capacity of its T tokens, every slot ranked
    over the global flat order), with some assignments dropped; the
    layer's output the port's one-device layer's, equal on every
    rank."""
    inp, ranks, _, _ = world
    case = inp["models"][key]
    cfg = _cfg(ARCHS[key])
    name = _moe_params(case["state"], cfg)
    x = case["routing"].numpy()
    experts, keep, cap = _reference_routing(
        x, case["state"][f"{name}.moe.router"].numpy(), cfg)
    assert not keep.all() and keep.any()          # some assignments drop
    one = build_model(cfg, "cpu")
    one.load_state_dict(case["state"])
    m = cfg.moe
    with torch.no_grad():
        y, aux = moe_apply(one.get_submodule(name).moe, case["routing"],
                           num_experts=m.num_experts, top_k=m.top_k,
                           capacity_factor=m.capacity_factor)
    for res in ranks:
        r = res[key]["routing"]
        assert r["capacity"] == cap
        np.testing.assert_array_equal(r["experts"].numpy(), experts)
        np.testing.assert_array_equal(r["keep"].numpy(), keep)
        _close(r["y"], _np(y), f"{key} moe output")
        assert r["aux"] == pytest.approx(float(aux), rel=1e-5)


@pytest.mark.parametrize("key", FLASH)
def test_flash_route_matches_the_one_device_flash_route(world, key):
    """Kernel 15's plain version in ``local_map``: on each rank's heads
    (deepseek, vision) or, where the 3 heads do not divide ``model``, on
    each rank's stretch of the query rows against the whole K/V, told
    where its rows start (whisper's causal decoder and non-causal
    encoder, smollm)."""
    inp, ranks, _, _ = world
    case = inp["models"][key]
    cfg = _cfg(case["arch"]).with_(use_flash=True)
    one = build_model(cfg, "cpu")
    one.load_state_dict(case["state"])
    b = {k: torch.from_numpy(v) for k, v in case["batch"].items()
         if k != "labels"}
    with torch.no_grad():
        want, _ = one(b)
    for res in ranks:
        _close(res[key]["flash_logits"], _np(want), f"{key} flash logits")


def test_caches_are_placed_by_the_rules(world):
    """The SSM state's heads and the conv tail's channels over ``model``,
    batch over ``data``; the cross keys by the reference's ``/cross/``
    rule (vision: 16 context positions over ``model``)."""
    _, ranks, _, _ = world
    sh = "(Shard(dim=0), Shard(dim=1))"
    mamba = ranks[0]["mamba2"]["cache_placements"]
    assert mamba["0/ssm/state"] == sh
    assert mamba["0/ssm/conv"] == "(Shard(dim=0), Shard(dim=2))"
    vision = ranks[0]["vision"]["cache_placements"]
    cross = [v for k, v in vision.items() if "/cross/" in k]
    assert cross and set(cross) == {sh}


def test_elastic_restore_gives_each_rank_its_slice(world):
    """A reduced deepseek checkpoint restored onto 2x2: each rank holds
    exactly its ``indices()`` slice of every leaf; the expert banks' 8
    experts split 4 and 4 over ``model``."""
    inp, ranks, _, _ = world
    state = inp["models"]["deepseek"]["state"]
    n = 0
    for res in ranks:
        el = res["elastic"]
        for key, part in el["parts"].items():
            want = state[key][el["slices"][key]]
            np.testing.assert_array_equal(part.numpy(), want.numpy(),
                                          err_msg=key)
            np.testing.assert_array_equal(el["put"][key].numpy(),
                                          want.numpy())
            if key.endswith("moe.w_gate"):
                assert part.shape[0] == state[key].shape[0] // 2
            n += 1
    assert n == 4 * len(state)


def test_no_rank_imported_jax(world):
    _, ranks, _, _ = world
    for res in ranks:
        assert res["jax_loaded"] is False
        assert all(res[k]["jax_loaded"] is False for k in ARCHS)
