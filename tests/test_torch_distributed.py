"""Sharded execution of the port's dense LM on gloo worlds of CPU ranks.

Two worlds of 4 ranks, one spawn each for the module: a 2x2
``(data, model)`` mesh and a 2x1x2 ``(pod, data, model)`` one
(``tests/_torch_dist_worker.py``; every process group times out after
120 s and every rank is joined with a timeout that fails the test).
Reduced smollm (3 heads: the sequence-parallel branch on ``model`` 2) and
reduced stablelm (8 heads: heads-parallel), float32, with the reference's
``init(0)`` weights carried across by ``params_from_jax``, against the
reference's single-device ``LM``:

* forward logits, loss, the gathered gradients, prefill + 4 greedy
  ``decode_step``s, and two ``make_train_step`` steps (AdamW with float32
  and bfloat16 moments, 1 and 2 microbatches; Adafactor) within
  ``1e-5 x max|ref|`` (the parameters' largest over all of them; AdamW at
  a learning rate of 1e-4 and an epsilon of 1e-6, so that the sign-like
  first updates of gradients near zero, where summation order alone
  moves a gradient, move a parameter by far less than the bound),
  greedy tokens equal; int8 moments take one step, their codes within
  one of the reference's;
* on 2x2, the updated parameters against the reference's own jitted step
  on a (2, 2) mesh of 4 forced host devices (in a subprocess, its
  ``in_shardings`` from its ``shard_params``; the mesh's axes automatic,
  as ``jax.make_mesh``'s explicit ones refuse the reference's own
  embedding gather);
* the data ranks' ``GraphCorpusPipeline`` shards are disjoint and their
  union is the one-shard stream; ranks that differ only on ``model``
  read the same shard;
* a checkpoint saved on 2x2 is byte for byte a one-device save of the
  same arrays; ``elastic_restore`` of the reference's checkpoint onto
  2x2 puts on each rank exactly its ``indices()`` slice, equal to the
  reference's shard on the same mesh position;
* the trainer on 2x2 (rank-local batches, a crash and its recovery on
  the same mesh) against the one-device trainer on the global batches;
* heads-parallel stablelm's flash route runs kernel 15 on each rank's
  local heads (``local_map``; its plain version on the CPU) and gives the
  one-device flash route's logits;
* no rank imported JAX.
"""
import json
import os
import socket
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
import repro_torch.checkpoint.checkpointer as TK
import repro_torch.configs as TC
import repro_torch.train.optimizer as TO
from repro.models import build_model as jbuild
from repro.train.train_step import make_train_step as jmake
from repro_torch.models import build_model
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORKER = Path(__file__).with_name("_torch_dist_worker.py")
ARCHS = {"smollm": "smollm-360m", "stablelm": "stablelm-1.6b"}
B, S, PROMPT, DECODE = 4, 16, 12, 4
LR, EPS = 1e-4, 1e-6
#: name -> (moments or "adafactor", learning rate, microbatches, steps)
TRAIN = {"adamw": ("float32", LR, 1, 2), "micro2": ("float32", LR, 2, 2),
         "bf16": ("bfloat16", LR, 1, 2), "int8": ("int8", LR, 1, 1),
         "adafactor": ("adafactor", LR, 1, 2)}
#: what the 2x1x2 world trains (the 2x2 world trains every entry)
TRAIN_POD = ("adamw",)
MESHES = {"2x2": ("2,2", "data,model"), "2x1x2": ("2,1,2", "pod,data,model")}
LAKE = dict(num_docs=1500, vocab=512, mean_len=24, seed=0)
#: ranks join within this many seconds or the test fails
JOIN_S = 600


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what, top=None):
    """Within 1e-5 x max|want| (or x ``top``, the largest of a set)."""
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if top is None else top
    bound = 1e-5 * max(top, 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=bound,
                               err_msg=what)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _jopt(kind, lr):
    return JO.adafactor(lr) if kind == "adafactor" else \
        JO.adamw(lr, eps=EPS, moment_dtype=kind)


# ------------------------------------------------------------- references

@pytest.fixture(scope="module")
def ref():
    """The reference's single-device results of every case."""
    out = {}
    for key, arch in ARCHS.items():
        cfg = JC.get_config(arch).reduced()
        jm = jbuild(cfg)
        jp = jm.init(0)
        b = _batch(cfg, 1)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        logits, _ = jax.jit(jm.apply)(jp, jb)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(jp, jb)
        cache = jm.init_cache(B, max_len=PROMPT + DECODE, dtype=jnp.float32)
        lg, cache = jax.jit(jm.prefill)(
            jp, {"tokens": jb["tokens"][:, :PROMPT]}, cache)
        steps, toks = [np.asarray(lg)], []
        decode = jax.jit(jm.decode_step)
        for _ in range(DECODE):
            tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok))
            lg, cache = decode(jp, tok, cache)
            steps.append(np.asarray(lg))
        tcfg = TC.get_config(arch).reduced()
        sd = lambda tree: params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                             tree))
        train = {}
        for name, (kind, lr, n_micro, n_steps) in TRAIN.items():
            opt = _jopt(kind, lr)
            step = jax.jit(jmake(jm, opt, n_micro))
            p, st, mets = jp, opt.init(jp), []
            for _ in range(n_steps):
                p, st, m = step(p, st, jb)
                mets.append({k: float(v) for k, v in m.items()})
            train[name] = {"params": sd(p), "metrics": mets, "state": st}
        out[key] = {"state": sd(jp), "batch": b, "logits": np.asarray(logits),
                    "loss": float(loss), "grads": sd(grads),
                    "decode": steps, "greedy": np.concatenate(toks, 1),
                    "train": train, "cfg": tcfg}
    return out


REF_SHARDED = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    import repro.train.optimizer as O
    from repro.checkpoint.checkpointer import save_checkpoint
    from repro.checkpoint.reshard import elastic_restore
    from repro.configs import get_config
    from repro.distributed.sharding import shard_batch, shard_params
    from repro.models import build_model
    from repro.train.train_step import make_train_step
    out_dir, B, S, lr = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
        float(sys.argv[4])
    # GSPMD's automatic axes (jax.make_mesh's default explicit axes
    # refuse the reference's own gathers)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    order = [int(d.id) for d in mesh.devices.flat]
    for key, arch in json.loads(sys.argv[5]).items():
        cfg = get_config(arch).reduced()
        m = build_model(cfg)
        p = m.init(0)
        rng = np.random.default_rng(1)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        opt = O.adamw(lr, eps=float(sys.argv[6]))
        st = opt.init(p)
        psh, ssh = shard_params(p, mesh), shard_params(st, mesh)
        bsh = shard_batch(b, mesh, B)
        p, st = jax.device_put(p, psh), jax.device_put(st, ssh)
        b = jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, bsh)
        step = jax.jit(make_train_step(m, opt, 1),
                       in_shardings=(psh, ssh, bsh))
        with mesh:
            for _ in range(2):
                p, st, met = step(p, st, b)
        flat = jax.tree_util.tree_flatten_with_path(p)[0]
        np.savez(os.path.join(out_dir, key + ".npz"),
                 **{jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat})
    # the reference saves reduced smollm and restores it onto the mesh
    cfg = get_config("smollm-360m").reduced()
    params = jax.tree.map(np.asarray, build_model(cfg).init(0))
    ck = os.path.join(out_dir, "ckpt")
    save_checkpoint(ck, 3, {"params": params}, extra={"k": 1})
    tree, _ = elastic_restore(ck, 3, {"params": params}, mesh)
    shards = {}
    for kp, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) for k in kp)
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for pos, dev in enumerate(order):
            shards[f"{key}@{pos}"] = by_dev[dev]
    np.savez(os.path.join(out_dir, "elastic.npz"), **shards)
    print("RESULT ok")
""")


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's jitted AdamW step on a (2, 2) mesh of 4 forced host
    devices, and its checkpoint restored there by its ``elastic_restore``
    (each shard by mesh position)."""
    d = tmp_path_factory.mktemp("ref_sharded")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", REF_SHARDED, str(d), str(B), str(S), str(LR),
         json.dumps(ARCHS), str(EPS)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0 and "RESULT ok" in proc.stdout, \
        proc.stderr[-3000:]
    out = {"dir": d, "elastic": dict(np.load(d / "elastic.npz"))}
    for key, arch in ARCHS.items():
        z = np.load(d / f"{key}.npz")
        tree = {}
        for k in z.files:        # "['units']['l0']['attn']['q']" -> nested
            node, parts = tree, [p.strip("'") for p in k[2:-2].split("']['")]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
        out[key] = params_from_jax(TC.get_config(arch).reduced(), tree)
    return out


# ----------------------------------------------------------------- worlds

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(root: Path, mesh: str, world: int = 4):
    """Run the worker as ``world`` ranks of a gloo world on ``mesh``;
    every rank must exit 0 within ``JOIN_S`` seconds.  Returns each
    rank's results."""
    shape, axes = MESHES[mesh]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    port = _free_port()
    procs = []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(port),
             str(root), shape, axes], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the {mesh} world did not finish in {JOIN_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()[-4000:]
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _inputs(ref, root: Path, mesh: str, ref_dir=None):
    models = {}
    for key in ARCHS:
        r = ref[key]
        train = {n: TRAIN[n] for n in (TRAIN if mesh == "2x2" else TRAIN_POD)}
        models[key] = {"arch": ARCHS[key], "state": r["state"],
                       "batch": r["batch"], "prompt": PROMPT,
                       "decode": DECODE, "train": train, "eps": EPS,
                       "flash": key == "stablelm"}
    inp = {"models": models, "pipeline": {"lake": LAKE}}
    if mesh == "2x2":
        models["smollm"].update(checkpoint="adamw",
                                ckpt_dir=str(root / "ckpt_mesh"))
        import jax as _jax
        from repro.models import build_model as _jb
        cfg = JC.get_config("smollm-360m").reduced()
        like = _jax.tree.map(np.asarray, _jb(cfg).init(0))
        inp["elastic"] = {"dir": str(ref_dir / "ckpt"), "step": 3,
                          "like": {"params": like}}
        rng = np.random.default_rng(5)
        v = TC.get_config("smollm-360m").reduced().vocab_size
        inp["trainer"] = {
            "tokens": rng.integers(0, v, (4, B, S)).astype(np.int32),
            "labels": rng.integers(0, v, (4, B, S)).astype(np.int32),
            "config": dict(total_steps=4, checkpoint_every=2, log_every=1,
                           checkpoint_dir=str(root / "trainer_ckpt")),
            "fail_at": 3, "lr": LR, "eps": EPS}
    torch.save(inp, root / "inputs.pt")
    return inp


@pytest.fixture(scope="module")
def world22(ref, ref_sharded, tmp_path_factory):
    root = tmp_path_factory.mktemp("world22")
    inp = _inputs(ref, root, "2x2", ref_sharded["dir"])
    return inp, spawn(root, "2x2"), root


@pytest.fixture(scope="module")
def world212(ref, tmp_path_factory):
    root = tmp_path_factory.mktemp("world212")
    inp = _inputs(ref, root, "2x1x2")
    return inp, spawn(root, "2x1x2"), root


@pytest.fixture(params=list(MESHES))
def world(request):
    return request.param, request.getfixturevalue(
        "world22" if request.param == "2x2" else "world212")


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("key", list(ARCHS))
def test_forward_matches_the_reference(world, ref, key):
    _, (_, ranks, _) = world
    for res in ranks:
        _close(res[key]["logits"], ref[key]["logits"], f"{key} logits")


def test_flash_route_runs_on_the_local_heads(world, ref):
    """Heads-parallel stablelm with ``use_flash``: kernel 15 (its plain
    version here) on each rank's local heads through ``local_map``, equal
    to the port's one-device flash route."""
    _, (_, ranks, _) = world
    cfg = ref["stablelm"]["cfg"].with_(use_flash=True)
    one = build_model(cfg, "cpu")
    one.load_state_dict(ref["stablelm"]["state"])
    with torch.no_grad():
        want, _ = one({"tokens": torch.from_numpy(
            ref["stablelm"]["batch"]["tokens"])})
    for res in ranks:
        _close(res["stablelm"]["flash_logits"], _np(want), "flash logits")


@pytest.mark.parametrize("key", list(ARCHS))
def test_loss_and_gathered_gradients_match_the_reference(world, ref, key):
    _, (_, ranks, _) = world
    res = ranks[0][key]
    assert res["loss"] == pytest.approx(ref[key]["loss"], rel=1e-5, abs=0)
    want = ref[key]["grads"]
    assert set(res["grads"]) == set(want)
    for n, g in want.items():
        _close(res["grads"][n], g.float().numpy(), f"{key} grad {n}")


@pytest.mark.parametrize("key", list(ARCHS))
def test_prefill_and_greedy_decode_match_the_reference(world, ref, key):
    _, (_, ranks, _) = world
    res = ranks[0][key]
    np.testing.assert_array_equal(res["greedy"].numpy(), ref[key]["greedy"])
    for i, (got, want) in enumerate(zip(res["decode_logits"],
                                        ref[key]["decode"])):
        _close(got, want, f"{key} decode step {i}")


@pytest.mark.parametrize(
    "world,name", [(m, n) for m in MESHES
                   for n in (TRAIN if m == "2x2" else TRAIN_POD)],
    indirect=["world"])
@pytest.mark.parametrize("key", list(ARCHS))
def test_train_steps_match_the_reference(world, ref, key, name):
    _, (_, ranks, _) = world
    got, want = ranks[0][key]["train"][name], ref[key]["train"][name]
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    start = ref[key]["state"]
    moved = max(float((want["params"][n] - start[n]).abs().max())
                for n in start)
    top = max(float(v.abs().max()) for v in want["params"].values())
    assert moved > 10 * 1e-5 * top      # the steps move the parameters
    for n, w in want["params"].items():
        _close(got["params"][n], w.numpy(), f"{key} {name} {n}", top)
    if name == "int8":              # one step: codes within one
        st = opt_state_from_jax(ref[key]["cfg"], jax.tree.map(
            np.asarray, want["state"]), "adamw")
        for mom in ("m", "v"):
            for n, q in st[mom].items():
                g = got["state"][mom][n]
                diff = (g["q"].int() - q["q"].int()).abs().max()
                assert int(diff) <= 1, (mom, n)
                _close(g["scale"], q["scale"].numpy(), f"{mom} {n} scale")


@pytest.mark.parametrize("key", list(ARCHS))
def test_every_rank_holds_the_same_global_values(world, key):
    _, (_, ranks, _) = world
    for res in ranks[1:]:
        assert torch.equal(res[key]["logits"], ranks[0][key]["logits"])
        assert res[key]["loss"] == ranks[0][key]["loss"]
        for n, p in ranks[0][key]["train"]["adamw"]["params"].items():
            assert torch.equal(res[key]["train"]["adamw"]["params"][n], p)


def test_parameters_and_cache_are_placed_by_the_rules(world):
    """A projection is split over the data axes (FSDP) and ``model``
    (TP); the embedding's d_model over ``model``; a norm replicated; the
    KV cache's batch over the data axes and its length over ``model``."""
    mesh, (_, ranks, _) = world
    pl = ranks[0]["smollm"]["placements"]
    assert pl["layers.0.attn.q"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["layers.0.attn.o"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["embed"] == "(Replicate(), Shard(dim=1))"
    assert pl["layers.0.ln1.scale"] == "(Replicate(), Replicate())"
    assert ranks[0]["smollm"]["cache_placements"]["0/kv/k"] == \
        "(Shard(dim=0), Shard(dim=1))"


def test_updated_params_match_the_references_sharded_run(world22,
                                                         ref_sharded):
    """The port's 4-rank AdamW steps against the reference's jitted steps
    on a (2, 2) mesh of forced host devices."""
    _, ranks, _ = world22
    for key in ARCHS:
        want = ref_sharded[key]
        got = ranks[0][key]["train"]["adamw"]["params"]
        assert set(got) == set(want)
        top = max(float(w.abs().max()) for w in want.values())
        for n, w in want.items():
            _close(got[n], w.float().numpy(), f"{key} sharded {n}", top)


def test_checkpoint_on_the_mesh_is_a_one_device_save(world22, tmp_path):
    """Saved on 2x2 by every rank (rank 0 writing): the shard files are
    byte for byte a one-device save of the gathered arrays, and the
    manifests equal but for ``created``; ``process_index`` is the
    writer's rank, 0."""
    _, ranks, root = world22
    res = ranks[0]["smollm"]["train"]["adamw"]
    one = TK.save_checkpoint(str(tmp_path), 2, {"params": res["params"],
                                                "opt": res["state"]},
                             extra={"next_step": 2})
    mesh = root / "ckpt_mesh" / "step_00000002"
    a = json.loads((mesh / "manifest.json").read_text())
    b = json.loads((Path(one) / "manifest.json").read_text())
    a.pop("created")
    b.pop("created")
    assert a == b
    assert {leaf["process_index"] for leaf in a["leaves"]} == {0}
    for leaf in a["leaves"]:
        assert (mesh / leaf["file"]).read_bytes() == \
            (Path(one) / leaf["file"]).read_bytes(), leaf["path"]
    assert not list((root / "ckpt_mesh").glob("*.tmp"))


def test_elastic_restore_gives_each_rank_its_slice(world22, ref_sharded):
    """Each rank holds exactly its ``indices()`` slice of every leaf,
    bit for bit the reference's shard at the same mesh position; the
    host tree placed by ``device_put_resharded`` alike."""
    inp, ranks, _ = world22
    like = inp["elastic"]["like"]
    ref_shards = ref_sharded["elastic"]
    n = 0
    for pos, res in enumerate(ranks):
        el = res["elastic"]
        assert el["extra"] == {"k": 1}
        for key, part in el["parts"].items():
            node = like
            for k in key.split("/"):
                node = node[k]
            want = np.asarray(node)[el["slices"][key]]
            np.testing.assert_array_equal(part.numpy(), want, err_msg=key)
            np.testing.assert_array_equal(part.numpy(),
                                          ref_shards[f"{key}@{pos}"])
            np.testing.assert_array_equal(el["put"][key].numpy(), want)
            n += 1
    assert n == 4 * len(ranks[0]["elastic"]["parts"]) and n > 40


def test_pipeline_shards_are_disjoint_and_cover_the_stream(world):
    """The data ranks' eligible documents are disjoint, their union the
    one-shard pipeline's; ranks that differ only on ``model`` read the
    same shard; the global batch stacks the data ranks' local ones."""
    import repro_torch.core as C
    from repro_torch.data.pipeline import GraphCorpusPipeline, PipelineConfig
    from repro_torch.data.synthetic import document_graph
    _, (_, ranks, _) = world
    lake = document_graph(**LAKE)
    b = C.GraphArBuilder("corpus")
    b.add_vertices(
        C.VertexTypeSchema("doc", [C.PropertySchema("tokens", "tokens")],
                           labels=list(lake.labels), page_size=128),
        {"tokens": lake.tokens}, lake.labels)
    b.add_edges(C.EdgeTypeSchema("doc", "links", "doc", page_size=128),
                lake.links_src, lake.links_dst)
    one = GraphCorpusPipeline(
        b.build(), (C.L("HighQuality") | C.L("News")) & ~C.L("Spam"),
        PipelineConfig(seq_len=32, batch_size=2), engine="torch")
    by_shard = {}
    for res in ranks:
        sid, n = res["pipeline"]["shard"]
        assert n == 2
        if sid in by_shard:
            np.testing.assert_array_equal(by_shard[sid]["eligible"],
                                          res["pipeline"]["eligible"])
        by_shard[sid] = res["pipeline"]
    assert sorted(by_shard) == [0, 1]
    a, b2 = by_shard[0]["eligible"], by_shard[1]["eligible"]
    assert not set(a.tolist()) & set(b2.tolist())
    np.testing.assert_array_equal(np.sort(np.concatenate([a, b2])),
                                  np.sort(one.eligible))
    glob = np.concatenate([by_shard[0]["tokens"], by_shard[1]["tokens"]])
    for res in ranks:
        assert res["pipeline"]["global_shape"] == glob.shape
        np.testing.assert_array_equal(res["pipeline"]["global"].numpy(),
                                      glob)


def test_trainer_on_the_mesh_matches_one_device(world22, tmp_path):
    """4 steps, checkpoints every 2, a crash at 3 restored on the same
    mesh: the history and final parameters of the one-device trainer on
    the global batches."""
    inp, ranks, _ = world22
    case = inp["trainer"]
    cfg = TC.get_config("smollm-360m").reduced()
    conf = dict(case["config"], checkpoint_dir=str(tmp_path / "one"))
    out = Trainer(build_model(cfg, "cpu"), TO.adamw(LR, eps=EPS),
                  TrainerConfig(**conf),
                  lambda s: {"tokens": case["tokens"][s],
                             "labels": case["labels"][s]}).run(
        simulate_failure_at=case["fail_at"])
    for res in ranks:
        tr = res["trainer"]
        assert tr["failures"] == out["failures"] == 1
        assert tr["final_step"] == out["final_step"] == 4
        # steps 1-4 and the replay of 3 after the restore from step 2
        assert len(tr["history"]) == len(out["history"]) == 5
        for g, h in zip(tr["history"], out["history"]):
            assert g == pytest.approx(h["loss"], rel=1e-5)
        top = max(float(p.abs().max()) for p in out["params"].values())
        for n, p in out["params"].items():
            _close(tr["params"][n], _np(p), f"trainer {n}", top)


def test_no_rank_imported_jax(world):
    _, (_, ranks, _) = world
    for res in ranks:
        assert res["jax_loaded"] is False
        assert res["smollm"]["jax_loaded"] is False


def test_rank_coordinates_follow_the_mesh_order(world):
    mesh, (_, ranks, _) = world
    axes = MESHES[mesh][1].split(",")
    shape = [int(x) for x in MESHES[mesh][0].split(",")]
    for r, res in enumerate(ranks):
        want = dict(zip(axes, (int(c) for c in np.unravel_index(r, shape))))
        assert res["coordinate"] == want
