"""The port's sharding rules, mesh placement and elastic restore against the
JAX package's.

Every registered architecture at its full config: the port's parameters
and optimizer states (AdamW with float32, bfloat16 and int8 moments, and
Adafactor) on ``meta``, the reference's as ``jax.eval_shape`` stand-ins,
over the four meshes (16x16, 2x16x16, 2x4, 2x2x2; the reference's as
``AbstractMesh``, the port's as virtual meshes naming the CPU).  Each
port leaf's spec and shard shape must equal the reference's on the
stacked leaf with the unit axis dropped; batch and cache specs the same.
``indices()`` and ``elastic_restore`` are held against the reference's
on 8 forced host devices in a subprocess.
"""
import functools
import json
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
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefSharding

import repro.distributed.sharding as RS
from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.train.optimizer import adafactor as ref_adafactor
from repro.train.optimizer import adamw as ref_adamw

import repro_torch.distributed.sharding as S
from repro_torch.checkpoint.checkpointer import save_checkpoint
from repro_torch.checkpoint.reshard import (Sharded, device_put_resharded,
                                            elastic_restore)
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch.mesh import (Mesh, describe, make_production_mesh,
                                     make_test_mesh, virtual_mesh)
from repro_torch.models import build_model
from repro_torch.train.optimizer import adafactor, adamw
from repro_torch.train.train_step import model_params, unit_layout

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
#: (shape, axes) of the reference's production and test meshes
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "2x4", "2x2x2"]
OPTS = ["adamw-float32", "adamw-bfloat16", "adamw-int8", "adafactor"]


def _meshes(shape, axes):
    return AbstractMesh(shape, axes), virtual_mesh(shape, axes, CPU)


def _flat_ref(tree):
    """{path tuple of str: leaf} of a reference tree."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in kp)] = leaf
    return out


def _ref_opt(kind):
    if kind == "adafactor":
        return ref_adafactor(1e-3)
    return ref_adamw(1e-3, moment_dtype=kind.split("-")[1])


def _port_opt(kind):
    if kind == "adafactor":
        return adafactor(1e-3)
    return adamw(1e-3, moment_dtype=kind.split("-")[1])


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    model = ref_build(ref_config(arch))
    params = jax.eval_shape(lambda: model.init(0))
    trees = {"params": params}
    for kind in OPTS:
        trees[kind] = jax.eval_shape(_ref_opt(kind).init, params)
    return trees


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    model = build_model(cfg, "meta")
    params = {n: p.detach() for n, p in model.named_parameters()}
    layout = unit_layout(model)
    trees = {"params": params}
    for kind in OPTS:
        trees[kind] = _port_opt(kind).init(params, layout)
    return cfg, trees


def _expected(ref_spec, ref_shape, port_shape, stacked):
    """The reference's spec and shape with the unit axis dropped, where
    the reference's leaf has one the port's lacks."""
    if stacked and tuple(ref_shape[1:]) == tuple(port_shape):
        return tuple(ref_spec)[1:] if len(ref_spec) else (), \
            tuple(ref_shape[1:])
    assert tuple(ref_shape) == tuple(port_shape)
    return tuple(ref_spec), tuple(ref_shape)


def test_partition_spec_prints_and_compares_as_the_reference():
    P, RP = S.PartitionSpec, jax.sharding.PartitionSpec
    for entries in [(), ("data", None), (("pod", "data"), "model"),
                    (None, "model", None)]:
        assert repr(P(*entries)) == repr(RP(*entries))
        assert P(*entries) == RP(*entries)
    assert P(("data",), None) == P("data", None) == RP(("data",), None)
    assert P("data", None) != P("data") and P() != P(None)
    import pickle
    assert pickle.loads(pickle.dumps(P(("pod", "data"), None))) == \
        P(("pod", "data"), None)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_and_opt_state_specs_equal_the_reference(arch):
    """Every parameter and every optimizer-state leaf of the four
    optimizers, over the four meshes: the port's spec and shard shape are
    the reference's on the stacked leaf, after ``_validate``, with the unit
    axis dropped; every reference leaf is some port leaf's."""
    cfg, port = _port_trees(arch)
    ref = _ref_trees(arch)
    assert REF_ARCHS == ASSIGNED_ARCHS
    for shape, axes in MESHES:
        rmesh, pmesh = _meshes(shape, axes)
        for key in ["params"] + OPTS:
            rflat = _flat_ref(ref[key])
            shardings = dict(S.tree_leaves_with_path(
                S.shard_params(port[key], pmesh, cfg)))
            ref_of = {}        # a stacked leaf serves each of its units
            for path, leaf in S.tree_leaves_with_path(port[key]):
                rpath, stacked = S.reference_path(path, cfg)
                rleaf = rflat[rpath]
                if rpath not in ref_of:
                    rspec = RS._validate(RS.param_spec(rpath, rleaf, rmesh),
                                         rleaf.shape, rmesh)
                    ref_of[rpath] = (rspec, RefSharding(
                        rmesh, rspec).shard_shape(rleaf.shape))
                rspec, rshard = ref_of[rpath]
                want, rshape = _expected(rspec, rleaf.shape, leaf.shape,
                                         stacked)
                got = shardings[path]
                assert tuple(got.spec) == want, (key, path, rpath)
                if tuple(rshape) != tuple(rleaf.shape):    # unit axis
                    rshard = rshard[1:]
                assert got.shard_shape(tuple(leaf.shape)) == tuple(rshard), \
                    (key, path)
            assert set(ref_of) == set(rflat), (key, set(rflat) - set(ref_of))


@pytest.mark.parametrize("mesh", range(4), ids=MESH_IDS)
def test_batch_specs_equal_the_reference(mesh):
    rmesh, pmesh = _meshes(*MESHES[mesh])
    for b in (1, 2, 4, 8, 16, 32, 128, 256, 512):
        batch = {"tokens": torch.empty((b, 16), dtype=torch.int32,
                                       device="meta"),
                 "frames": torch.empty((b, 16, 8), device="meta")}
        ref = RS.shard_batch({k: jax.ShapeDtypeStruct(tuple(v.shape),
                                                      jnp.float32)
                              for k, v in batch.items()}, rmesh, b)
        got = S.shard_batch(batch, pmesh, b)
        assert tuple(S.batch_spec(pmesh, b)) == \
            tuple(RS.batch_spec(rmesh, b))
        for k in batch:
            assert tuple(got[k].spec) == tuple(ref[k].spec), (b, k)


@functools.lru_cache(maxsize=None)
def _caches(arch, batch, seq):
    rcfg, cfg = ref_config(arch), get_config(arch)
    ctx = seq if cfg.encoder_layers else cfg.num_vision_tokens
    rmodel = ref_build(rcfg)
    ref = jax.eval_shape(lambda: rmodel.init_cache(
        batch, max_len=seq, ctx_len=ctx, dtype=jnp.bfloat16))
    port = build_model(cfg, "meta").init_cache(batch, seq, ctx_len=ctx)
    return cfg, ref, port


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_equal_the_reference(arch):
    """Every cache leaf at batch 1 (sequence parallel) and above, over the
    four meshes: the reference's ``cache_spec`` on the stacked leaf with the
    unit axis dropped; every reference leaf is some port leaf's."""
    for batch, seq in ((1, 4096), (8, 2048), (128, 32768), (3, 1024)):
        cfg, ref, port = _caches(arch, batch, seq)
        rflat = _flat_ref(ref)
        for shape, axes in MESHES:
            rmesh, pmesh = _meshes(shape, axes)
            shardings = dict(S.tree_leaves_with_path(
                S.shard_cache(port, pmesh, batch, cfg)))
            ref_of = {}        # a stacked leaf serves each of its units
            for path, leaf in S.tree_leaves_with_path(port):
                rpath, stacked = S._cache_path(path, cfg)
                rleaf = rflat[rpath]
                if rpath not in ref_of:
                    rspec = RS.cache_spec(rpath, rleaf, rmesh, batch)
                    ref_of[rpath] = (rspec, RefSharding(
                        rmesh, rspec).shard_shape(rleaf.shape))
                rspec, rshard = ref_of[rpath]
                want, _ = _expected(rspec, rleaf.shape, leaf.shape, stacked)
                assert tuple(shardings[path].spec) == want, (batch, path)
                if stacked:
                    rshard = rshard[1:]
                assert shardings[path].shard_shape(tuple(leaf.shape)) == \
                    tuple(rshard), (batch, path)
            assert set(ref_of) == set(rflat)


def test_constrain_resolves_as_the_reference(monkeypatch):
    """The spec ``constrain`` resolves equals the one the reference hands
    ``with_sharding_constraint``, for every mesh and a set of axes."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sh: seen.append(sh.spec) or x)
    cases = [("dp", None), ("dp", "model"), (None, "model", None),
             ("pod", "data"), ("model", "dp"), ("seq", "model"), ()]
    for shape, axes in MESHES:
        rmesh, pmesh = _meshes(shape, axes)
        monkeypatch.setattr(RS, "_context_mesh", lambda m=rmesh: m)
        for ax in cases:
            for dims in ((256, 512), (6, 10, 16), (7,)):
                dims = dims[:len(ax)] if ax else dims
                seen.clear()
                RS.constrain(jax.ShapeDtypeStruct(dims, jnp.float32), *ax)
                assert tuple(S.constraint_spec(dims, ax, pmesh)) == \
                    tuple(seen[0]), (shape, ax, dims)


def test_constrain_on_one_device_and_across_devices():
    """No mesh: a no-op.  A virtual mesh naming the tensor's one device:
    the tensor itself.  A virtual mesh naming more than one device still
    raises (it has no ranks to run on).  A distributed mesh (a fake world
    of 4 ranks, ``meta`` parts) redistributes to the resolved spec, the
    gradients' tree to the parameters' specs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import distributed_mesh, fake_world
    x = torch.arange(64.0).reshape(8, 8)
    grads = {"embed": torch.zeros((16, 8)), "layers.0.attn.q":
             torch.zeros((8, 8))}
    cfg = get_config("smollm-360m").reduced()
    assert S.constrain(x, "dp", "model") is x          # no mesh
    with make_test_mesh(device="cpu") as mesh:
        assert S._context_mesh() is mesh
        assert S.constrain(x, "dp", "model") is x
        out = S.constrain_like_params(grads, cfg)
        assert all(out[k] is v for k, v in grads.items())
        with pytest.raises(ValueError, match="meta"):
            S.constrain(x.to("meta"), "dp", None)
    assert S._context_mesh() is None
    devs = np.array([[CPU, torch.device("meta")]] * 2, dtype=object)
    with Mesh(devs, ("data", "model")):
        with pytest.raises(NotImplementedError, match="virtual mesh"):
            S.constrain(x, "dp", "model")
        with pytest.raises(NotImplementedError):
            S.constrain_like_params(grads, cfg)
    with pytest.raises(ValueError, match="config"):
        S.shard_params(grads, make_test_mesh(device="cpu"))
    with fake_world(4):
        mesh = distributed_mesh((2, 2), ("data", "model"))
        assert mesh.distributed and mesh.device == torch.device("meta")
        with mesh:
            y = S.constrain(x.to("meta"), "dp", "model")
            assert isinstance(y, DTensor)
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert tuple(y.to_local().shape) == (4, 4)
            z = S.constrain(y, None, "dp")
            assert tuple(z.placements) == (Shard(1), Replicate())
            assert S.constrain(z, None, "dp") is z       # placed so already
            out = S.constrain_like_params(
                {k: v.to("meta") for k, v in grads.items()}, cfg)
            for k, v in out.items():
                want = S.placements(S.leaf_spec((k,), v.shape, mesh, cfg),
                                    mesh)
                assert list(v.placements) == want, k
            with pytest.raises(ValueError, match="rank's device"):
                S.constrain(x, "dp", None)          # not on the rank's device


def test_meshes_keep_the_reference_shapes():
    import repro.launch.mesh as RM
    for multi in (False, True):
        prod = make_production_mesh(multi_pod=multi)
        test = make_test_mesh(multi_pod=multi, device="cpu")
        assert prod.size == (512 if multi else 256) and test.size == 8
        assert set(prod.devices.flat) == {torch.device("cuda", 0)}
        assert set(test.devices.flat) == {CPU}
        for m, (shape, axes) in ((prod, MESHES[int(multi)]),
                                 (test, MESHES[2 + int(multi)])):
            assert m.axis_names == axes
            assert tuple(m.shape.values()) == shape
            assert describe(m) == RM.describe(AbstractMesh(shape, axes))
            assert list(m.devices.flat) == [m.devices[i] for i in
                                             np.ndindex(shape)]
    assert make_test_mesh(device="cuda").devices.flat[0] == \
        torch.device("cuda", 0)


def _save_port_tree(tmp_path, dtype):
    cfg = get_config("smollm-360m").reduced().with_(param_dtype=dtype)
    model = build_model(cfg, "cpu").init(3)
    params = model_params(model)
    save_checkpoint(str(tmp_path), 5, {"params": params}, extra={"s": 5})
    like = {"params": {n: p.to("meta") for n, p in params.items()}}
    return cfg, params, like


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elastic_restore_of_a_port_checkpoint(tmp_path, dtype):
    """A reduced smollm saved in the port's layout, restored onto the 2x4
    mesh naming the CPU: every leaf's full() bit for bit, each shard the
    slice indices() names, one tensor per distinct slice."""
    cfg, params, like = _save_port_tree(tmp_path, dtype)
    mesh = make_test_mesh(device="cpu")
    placed, extra = elastic_restore(str(tmp_path), 5, like, mesh, cfg)
    assert extra == {"s": 5}
    specs = S.shard_params(like, mesh, cfg)
    for n, p in params.items():
        sh = placed["params"][n]
        assert isinstance(sh, Sharded) and sh.dtype == p.dtype
        assert sh.spec == specs["params"][n].spec
        assert torch.equal(sh.full(), p)
        idx = sh.indices()
        assert len(sh.shards) == mesh.size == len(idx)
        for i, shard in zip(idx, sh.shards):
            assert shard.is_contiguous() and torch.equal(shard, p[i])
        distinct = {tuple((s.start, s.stop) for s in i) for i in idx}
        assert len({id(s) for s in sh.shards}) == len(distinct)
    assert placed["params"]["embed"].spec == S.PartitionSpec(None, "model")
    # the placement alone, from host tensors
    again = device_put_resharded(params, mesh, cfg)
    assert all(torch.equal(again[n].full(), p) for n, p in params.items())


REF_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np, torch
    from repro.checkpoint.checkpointer import save_checkpoint
    from repro.checkpoint.reshard import elastic_restore as ref_restore
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh as ref_mesh
    from repro.models import build_model
    import repro_torch.distributed.sharding as S
    from repro_torch.checkpoint.reshard import elastic_restore
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    out = {"indices": 0, "leaves": 0, "shards": 0}
    # indices() against devices_indices_map
    specs = [(), (None, "model"), ("data", None), ("data", "model"),
             ("model", "data"), (("data", "model"), None),
             (None, ("pod", "data"), "model"), (("pod", "data", "model"),),
             ("pod", None, ("data", "model"))]
    for multi in (False, True):
        rm, pm = ref_mesh(multi_pod=multi), make_test_mesh(multi_pod=multi,
                                                           device="cpu")
        for spec in specs:
            if any(a not in rm.axis_names for e in spec if e is not None
                   for a in (e if isinstance(e, tuple) else (e,))):
                continue
            shape = (8, 16, 24)[:max(len(spec), 1)]
            ref = jax.sharding.NamedSharding(
                rm, jax.sharding.PartitionSpec(*spec))
            m = ref.devices_indices_map(shape)
            want = [m[d] for d in rm.devices.flat]
            got = S.NamedSharding(pm, S.PartitionSpec(*spec)).indices(shape)
            assert got == want, (spec, got, want)
            out["indices"] += 1
    # the reference saves a reduced smollm; both restore onto 2x4
    cfg = get_config("smollm-360m").reduced()
    params = jax.tree.map(np.asarray, build_model(cfg).init(0))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, {"params": params}, extra={"k": 1})
        rtree, rextra = ref_restore(d, 3, {"params": params}, ref_mesh())
        ptree, pextra = elastic_restore(d, 3, {"params": params},
                                        make_test_mesh(device="cpu"))
    assert rextra == pextra == {"k": 1}
    rflat = jax.tree_util.tree_flatten_with_path(rtree)[0]
    for kp, arr in rflat:
        node = ptree
        for k in kp:
            node = node[k.key]
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for dev, shard in zip(ref_mesh().devices.flat, node.shards):
            want = by_dev[dev]
            got = shard.numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, kp
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), kp
            out["shards"] += 1
        assert np.array_equal(node.full().numpy(), np.asarray(arr)), kp
        out["leaves"] += 1
    print("RESULT " + json.dumps(out))
""")


def test_indices_and_elastic_restore_equal_the_reference():
    """In a subprocess with 8 forced host devices: ``indices()`` against
    ``devices_indices_map`` on both test meshes, and a reduced smollm
    checkpoint saved by the reference, restored by the reference's
    ``elastic_restore`` and by the port's onto 2x4 naming the CPU: equal
    shard by shard, bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    res = json.loads(line[len("RESULT "):])
    assert res["indices"] >= 12 and res["leaves"] >= 10
    assert res["shards"] == 8 * res["leaves"]
