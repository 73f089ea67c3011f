"""The dry-run's cells traced on a fake world, and the distributed mesh's
constraints on it, in one process.

The reference's four small cells (``test_dryrun_small.py``: smollm
``train_4k`` on 2x4 and on 2x2x2 with ``pod``, mamba2 ``decode_32k``,
whisper ``prefill_32k``) each traced twice: on the virtual mesh (the
global trace over the mesh's entries, no collective) and as rank 0 of a
fake world of the mesh's 8 ranks, its inputs DTensors over ``meta``
parts.  On the fake world:

* the sharded train cells issue collectives, all-gathers and
  reduce-scatters among them, and price them (``coll_count > 0``,
  ``t_collective > 0``): the reference's
  ``test_collectives_present_on_sharded_train`` assertion (the reference's
  own test fails on a CPU-only host: its dry-run subprocess expects a TPU
  pod's devices);
* per-device bytes come from the local trace: above nothing, below the
  global trace's;
* argument bytes are the virtual row's, and the model FLOPs;
* nothing is allocated on any device (every tensor an op makes is on
  ``meta``, host scalars aside);
* a world of one rank gives the virtual one-device row's FLOPs, argument
  bytes and no collective (its bytes within the DTensor layer's own
  copies, 5%).

Also: the fake world's fallback when PyTorch's testing module is absent,
the flash route's sequence-parallel branch where the heads do not divide
``model``, every assigned architecture traced on a fake world, and the
CLI's MoE and vision cells as fake worlds' rows with collectives.
"""
import sys

import pytest
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import (distributed_mesh, fake_world,
                                     make_test_mesh, virtual_mesh)
from repro_torch.launch.shapes import ShapeDef
from repro_torch.models import build_model
from repro_torch.models.model import shard_model

torch.set_num_threads(1)

SMALL_CELLS = [("smollm-360m", "train_4k", False),
               ("mamba2-2.7b", "decode_32k", False),
               ("whisper-small", "prefill_32k", False),
               ("smollm-360m", "train_4k", True)]
TRAIN_CELLS = [0, 3]


class _Devices(torch.utils._python_dispatch.TorchDispatchMode):
    """Every device an op's outputs land on (meta, or a host scalar); an
    op on DTensors is left to DTensor, whose local ops come back here, and
    its shape propagation on fake tensors (no storage) is not looked at."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                self.seen.add("meta" if t.device.type == "meta" else
                              f"{t.device.type} {t.dtype} numel {t.numel()}")
        return out


@pytest.fixture(scope="module")
def rows():
    out = []
    for arch, shape, multi in SMALL_CELLS:
        virtual = DR.run_cell(arch, shape, multi, mesh_factory=make_test_mesh)
        with _Devices() as devs:
            fake = DR.run_cell(arch, shape, multi,
                               mesh_factory=make_test_mesh, fake=True)
        out.append((virtual, fake, devs.seen))
    return out


@pytest.mark.parametrize("cell", range(len(SMALL_CELLS)))
def test_fake_world_rows_are_ok_and_say_so(rows, cell):
    virtual, fake, _ = rows[cell]
    assert fake["status"] == "ok", fake
    assert fake["chips"] == virtual["chips"] == 8
    assert fake["mesh"] == virtual["mesh"]
    assert fake["per_device"] == DR.PER_DEVICE_FAKE.format(8)
    assert fake["collectives"] == DR.FAKE_COLLECTIVES.format(8)
    assert fake["model_flops"] == virtual["model_flops"]
    assert fake["t_compute_s"] > 0 and fake["t_memory_s"] > 0


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_sharded_train_cells_issue_and_price_collectives(rows, cell):
    _, fake, _ = rows[cell]
    assert fake["coll_count"] > 0
    assert fake["t_collective_s"] > 0
    assert fake["coll_by_op"].get("all-gather", 0) > 0
    assert fake["coll_by_op"].get("reduce-scatter", 0) > 0
    # the test mesh lies in one node: every byte goes over NVLink
    assert fake["coll_ici_bytes"] > 0 and fake["coll_dcn_bytes"] == 0


@pytest.mark.parametrize("cell", range(len(SMALL_CELLS)))
def test_per_device_bytes_come_from_the_local_trace(rows, cell):
    virtual, fake, _ = rows[cell]
    # a row's bytes a device are its memory term times the HBM rate
    global_bytes = virtual["t_memory_s"] * virtual["chips"]
    assert 0 < fake["t_memory_s"] < global_bytes
    assert 0 < fake["hlo_flops_per_dev"] < \
        virtual["hlo_flops_per_dev"] * virtual["chips"]


@pytest.mark.parametrize("cell", range(len(SMALL_CELLS)))
def test_argument_bytes_are_unchanged(rows, cell):
    virtual, fake, _ = rows[cell]
    assert fake["memory"] == virtual["memory"]


@pytest.mark.parametrize("cell", range(len(SMALL_CELLS)))
def test_the_fake_world_allocates_nothing(rows, cell):
    """Every tensor the step makes is on ``meta``; on the host there are
    scalars and the integer or boolean index tensors of DTensor's own
    bookkeeping (the mesh's rank grid, a placement's shard offsets), never
    a value tensor."""
    _, _, seen = rows[cell]
    assert "meta" in seen
    host = [s for s in seen if s != "meta"]
    assert all(s.startswith("cpu ") for s in host), host
    values = [s for s in host if not s.endswith(" numel 1")
              and "int" not in s and "bool" not in s]
    assert not values, values


@pytest.mark.parametrize("kind,seq,batch", [("train", 512, 8),
                                            ("decode", 1024, 4),
                                            ("prefill", 512, 2)])
def test_one_rank_world_gives_the_virtual_row(kind, seq, batch):
    cfg = get_config("smollm-360m").with_(n_units=2)
    shape = ShapeDef(kind, kind, seq, batch)
    v = DR.roofline_row("smollm-360m", cfg, shape,
                        virtual_mesh((1, 1), ("data", "model"), "cpu"), "1x1")
    with fake_world(1):
        f = DR.roofline_row("smollm-360m", cfg, shape,
                            distributed_mesh((1, 1), ("data", "model")), "1x1")
    for key in ("hlo_flops_per_dev", "model_flops", "coll_count",
                "t_collective_s", "memory", "t_compute_s"):
        assert f[key] == v[key], key
    assert f["t_memory_s"] == pytest.approx(v["t_memory_s"], rel=0.05)


def test_fake_world_without_the_testing_module(monkeypatch):
    """Where ``torch.testing._internal.distributed.fake_pg`` is absent the
    port registers the same C++ fake group itself."""
    from repro_torch.distributed.sharding import constrain
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with fake_world(4):
        mesh = distributed_mesh((2, 2), ("data", "model"))
        with mesh:
            y = constrain(torch.empty(8, 8, device="meta"), "dp", "model")
    assert tuple(y.to_local().shape) == (4, 4)


def test_flash_route_runs_sequence_parallel_where_heads_do_not_divide():
    """Reduced smollm has 3 heads: on ``model`` 2 the flash route runs
    sequence-parallel, each rank's 8 query rows of 16 through the route's
    ``mha`` (its plain version here: the kernel's wrapper raises on
    ``meta``) against the whole K/V, told where its rows start, and the
    logits come back whole."""
    from repro_torch.kernels.flash_attention import ops as FO
    cfg = get_config("smollm-360m").reduced().with_(use_flash=True)
    mha, calls = FO.mha, []

    def plain(q, k, v, causal=True, use_kernel=True, q_start=0):
        calls.append((tuple(q.shape), tuple(k.shape), causal, q_start))
        return mha(q, k, v, causal=causal, use_kernel=False,
                   q_start=q_start)

    with fake_world(4), pytest.MonkeyPatch.context() as mp:
        mp.setattr(FO, "mha", plain)
        mesh = distributed_mesh((2, 2), ("data", "model"))
        model = shard_model(build_model(cfg, "meta"), mesh)
        tokens = torch.zeros((2, 16), dtype=torch.int32, device="meta")
        with mesh, torch.no_grad():
            logits, _ = model({"tokens": tokens})
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    # rank 0 of the fake world: its batch row's first 8 query rows of 16
    # (3 heads) over all 16 keys (1 KV head), once a layer
    assert calls == [((1, 3, 8, 32), (1, 1, 16, 32), True, 0)] * \
        cfg.num_layers


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_arch_traces_on_a_fake_world(arch):
    """Every assigned architecture, MoE and vision context included, runs
    on a distributed mesh: one unit of its reduced config traced as a
    train step on a fake world of 2 x 2, a fake world's ``ok`` row with
    collectives."""
    cfg = get_config(arch).reduced()
    cfg = cfg.with_(n_units=1,
                    window_pattern=cfg.window_pattern[:cfg.unit_size])
    with fake_world(4):
        row = DR.roofline_row(arch, cfg, ShapeDef("train", "train", 32, 4),
                              distributed_mesh((2, 2), ("data", "model")),
                              "2x2")
    assert row["status"] == "ok", row
    assert row["per_device"] == DR.PER_DEVICE_FAKE.format(4)
    assert row["coll_count"] > 0 and row["t_collective_s"] > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama-3.2-vision-11b"])
def test_the_cli_gives_the_fake_worlds_row_with_collectives(arch, tmp_path):
    """The CLI's cell of a MoE or a vision model is the fake world's
    ``ok`` row on 16x16, with the collectives its rank 0 issues (the MoE
    dispatch's gather among them), no longer the virtual mesh's."""
    import json
    report = tmp_path / "report.json"
    DR.main(["--arch", arch, "--shape", "decode_32k", "--mesh", "single",
             "--report", str(report)])
    (row,) = json.loads(report.read_text())
    assert row["status"] == "ok", row
    assert row["per_device"] == DR.PER_DEVICE_FAKE.format(256)
    assert row["collectives"] == DR.FAKE_COLLECTIVES.format(256)
    assert row["coll_count"] > 0 and row["t_collective_s"] > 0
    assert row["t_memory_s"] > 0
