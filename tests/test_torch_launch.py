"""The port's launch layer against the JAX package's: shapes, the roofline's
analytic counts, the memory floor, the collective summation, the dry-run
on ``meta`` and the serve and train CLIs.

The reference's dry-run compiles on forced host devices and prices TPU
constants; the port traces on ``meta`` and prices one H100's.  What must
agree is what both compute from the config alone (shapes, dtypes, active
parameters, model FLOPs, the analytic floor) and the collective
summation; the port's rows are held to their own contract (``ok``, both
terms positive, the model FLOPs equal to the reference's, no collective
on a virtual mesh, nothing allocated).
"""
import re
import sys
from pathlib import Path

import jax
import pytest
import torch

import repro.launch.report as RR
import repro.launch.roofline as RF
import repro.launch.shapes as RSH
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build

import repro_torch.launch.dryrun as DR
import repro_torch.launch.report as PR
import repro_torch.launch.roofline as PF
import repro_torch.launch.shapes as PSH
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.distributed.sharding import (_cache_path,
                                              tree_leaves_with_path)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
KINDS = ("train", "prefill", "decode")
#: the four cells of the reference's ``tests/test_dryrun_small.py``
SMALL_CELLS = [("smollm-360m", "train_4k", False),
               ("mamba2-2.7b", "decode_32k", False),
               ("whisper-small", "prefill_32k", False),
               ("smollm-360m", "train_4k", True)]


def test_shapes_equal_the_reference():
    assert {k: (v.name, v.kind, v.seq, v.batch)
            for k, v in PSH.SHAPES.items()} == \
        {k: (v.name, v.kind, v.seq, v.batch) for k, v in RSH.SHAPES.items()}
    for arch in ASSIGNED_ARCHS:
        assert PSH.supported_shapes(get_config(arch)) == \
            RSH.supported_shapes(ref_config(arch))


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_and_cache_specs_have_the_reference_shapes(arch):
    """Every supported shape: the batch's shapes and dtypes, and every
    cache leaf's (the unit axis of a stacked leaf dropped), on ``meta``."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    model = build_model(cfg, "meta")
    rmodel = ref_build(rcfg)
    for name in PSH.supported_shapes(cfg):
        shape, rshape = PSH.SHAPES[name], RSH.SHAPES[name]
        for labels in (True, False):
            got = PSH.batch_specs(cfg, shape, labels)
            want = RSH.batch_specs(rcfg, rshape, labels)
            assert set(got) == set(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[k].shape
                assert _dtype(t.dtype) == str(want[k].dtype)
        if shape.kind == "train":
            continue
        cache = PSH.cache_specs(model, cfg, shape)
        ref = RSH.cache_specs(rmodel, rcfg, rshape)
        rflat = {tuple(str(getattr(k, "key", k)) for k in kp): leaf
                 for kp, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
        seen = set()
        for path, leaf in tree_leaves_with_path(cache):
            rpath, stacked = _cache_path(path, cfg)
            rleaf = rflat[rpath]
            seen.add(rpath)
            want = rleaf.shape[1:] if stacked else rleaf.shape
            assert tuple(leaf.shape) == tuple(want), (name, path)
            assert _dtype(leaf.dtype) == str(rleaf.dtype), (name, path)
            # only the scalar index lives on the host
            assert leaf.device.type == "meta" or leaf.dim() == 0
        assert seen == set(rflat)
    with pytest.raises(ValueError, match="meta"):
        PSH.cache_specs(build_model(cfg.reduced(), "cpu"), cfg.reduced(),
                        PSH.SHAPES["decode_32k"])


def test_active_params_and_model_flops_equal_the_reference():
    for arch in ASSIGNED_ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert PF.active_params(cfg) == RF.active_params(rcfg), arch
        for kind in KINDS:
            for b, s in ((256, 4096), (32, 32768), (1, 524288)):
                assert PF.model_flops(cfg, kind, b, s) == \
                    RF.model_flops(rcfg, kind, b, s), (arch, kind)


@pytest.mark.parametrize("chips,multi", [(256, False), (512, True)])
def test_analytic_memory_floor_equals_the_reference(chips, multi):
    """Every architecture and supported shape: the bytes equal the
    reference's exactly; only the fit flag is the card's."""
    n = 0
    for arch in ASSIGNED_ARCHS:
        for shape in PSH.supported_shapes(get_config(arch)):
            got = PR.analytic_memory_floor(arch, shape, chips, multi)
            want = RR.analytic_memory_floor(arch, shape, chips, multi)
            assert got.pop("fits_floor_h100_80gb") == \
                (want["floor_bytes"] <= PF.HBM_BYTES)
            want.pop("fits_floor_16gb")
            assert got == want, (arch, shape)
            n += 1
    assert n >= 30
    # the reference's own two cases (test_dryrun_small.py:96) fit the card
    for arch, shape in (("jamba-1.5-large-398b", "train_4k"),
                        ("mistral-large-123b", "decode_32k")):
        floor = PR.analytic_memory_floor(arch, shape, 256, False)
        assert floor["fits_floor_h100_80gb"] and \
            floor["floor_bytes"] == RR.analytic_memory_floor(
                arch, shape, 256, False)["floor_bytes"]


def test_parse_collectives_equals_the_reference_on_records():
    """The reference's HLO case (``test_dryrun_small.py:82``) as records:
    the same counts and bytes."""
    hlo = """
    %all-reduce.1 = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}} , to_apply=%add
    %all-gather.2 = bf16[64]{0} all-gather(%y), replica_groups={{0,256}} , dimensions={0}
    %dot.3 = f32[8,8]{1,0} dot(%a, %b)
    """
    ref = RF.parse_collectives(hlo, chips_per_pod=256)
    records = [("all-reduce", 128 * 256 * 4, (0, 1, 2, 3)),
               ("all-gather", 64 * 2, (0, 256)),
               ("dot", 8 * 8 * 4, (0,))]
    got = PF.parse_collectives(records, chips_per_node=256)
    assert (got.count, got.ici_bytes, got.dcn_bytes, got.by_op) == \
        (ref.count, ref.ici_bytes, ref.dcn_bytes, ref.by_op)
    # the card's node of 8: the same group {0..3} stays inside, {0, 256}
    # crosses; a record of no bytes counts nothing
    got8 = PF.parse_collectives(records + [("all-to-all", 0, (0, 9))])
    assert (got8.ici_bytes, got8.dcn_bytes, got8.count) == \
        (128 * 256 * 4, 64 * 2, 2)


def test_trace_counter_records_collectives(tmp_path):
    """A gloo process group of one rank: the dispatch mode records the
    c10d and functional collectives a step issues, with their ranks."""
    import socket

    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(4, 8)
        with DR.TraceCounter() as tc:
            dist.all_reduce(x)
            out = [torch.empty(4, 8)]
            dist.all_gather(out, x)
            fc.all_reduce(x, "sum", dist.group.WORLD).wait()
    finally:
        dist.destroy_process_group()
    assert [r[0] for r in tc.records] == ["all-reduce", "all-gather",
                                          "all-reduce"]
    assert all(r[1] == 4 * 8 * 4 and list(r[2]) == [0] for r in tc.records)
    stats = PF.parse_collectives(tc.records)
    assert stats.count == 3 and stats.ici_bytes == 3 * 128 and \
        stats.dcn_bytes == 0


class _Devices(torch.utils._python_dispatch.TorchDispatchMode):
    """Every device an op's outputs land on (meta, or a host scalar)."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.add("meta" if t.device.type == "meta" else
                              f"{t.device.type} numel {t.numel()}")
        return out


@pytest.fixture(scope="module")
def small_rows():
    rows = []
    for arch, shape, multi in SMALL_CELLS:
        with _Devices() as devs:
            row = DR.run_cell(arch, shape, multi, mesh_factory=make_test_mesh)
        rows.append((arch, shape, multi, row, devs.seen))
    return rows


def test_dryrun_small_cells_are_ok_on_meta(small_rows):
    """The reference's four small cells: ``ok``, both terms positive, a
    bottleneck of compute or memory, the model FLOPs the reference's, no
    collective on the virtual mesh (the row says why), and no tensor on
    any device but ``meta`` (host scalars aside: the cache index)."""
    for arch, shape, multi, row, seen in small_rows:
        assert row["status"] == "ok", row
        assert row["mesh"] == ("pod=2 x data=2 x model=2" if multi
                               else "data=2 x model=4")
        assert row["chips"] == 8
        assert row["t_compute_s"] > 0 and row["t_memory_s"] > 0
        assert row["bottleneck"] in ("compute", "memory")
        s = RSH.SHAPES[shape]
        assert row["model_flops"] == RF.model_flops(ref_config(arch), s.kind,
                                                    s.batch, s.seq)
        assert row["coll_count"] == 0 and row["t_collective_s"] == 0
        assert row["collectives"] == DR.VIRTUAL_COLLECTIVES
        assert "partitioner" in row["per_device"]
        mem = row["memory"]
        assert mem["fits_h100_80gb_args"] and mem["fits_h100_80gb"]
        assert mem["argument_size_in_bytes"] == sum(
            v for k, v in mem.items() if k.endswith("_bytes")
            and k not in ("argument_size_in_bytes", "floor_bytes"))
        assert all(s == "meta" or s.endswith("numel 1") for s in seen), seen


def test_dryrun_train_rows_scale_one_microbatch(small_rows):
    """The train cell's FLOPs are n_micro x (step - update) + update of
    the traced microbatch; the 2x2x2 mesh splits the same global figures
    over its 8 entries, and its argument bytes are the shard sums."""
    single, multi = small_rows[0][3], small_rows[3][3]
    assert single["hlo_flops_per_dev"] == multi["hlo_flops_per_dev"]
    cfg = get_config("smollm-360m")
    mesh = make_test_mesh(device="cpu")
    one = cfg.with_(train_microbatches=1)
    micro = DR.SHAPES["train_4k"].batch // cfg.train_microbatches
    step = DR.trace_costs(*DR.build_cell(one, DR.SHAPES["train_4k"], mesh,
                                         batch_override=micro)[:2])
    opt = DR.trace_costs(*DR.build_cell(one, DR.SHAPES["train_4k"], mesh,
                                        batch_override=micro,
                                        train_opt_only=True)[:2])
    n = cfg.train_microbatches
    assert single["hlo_flops_per_dev"] * 8 == \
        n * (step["flops"] - opt["flops"]) + opt["flops"]
    assert opt["flops"] == 0 and step["bytes"] > opt["bytes"] > 0


def test_traced_forward_flops_equal_the_analytic_count():
    """A reduced smollm forward on ``meta``: the FLOP counter sees exactly
    the projections, the head and the [S, S] attention products."""
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg, "meta")
    b, s = 3, 48
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    with torch.no_grad():
        got = DR.trace_costs(lambda: model({"tokens": tokens}), ())
    n_matmul = PF.active_params(cfg) - cfg.vocab_size * cfg.d_model
    attn = 4 * b * cfg.num_heads * s * s * cfg.head_dim * cfg.num_layers
    assert got["flops"] == 2 * b * s * n_matmul + attn
    assert got["bytes"] > 0 and got["coll_count"] == 0


def test_a_kernel_route_on_meta_fails_the_cell():
    """A route that reached a hand kernel on ``meta`` raises (no fake is
    registered for it), so the cell is a FAIL row, never a quiet switch."""
    cfg = get_config("smollm-360m").reduced().with_(use_flash=True)
    model = build_model(cfg, "meta")
    tokens = torch.empty((2, 128), dtype=torch.int32, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        model({"tokens": tokens})


def test_train_lower_only_runs_the_dryrun(tmp_path, monkeypatch):
    from repro_torch.launch import train as launch
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(SRC))
    with pytest.raises(SystemExit) as e:
        launch.main(["--arch", "smollm-360m", "--lower-only"])
    assert e.value.code == 0
    import json
    rows = json.loads((tmp_path / "dryrun_report.json").read_text())
    assert [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in rows] \
        == [("smollm-360m", "train_4k", "16x16", "ok")]


def test_report_tables_render_port_rows(small_rows, tmp_path):
    rows = [r for *_, r, _ in small_rows[:3]]
    rows.append({"arch": "gemma3-4b", "shape": "train_4k",
                 "mesh": "16x16", "status": "FAIL"})
    for r in rows[:3]:
        r["chips"] = 256           # the table's floor is the pod's
    table = PR.dryrun_table(rows, False)
    assert table.count("| ok |") == 3 and "| FAIL |" in table
    assert "fits 80GB" in table and "16GB" not in table
    roof = PR.roofline_table(rows)
    assert roof.count("\n") == 4 and "MXU" not in roof and "VMEM" not in roof


def test_serve_cli_takes_the_reference_ticks(capsys, monkeypatch):
    """``--reduced --device cpu``: the reference CLI's number of ticks and
    batched decode steps (``eos_id`` -1: scheduling alone decides them)."""
    from repro.launch import serve as ref_serve

    from repro_torch.launch import serve
    got = serve.main(["--arch", "smollm-360m", "--reduced", "--device",
                      "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "smollm-360m",
                                      "--reduced"])
    capsys.readouterr()
    ref_serve.main()
    out = capsys.readouterr().out
    m = re.search(r"served 8 requests in (\d+) ticks \((\d+) batched", out)
    assert m, out
    assert (got["ticks"], got["steps"]) == (int(m.group(1)), int(m.group(2)))
    assert got["requests"] == 8 and got["tokens"] == 8 * 16


def test_serve_cli_without_a_card_raises(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--arch", "smollm-360m", "--reduced"])
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", "whisper-small", "--reduced", "--device",
                    "cpu"])
