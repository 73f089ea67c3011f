"""Dry-run: trace every (arch x shape x mesh) cell on the ``meta`` device.

The JAX package's ``launch/dryrun.py`` on PyTorch.  The reference lowers
and compiles each cell through XLA on 256 or 512 forced host devices and
reads FLOPs, bytes and memory from the executable.  The port's
counterpart of lower-and-compile is a trace on ``meta``: parameters,
optimizer state, batch and cache are ``meta`` tensors (shapes and dtypes,
no storage), and the cell's step runs eagerly over them under
``torch.utils.flop_counter.FlopCounterMode`` and :class:`TraceCounter`, a
dispatch mode that sums the bytes every aten op reads and writes (the
traffic the eager port really moves, unfused) and records the collective
calls the step issues.  The dry-run allocates nothing on any device: it
is not a CPU fallback but the counterpart of ``jax.eval_shape`` with the
executable's cost analysis.

For every assigned architecture and its supported input shapes it:

  1. builds the step (train / prefill / decode) and its ``meta`` inputs
     with the FSDP/TP/EP/SP shardings of ``distributed/sharding.py`` on
     the production mesh (16x16, or 2x16x16 over two pods: virtual
     meshes, ``launch/mesh.py``);
  2. traces one microbatch's train step and, apart, the optimizer update,
     and scales (:func:`probe_roofline`), or traces the prefill/decode
     step once;
  3. records the exact per-device argument bytes (each leaf's
     ``shard_shape`` under its spec) and the analytic floor
     (``launch/report.py``) against one H100's 80e9 bytes, and the
     roofline terms on H100 constants (``launch/roofline.py``).

The cell's config is taken as it is: its microbatches, its remat policy
and its route.  A route that reached a hand kernel would need the kernel's
``meta`` implementation (``torch.library.register_fake``); none does
(every config has ``use_flash=False``, prefill and decode attend through
the cache on the plain route, and training refuses the flash route), and a
kernel reached on ``meta`` raises (``kernels/_build.py:on_cuda``), which
makes the cell a ``FAIL`` row: no route is switched quietly.

A cell's mesh is a *fake world* (``launch/mesh.py:fake_world``) of the
mesh's size, 256 or 512 ranks held by this process as rank 0: the mesh is
a distributed one over it, the parameters, optimizer state, batch and
cache are DTensors over ``meta`` parts placed by the sharding rules, and
the step runs rank 0's part of the SPMD program, its sharding constraints
redistributing as on cards.  Per-device FLOPs and bytes are rank 0's own
(the local ops its DTensors issue: :class:`TraceCounter` lets DTensor
dispatch its ops and counts what comes back down; DTensor's shape
propagation on fake tensors is not counted), and its collectives are the
records :func:`~repro_torch.launch.roofline.parse_collectives` prices on
NVLink inside a node and the network across nodes.  The fake group moves
nothing, so no bytes are allocated and every collective completes at
once.  Every family runs on it: MoE layers (their dispatch moving the
tokens among the ranks), the SSM, cross-attention and the encoder.
(``run_cell`` without ``fake`` gives the virtual mesh's row, the global
trace divided by the mesh's entries, with no collective, and says so.)

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
      --shape train_4k --mesh single --report out.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.distributed.sharding import (is_distributed,
                                              nbytes_per_device, place,
                                              shard_batch, shard_cache,
                                              shard_params)
from repro_torch.launch.mesh import (describe, fake_world,
                                     make_production_mesh)
from repro_torch.launch.roofline import (CHIPS_PER_NODE, HBM_BYTES,
                                         CollectiveStats, Roofline,
                                         active_params, model_flops,
                                         parse_collectives)
from repro_torch.launch.shapes import (SHAPES, ShapeDef, batch_specs,
                                       cache_specs, supported_shapes)
from repro_torch.models import build_model
from repro_torch.models.model import shard_model
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import adamw
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import (make_train_step, model_params,
                                          unit_layout)

#: what a virtual mesh's row says of its collectives
VIRTUAL_COLLECTIVES = "none issued on a virtual mesh"
#: what a virtual mesh's row says of its per-device figures
PER_DEVICE = ("traced global / chips: no partitioner, so no involuntary "
              "replication is observable")
#: what a fake world's row says of them
PER_DEVICE_FAKE = ("rank 0's local trace on a fake world of {} ranks "
                   "(DTensor parts on meta)")
FAKE_COLLECTIVES = ("traced: rank 0's collectives on a fake world of {} "
                    "ranks")

# --------------------------------------------------------------------------
# counting a trace
# --------------------------------------------------------------------------

#: ops that allocate or relabel storage and move no bytes
_NO_TRAFFIC = frozenset((
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten._unsafe_view.default",
    "aten.detach.default", "aten.alias.default", "aten.lift_fresh.default",
    "aten.set_.source_Storage_storage_offset",
    "_c10d_functional.wait_tensor.default",
    "_c10d_functional._wrap_tensor_autograd.default",
))
#: gathers: the first input is read only where the output's rows come from
_GATHERS = frozenset(("aten.embedding.default", "aten.index.Tensor",
                      "aten.index_select.default", "aten.gather.default"))
#: scatters into their first input: only the written rows move
_SCATTERS = frozenset(("aten.index_put_.default", "aten.index_put.default",
                       "aten.scatter_.src", "aten.scatter.src",
                       "aten.scatter_add_.default", "aten.scatter_add.default",
                       "aten.index_copy_.default", "aten.index_add_.default"))
#: collective ops -> (the reference's name, the argument holding the
#: result, or None for the op's return value)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", None),
    "_c10d_functional.all_reduce_": ("all-reduce", None),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", None),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", None),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", None),
    "_c10d_functional.all_to_all_single": ("all-to-all", None),
    # DTensor's Shard(i) -> Shard(j) on a card (one op around NCCL's
    # all-to-all)
    "_dtensor.shard_dim_alltoall": ("all-to-all", None),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d.alltoall_": ("all-to-all", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
    "c10d.send": ("collective-permute", 0),
    "c10d.recv_": ("collective-permute", 0),
}


def _flat(x, acc: list) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts), in order."""
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, acc)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, acc)
    return acc


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _group_ranks(args, kwargs):
    """The ranks of a collective's process group: a ``ProcessGroup``
    argument, or (functional collectives) its group name."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    vals = list(args) + list(kwargs.values())
    for a in vals:
        if isinstance(a, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(a)
            return list(dist.get_process_group_ranks(pg))
    for a in reversed(vals):
        if isinstance(a, str):
            try:
                pg = c10d._resolve_process_group(a)
            except Exception:  # a reduce op's name, not a group's
                continue
            return list(dist.get_process_group_ranks(pg))
    return []


def _classify(func):
    """(how the op's bytes count, its collective entry or None)."""
    name = str(func)
    coll = _COLLECTIVE_OPS.get(name.rsplit(".", 1)[0])
    if func.is_view or name in _NO_TRAFFIC:
        return "none", coll
    if name in _GATHERS:
        return "gather", coll
    if name in _SCATTERS:
        return "scatter", coll
    return "all", coll


class TraceCounter(TorchDispatchMode):
    """Counts what a step moves: for every aten op but a view, the bytes of
    its tensor inputs and of the outputs that are not inputs (an in-place
    op's target counts once); a gather's table counts as its output's
    bytes and a scatter's target as its values', not whole.  Collective
    calls are kept as ``(op, result bytes, group ranks)`` records for
    :func:`~repro_torch.launch.roofline.parse_collectives`.

    An op on DTensors is handed to DTensor (``NotImplemented``), whose
    local ops and collectives come back through this mode and are counted
    with their local shapes; DTensor's shape propagation, which runs the
    op on fake tensors of the global shapes, is not counted.  These local
    ops' FLOPs are summed too (``flops``: PyTorch's FLOP formulas), as
    ``FlopCounterMode`` would count DTensor ops at their global shapes.
    ``meta_only`` leaves out ops on no ``meta`` tensor: the host-side
    index bookkeeping DTensor does for its placements."""

    def __init__(self, meta_only: bool = False):
        super().__init__()
        self.meta_only = meta_only
        self.bytes = 0
        self.ops = 0
        self.flops = 0
        self.records = []
        self._kinds: Dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if self.meta_only and not any(
                t.device.type == "meta"
                for t in _flat(out, _flat(args, _flat(kwargs, [])))):
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _classify(func)
        how, coll = kind
        if coll is not None:
            op, where = coll
            result = out if where is None else args[where]
            self.records.append((op, _nbytes(_flat(result, [])),
                                 _group_ranks(args, kwargs)))
        if how == "none":
            return out
        ins = _flat(kwargs, _flat(args, []))
        seen = {id(t) for t in ins}
        outs = [t for t in _flat(out, []) if id(t) not in seen]
        if how == "gather":
            moved = _nbytes(ins[1:]) + 2 * _nbytes(outs)
        elif how == "scatter":
            moved = 2 * _nbytes(ins[1:]) + _nbytes(outs)
        else:
            moved = _nbytes(ins) + _nbytes(outs)
        self.bytes += moved
        self.ops += 1
        return out


_KEYS = ("flops", "bytes", "ici", "dcn", "coll_count")


def trace_costs(fn, args, chips_per_node: int = CHIPS_PER_NODE,
                mesh=None) -> Dict:
    """Run ``fn(*args)`` on its ``meta`` inputs under the FLOP counter and
    :class:`TraceCounter`: global FLOPs, bytes, aten ops and collectives;
    on a distributed ``mesh`` (entered for the run), rank 0's own."""
    if mesh is not None and is_distributed(mesh):
        with torch.no_grad(), mesh, TraceCounter(meta_only=True) as tc:
            fn(*args)
        flops = tc.flops
    else:
        with torch.no_grad(), FlopCounterMode(display=False) as fc, \
                TraceCounter() as tc:
            fn(*args)
        flops = fc.get_total_flops()
    coll = parse_collectives(tc.records, chips_per_node)
    return {"flops": float(flops), "bytes": float(tc.bytes),
            "ici": float(coll.ici_bytes), "dcn": float(coll.dcn_bytes),
            "coll_count": float(coll.count), "by_op": coll.by_op,
            "ops": tc.ops}


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def moment_dtype_for(cfg) -> str:
    """Optimizer-state policy: int8 moments >=100B, bf16 >=10B, else fp32."""
    n = active_params(cfg)
    total = n  # dense ~= active; MoE far larger -> use analytic full count
    if cfg.moe:
        total = n + (cfg.moe.num_experts - cfg.moe.top_k) * 3 \
            * cfg.d_model * cfg.moe.d_expert * \
            sum(1 for s in (list(cfg.prefix) + list(cfg.unit) * cfg.n_units)
                if s.moe)
    if total > 100e9:
        return "int8"
    if total > 10e9:
        return "bfloat16"
    return "float32"


def build_cell(cfg, shape: ShapeDef, mesh, *, batch_override: int = None,
               train_opt_only: bool = False):
    """Returns (fn, args, in_shardings): the cell's step and its ``meta``
    inputs, with the shardings of each input tree.  The model holds its
    parameters, so a prefill/decode step ignores its first argument, which
    is there for the argument bytes.  On a distributed mesh the inputs
    (and the model's parameters) are DTensors placed by their
    shardings."""
    model = build_model(cfg, "meta")
    b = batch_override or shape.batch
    shape = dataclasses.replace(shape, batch=b)

    def placed(args, in_sh):
        if not is_distributed(mesh):
            return args
        return tuple(place(a, s) for a, s in zip(args, in_sh))

    if shape.kind == "train":
        params = model_params(model)
        layout = unit_layout(model)
        opt = adamw(warmup_cosine(3e-4, 100, 10_000),
                    moment_dtype=moment_dtype_for(cfg))
        state = opt.init(params, layout)
        if train_opt_only:
            # optimizer-update-only probe (separates update cost from loss)
            def fn(grads, state, params):
                return opt.update(grads, state, params, layout)
            grads = {n: torch.empty(p.shape, dtype=torch.float32,
                                    device="meta")
                     for n, p in params.items()}
            in_sh = (shard_params(grads, mesh, cfg),
                     shard_params(state, mesh, cfg),
                     shard_params(params, mesh, cfg))
            return fn, placed((grads, state, params), in_sh), in_sh
        fn = make_train_step(model, opt, n_micro=cfg.train_microbatches,
                             accum_dtype=torch.bfloat16
                             if cfg.param_dtype == "bfloat16"
                             else torch.float32)
        batch = batch_specs(cfg, shape, with_labels=True)
        in_sh = (shard_params(params, mesh, cfg),
                 shard_params(state, mesh, cfg),
                 shard_batch(batch, mesh, shape.batch))
        return fn, placed((params, state, batch), in_sh), in_sh

    if is_distributed(mesh):
        shard_model(model, mesh)
    params = {n: p.detach() for n, p in model.named_parameters()}
    batch = batch_specs(cfg, shape, with_labels=False)
    cache = cache_specs(model, cfg, shape)
    in_sh = (shard_params(params, mesh, cfg),
             shard_batch(batch, mesh, shape.batch),
             shard_cache(cache, mesh, shape.batch, cfg))
    params, batch, cache = placed((params, batch, cache), in_sh)
    if shape.kind == "prefill":
        step = make_prefill_step(model)
        return (lambda _, batch, cache: step(batch, cache)), \
            (params, batch, cache), in_sh
    # decode
    step = make_decode_step(model)
    return (lambda _, tokens, cache: step(tokens, cache)), \
        (params, batch["tokens"], cache), \
        (in_sh[0], in_sh[1]["tokens"], in_sh[2])


def probe_roofline(cfg, shape: ShapeDef, mesh,
                   chips_per_node: int = CHIPS_PER_NODE) -> Dict:
    """The step's global costs from its trace.

    The reference needs unrolled 1- and 2-unit probes and an affine fit
    because XLA's cost analysis counts a while loop's body once.  The
    port's trace is eager and counts every unit, so neither is needed.  A
    train cell traces one microbatch's step (its forward, backward and
    update) and, apart, the optimizer update, and scales as the reference
    does: ``n_micro * (step - update) + update``.
    """
    if shape.kind != "train":
        fn, args, _ = build_cell(cfg, shape, mesh)
        return trace_costs(fn, args, chips_per_node, mesh)
    n = cfg.train_microbatches
    one = cfg.with_(train_microbatches=1)
    micro_b = shape.batch // n
    c = trace_costs(*build_cell(one, shape, mesh,
                                batch_override=micro_b)[:2], chips_per_node,
                    mesh)
    o = trace_costs(*build_cell(one, shape, mesh, batch_override=micro_b,
                                train_opt_only=True)[:2], chips_per_node,
                    mesh)
    out = {k: n * max(c[k] - o[k], 0.0) + o[k] for k in _KEYS}
    out["by_op"] = {k: n * c["by_op"].get(k, 0) for k in c["by_op"]}
    out["ops"] = n * (c["ops"] - o["ops"]) + o["ops"]
    return out


def argument_bytes(kind: str, args, in_sh) -> Dict[str, float]:
    """Per-device bytes of a cell's inputs (:func:`build_cell`'s), exact:
    each leaf's ``shard_shape`` under its spec times its item size."""
    per = [float(nbytes_per_device(a, s)) for a, s in zip(args, in_sh)]
    names = ("params_bytes", "opt_state_bytes", "batch_bytes") \
        if kind == "train" else ("params_bytes", "batch_bytes", "cache_bytes")
    out = dict(zip(names, per))
    out["argument_size_in_bytes"] = float(sum(per))
    return out


def roofline_row(arch: str, cfg, shape: ShapeDef, mesh, mesh_id: str,
                 floor: Optional[Dict] = None) -> Dict:
    """One cell's row: trace it, size its arguments, price it."""
    chips = int(mesh.size)
    t0 = time.time()
    fn, args, in_sh = build_cell(cfg, shape, mesh)
    memory = argument_bytes(shape.kind, args, in_sh)
    del fn, args, in_sh
    costs = probe_roofline(cfg, shape, mesh)
    elapsed = time.time() - t0
    memory["fits_h100_80gb_args"] = bool(
        memory["argument_size_in_bytes"] <= HBM_BYTES)
    if floor is not None:
        memory["floor_bytes"] = float(floor["floor_bytes"])
        memory["fits_h100_80gb"] = bool(floor["floor_bytes"] <= HBM_BYTES)
    coll = CollectiveStats(ici_bytes=int(costs["ici"]),
                           dcn_bytes=int(costs["dcn"]),
                           by_op=costs["by_op"],
                           count=int(costs["coll_count"]))
    fake = is_distributed(mesh)
    per = 1 if fake else chips        # a fake world's trace is rank 0's
    rf = Roofline(arch=arch, shape=shape.name, mesh=mesh_id, chips=chips,
                  flops_per_device=costs["flops"] / per,
                  bytes_per_device=costs["bytes"] / per, coll=coll,
                  model_flops=model_flops(cfg, shape.kind, shape.batch,
                                          shape.seq),
                  per_device_memory=memory)
    row = rf.row()
    virtual = len(set(mesh.devices.flat)) == 1
    row.update({"status": "ok", "compile_s": elapsed,
                "coll_by_op": costs["by_op"],
                "raw_scanned_flops_per_dev": costs["flops"] / per,
                "probes": False, "aten_ops": costs["ops"],
                "per_device": PER_DEVICE_FAKE.format(chips) if fake
                else PER_DEVICE,
                "collectives": FAKE_COLLECTIVES.format(chips) if fake
                else VIRTUAL_COLLECTIVES
                if virtual and not coll.count else "traced"})
    return row


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             mesh_factory=make_production_mesh, fake: bool = False) -> Dict:
    """One cell's row: on a fake world of the mesh's size (``fake``), or
    on the virtual mesh."""
    from repro_torch.launch.report import analytic_memory_floor
    mesh = mesh_factory(multi_pod=multi_pod)
    cfg = get_config(arch)
    mesh_id = (("2x16x16" if multi_pod else "16x16")
               if mesh_factory is make_production_mesh else describe(mesh))
    floor = analytic_memory_floor(arch, shape_name, mesh.size, multi_pod)
    if not fake:
        return roofline_row(arch, cfg, SHAPES[shape_name], mesh, mesh_id,
                            floor)
    with fake_world(mesh.size):
        mesh = mesh_factory(multi_pod=multi_pod, distributed=True)
        return roofline_row(arch, cfg, SHAPES[shape_name], mesh, mesh_id,
                            floor)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape id")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--report", default="dryrun_report.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    rows = []
    if os.path.exists(args.report):
        with open(args.report) as f:
            rows = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in rows
            if r.get("status") == "ok"}

    for arch in archs:
        cfg = get_config(arch)
        shapes = ([args.shape] if args.shape
                  else supported_shapes(cfg))
        for shape_name in shapes:
            for multi in meshes:
                mesh_id = "2x16x16" if multi else "16x16"
                if (arch, shape_name, mesh_id) in done:
                    print(f"[skip] {arch} {shape_name} {mesh_id} (cached)")
                    continue
                tag = f"{arch} | {shape_name} | {mesh_id}"
                print(f"[trace on meta] {tag} ...", flush=True)
                try:
                    row = run_cell(arch, shape_name, multi, fake=True)
                    print(f"  ok in {row['compile_s']:.1f}s  "
                          f"bottleneck={row['bottleneck']}  "
                          f"t=(c {row['t_compute_s']:.3e}, "
                          f"m {row['t_memory_s']:.3e}, "
                          f"x {row['t_collective_s']:.3e})s  "
                          f"useful={row['useful_flops_ratio']:.2f}",
                          flush=True)
                except Exception as e:  # a failure here is a system bug
                    row = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_id, "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"  FAIL: {row['error']}", flush=True)
                rows = [r for r in rows
                        if (r["arch"], r["shape"], r["mesh"])
                        != (arch, shape_name, mesh_id)]
                rows.append(row)
                with open(args.report, "w") as f:
                    json.dump(rows, f, indent=1, default=str)

    ok = sum(1 for r in rows if r.get("status") == "ok")
    fail = sum(1 for r in rows if r.get("status") != "ok")
    print(f"\n== dry-run complete: {ok} ok, {fail} failed -> {args.report}")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
