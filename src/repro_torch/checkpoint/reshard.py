"""Elastic resharding: restore a checkpoint onto a different mesh/topology.

The JAX package's ``checkpoint/reshard.py`` on PyTorch.  Checkpoints
store *global* logical arrays (host-side), so moving between meshes is a
metadata problem, not a data problem: the restore path re-chunks each
leaf for the new mesh's shardings (``distributed/sharding.py``).  This is
the mechanism behind elastic scale-down (lose a pod, resume on one) and
scale-up.

A placed leaf is a :class:`Sharded` value: one contiguous tensor per mesh
entry, on the entry's device, holding the slice ``indices()`` gives it.
On a virtual mesh (``launch/mesh.py``: every entry names one device)
entries on one device with the same slice share one tensor, as they would
share one buffer on a real card, so a tree placed on a mesh naming one
card 8 times takes the tree's bytes and not 8 times them.

On a distributed mesh (``launch/mesh.py``: one ``torch.distributed`` rank
an entry) a placed leaf is a DTensor instead: each rank reads only its own
slices of each shard file (``indices()`` at its coordinate, through a
memory map) and builds its part, with no collective.

``plan_reshard`` additionally reports, per leaf, which byte ranges each new
device needs -- on a real cluster this drives host-to-host transfer
planning; here it documents/tests the chunking math.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              from_part, is_distributed,
                                              rank_slices, shard_params,
                                              tree_leaves_with_path,
                                              tree_map_with_path)
from repro_torch.models.convert import to_tensor


@dataclasses.dataclass
class Sharded:
    """One leaf placed on a mesh: ``shards[i]`` is mesh entry ``i``'s
    part (the mesh's device order), ``full()`` the global tensor again."""
    spec: PartitionSpec
    mesh: Any
    shape: Tuple[int, ...]
    dtype: torch.dtype
    shards: List[torch.Tensor]

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def indices(self) -> List[Tuple[slice, ...]]:
        return self.sharding.indices(self.shape)

    def full(self) -> torch.Tensor:
        """The global tensor, assembled on the first shard's device."""
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=self.shards[0].device)
        for idx, shard in zip(self.indices(), self.shards):
            out[idx] = shard
        return out


def _host_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else to_tensor(leaf)


def place(leaf, sharding: NamedSharding) -> Sharded:
    """``leaf`` split over ``sharding``'s mesh: each distinct (device,
    slice) copied once into a fresh contiguous tensor on the device."""
    t = _host_tensor(leaf)
    mesh = sharding.mesh
    shards, made = [], {}
    for dev, idx in zip(mesh.devices.flat,
                        sharding.indices(tuple(t.shape))):
        key = (str(dev), tuple((s.start, s.stop) for s in idx))
        if key not in made:
            part = t[idx]
            made[key] = torch.empty(part.shape, dtype=t.dtype,
                                    device=dev).copy_(part)
        shards.append(made[key])
    return Sharded(sharding.spec, mesh, tuple(t.shape), t.dtype, shards)


def _rank_part(leaf, sharding: NamedSharding):
    """This rank's part of a host leaf as a DTensor (a distributed
    mesh)."""
    t = _host_tensor(leaf)
    return from_part(t[rank_slices(sharding, t.shape)], sharding, t.shape)


def device_put_resharded(tree, mesh, cfg=None):
    """Place a host tree onto ``mesh`` with the framework sharding rules
    (``cfg`` names the unit size of a tree holding the port's unit
    parameters, ``layers.{i}.*``): :class:`Sharded` leaves on a virtual
    mesh, DTensors holding this rank's slices on a distributed one."""
    shardings = dict(tree_leaves_with_path(shard_params(tree, mesh, cfg)))
    put = _rank_part if is_distributed(mesh) else place
    return tree_map_with_path(lambda p, leaf: put(leaf, shardings[p]), tree)


def plan_reshard(shape: Tuple[int, ...], old_spec_shards: int,
                 new_spec_shards: int, axis: int = 0) -> List[Dict]:
    """Chunk-movement plan for one leaf resharded along ``axis``.

    Returns, for each new shard, the list of (old_shard, slice) pairs it
    reads -- the host transfer schedule for elastic restore.
    """
    n = shape[axis]
    assert n % old_spec_shards == 0 and n % new_spec_shards == 0
    old_sz = n // old_spec_shards
    new_sz = n // new_spec_shards
    plan = []
    for new_i in range(new_spec_shards):
        lo, hi = new_i * new_sz, (new_i + 1) * new_sz
        reads = []
        o = lo // old_sz
        while o * old_sz < hi:
            s = max(lo, o * old_sz)
            e = min(hi, (o + 1) * old_sz)
            reads.append({"old_shard": o,
                          "offset": s - o * old_sz,
                          "length": e - s})
            o += 1
        plan.append({"new_shard": new_i, "reads": reads,
                     "bytes_factor": sum(r["length"] for r in reads) / n})
    return plan


def _host_cast(arr, ref):
    """A restored leaf (numpy, or a bfloat16 tensor) in ``ref``'s type, on
    the host."""
    if isinstance(ref, torch.Tensor):
        return _host_tensor(arr).to(ref.dtype)
    if isinstance(arr, torch.Tensor):      # bfloat16 into a numpy leaf
        arr = arr.float().numpy()
    return arr.astype(ref.dtype) if hasattr(ref, "dtype") else arr


def elastic_restore(directory: str, step: int, like, new_mesh,
                    cfg=None) -> Tuple[Any, Dict]:
    """Restore a checkpoint saved on any mesh onto ``new_mesh``: the port's
    checkpointer reads each shard file (the reference's bfloat16 ones
    too), then every leaf of ``like``'s structure (tensors on any device,
    ``meta`` included, or numpy arrays: only shapes and types are read) is
    placed under the sharding rules.  Returns (the placed tree, extra).
    On a distributed mesh each rank reads only its own slices."""
    from .checkpointer import restore_checkpoint
    if is_distributed(new_mesh):
        return _restore_rank_parts(directory, step, like, new_mesh, cfg)
    by_path, extra = restore_checkpoint(directory, step)

    def one(path, ref):
        key = "/".join(str(p) for p in path)
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = by_path[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= expected {tuple(ref.shape)}")
        return _host_cast(arr, ref)
    return device_put_resharded(tree_map_with_path(one, like), new_mesh,
                                cfg), extra


def _restore_rank_parts(directory: str, step: int, like, mesh,
                        cfg=None) -> Tuple[Any, Dict]:
    """:func:`elastic_restore` onto a distributed mesh: each leaf's shard
    file memory-mapped and this rank's slices of it copied out (its
    checksum is not checked: that needs every byte)."""
    from .checkpointer import BF16
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    files = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    shardings = dict(tree_leaves_with_path(shard_params(like, mesh, cfg)))

    def one(p, ref):
        key = "/".join(str(k) for k in p)
        if key not in files:
            raise KeyError(f"checkpoint missing leaf {key}")
        meta = files[key]
        if tuple(meta["shape"]) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape "
                             f"{tuple(meta['shape'])} != expected "
                             f"{tuple(ref.shape)}")
        arr = np.load(os.path.join(path, meta["file"]), mmap_mode="r")
        part = np.ascontiguousarray(arr[rank_slices(shardings[p],
                                                    arr.shape)])
        t = torch.from_numpy(part.view(np.int16)).view(torch.bfloat16) \
            if meta["dtype"] == BF16 else torch.from_numpy(part)
        return from_part(_host_cast(t, ref) if isinstance(
            ref, torch.Tensor) else t, shardings[p], tuple(ref.shape))

    return tree_map_with_path(one, like), manifest["extra"]
