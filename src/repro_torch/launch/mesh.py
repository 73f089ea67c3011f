"""Production and test meshes of the port.

The JAX package's ``launch/mesh.py`` on PyTorch.  The reference lays its
meshes over TPU chips: one pod of 16x16 = 256 chips ``(data, model)``, two
pods of 2x16x16 = 512 ``(pod, data, model)``, and 2x4 / 2x2x2 test meshes
over 8 forced host devices.  The port keeps those shapes and axis names,
so every spec and shard shape compares one for one with the reference's.
A :class:`Mesh` comes in two kinds:

* a *virtual* mesh (:func:`virtual_mesh`): every entry names one
  ``torch.device`` (``cuda:0`` by default, or the caller's) -- the mesh the
  partition plane's multi-device tail runs on (``kernels/shard.py``).  It
  places nothing by itself: ``checkpoint/reshard.py`` places shards on its
  entries;
* a *distributed* mesh (:func:`distributed_mesh`): each entry is a rank of
  the ``torch.distributed`` world, laid over ``init_device_mesh`` with the
  reference's shape and axis names.  This rank's device is
  ``cuda:{local_rank}`` under NCCL, ``cpu`` under gloo.  Parameters,
  batches and caches placed on it are DTensors
  (``distributed/sharding.py:place``), and the model's sharding
  constraints redistribute them: the port's SPMD execution.

:func:`init_world` starts a rank's process group (the caller names the
address, world size and rank: nothing on a card machine tells a program
of a cluster).  :func:`fake_world` is a world of ``size`` ranks held by
one process as rank 0, over PyTorch's fake process group, whose
collectives complete at once without moving data: the dry-run traces one
rank's program of a 256- or 512-card mesh on it, on ``meta``.

A mesh is a context manager, as JAX's is: inside ``with mesh:`` the
sharding constraints (``distributed/sharding.py:constrain``) resolve
against it.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import pop_mesh, push_mesh


def _device(device) -> torch.device:
    """``None`` -> ``cuda:0``; a CUDA device without an index -> index 0.
    No card is needed: a mesh is a layout, not an allocation."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Mesh:
    """An object ndarray of ``torch.device`` with named axes: ``devices``,
    ``axis_names`` and ``shape`` (axis -> size), as ``jax.sharding.Mesh``
    has them.  ``device_mesh`` is the ``DeviceMesh`` of a distributed
    mesh (``None`` on a virtual one), ``mesh_dims`` the axes each of its
    dims covers, and ``device`` this rank's device."""

    def __init__(self, devices, axis_names: Sequence[str],
                 device_mesh=None, device=None, mesh_dims=None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = _device(arr[idx])
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))
        self.device_mesh = device_mesh
        self.mesh_dims = tuple(mesh_dims) if mesh_dims is not None else \
            tuple((a,) for a in self.axis_names)
        self.device = None if device is None else torch.device(device)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def coordinate(self) -> dict:
        """This rank's position on each axis (a distributed mesh)."""
        if not self.distributed:
            raise ValueError("a virtual mesh has no rank of its own")
        coord = np.unravel_index(dist.get_rank(), tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(c) for c in coord)))

    def __enter__(self) -> "Mesh":
        push_mesh(self)
        return self

    def __exit__(self, *exc) -> None:
        pop_mesh()


def virtual_mesh(shape: Sequence[int], axes: Sequence[str],
                 device=None) -> Mesh:
    """A mesh of ``shape`` whose every entry names ``device``."""
    devs = np.empty(tuple(shape), dtype=object)
    dev = _device(device)
    for idx in np.ndindex(devs.shape):
        devs[idx] = dev
    return Mesh(devs, axes)


def _rank_device(backend: str, rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:{local_rank}`` under NCCL, ``meta`` on
    a fake world, ``cpu`` otherwise."""
    if backend == "nccl":
        rank = dist.get_rank() if rank is None else rank
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("meta" if backend == "fake" else "cpu")


def distributed_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over the ranks of the initialised world, whose
    size must equal the mesh's, in rank order (C order over ``axes``):
    ``init_device_mesh`` with the reference's axis names.  The rules
    split every dim over ``pod`` and ``data`` together (the data axes),
    never over one alone, so where the mesh has both its ``DeviceMesh``
    folds them into one ``dp`` dim (ranks in the same order): DTensor
    then plans over two mesh dims, not three."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a distributed mesh needs an initialised world "
                           "(launch.mesh.init_world or fake_world)")
    size = int(np.prod(shape))
    if dist.get_world_size() != size:
        raise ValueError(f"a mesh of {tuple(shape)} needs {size} ranks, the "
                         f"world has {dist.get_world_size()}")
    backend = str(dist.get_backend()).lower()
    dev = _rank_device(backend)
    kind = "cuda" if dev.type == "cuda" else "cpu"
    if backend == "fake":
        kind = _FAKE_DEVICE_TYPE[0]
    axes = tuple(axes)
    dims = tuple((a,) for a in axes)
    dm_shape = tuple(shape)
    if axes[:2] == ("pod", "data"):
        dims = (("pod", "data"),) + dims[2:]
        dm_shape = (shape[0] * shape[1],) + tuple(shape[2:])
    dm = init_device_mesh(kind, dm_shape,
                          mesh_dim_names=tuple("+".join(d) for d in dims))
    devs = np.empty(tuple(shape), dtype=object)
    for r, idx in enumerate(np.ndindex(devs.shape)):
        devs[idx] = torch.device("cuda", r % torch.cuda.device_count()) \
            if dev.type == "cuda" else dev
    return Mesh(devs, axes, device_mesh=dm, device=dev, mesh_dims=dims)


def init_world(rank: int, world_size: int, init_method: str,
               backend: Optional[str] = None,
               timeout_s: float = 120.0) -> torch.device:
    """Join this process to a world of ``world_size`` ranks at
    ``init_method`` (``tcp://localhost:<port>``) as ``rank``: NCCL where
    there is a card, gloo otherwise (or ``backend``).  A collective that
    waits past ``timeout_s`` fails.  Returns this rank's device (set as
    the current CUDA device under NCCL)."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dev = _rank_device(backend, rank)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return dev


def _fake_backend() -> None:
    """Register PyTorch's fake process-group backend (``"fake"``): its
    testing module where present, else the same C++ group directly."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError:
        from torch._C._distributed_c10d import FakeProcessGroup

        def create(common, opts):
            return FakeProcessGroup._create_internal(
                common.group_rank, common.group_size, opts)
        dist.Backend.register_backend("fake", create, extended_api=True,
                                      devices=["cpu", "cuda"])


#: the device type a fake world's meshes take (``fake_world``)
_FAKE_DEVICE_TYPE = ["cpu"]


@contextlib.contextmanager
def fake_world(size: int, device_type: str = "cpu"):
    """A world of ``size`` ranks held by this process as rank 0, over the
    fake process group: its collectives move nothing and complete at once.
    Destroyed on exit.  No other world may be live.

    ``device_type`` is its meshes' (the tensors stay on ``meta``):
    DTensor plans each op from a cost model of the mesh's device type and
    its devices a host, and moves a shard to another dim by all-to-all
    except on a ``"cpu"`` mesh (gloo's all-gather and chunk).  ``"cuda"``
    (on a host with the cards the mesh stands for) plans as the cards'
    NCCL world does."""
    if dist.is_initialized():
        raise RuntimeError("a world is already initialised in this process")
    _fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=int(size))
    _FAKE_DEVICE_TYPE[0] = device_type
    try:
        yield
    finally:
        _FAKE_DEVICE_TYPE[0] = "cpu"
        dist.destroy_process_group()


def _make(shape, axes, device, distributed: bool) -> Mesh:
    return distributed_mesh(shape, axes) if distributed \
        else virtual_mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         distributed: bool = False) -> Mesh:
    """16x16 ``(data, model)``, or 2x16x16 with ``pod``; ``distributed``
    lays it over the world's ranks (a fake world of 256 or 512 for the
    dry-run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device, distributed)


def make_test_mesh(*, multi_pod: bool = False, device=None,
                   distributed: bool = False) -> Mesh:
    """The reference's small CI mesh (8 entries)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device, distributed)


def describe(mesh) -> str:
    return " x ".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)
