"""Production and test meshes of the port.

The JAX package's ``launch/mesh.py`` on PyTorch.  The reference lays its
meshes over TPU chips: one pod of 16x16 = 256 chips ``(data, model)``, two
pods of 2x16x16 = 512 ``(pod, data, model)``, and 2x4 / 2x2x2 test meshes
over 8 forced host devices.  The port keeps those shapes and axis names,
so every spec and shard shape compares one for one with the reference's,
but a :class:`Mesh` here is a *virtual* mesh: every entry names one
``torch.device`` (``cuda:0`` by default, or the caller's) -- the mesh the
partition plane's multi-device tail runs on (``kernels/shard.py``).  It
places nothing by itself: the dry-run traces on it without a card, and
``checkpoint/reshard.py`` places shards on its entries.

``torch.distributed.DeviceMesh`` does not serve here: it needs a process
group whose world size equals the mesh's size (256 or 512).

A mesh is a context manager, as JAX's is: inside ``with mesh:`` the
sharding constraints (``distributed/sharding.py:constrain``) resolve
against it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

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
    has them."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = _device(arr[idx])
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

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


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return virtual_mesh(shape, axes, device)


def make_test_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's small CI mesh (8 entries)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return virtual_mesh(shape, axes, device)


def describe(mesh) -> str:
    return " x ".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)
