"""Sharded checkpointing with atomic commit.

The JAX package's ``checkpoint/checkpointer.py`` on PyTorch, with the same
files: ``<dir>/step_<N>/`` holds one ``.npy`` shard file per leaf and
``manifest.json`` (the step, the ``extra`` dict, and per leaf its path,
file, shape, dtype, the first 16 hex digits of the file's sha256 and the
``process_index``: the writer's rank, 0 on one card).  A checkpoint is *committed* by
renaming ``step_<N>.tmp -> step_<N>`` after every shard and the manifest
are written -- the restore path only ever sees committed checkpoints,
which is the invariant the FT coordinator restarts against.  Shards are
written and read by a small thread pool.

Leaves are tensors (on any device) or numpy arrays, in nested dicts and
lists, flattened in the reference's order (dict keys sorted).  bfloat16,
which numpy lacks, is written as the reference's numpy writes its
``ml_dtypes`` bfloat16 (a ``'<V2'`` header over the raw 16-bit patterns,
so the shard is byte for byte the reference's) and read back through an
int16 view, keyed by the manifest's ``dtype``.  The reference's own
restore cannot read such a leaf (``astype`` of a void array raises); the
port reads both packages' bfloat16 checkpoints.

A tree of DTensors (a distributed mesh, ``launch/mesh.py``) is saved as
its global arrays: every rank takes part in gathering each leaf in turn,
and rank 0 writes, so the files and manifest are a one-card save's (its
``process_index`` the writer's rank); the other ranks wait for the
commit.  Restored into a ``like`` of DTensors, each rank keeps its own
part of each leaf.
"""
from __future__ import annotations

import hashlib
import io
import json
import math
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"
#: shards written and read at once (copies off the card, hashing and file
#: I/O release the interpreter lock)
_WORKERS = min(8, os.cpu_count() or 1)
#: a shard's header lies within its first bytes (``np.save`` pads it to
#: a multiple of 64; the dicts written here are far shorter)
_HEAD = 1 << 16


def _flat_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _flat_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flat_with_paths(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _rebuild(like, leaves, prefix: Tuple = ()):
    """``like``'s structure with the leaf at each path taken from
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, Mapping):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(the array to write, the manifest's dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == BF16:            # an ml_dtypes array
        return np.ascontiguousarray(arr).view(np.int16), BF16
    return arr, str(arr.dtype)


class _Hashing:
    """A file that hashes what is written through it, so that a shard's
    checksum costs no second pass over its bytes."""

    def __init__(self, f):
        self.f = f
        self.sha = hashlib.sha256()

    def write(self, b) -> int:
        self.sha.update(b)
        return self.f.write(b)


def _save(fpath: str, arr: np.ndarray, dtype: str) -> str:
    """Write one shard (``np.save``'s bytes); returns its checksum."""
    with open(fpath, "wb") as raw:
        f = _Hashing(raw)
        if dtype != BF16:
            np.lib.format.write_array(f, np.asanyarray(arr),
                                      allow_pickle=False)
        else:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
    return f.sha.hexdigest()[:16]


def _load(fpath: str, dtype: str, sha: Optional[str]):
    """One shard, read once: its checksum checked against ``sha`` (unless
    None), then the array over the same bytes (a torch bfloat16 tensor for
    a bfloat16 leaf)."""
    with open(fpath, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(data)
    if sha is not None and hashlib.sha256(data).hexdigest()[:16] != sha:
        raise IOError(f"checksum mismatch in {fpath} (corrupt checkpoint)")
    head = io.BytesIO(bytes(data[:_HEAD]))
    version = np.lib.format.read_magic(head)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dt = read(head)
    arr = np.frombuffer(data, dtype=dt, count=math.prod(shape),
                        offset=head.tell()).reshape(
        shape, order="F" if fortran else "C")
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return arr


def _full(leaf):
    """A DTensor leaf's global tensor (a collective every rank takes part
    in); anything else as it is."""
    return leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf


def _writer(leaves) -> Optional[int]:
    """This process's rank where the tree holds DTensors, else None."""
    if any(hasattr(leaf, "full_tensor") for _, leaf in leaves):
        import torch.distributed as dist
        return dist.get_rank()
    return None


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Write + atomically commit one checkpoint. Returns final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaves = _flat_with_paths(tree)
    rank = _writer(leaves)
    if rank:                         # not the writer: gather, then wait
        for _, leaf in leaves:
            _full(leaf)
        import torch.distributed as dist
        dist.barrier()
        return final
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "created": time.time(),
                "extra": extra or {}, "leaves": []}

    def write(i, path, leaf):
        arr, dtype = _host(leaf)
        fname = f"shard_{i:05d}.npy"
        return {"path": path, "file": fname, "shape": list(arr.shape),
                "dtype": dtype, "sha": _save(os.path.join(tmp, fname), arr,
                                             dtype),
                "process_index": rank or 0}
    with ThreadPoolExecutor(_WORKERS) as pool:
        # gathers run here in leaf order, the same on every rank
        futures = [pool.submit(write, i, path, _full(leaf))
                   for i, (path, leaf) in enumerate(leaves)]
        manifest["leaves"] = [f.result() for f in futures]
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    if rank is not None:
        import torch.distributed as dist
        dist.barrier()
    return final


def list_checkpoints(directory: str) -> List[int]:
    """Committed checkpoints only (ignores .tmp)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def _cast(arr, ref):
    """A restored leaf in the type (and, for a tensor, on the device) of
    ``ref``; for a DTensor ``ref``, this rank's part of it placed as
    ``ref`` is."""
    if hasattr(ref, "device_mesh"):
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed.sharding import local_range
        idx = tuple(slice(lo, lo + n) for lo, n in (
            local_range(ref, d) for d in range(ref.dim())))
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        part = t[idx].to(device=ref.to_local().device, dtype=ref.dtype)
        return DTensor.from_local(part.contiguous(), ref.device_mesh,
                                  ref.placements, run_check=False,
                                  shape=ref.shape, stride=ref.stride())
    if isinstance(ref, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(device=ref.device, dtype=ref.dtype)
    if isinstance(arr, torch.Tensor):      # bfloat16 into a numpy leaf
        arr = arr.float().numpy()
    return arr.astype(ref.dtype) if hasattr(ref, "dtype") else arr


def restore_checkpoint(directory: str, step: int, like=None,
                       verify: bool = True) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (or a flat dict by path)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    def read(leaf):
        return _load(os.path.join(path, leaf["file"]), leaf["dtype"],
                     leaf["sha"] if verify else None)
    with ThreadPoolExecutor(_WORKERS) as pool:
        by_path: Dict[str, Any] = dict(zip(
            (leaf["path"] for leaf in manifest["leaves"]),
            pool.map(read, manifest["leaves"])))
    if like is None:
        return by_path, manifest["extra"]
    leaves = {}
    for p, ref in _flat_with_paths(like):
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf {p}")
        arr = by_path[p]
        if list(arr.shape) != list(ref.shape):
            raise ValueError(
                f"{p}: checkpoint shape {tuple(arr.shape)} != expected "
                f"{tuple(ref.shape)} (use reshard.py for elastic restore)")
        leaves[p] = _cast(arr, ref)
    return _rebuild(like, leaves), manifest["extra"]


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    steps = list_checkpoints(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"))
