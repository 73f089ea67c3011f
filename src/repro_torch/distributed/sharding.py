"""Sharding rules: parameter, optimizer-state, batch and cache
PartitionSpecs.

The JAX package's ``distributed/sharding.py`` on PyTorch.  Strategy
(production mesh ``(data=16, model=16)``, multi-pod adds an outer ``pod``
axis folded into data parallelism):

* **FSDP** -- every large parameter's d_model-like dimension is sharded over
  the data axes, so per-device parameter+optimizer memory scales 1/NxDP.
* **TP**   -- head/ffn/expert dimensions shard over ``model``.
* **EP**   -- MoE expert banks shard their expert dimension over ``model``.
* **SP**   -- long-context decode (batch=1) shards the KV-cache *sequence*
  dimension over the data axes.
* Vectors (norm scales, A_log, biases) are replicated -- negligible bytes.

The rules are pure functions of a path, a shape and a mesh's axis sizes
(``mesh.axis_names``, ``mesh.shape``), so they take the port's
:class:`~repro_torch.launch.mesh.Mesh` and the reference's meshes alike.
:func:`param_spec` and :func:`cache_spec` are the reference's, line for
line, over the reference's paths (``/``-joined; ``"/moe/" in name``) and
its stacked shapes.  The port keys on those paths through
:func:`~repro_torch.models.convert.reference_leaf`, the one map from a
port name to the reference's leaf: a repeating unit's parameter
(``layers.{i}.attn.q``) is the reference's ``units/l{j}/attn/q``, whose
leading ``n_units`` axis the port does not have, so its spec is the
reference's with the leading entry dropped.  Optimizer states nest the
parameter's path (``m``/``v`` above it, int8's ``q``/``scale`` and
Adafactor's ``row``/``col``/``full`` below), as in the reference.

``shard_params``, ``shard_batch``, ``shard_cache`` and ``replicated``
return :class:`NamedSharding` values: a (mesh, spec) pair with
``shard_shape`` and ``indices`` (one tuple of slices per mesh entry, in the
mesh's device order, as JAX's ``devices_indices_map`` gives them).

On a distributed mesh (``launch/mesh.py``: one ``torch.distributed``
rank an entry) a spec is DTensor placements (:func:`placements`) and
:func:`place` puts a tree under its shardings as DTensors.
``constrain`` and ``constrain_like_params`` resolve their specs against
the mesh entered with ``with mesh:`` as the reference's do: on a
distributed mesh they redistribute to the resolved spec (the reference's
``with_sharding_constraint``; the model, attention and train step call
them where the reference does).  Where every entry of a virtual mesh
names the tensor's own device they return the tensor unchanged: nothing
moves on one card.  A virtual mesh naming more than one device raises
``NotImplementedError``: it has no ranks to run on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class PartitionSpec(tuple):
    """A tuple of per-dimension entries: ``None`` (replicated), one mesh
    axis name, or a tuple of names (a one-name tuple is the name).
    Prints and compares as the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"

    __str__ = __repr__


P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: how a global array splits over its entries."""
    mesh: Any
    spec: PartitionSpec

    def _tiles(self, global_shape) -> List[Tuple[str, ...]]:
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than the shape "
                             f"{tuple(global_shape)} has dims")
        return [_axes(self.spec[i]) if i < len(self.spec) else ()
                for i in range(len(global_shape))]

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The shape of one entry's shard; raises ``ValueError`` where a
        dim does not divide evenly (as JAX's does)."""
        out = []
        for d, axes in zip(global_shape, self._tiles(global_shape)):
            n = math.prod(self.mesh.shape[a] for a in axes)
            if d % n:
                raise ValueError(f"{self.spec} splits a dim of {d} into "
                                 f"{n} (shape {tuple(global_shape)})")
            out.append(d // n)
        return tuple(out)

    def indices(self, global_shape) -> List[Tuple[slice, ...]]:
        """One tuple of slices per mesh entry, in the mesh's device order
        (C order over its axes): the part of the global array the entry
        holds."""
        shard = self.shard_shape(global_shape)
        tiles = self._tiles(global_shape)
        names = tuple(self.mesh.axis_names)
        out = []
        for coord in np.ndindex(*(self.mesh.shape[a] for a in names)):
            pos = dict(zip(names, coord))
            idx = []
            for size, axes in zip(shard, tiles):
                if not axes:
                    idx.append(slice(None))
                    continue
                k = 0
                for a in axes:
                    k = k * self.mesh.shape[a] + pos[a]
                idx.append(slice(k * size, (k + 1) * size))
            out.append(tuple(idx))
        return out


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    return -(-cfg.vocab_size // multiple) * multiple


def data_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _dp(mesh):
    ax = data_axes(mesh)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


# ---------------------------------------------------------------------------
# the reference's rules, on its paths and stacked shapes
# ---------------------------------------------------------------------------

class _Leaf:
    """A shape standing in for a leaf."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def param_spec(path: Tuple[str, ...], leaf, mesh) -> P:
    """PartitionSpec for one parameter, keyed on the reference's tree path.

    Parameters under ``units``/``enc_units`` are stacked along a leading
    scan axis; rules apply to the trailing dims with a ``None`` prepended.
    """
    dp = _dp(mesh)
    name = "/".join(str(p) for p in path)
    shape = leaf.shape
    # optimizer states nest param paths under m/v/row/col; the scan axis is
    # present whenever 'units'/'enc_units' appears anywhere in the path
    lead = 1 if any(p in ("units", "enc_units") for p in path) else 0

    # int8-quantized moment leaves ({"q": [..., nblk, 128], "scale":
    # [..., nblk, 1]}) inherit the parent matrix's spec: the split last
    # dim (nblk) takes the parent's last-dim axis, the block dim is local.
    if path and str(path[-1]) in ("q", "scale") and len(shape) - lead >= 3:
        parent = _Leaf(shape[:-2] + (shape[-2] * max(shape[-1], 1),))
        pspec = param_spec(path[:-1], parent, mesh)
        entries = list(pspec) + [None] * (len(parent.shape) - len(pspec))
        return P(*entries, None)
    core = len(shape) - lead
    pre = [None] * lead
    # vectors & scalars: replicate
    if core <= 1:
        return P()
    # embeddings: lookup table keeps vocab UNsharded (token gather stays
    # collective-free) with d_model over model; the decoupled head is
    # vocab-parallel so logits land vocab-sharded with no psum.
    if name.endswith("embed"):
        return P(None, "model")
    if name.endswith("lm_head"):
        return P(None, "model")
    # MoE expert banks [E, d_in, d_out]: EP over model + FSDP over data
    if "/moe/" in name and core == 3:
        return P(*pre, "model", dp, None)
    if name.endswith("/moe/router"):
        return P(*pre, dp, None)
    if name.endswith("conv_w"):          # [W, C]: channels over model
        return P(*pre, None, "model")
    # attention / mlp / ssm projections [d_in, d_out]
    if core == 2:
        # contract-side sharding heuristic: project *out of* d_model -> TP on
        # the output dim; project back *into* d_model -> TP on the input dim.
        if name.endswith(("/o", "/down", "/out_proj")):
            return P(*pre, "model", dp)
        return P(*pre, dp, "model")
    return P()


def _validate(spec: P, shape, mesh) -> P:
    """Drop mesh axes whose size does not divide the dim (safety net)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = int(np.prod([mesh.shape[a] for a in axes]))
        out.append(entry if shape[i] % n == 0 else None)
    return P(*out)


def batch_spec(mesh, batch_size: int) -> P:
    """Tokens/labels [B, S]: shard batch over data axes when divisible."""
    dp = _dp(mesh)
    n_dp = int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))
    if batch_size % n_dp == 0 and batch_size >= n_dp:
        return P(dp, None)
    return P(None, None)


def cache_spec(path: Tuple[str, ...], leaf, mesh, batch_size: int) -> P:
    """KV/SSM cache sharding, on the reference's cache path.

    batch > 1: shard batch over data, head_dim over model.
    batch == 1 (long-context): sequence parallelism -- shard the cache
    sequence dim over data instead.
    """
    dp = _dp(mesh)
    n_dp = int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))
    name = "/".join(str(p) for p in path)
    shape = leaf.shape
    batch_ok = batch_size % n_dp == 0 and batch_size >= n_dp
    if name.endswith("index"):
        return P()
    nd = len(shape)
    # leading axis may be the scan (units) axis: detect via 'units' in path
    scan_off = 1 if "units" in name else 0
    core = nd - scan_off
    lead = [None] * scan_off
    if core == 4 and ("/kv/" in name or "/cross/" in name):
        # [B, L, KV, dh] -- KV-sequence parallelism: the cache length
        # shards over 'model'; batch over data when divisible, else
        # (long-context batch=1) L takes every axis.
        if batch_ok:
            if shape[scan_off + 1] % mesh.shape["model"] == 0:
                return P(*lead, dp, "model", None, None)
            return P(*lead, dp, None, None, "model")
        all_ax = tuple(a for a in ("pod", "data", "model")
                       if a in mesh.axis_names)
        n_all = int(np.prod([mesh.shape[a] for a in all_ax]))
        if shape[scan_off + 1] % n_all == 0:
            return P(*lead, None, all_ax, None, None)
        return P(*lead, None, None, None, "model")
    if core == 4 and "/ssm/" in name and name.endswith("state"):
        # [B, H, P, N]
        if batch_ok:
            return P(*lead, dp, "model", None, None)
        return P(*lead, None, "model", None, None)
    if core == 3 and name.endswith("conv"):
        # [B, W-1, C]
        if batch_ok:
            return P(*lead, dp, None, "model")
        return P(*lead, None, None, "model")
    return P()


# ---------------------------------------------------------------------------
# the port's trees on the reference's paths
# ---------------------------------------------------------------------------

#: keys of the port's optimizer states around a parameter's name (``m``,
#: ``v`` and ``step`` above it; int8's ``q``/``scale`` and Adafactor's
#: ``row``/``col``/``full`` below it): the reference nests the same keys
STATE_KEYS = frozenset(("m", "v", "step", "q", "scale", "row", "col",
                        "full"))


def reference_path(path: Sequence, cfg: Optional[ModelConfig] = None
                   ) -> Tuple[Tuple[str, ...], bool]:
    """(the reference's path, stacked) of a port leaf's ``path``: each
    key that names a port parameter (``layers.3.attn.q``, ``prefix.0.mlp.up``,
    ``embed``) becomes the reference's leaf path through
    :func:`reference_leaf`; ``stacked`` when one of them is a repeating
    unit's, whose leading axis the port does not have.  A path already in
    the reference's layout (``units/l0/attn/q``) maps to itself.  A unit's
    parameter needs ``cfg`` (its unit size)."""
    from repro_torch.models.convert import UNIT_HEADS, reference_leaf
    out: List[str] = []
    stacked = False
    for key in path:
        key = str(key)
        if key in STATE_KEYS:
            out.append(key)
            continue
        if key.partition(".")[0] in UNIT_HEADS and cfg is None:
            raise ValueError(f"{key} is a repeating unit's parameter: pass "
                             f"the model's config")
        leaf, unit = reference_leaf(cfg, key)
        out += [p for p in leaf.split(".") if p]
        stacked = stacked or unit is not None
    return tuple(out), stacked


def _drop_lead(spec: P, stacked: bool) -> P:
    return P(*spec[1:]) if stacked and len(spec) else spec


def leaf_spec(path: Sequence, shape, mesh,
              cfg: Optional[ModelConfig] = None) -> P:
    """The validated spec of the port leaf at ``path`` with ``shape``: the
    reference's on its path and stacked shape, the unit axis dropped."""
    rpath, stacked = reference_path(path, cfg)
    full = ((1,) if stacked else ()) + tuple(shape)
    spec = _validate(param_spec(rpath, _Leaf(full), mesh), full, mesh)
    return _drop_lead(spec, stacked)


def _cache_path(path: Sequence, cfg: ModelConfig
                ) -> Tuple[Tuple[str, ...], bool]:
    """The reference's path of a port cache leaf: layer ``i`` of the
    port's ``layers`` list (prefix layers first) is ``prefix_{i}`` or a
    unit's ``units/l{j}`` (stacked), through :func:`reference_leaf`."""
    from repro_torch.models.convert import reference_leaf
    path = [str(p) for p in path]
    if len(path) < 2 or path[0] != "layers":
        return tuple(path), False
    i, n_pre = int(path[1]), len(cfg.prefix)
    name = f"prefix.{i}." if i < n_pre else f"layers.{i - n_pre}."
    leaf, unit = reference_leaf(cfg, name)
    return tuple(p for p in leaf.split(".") if p) + tuple(path[2:]), \
        unit is not None


def cache_leaf_spec(path: Sequence, shape, mesh, batch_size: int,
                    cfg: ModelConfig) -> P:
    """The spec of the port cache leaf at ``path``: the reference's on its
    path and stacked shape, the unit axis dropped."""
    rpath, stacked = _cache_path(path, cfg)
    full = ((1,) if stacked else ()) + tuple(shape)
    return _drop_lead(cache_spec(rpath, _Leaf(full), mesh, batch_size),
                      stacked)


def tree_map_with_path(fn, tree, path: Tuple = ()):
    """``tree`` (nested dicts, lists and tuples) with each leaf replaced
    by ``fn(path, leaf)``; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    out: List[Tuple[Tuple, Any]] = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree, path)
    return out


def shard_params(params, mesh, cfg: Optional[ModelConfig] = None):
    """A tree of :class:`NamedSharding` matching ``params`` (a parameter
    dict by the port's names, an optimizer state, or a tree holding them,
    such as a checkpoint's ``{"params", "opt"}``)."""
    return tree_map_with_path(
        lambda p, leaf: NamedSharding(mesh, leaf_spec(p, leaf.shape, mesh,
                                                      cfg)), params)


def shard_batch(batch_tree: Dict, mesh, batch_size: int) -> Dict:
    spec = batch_spec(mesh, batch_size)

    def one(_, leaf):
        nd = len(leaf.shape)
        return NamedSharding(mesh, P(*(list(spec) + [None] * (nd - 2))))

    return tree_map_with_path(one, batch_tree)


def shard_cache(cache: Dict, mesh, batch_size: int, cfg: ModelConfig):
    """A tree of :class:`NamedSharding` matching the port's ``cache``
    (``LM.init_cache``'s ``{"index", "layers": [...]}``)."""
    return tree_map_with_path(
        lambda p, leaf: NamedSharding(mesh, cache_leaf_spec(
            p, leaf.shape, mesh, batch_size, cfg)), cache)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def nbytes_per_device(tree, shardings) -> int:
    """The bytes one mesh entry holds of ``tree``: each leaf's
    ``shard_shape`` under its sharding times its item size."""
    specs = dict(tree_leaves_with_path(shardings))
    total = 0
    for path, leaf in tree_leaves_with_path(tree):
        shard = specs[path].shard_shape(tuple(leaf.shape))
        item = leaf.element_size() if hasattr(leaf, "element_size") \
            else leaf.dtype.itemsize
        total += math.prod(shard) * item
    return total


# ---------------------------------------------------------------------------
# in-model constraints against the ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT = threading.local()


def push_mesh(mesh) -> None:
    """Make ``mesh`` the ambient mesh (``Mesh.__enter__``)."""
    _AMBIENT.__dict__.setdefault("stack", []).append(mesh)


def pop_mesh() -> None:
    _AMBIENT.stack.pop()


def _context_mesh():
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def _placed(x, mesh) -> None:
    """Raise unless every entry of the virtual ``mesh`` names ``x``'s
    device."""
    devices = set(mesh.devices.flat)
    if len(devices) > 1:
        raise NotImplementedError(
            f"the virtual mesh names {len(devices)} devices: sharded "
            f"execution needs a distributed mesh over torch.distributed "
            f"ranks (launch.mesh.distributed_mesh)")
    if devices != {x.device}:
        raise ValueError(f"the tensor is on {x.device}, the mesh names "
                         f"{devices.pop()}")


def is_distributed(mesh) -> bool:
    """A mesh over ``torch.distributed`` ranks (``launch/mesh.py``)."""
    return getattr(mesh, "device_mesh", None) is not None


def placements(spec, mesh) -> list:
    """``spec`` as DTensor placements on a distributed ``mesh``: on each
    dim of its ``DeviceMesh`` that a dim's entry names, ``Shard(dim)``;
    ``Replicate()`` on the rest.  A tuple entry splits its dim over its
    axes in order, major first, which DTensor does in the mesh's order,
    so a tuple out of the mesh's order raises; a mesh dim that folds
    several axes (``pod`` and ``data``) is named by all of them at once."""
    from torch.distributed.tensor import Replicate, Shard
    dims = list(mesh.mesh_dims)
    out = [Replicate()] * len(dims)
    for d, entry in enumerate(spec):
        axes, pos = list(_axes(entry)), []
        while axes:
            k = next((k for k, dim in enumerate(dims)
                      if tuple(axes[:len(dim)]) == dim), None)
            if k is None:
                raise ValueError(f"{spec}: {entry} does not name whole dims "
                                 f"of the mesh's {tuple(dims)}")
            pos.append(k)
            axes = axes[len(dims[k]):]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: the axes {entry} are not in the "
                             f"mesh's order {tuple(mesh.axis_names)}")
        for k in pos:
            out[k] = Shard(d)
    return out


class _Constrain(torch.autograd.Function):
    """Redistribute to ``pl``, and the gradient to ``pl`` too: the
    transpose of the reference's ``with_sharding_constraint`` is the same
    constraint on the cotangent, so the backward meets the placements the
    forward was given (DTensor's ``redistribute`` would send the gradient
    back to the input's placement instead)."""

    @staticmethod
    def forward(ctx, x, dm, pl):
        ctx.dm, ctx.pl = dm, pl
        return x.redistribute(dm, pl)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.pl):
            g = g.redistribute(ctx.dm, ctx.pl)
        return g, None, None


def to_dtensor(x, spec, mesh):
    """``x`` as a DTensor on the distributed ``mesh`` under ``spec``: a
    DTensor is redistributed (a no-op where it is placed so already), its
    gradient constrained alike; a plain tensor holds the global value,
    the same on every rank, and is cut to this rank's part with no
    collective (differentiably, so a tensor of the model's graph stays in
    it)."""
    from torch.distributed.tensor import DTensor, Replicate
    dm, pl = mesh.device_mesh, tuple(placements(spec, mesh))
    if not isinstance(x, DTensor):
        if x.device != mesh.device:
            raise ValueError(f"the tensor is on {x.device}, this rank's "
                             f"device is {mesh.device}")
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    elif x.device_mesh != dm:
        raise ValueError("the DTensor lies on another mesh")
    if tuple(x.placements) == pl and not x.requires_grad:
        return x
    return _Constrain.apply(x, dm, pl)


def place(tree, shardings):
    """Place ``tree`` under its shardings (a matching tree of
    :class:`NamedSharding`): on a distributed mesh each leaf becomes a
    DTensor holding this rank's part (moved to this rank's device first;
    a DTensor is redistributed; a scalar, such as a step counter or a
    cache index, stays the plain tensor it is, the same on every rank); on a
    virtual mesh the tree is returned as it is (one card holds every
    entry's part)."""
    specs = dict(tree_leaves_with_path(shardings))

    def one(path, leaf):
        sh = specs[path]
        if not is_distributed(sh.mesh) or not hasattr(leaf, "shape"):
            return leaf
        if len(leaf.shape) == 0:       # a counter: the same on every rank
            return leaf
        from torch.distributed.tensor import DTensor
        if isinstance(leaf, DTensor):
            return to_dtensor(leaf, sh.spec, sh.mesh)
        leaf = torch.as_tensor(leaf).detach()
        return to_dtensor(leaf.to(sh.mesh.device), sh.spec,
                          sh.mesh).detach()

    return tree_map_with_path(one, tree)


def placed_like(x, old):
    """``x`` redistributed to ``old``'s placements where both are
    DTensors (a new optimizer moment keeps its state's placement, a cache
    entry the cache's); anything else as it is."""
    if hasattr(old, "device_mesh") and hasattr(x, "device_mesh") and \
            tuple(x.placements) != tuple(old.placements):
        return x.redistribute(old.device_mesh, old.placements)
    return x


def rank_slices(sharding: NamedSharding, shape) -> Tuple[slice, ...]:
    """The slices of a global array of ``shape`` that this rank holds on
    ``sharding``'s distributed mesh: ``indices()`` at its coordinate."""
    import torch.distributed as dist
    return sharding.indices(tuple(shape))[dist.get_rank()]


def from_part(part, sharding: NamedSharding, shape):
    """A DTensor of global ``shape`` from this rank's ``part`` (the slices
    :func:`rank_slices` gives it), moved to this rank's device; no
    collective."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    part = torch.as_tensor(part).to(mesh.device).contiguous()
    stride = tuple(int(x) for x in torch.empty(
        tuple(shape), device="meta").stride())
    return DTensor.from_local(part, mesh.device_mesh,
                              placements(sharding.spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def local_range(x, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's stretch of a DTensor's
    ``dim``, split evenly (as the rules split) over the mesh dims that
    shard it, major first; computed from the rank's coordinate, with no
    tensor made."""
    from torch.distributed.tensor import Shard
    dm, n = x.device_mesh, x.shape[dim]
    coord = dm.get_coordinate()
    k, parts = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            if type(p) is not Shard:
                raise NotImplementedError(f"placement {p} of dim {dim}")
            k = k * dm.size(i) + coord[i]
            parts *= dm.size(i)
    size = n // parts
    return k * size, size


def constraint_spec(shape, axes: Sequence, mesh) -> P:
    """The spec ``constrain`` resolves ``axes`` to on ``mesh``: "dp" -> all
    data axes, an axis the mesh lacks -> None, then validated."""
    resolved = []
    for a in axes:
        if a == "dp":
            ax = data_axes(mesh)
            resolved.append(ax if len(ax) > 1 else (ax[0] if ax else None))
        elif a is None or a in mesh.axis_names:
            resolved.append(a)
        else:
            resolved.append(None)
    return _validate(P(*resolved), shape, mesh)


def spmd():
    """A context for one rank's program on the ambient mesh: on a
    distributed mesh, plain tensors mix with DTensors as replicated ones
    (``implicit_replication``; a plain tensor the program makes is the
    same on every rank); elsewhere nothing."""
    mesh = _context_mesh()
    if mesh is None or not is_distributed(mesh):
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, nestable: it restores the
    setting it found (DTensor's own clears it on exit)."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before


def constrain_like_params(tree, cfg: Optional[ModelConfig] = None):
    """Constrain a parameter-shaped tree (e.g. gradients) to the
    parameter rules against the ambient mesh: no-op without one, the tree
    itself where a virtual mesh names only its leaves' device, each leaf
    redistributed to its parameter's spec on a distributed mesh."""
    mesh = _context_mesh()
    if mesh is None:
        return tree

    def one(path, leaf):
        spec = leaf_spec(path, leaf.shape, mesh, cfg)
        if is_distributed(mesh):
            return to_dtensor(leaf, spec, mesh)
        _placed(leaf, mesh)
        return leaf

    return tree_map_with_path(one, tree)


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` against the ambient
    mesh.  ``axes`` entries: "dp" -> all data axes, "model", or None.
    Without a mesh (smoke tests, one-device runs) it is a no-op; on a
    virtual mesh naming only ``x``'s device it returns ``x``; on a
    distributed mesh it redistributes ``x`` to the resolved spec (a plain
    tensor is the global value, as :func:`to_dtensor` takes it)."""
    mesh = _context_mesh()
    if mesh is None:
        return x
    spec = constraint_spec(x.shape, axes, mesh)
    if is_distributed(mesh):
        return to_dtensor(x, spec, mesh)
    _placed(x, mesh)
    return x
