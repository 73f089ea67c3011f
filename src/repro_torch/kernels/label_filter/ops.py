"""Storage-plane integration of the filtering plane.

A compiled :class:`~repro_torch.core.labels.CondProgram` over RLE label
columns evaluates

* on the ``numpy`` engine as the vectorized run-boundary merge
  (:func:`repro_torch.core.labels.program_filter_intervals`, the host
  oracle),
* on the ``torch`` (CPU) and ``cuda`` engines as the ``cond_bitmap``
  kernel (:mod:`.kernel`) over the interval position lists.

All engines charge the same I/O -- the referenced labels' RLE metadata --
through :func:`repro_torch.core.labels.charge_label_metadata`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.labels import (Cond, CondProgram, Intervals,
                                     bitmap_to_intervals,
                                     charge_label_metadata, compile_cond,
                                     interval_hull, intervals_to_bitmap,
                                     program_filter_intervals)
from repro_torch.core.pac import PAC
from repro_torch.core.vertex import VertexTable
from repro_torch.kernels._pad import next_multiple
from repro_torch.kernels.pac_decode.ops import engine_device

from . import kernel as K


@dataclasses.dataclass
class FilterPlan:
    """Padded kernel inputs for one (vertex table, program) pair.

    ``pos`` stacks every leaf label's interval position list, padded with
    ``count`` (the searchsorted sentinel); ``meta[i] = (first_value,
    count)``.  Built once per filter and reused across dispatches.

    Label columns are immutable, so the plan also owns the filtering
    plane's **device residency**: :meth:`device` mirrors the RLE run
    arrays once per device, and :meth:`device_bitmap` caches the
    evaluated predicate plane per (device, n_words) -- the fused filtered
    retrieval ANDs that plane instead of re-running the per-lane binary
    searches every dispatch.
    """

    program: CondProgram
    pos: np.ndarray    # int32 [k, n_pos]
    meta: np.ndarray   # int32 [k, 2]
    count: int         # number of rows (vertices)
    #: vertex table the plan was built over (for the lazy qualifying-hull
    #: evaluation; label columns are immutable).
    vt: "VertexTable | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    _qual: "Tuple[int, int] | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    #: device -> (pos, meta) tensors; populated lazily, once each.
    _device: Dict[str, Tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    #: (device, n_words) -> int32[n_words] predicate plane on the device;
    #: ("mesh", devices, n_words) -> one plane per mesh entry.
    _device_bitmaps: Dict[Tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return -(-self.count // 32)

    def qual_range(self) -> Tuple[int, int]:
        """Half-open hull ``[lo, hi)`` of the qualifying ids, evaluated on
        the host on first use and cached (page pruning compares page
        hulls against it).  ``(0, 0)`` when nothing qualifies."""
        if self._qual is None:
            self._qual = interval_hull(
                *program_filter_intervals(self.vt, self.program))
        return self._qual

    def device(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device mirror of the RLE run arrays (once per device)."""
        key = str(torch.device(device))
        arrs = self._device.get(key)
        if arrs is None:
            arrs = (torch.from_numpy(self.pos).to(key),
                    torch.from_numpy(self.meta).to(key))
            self._device[key] = arrs
        return arrs

    def device_bitmap(self, device, n_words: int) -> torch.Tensor:
        """Predicate plane over ``[0, 32 * n_words)`` on ``device``,
        evaluated once per (device, n_words) by ``cond_bitmap``; lanes
        past ``count`` are zero."""
        key = (str(torch.device(device)), n_words)
        words = self._device_bitmaps.get(key)
        if words is None:
            words = K.cond_bitmap(*self.device(device), self.program.ops,
                                  n_words)
            self._device_bitmaps[key] = words
        return words


    def device_bitmap_sharded(self, device_or_mesh, n_words: int
                              ) -> Tuple[torch.Tensor, ...]:
        """The predicate plane for every entry of a partition mesh (a
        tuple of devices, or one device): one copy per distinct device,
        evaluated on the first and copied to the others, placed once per
        (mesh, n_words), so a filtered multi-device dispatch ships no
        label bytes."""
        mesh = (tuple(device_or_mesh)
                if isinstance(device_or_mesh, (tuple, list))
                else (device_or_mesh,))
        mesh = tuple(torch.device(d) for d in mesh)
        key = ("mesh", tuple(str(d) for d in mesh), n_words)
        planes = self._device_bitmaps.get(key)
        if planes is None:
            first = self.device_bitmap(mesh[0], n_words)
            copies = {str(mesh[0]): first}
            for d in mesh:
                if str(d) not in copies:
                    copies[str(d)] = first.to(d)
            planes = tuple(copies[str(d)] for d in mesh)
            self._device_bitmaps[key] = planes
        return planes


def make_plan(vt: VertexTable, cond: Union[Cond, CondProgram]) -> FilterPlan:
    program = compile_cond(cond)
    if not program.labels:
        raise ValueError("condition references no labels")
    rles = [vt.label_rle(n) for n in program.labels]
    n = vt.num_vertices
    n_pos = next_multiple(max(r.positions.size for r in rles), 128)
    pos = np.full((len(rles), n_pos), n, np.int32)
    meta = np.zeros((len(rles), 2), np.int32)
    for i, r in enumerate(rles):
        pos[i, :r.positions.size] = r.positions
        meta[i] = (int(r.first_value), n)
    return FilterPlan(program, pos, meta, n, vt=vt)


def label_filter_bitmap(vt: VertexTable, cond: Union[Cond, CondProgram],
                        meter=None, engine: str = "cuda") -> np.ndarray:
    """Whole-table predicate bitmap: uint32 words over [0, num_vertices)."""
    program = compile_cond(cond)
    charge_label_metadata(vt, program.labels, meter)
    if engine == "numpy":
        return intervals_to_bitmap(program_filter_intervals(vt, program),
                                   vt.num_vertices)
    plan = make_plan(vt, program)
    dev = engine_device(engine)
    words = K.cond_bitmap(*plan.device(dev), program.ops, plan.n_words)
    return words.cpu().numpy().view(np.uint32)


def label_filter_intervals(vt: VertexTable, cond: Union[Cond, CondProgram],
                           meter=None, engine: str = "cuda") -> Intervals:
    """Qualifying half-open intervals; engine-dispatched, same accounting."""
    program = compile_cond(cond)
    if engine == "numpy":
        charge_label_metadata(vt, program.labels, meter)
        return program_filter_intervals(vt, program)
    return bitmap_to_intervals(
        label_filter_bitmap(vt, program, meter, engine), vt.num_vertices)


def label_filter_pac(vt: VertexTable, cond: Union[Cond, CondProgram],
                     page_size: int, meter=None,
                     engine: str = "cuda") -> PAC:
    """Qualifying ids as a PAC over ``page_size`` pages (bitmap planes on
    the kernel engines).  One-shot wrapper around
    :meth:`repro_torch.core.labels.LabelFilter.pac`, which owns the
    plane-selection logic and the memoization for long-lived filters."""
    from repro_torch.core.labels import LabelFilter
    f = LabelFilter(vt, cond)
    f.charge(meter)
    return f.pac(page_size, engine)
