"""Numeric predicate pushdown -- the value side of the statistics plane.

Label predicates (:mod:`repro_torch.core.labels`) derive their qualifying-id
hull from RLE interval lists; this module extends the same compiled
filtering plane to **numeric property comparisons**.  A
:class:`NumProp` builder turns comparison operators into frozen
:class:`NumCmp` leaves (half-open value ranges ``lo <= prop < hi``);
the leaves compile through the :func:`~repro_torch.core.labels.
compile_cond` stack machine (they expose ``leaf_key()``), so AND / OR /
NOT combinations of numeric comparisons evaluate with the same flat
program that label predicates use -- host planes, bitmap words, and
device kernels alike.

:class:`NumericFilter` is the :class:`~repro_torch.core.labels.LabelFilter`
sibling the retrieval plane's ``filter=`` hook consumes.  Evaluation is
itself statistics-pruned: each leaf's value range is compared against
the property column's **per-page zone maps** (``PlainColumn.
page_stats``), and only pages whose ``[vmin, vmax]`` hull can intersect
the leaf's range are ever read -- pages skipped by the zone map are
provably all-False for that leaf, so the per-leaf boolean planes (and
everything derived from them: qualifying intervals, bitmaps, the
kernel :class:`~repro_torch.kernels.label_filter.ops.FilterPlan`) are
exact.
The filter's data-page I/O is recorded once at first evaluation and
replayed verbatim by :meth:`NumericFilter.charge` so every engine and
dispatch path charges identically, mirroring the label plane's
metadata-charge discipline.

Downstream, ``NumericFilter.qual_range()`` yields the qualifying-id
hull that drives partition, page, and delta-segment statistics pruning
-- numeric predicates push down exactly like label predicates do.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .encoding import hull_intersects, rle_encode_bool
from .labels import (Cond, Intervals, LabelFilter, Not, bitmap_to_intervals,
                     compile_cond, eval_program, interval_hull,
                     intervals_to_bitmap)
from .storage import IOMeter
from .vertex import VertexTable

#: sentinels for unbounded comparison sides (well outside any int64
#: property this repo stores, and far from int64 overflow under +-1).
VALUE_LO = -(2 ** 62)
VALUE_HI = 2 ** 62


class NumCmp(Cond):
    """One half-open numeric comparison ``lo <= prop < hi`` (a leaf).

    Frozen and hashable -- :func:`~repro_torch.core.labels.compile_cond`
    dedupes leaves by :meth:`leaf_key`, and filter plans are cached per
    compiled program.
    """

    __slots__ = ("prop", "lo", "hi")

    def __init__(self, prop: str, lo: int, hi: int):
        object.__setattr__(self, "prop", prop)
        object.__setattr__(self, "lo", int(lo))
        object.__setattr__(self, "hi", int(hi))

    def __setattr__(self, *a):
        raise AttributeError("NumCmp is immutable")

    def leaf_key(self) -> "NumCmp":
        return self

    def labels(self) -> List[str]:
        return []

    def evaluate(self, env: Dict) -> np.ndarray:
        return env[self]

    def __hash__(self) -> int:
        return hash((NumCmp, self.prop, self.lo, self.hi))

    def __eq__(self, other) -> bool:
        return (isinstance(other, NumCmp) and self.prop == other.prop
                and self.lo == other.lo and self.hi == other.hi)

    def __repr__(self) -> str:
        lo = "" if self.lo <= VALUE_LO else f"{self.lo}<="
        hi = "" if self.hi >= VALUE_HI else f"<{self.hi}"
        return f"({lo}{self.prop}{hi})"


class NumProp:
    """Comparison builder over one numeric vertex property.

    ``NumProp("age") >= 30`` / ``< 18`` / ``== 7`` /
    ``.between(10, 20)`` all yield :class:`NumCmp` leaves composable
    with ``&``, ``|``, ``~`` -- and with label leaves they must *not*
    be mixed inside one filter (each filter evaluates over one plane
    family).
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __ge__(self, v) -> NumCmp:
        return NumCmp(self.name, int(v), VALUE_HI)

    def __gt__(self, v) -> NumCmp:
        return NumCmp(self.name, int(v) + 1, VALUE_HI)

    def __lt__(self, v) -> NumCmp:
        return NumCmp(self.name, VALUE_LO, int(v))

    def __le__(self, v) -> NumCmp:
        return NumCmp(self.name, VALUE_LO, int(v) + 1)

    def __eq__(self, v) -> NumCmp:  # type: ignore[override]
        return NumCmp(self.name, int(v), int(v) + 1)

    def __ne__(self, v) -> Cond:  # type: ignore[override]
        return Not(NumCmp(self.name, int(v), int(v) + 1))

    def between(self, lo, hi) -> NumCmp:
        """Half-open range ``lo <= prop < hi``."""
        return NumCmp(self.name, int(lo), int(hi))

    def __repr__(self) -> str:
        return f"NumProp({self.name!r})"


class NumericFilter(LabelFilter):
    """A compiled numeric predicate bound to one vertex table.

    Drop-in sibling of :class:`~repro_torch.core.labels.LabelFilter`: the
    retrieval plane's ``filter=`` hook, the fused kernel dispatches
    (via the inherited :meth:`plan`-consuming paths), and the
    statistics pushdown (``qual_range``) all work unchanged.  The leaf
    planes are built once, zone-map-pruned (see the module docstring),
    and the I/O of that one evaluation replays deterministically on
    every :meth:`charge`.
    """

    def __init__(self, vt: VertexTable, cond: Cond):
        self.vt = vt
        self.cond = cond
        self.program = compile_cond(cond)
        bad = [l for l in self.program.labels if not isinstance(l, NumCmp)]
        if bad:
            raise TypeError("NumericFilter conditions must be built from "
                            f"NumProp comparisons; got {bad[0]!r} (label "
                            "and numeric leaves cannot mix in one filter)")
        self._plan = None
        self._bitmaps: Dict[str, np.ndarray] = {}
        self._intervals: "Intervals | None" = None
        self._pacs: Dict = {}
        self._planes: "List[np.ndarray] | None" = None
        self._io: "Tuple[int, int] | None" = None
        #: property zone-map counters (observability only)
        self.prop_pages_read = 0
        self.prop_pages_skipped = 0

    # -- evaluation -----------------------------------------------------------

    def _leaf_planes(self) -> List[np.ndarray]:
        """Per-leaf boolean planes over ``[0, num_vertices)``, built once.

        Leaves grouped per property read the union of their zone-map-
        qualifying pages in one metered fetch; pages outside a leaf's
        hull stay False in its plane (exact -- the zone map proves no
        value there can satisfy the comparison), which keeps NOT safe
        through the program.
        """
        if self._planes is not None:
            return self._planes
        n = self.vt.num_vertices
        meter = IOMeter()
        leaves: List[NumCmp] = list(self.program.labels)
        planes: List = [None] * len(leaves)
        by_prop: Dict[str, List[int]] = {}
        for i, leaf in enumerate(leaves):
            by_prop.setdefault(leaf.prop, []).append(i)
        for prop, idxs in sorted(by_prop.items()):
            col = self.vt.property_column(prop)
            if not hasattr(col, "page_stats"):
                # no zone maps on this encoding: whole-column read
                vals = np.asarray(col.read_all(meter))
                for i in idxs:
                    lf = leaves[i]
                    planes[i] = (vals >= lf.lo) & (vals < lf.hi)
                continue
            stats = col.page_stats()
            ps = col.page_size
            quals = {i: [p for p, s in enumerate(stats)
                         if hull_intersects(s.vmin, s.vmax,
                                            leaves[i].lo, leaves[i].hi)]
                     for i in idxs}
            need = sorted({p for pl in quals.values() for p in pl})
            got = col.read_pages(need, meter) if need else {}
            self.prop_pages_read += len(need)
            self.prop_pages_skipped += len(stats) - len(need)
            for i in idxs:
                lf = leaves[i]
                plane = np.zeros(n, bool)
                for p in quals[i]:
                    seg = np.asarray(got[p])
                    plane[p * ps: p * ps + len(seg)] = \
                        (seg >= lf.lo) & (seg < lf.hi)
                planes[i] = plane
        self._io = (meter.nbytes, meter.nrequests)
        self._planes = planes
        return planes

    # -- LabelFilter interface ------------------------------------------------

    def charge(self, meter) -> None:
        """Replay the evaluation's recorded data-page I/O -- identical
        on every engine and dispatch path, like the label plane's
        metadata charge."""
        self._leaf_planes()
        if meter is not None:
            meter.record(*self._io)

    def plan(self):
        """Kernel-plane inputs: the leaf planes RLE-encoded into the
        exact pos/meta layout label plans use, so the cond kernels (and
        the fused filtered retrieval built on them) run unchanged.  The
        qualifying hull is set eagerly from the host intervals -- the
        lazy label-plane derivation resolves leaves by name and does
        not apply here."""
        if self._plan is None:
            from repro_torch.kernels._pad import next_multiple
            from repro_torch.kernels.label_filter.ops import FilterPlan
            planes = self._leaf_planes()
            n = self.vt.num_vertices
            rles = [rle_encode_bool(pl) for pl in planes]
            n_pos = next_multiple(max(r.positions.size for r in rles), 128)
            pos = np.full((len(rles), n_pos), n, np.int32)
            meta = np.zeros((len(rles), 2), np.int32)
            for i, r in enumerate(rles):
                pos[i, :r.positions.size] = r.positions
                meta[i] = (int(r.first_value), n)
            plan = FilterPlan(self.program, pos, meta, n, vt=self.vt)
            plan._qual = interval_hull(*self.intervals("numpy"))
            self._plan = plan
        return self._plan

    def intervals(self, engine: str = "numpy") -> Intervals:
        if engine == "numpy":
            if self._intervals is None:
                keep = np.asarray(
                    eval_program(self.program.ops, self._leaf_planes()),
                    bool)
                self._intervals = \
                    rle_encode_bool(keep).interval_starts(True)
            return self._intervals
        return bitmap_to_intervals(self.bitmap(engine),
                                   self.vt.num_vertices)

    def bitmap(self, engine: str = "numpy") -> np.ndarray:
        words = self._bitmaps.get(engine)
        if words is None:
            if engine == "numpy":
                words = intervals_to_bitmap(self.intervals("numpy"),
                                            self.vt.num_vertices)
            else:
                from repro_torch.kernels.pac_decode.ops import engine_device
                plan = self.plan()
                words = plan.device_bitmap(engine_device(engine),
                                           plan.n_words)
                words = words.cpu().numpy().view(np.uint32)
            self._bitmaps[engine] = words
        return words

    def __repr__(self) -> str:
        return f"NumericFilter({self.vt.schema.name}, {self.cond})"
