"""Label filtering (paper §5).

Simple conditions (Definition 3): the RLE interval list ``P`` of a label
column directly yields the qualifying intervals -- "select all odd intervals
or all even intervals" -- in ``O(|P|)`` instead of ``O(n)``.

Complex conditions (Definition 4): a UDF ``f`` over ``k`` labels.  Theorem 1:
if no interval-list position breaks ``[s, e)``, all vertices inside share all
``k`` label values, so one representative evaluation suffices.  The
merge-based algorithm merges the ``k`` sorted position lists into one list
``P`` (we use a vectorized sorted-union; the k-way heap merge of the paper is
a CPU idiom) and calls the UDF once per merged interval -- vectorized here as
a single batched evaluation over all representatives.

The filtering plane: a :class:`Cond` tree is **compiled** to a flat
postfix program (:func:`compile_cond`) evaluated by a stack machine with no
per-node recursion -- the same program runs over numpy boolean planes at run
representatives (host engine), torch bool planes (the plain PyTorch
version), or as an opcode array inside the CUDA ``cond_bitmap`` kernel.
:class:`LabelFilter` bundles a vertex table with a compiled predicate so
retrieval paths can push the filter down into the fused decode->bitmap
dispatch (see ``core/neighbor.py``).

Baselines reproduced for the paper's figures:
* ``filter_string``        -- decode concatenated label strings, match per vertex
* ``filter_binary_plain``  -- per-vertex boolean column scan
* ``filter_binary_rle``    -- RLE decode to per-vertex booleans, then scan
* ``filter_rle_interval``  -- GraphAr: interval selection / merge (this module)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .encoding import RleColumn
from .pac import PAC
from .vertex import VertexTable

Intervals = Tuple[np.ndarray, np.ndarray]  # (starts, ends), half-open


def interval_hull(starts, ends) -> Tuple[int, int]:
    """Half-open hull ``[lo, hi)`` of a sorted interval list.

    The qualifying-hull derivation behind ``FilterPlan.qual_range`` --
    ``(0, 0)`` when nothing qualifies (everything prunes; no id can
    pass)."""
    return (int(starts[0]), int(ends[-1])) if len(starts) else (0, 0)


# --------------------------------------------------------------------------
# condition expression mini-language (Cypher/GQL label predicates)
# --------------------------------------------------------------------------

class Cond:
    """Label condition AST: (person:Asian&Enrollee), (A&!B)|C, ..."""

    def labels(self) -> List[str]:
        raise NotImplementedError

    def evaluate(self, env: Dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def __and__(self, other: "Cond") -> "Cond":
        return And(self, other)

    def __or__(self, other: "Cond") -> "Cond":
        return Or(self, other)

    def __invert__(self) -> "Cond":
        return Not(self)


class L(Cond):
    def __init__(self, name: str):
        self.name = name

    def labels(self) -> List[str]:
        return [self.name]

    def evaluate(self, env):
        return env[self.name]

    def __repr__(self):
        return f":{self.name}"


class And(Cond):
    def __init__(self, a: Cond, b: Cond):
        self.a, self.b = a, b

    def labels(self):
        return self.a.labels() + self.b.labels()

    def evaluate(self, env):
        return self.a.evaluate(env) & self.b.evaluate(env)

    def __repr__(self):
        return f"({self.a}&{self.b})"


class Or(Cond):
    def __init__(self, a: Cond, b: Cond):
        self.a, self.b = a, b

    def labels(self):
        return self.a.labels() + self.b.labels()

    def evaluate(self, env):
        return self.a.evaluate(env) | self.b.evaluate(env)

    def __repr__(self):
        return f"({self.a}|{self.b})"


class Not(Cond):
    def __init__(self, a: Cond):
        self.a = a

    def labels(self):
        return self.a.labels()

    def evaluate(self, env):
        return ~self.a.evaluate(env)

    def __repr__(self):
        return f"!{self.a}"


# --------------------------------------------------------------------------
# compiled condition programs (the engine-dispatched filtering plane)
# --------------------------------------------------------------------------

OP_LEAF = "leaf"
OP_NOT = "not"
OP_AND = "and"
OP_OR = "or"


@dataclasses.dataclass(frozen=True)
class CondProgram:
    """A :class:`Cond` tree compiled to a flat postfix program.

    ``labels`` holds the distinct leaf labels in first-use order; ``ops``
    is the postfix op stream -- ``("leaf", i)`` pushes leaf plane ``i``,
    ``("not",)`` / ``("and",)`` / ``("or",)`` pop and combine.  Evaluation
    is a flat loop (:func:`eval_program`), not a per-node ``evaluate``
    recursion, and is polymorphic over the plane type: numpy boolean
    arrays at merged-run representatives or torch bool planes evaluate
    the same program; the CUDA kernel runs it as an opcode array.
    Frozen/hashable, so plans can be cached per program.
    """

    labels: Tuple
    ops: Tuple[Tuple, ...]


def compile_cond(cond: Cond) -> CondProgram:
    """Compile a condition tree into a :class:`CondProgram` (iterative
    postorder walk; the only tree traversal left in the plane).

    Leaves are label references (:class:`L`, keyed by name)."""
    if isinstance(cond, CondProgram):
        return cond
    labels: List = []
    index: Dict = {}
    ops: List[Tuple] = []
    stack: List[Tuple[Cond, bool]] = [(cond, False)]
    while stack:
        node, visited = stack.pop()
        key = node.name if isinstance(node, L) else None
        if key is not None:
            i = index.setdefault(key, len(labels))
            if i == len(labels):
                labels.append(key)
            ops.append((OP_LEAF, i))
        elif visited:
            ops.append((OP_NOT,) if isinstance(node, Not)
                       else (OP_AND,) if isinstance(node, And) else (OP_OR,))
        elif isinstance(node, Not):
            stack += [(node, True), (node.a, False)]
        elif isinstance(node, (And, Or)):
            stack += [(node, True), (node.b, False), (node.a, False)]
        else:
            raise TypeError(f"cannot compile {type(node).__name__}")
    return CondProgram(tuple(labels), tuple(ops))


def eval_program(ops: Sequence[Tuple], leaves: Sequence):
    """Stack-machine evaluation of a postfix op stream over leaf planes.

    Planes only need ``&``, ``|``, ``~`` -- numpy bool arrays, uint32
    words, and torch bool tensors all qualify.  NOT over word planes sets
    tail bits past the row count; callers mask the final plane once.
    """
    stack: List = []
    for op in ops:
        if op[0] == OP_LEAF:
            stack.append(leaves[op[1]])
        elif op[0] == OP_NOT:
            stack.append(~stack.pop())
        else:
            b, a = stack.pop(), stack.pop()
            stack.append((a & b) if op[0] == OP_AND else (a | b))
    if len(stack) != 1:
        raise ValueError(f"malformed program: {len(stack)} planes left")
    return stack[0]


def charge_label_metadata(vt: VertexTable, names: Sequence[str],
                          meter) -> None:
    """IOMeter charge for reading the referenced labels' RLE metadata --
    the one I/O a label filter performs.  Shared by every engine so the
    accounting is identical by construction."""
    if meter is None:
        return
    for n in dict.fromkeys(names):
        vt.label_column(n).read_range(0, 0, meter)


# --------------------------------------------------------------------------
# interval plane <-> bitmap plane
# --------------------------------------------------------------------------

def intervals_to_bitmap(iv: Intervals, n: int) -> np.ndarray:
    """uint32 bitmap words over ``[0, n)`` with the intervals' bits set
    (vectorized boundary-marker cumsum; no per-interval loop)."""
    n_words = -(-n // 32)
    if n_words == 0:
        return np.zeros(0, np.uint32)
    starts = np.minimum(np.asarray(iv[0], np.int64), n)
    ends = np.minimum(np.asarray(iv[1], np.int64), n)
    mark = np.zeros(n_words * 32 + 1, np.int32)
    np.add.at(mark, starts, 1)
    np.add.at(mark, ends, -1)
    dense = np.cumsum(mark[:-1]) > 0
    return np.packbits(dense, bitorder="little").view(np.uint32)


def bitmap_to_intervals(words: np.ndarray, n: int) -> Intervals:
    """Coalesced half-open intervals of the set bits of a dense bitmap."""
    bits = np.unpackbits(np.ascontiguousarray(words, np.uint32)
                         .view(np.uint8), bitorder="little")[:n]
    edges = np.diff(bits.astype(np.int8), prepend=np.int8(0),
                    append=np.int8(0))
    return (np.flatnonzero(edges == 1).astype(np.int64),
            np.flatnonzero(edges == -1).astype(np.int64))


class LabelFilter:
    """A compiled label predicate bound to one vertex table.

    The unit the retrieval plane's ``filter=`` hook consumes: it owns the
    compiled program, lazily builds the kernel plane's padded input arrays
    (:func:`repro_torch.kernels.label_filter.ops.make_plan`), and caches
    the whole-table bitmap per engine (label columns are immutable).  I/O
    charging is explicit (:meth:`charge`) so callers apply the same
    accounting on every execution path.
    """

    def __init__(self, vt: VertexTable, cond: Cond):
        self.vt = vt
        self.cond = cond
        self.program = compile_cond(cond)
        self._plan = None
        self._bitmaps: Dict[str, np.ndarray] = {}
        self._intervals: "Intervals | None" = None
        self._pacs: Dict[Tuple[int, str], PAC] = {}

    def charge(self, meter) -> None:
        charge_label_metadata(self.vt, self.program.labels, meter)

    def qual_range(self) -> Tuple[int, int]:
        """Half-open hull ``[lo, hi)`` of the qualifying ids (evaluated
        lazily, once, on the plan).  The statistics pushdown skips pages
        whose value hull cannot intersect it."""
        return self.plan().qual_range()

    def plan(self):
        """Padded kernel inputs (positions/meta) + program, built once.

        The plan also carries the filtering plane's device residency
        (``FilterPlan.device`` / ``device_bitmap``): because the plan is
        cached here for the filter's lifetime, the RLE run arrays and the
        evaluated predicate bitmap cross to the device once and are
        reused by every subsequent fused dispatch."""
        if self._plan is None:
            from repro_torch.kernels.label_filter import ops as lf_ops
            self._plan = lf_ops.make_plan(self.vt, self.program)
        return self._plan

    def intervals(self, engine: str = "numpy") -> Intervals:
        if engine == "numpy":
            if self._intervals is None:
                self._intervals = program_filter_intervals(self.vt,
                                                           self.program)
            return self._intervals
        return bitmap_to_intervals(self.bitmap(engine), self.vt.num_vertices)

    def bitmap(self, engine: str = "numpy") -> np.ndarray:
        """uint32 words over ``[0, num_vertices)``; cached per engine."""
        words = self._bitmaps.get(engine)
        if words is None:
            from repro_torch.kernels.label_filter import ops as lf_ops
            words = lf_ops.label_filter_bitmap(self.vt, self.program,
                                               engine=engine)
            self._bitmaps[engine] = words
        return words

    def pac(self, page_size: int, engine: str = "numpy") -> PAC:
        """Filter PAC over ``page_size`` pages; memoized per (page size,
        engine) (label columns are immutable).  Callers must treat the
        returned PAC as read-only -- derive with ``intersect``/``union``,
        never mutate it in place."""
        pac = self._pacs.get((page_size, engine))
        if pac is None:
            if engine != "numpy" and page_size % 32 == 0:
                pac = PAC.from_dense_bitmap(self.bitmap(engine), page_size)
            else:
                pac = intervals_to_pac(self.intervals(engine),
                                       self.vt.num_vertices, page_size)
            self._pacs[(page_size, engine)] = pac
        return pac

    def mask_ids(self, ids: np.ndarray, engine: str = "numpy") -> np.ndarray:
        """Boolean membership mask for internal ids (bitmap probe)."""
        ids = np.asarray(ids, np.int64)
        words = self.bitmap(engine)
        return ((words[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1) \
            .astype(bool)

    def __repr__(self) -> str:
        return f"LabelFilter({self.vt.schema.name}, {self.cond})"


# --------------------------------------------------------------------------
# GraphAr fast paths
# --------------------------------------------------------------------------

def simple_filter_intervals(rle: RleColumn, exists: bool = True) -> Intervals:
    """Definition 3 via odd/even interval selection -- O(|P|)."""
    return rle.interval_starts(exists)


def merge_positions(rles: Sequence[RleColumn]) -> np.ndarray:
    """Merged breakpoint list P of k interval lists (sorted unique union)."""
    parts = [r.positions for r in rles]
    return np.unique(np.concatenate(parts))


def label_values_at(rle: RleColumn, points: np.ndarray) -> np.ndarray:
    """Label value at each representative vertex (vectorized Theorem 1).

    Run index of point p is ``searchsorted(positions, p, 'right') - 1``;
    value = first_value ^ (run_idx & 1).
    """
    run = np.searchsorted(rle.positions, points, side="right") - 1
    return (np.asarray(rle.first_value, bool)
            ^ ((run & 1).astype(bool)))


def program_filter_intervals(vt: VertexTable,
                             program: CondProgram) -> Intervals:
    """Merge-based complex filtering (paper §5.2, Fig. 7) over a compiled
    program: one vectorized run-boundary merge, leaf planes at the merged
    representatives (Theorem 1), then the flat stack machine -- the host
    engine of the filtering plane."""
    rles = [vt.label_rle(n) for n in program.labels]
    merged = merge_positions(rles)
    if merged.size < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    reps = merged[:-1]  # representative = interval start (Theorem 1)
    leaves = [label_values_at(r, reps) for r in rles]
    keep = np.asarray(eval_program(program.ops, leaves), bool)
    return _coalesce(merged[:-1][keep], merged[1:][keep])


def complex_filter_intervals(vt: VertexTable, cond: Cond) -> Intervals:
    """Compiled merge-based complex filtering (compile + host engine)."""
    return program_filter_intervals(vt, compile_cond(cond))


def evaluate_filter_intervals(vt: VertexTable, cond: Cond) -> Intervals:
    """Legacy per-node ``evaluate(env)`` recursion -- kept as the oracle
    the compiled plane is validated against (tests/benchmarks only)."""
    names = list(dict.fromkeys(cond.labels()))
    rles = [vt.label_rle(n) for n in names]
    merged = merge_positions(rles)
    if merged.size < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    reps = merged[:-1]
    env = {n: label_values_at(r, reps) for n, r in zip(names, rles)}
    keep = np.asarray(cond.evaluate(env), bool)
    return _coalesce(merged[:-1][keep], merged[1:][keep])


def _coalesce(starts: np.ndarray, ends: np.ndarray) -> Intervals:
    """Merge adjacent qualifying intervals (ends[i] == starts[i+1])."""
    if starts.size == 0:
        return starts.astype(np.int64), ends.astype(np.int64)
    new_run = np.ones(starts.size, bool)
    new_run[1:] = starts[1:] != ends[:-1]
    run_id = np.cumsum(new_run) - 1
    out_starts = starts[new_run]
    out_ends = np.zeros_like(out_starts)
    np.maximum.at(out_ends, run_id, ends)
    return out_starts.astype(np.int64), out_ends.astype(np.int64)


def intervals_to_pac(iv: Intervals, n: int, page_size: int) -> PAC:
    return PAC.from_intervals(iv[0], iv[1], n, page_size)


def intervals_to_ids(iv: Intervals) -> np.ndarray:
    """Concatenated ids of half-open intervals, fully vectorized.

    One repeat/cumsum construction instead of a Python loop of
    ``np.arange`` per interval: element ``j`` of the output is
    ``starts[i] + (j - offset[i])`` for its interval ``i``.
    """
    starts = np.asarray(iv[0], np.int64)
    ends = np.asarray(iv[1], np.int64)
    lengths = np.maximum(ends - starts, 0)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    keep = lengths > 0
    s, k = starts[keep], lengths[keep]
    within = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(k) - k, k)
    return np.repeat(s, k) + within


def intervals_count(iv: Intervals) -> int:
    return int((iv[1] - iv[0]).sum())


def filter_rle_interval(vt: VertexTable, cond: Cond, meter=None,
                        engine: str = "cuda") -> Intervals:
    """GraphAr entry point, engine-dispatched.

    ``numpy`` keeps the host plane (simple conditions take the O(|P|)
    odd/even path); the kernel engines evaluate the compiled program with
    the ``cond_bitmap`` kernel via :mod:`repro_torch.kernels.label_filter`
    -- identical IOMeter accounting (the referenced labels' RLE metadata)
    either way."""
    if engine != "numpy":
        from repro_torch.kernels.label_filter import ops as lf_ops
        return lf_ops.label_filter_intervals(vt, cond, meter, engine)
    charge_label_metadata(vt, compile_cond(cond).labels, meter)
    if isinstance(cond, L):
        return simple_filter_intervals(vt.label_rle(cond.name), True)
    if isinstance(cond, Not) and isinstance(cond.a, L):
        return simple_filter_intervals(vt.label_rle(cond.a.name), False)
    return complex_filter_intervals(vt, cond)


# --------------------------------------------------------------------------
# baselines (paper §6.3)
# --------------------------------------------------------------------------

def filter_string(vt: VertexTable, cond: Cond, meter=None) -> np.ndarray:
    """'string' baseline: split each vertex's label string, then match."""
    col = vt.table["<labels>"]
    strings = col.read_all(meter)
    names = list(dict.fromkeys(cond.labels()))
    n = vt.num_vertices
    env = {m: np.zeros(n, bool) for m in names}
    for i, s in enumerate(strings):
        if not s:
            continue
        present = s.split("|")
        for m in names:
            if m in present:
                env[m][i] = True
    return np.flatnonzero(cond.evaluate(env)).astype(np.int64)


def filter_binary_columns(vt: VertexTable, cond: Cond,
                          meter=None) -> np.ndarray:
    """'binary (plain)' / 'binary (RLE)' baselines: decode per-vertex bools
    for each referenced label column, evaluate per vertex."""
    names = list(dict.fromkeys(cond.labels()))
    env = {m: np.asarray(vt.label_column(m).read_all(meter), bool)
           for m in names}
    return np.flatnonzero(cond.evaluate(env)).astype(np.int64)
