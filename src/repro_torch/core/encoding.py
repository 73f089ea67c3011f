"""Page-level codecs for GraphAr columns.

Three encodings, mirroring the paper (§3-§5):

* ``plain``      -- raw little-endian values (Parquet PLAIN).
* ``delta``      -- Parquet-style DELTA_BINARY_PACKED: per page, a first
                    value followed by miniblocks of 32 deltas; each miniblock
                    subtracts its own ``min_delta`` and bitpacks the residuals
                    with a per-miniblock bit width restricted to powers of two
                    (``{0,1,2,4,8,16,32}``) so that packed values never
                    straddle 32-bit word boundaries.  The paper requires
                    power-of-two widths "for data alignment purposes"; the
                    same restriction lets the CUDA decode kernel unpack
                    every delta with one word load and one variable shift
                    (see kernels/pac_decode).
* ``rle``        -- boolean run-length encoding as an *interval position
                    list* ``P`` plus the first value (paper §5.1): run ``i``
                    covers ``[P[i], P[i+1])`` and has value
                    ``first_value ^ (i & 1)``.

All codecs are pure numpy (the storage plane); the PyTorch/CUDA decode
paths live in ``repro_torch.kernels`` and are validated against these.
The byte layout is the JAX package's, so a lake written by either
package reads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

# Rows per data page.  2048 rows x 4B ids = 8 KiB of packed payload upper
# bound per page; bitmap for a page = 2048 bits = 64 uint32 words.
# Configurable per file.
DEFAULT_PAGE_SIZE = 2048
MINIBLOCK = 32

#: Bit widths allowed for delta miniblocks (powers of two only).
ALLOWED_WIDTHS = (0, 1, 2, 4, 8, 16, 32)

#: bit layout of the unpack plan's packed ``pos`` lane (see
#: :meth:`PackedPages.unpack_plan`): ``widx << 11 | shift << 6 | bw``.
#: shift < 32 (5 bits), bw <= 32 (6 bits), widx < 2^20 (checked).
POS_WIDX_SHIFT = 11
POS_SHIFT_SHIFT = 6
POS_BW_MASK = 63


# --------------------------------------------------------------------------
# bitpacking (vectorized, power-of-two widths only)
# --------------------------------------------------------------------------

def _round_up_width(nbits: int) -> int:
    for w in ALLOWED_WIDTHS:
        if nbits <= w:
            return w
    raise ValueError(f"required width {nbits} > 32")


def bitpack(values: np.ndarray, bit_width: int) -> np.ndarray:
    """Pack ``values`` (non-negative, < 2**bit_width) into a uint32 word array.

    Values are laid out little-endian within each word; with power-of-two
    widths exactly ``32 // bit_width`` values occupy one word and no value
    straddles a word boundary.
    """
    if bit_width == 0:
        return np.zeros(0, dtype=np.uint32)
    if bit_width not in ALLOWED_WIDTHS:
        raise ValueError(f"bit width {bit_width} not in {ALLOWED_WIDTHS}")
    v = np.asarray(values, dtype=np.uint64)
    if v.size and bit_width < 64:
        assert int(v.max()) < (1 << bit_width), "value overflows bit width"
    per_word = 32 // bit_width
    pad = (-len(v)) % per_word
    if pad:
        v = np.concatenate([v, np.zeros(pad, dtype=np.uint64)])
    v = v.reshape(-1, per_word)
    shifts = (np.arange(per_word, dtype=np.uint64) * bit_width)
    words = np.bitwise_or.reduce(v << shifts, axis=1)
    return words.astype(np.uint32)


def bitunpack(words: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """Inverse of :func:`bitpack`; returns ``count`` uint32 values."""
    if bit_width == 0:
        return np.zeros(count, dtype=np.uint32)
    per_word = 32 // bit_width
    w = np.asarray(words, dtype=np.uint32)
    idx = np.arange(count, dtype=np.int64)
    word = w[idx // per_word].astype(np.uint64)
    shift = ((idx % per_word) * bit_width).astype(np.uint64)
    mask = np.uint64((1 << bit_width) - 1)
    return ((word >> shift) & mask).astype(np.uint32)


# --------------------------------------------------------------------------
# delta (DELTA_BINARY_PACKED-style)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DeltaPage:
    """One delta-encoded data page.

    ``packed`` concatenates the miniblocks' word arrays;
    ``word_offsets[i]`` is the starting word of miniblock ``i``.

    ``vmin``/``vmax`` are the page's value statistics, recorded at encode
    time (the values are in hand then; recovering them later would cost a
    decode).  They feed the statistics pushdown: a page whose
    ``[vmin, vmax]`` hull cannot intersect a
    predicate's qualifying id range contributes nothing and can be
    skipped.  An empty page records the empty hull ``(0, -1)``.
    """

    count: int
    first_value: int
    min_deltas: np.ndarray     # int64 [n_mini]
    bit_widths: np.ndarray     # uint8 [n_mini]
    word_offsets: np.ndarray   # int32 [n_mini]
    packed: np.ndarray         # uint32 [n_words]
    vmin: int = 0              # min value in the page (0 if empty)
    vmax: int = -1             # max value in the page (-1 if empty)

    def nbytes(self) -> int:
        # Physical layout cost: header (count, first) + per-miniblock
        # (min_delta varint approximated as 4B, width 1B) + packed words.
        return (12 + self.min_deltas.size * 5 + self.packed.nbytes)

    def max_bit_width(self) -> int:
        return int(self.bit_widths.max()) if self.bit_widths.size else 0

def delta_encode_page(values: np.ndarray) -> DeltaPage:
    v = np.asarray(values, dtype=np.int64)
    n = len(v)
    if n == 0:
        return DeltaPage(0, 0, np.zeros(0, np.int64), np.zeros(0, np.uint8),
                         np.zeros(0, np.int32), np.zeros(0, np.uint32))
    deltas = np.diff(v)  # n-1 deltas
    n_mini = max(1, -(-len(deltas) // MINIBLOCK))
    min_deltas = np.zeros(n_mini, np.int64)
    widths = np.zeros(n_mini, np.uint8)
    offsets = np.zeros(n_mini, np.int32)
    chunks: List[np.ndarray] = []
    woff = 0
    for i in range(n_mini):
        blk = deltas[i * MINIBLOCK:(i + 1) * MINIBLOCK]
        if blk.size == 0:
            continue
        lo = int(blk.min())
        resid = (blk - lo).astype(np.uint64)
        hi = int(resid.max())
        bw = _round_up_width(int(hi).bit_length())
        min_deltas[i] = lo
        widths[i] = bw
        offsets[i] = woff
        words = bitpack(resid, bw)
        chunks.append(words)
        woff += len(words)
    packed = (np.concatenate(chunks) if chunks else np.zeros(0, np.uint32))
    return DeltaPage(n, int(v[0]), min_deltas, widths, offsets, packed,
                     vmin=int(v.min()), vmax=int(v.max()))


def delta_decode_page(page: DeltaPage) -> np.ndarray:
    """Pure-numpy decode, fully vectorized (same gather+variable-shift
    unpack as the CUDA kernel: power-of-two widths never straddle words).
    """
    if page.count == 0:
        return np.zeros(0, np.int64)
    n_deltas = page.count - 1
    if n_deltas == 0:
        return np.array([page.first_value], np.int64)
    idx = np.arange(n_deltas, dtype=np.int64)
    mini = idx // MINIBLOCK
    within = idx % MINIBLOCK
    bw = page.bit_widths[mini].astype(np.int64)
    bit_pos = within * bw
    word_idx = page.word_offsets[mini].astype(np.int64) + bit_pos // 32
    if page.packed.size:
        word_idx = np.minimum(word_idx, page.packed.size - 1)
        words = page.packed[word_idx].astype(np.uint64)
    else:
        words = np.zeros(n_deltas, np.uint64)
    shift = (bit_pos % 32).astype(np.uint64)
    mask = np.where(bw >= 32, np.uint64(0xFFFFFFFF),
                    (np.uint64(1) << bw.astype(np.uint64))
                    - np.uint64(1))
    resid = ((words >> shift) & mask).astype(np.int64)
    resid[bw == 0] = 0
    deltas = resid + page.min_deltas[mini]
    out = np.empty(page.count, np.int64)
    out[0] = page.first_value
    np.cumsum(deltas, out=out[1:])
    out[1:] += page.first_value
    return out


# --------------------------------------------------------------------------
# RLE for boolean label columns (interval position lists)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RleColumn:
    """Whole-column RLE of a boolean array as interval positions.

    ``positions`` = [0, p1, p2, ..., n]; run ``i`` spans
    ``[positions[i], positions[i+1])`` with value ``first_value ^ (i & 1)``.
    """

    count: int
    first_value: bool
    positions: np.ndarray  # int64 [n_runs + 1]

    def nbytes(self) -> int:
        # 4B per position (ids < 2^32 in our graphs) + 1B header
        return 4 * self.positions.size + 5

    @property
    def n_runs(self) -> int:
        return max(0, self.positions.size - 1)

    def interval_starts(self, value: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Intervals (starts, ends) where the column equals ``value``.

        Paper §5.1: "simply select all odd intervals or all even intervals".
        """
        p = self.positions
        start_idx = 0 if (value == self.first_value) else 1
        starts = p[start_idx:-1:2]
        ends = p[start_idx + 1::2]
        return starts, ends


def rle_encode_bool(values: np.ndarray) -> RleColumn:
    v = np.asarray(values, dtype=bool)
    n = len(v)
    if n == 0:
        return RleColumn(0, False, np.zeros(1, np.int64))
    change = np.flatnonzero(v[1:] != v[:-1]) + 1
    positions = np.concatenate([[0], change, [n]]).astype(np.int64)
    return RleColumn(n, bool(v[0]), positions)


def rle_decode_bool(col: RleColumn) -> np.ndarray:
    """The dense column: run ``i`` repeated over its length."""
    values = (np.arange(col.n_runs) & 1).astype(bool) ^ col.first_value
    return np.repeat(values, np.diff(col.positions))


# --------------------------------------------------------------------------
# plain
# --------------------------------------------------------------------------

def plain_encode(values: np.ndarray) -> bytes:
    return np.ascontiguousarray(values).tobytes()


def plain_decode(buf: bytes, dtype: np.dtype, count: int) -> np.ndarray:
    return np.frombuffer(buf, dtype=dtype, count=count)


# --------------------------------------------------------------------------
# column-level delta encode/decode over pages
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PackedPages:
    """Column-wide packed-page batch arrays (the kernels' input layout).

    One row per data page, padded to the fixed shapes the pac_decode
    kernels read.  Built once per column and cached on
    :class:`DeltaColumn` so repeated queries stop re-materializing the
    batch arrays.

    ``version`` snapshots :attr:`DeltaColumn.version` at build time so a
    page write invalidates the cache even when the page count is
    unchanged (in-place mutation of the last partial page).

    :meth:`device_plan` keeps a lazily-populated, device-keyed **mirror**
    of the decode-ready unpack plan (kernels 1 and 4 read it), and
    :meth:`device_pages` one of the raw miniblock arrays (kernel 2 reads
    them), both placed by one populate and sharing ``first`` and
    ``packed``: the packed column is immutable per version, so it crosses
    to the card once and every later dispatch ships only an int32
    page-index vector (the kernels gather rows on the device).  The
    mirrors die with this object, so a version bump (which rebuilds
    ``PackedPages``) also invalidates them.
    """

    first: np.ndarray         # int32  [n_pages, 1]
    min_deltas: np.ndarray    # int32  [n_pages, n_mini]
    bit_widths: np.ndarray    # int32  [n_pages, n_mini]
    word_offsets: np.ndarray  # int32  [n_pages, n_mini]
    packed: np.ndarray        # uint32 [n_pages, max_words]
    counts: np.ndarray        # int32  [n_pages, 1]
    #: rows per page (max_words == page_size by construction, but kept
    #: explicit so the unpack plan never guesses).
    page_size: int = 0
    #: :attr:`DeltaColumn.version` this build corresponds to.
    version: int = 0
    #: per-page value statistics (min/max id per page, int64[n_pages];
    #: empty pages record the empty hull (0, -1)).
    page_min: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    page_max: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    #: host-cached per-delta unpack plan (see :meth:`unpack_plan`).
    _plan: "Tuple | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    #: device -> ``(plan, pages)`` (see :meth:`device_plan` and
    #: :meth:`device_pages`).
    _device_plans: Dict[str, Tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    #: host->device transfers performed (one per device populated).
    device_transfers: int = dataclasses.field(
        default=0, repr=False, compare=False)
    #: set by :meth:`poison` alone (nothing in the port sets it on its
    #: own); the dispatch layers then route to the host oracle path
    #: (identical ids and IOMeter) until a version bump rebuilds this
    #: object.
    poisoned: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    #: dispatches that fell back to the host path because of poisoning.
    fallbacks: int = dataclasses.field(
        default=0, repr=False, compare=False)

    @property
    def n_pages(self) -> int:
        return self.first.shape[0]

    def host_arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.first, self.min_deltas, self.bit_widths,
                self.word_offsets, self.packed, self.counts)

    def unpack_plan(self) -> Tuple[np.ndarray, ...]:
        """Per-delta unpack plan: everything about the variable-shift
        decode that does not depend on the query, precomputed once.

        The miniblock metadata (bit width, word offset, min delta) is
        expanded to per-delta resolution and folded together.  ``pos``
        packs the word index, within-word shift, and effective bit width
        of delta ``j`` of page ``i`` into one int32 lane
        (``widx << POS_WIDX_SHIFT | shift << POS_SHIFT_SHIFT | bw``) --
        one gathered array instead of three -- and the effective width
        is already forced to 0 past ``counts[i] - 1`` and for zero-width
        miniblocks (a zero width decodes a zero mask, so no per-dispatch
        count compare); ``min_delta`` is zeroed the same way.  A
        dispatch then decodes with one word load, a shift, a mask and a
        row prefix sum per delta.

        Returns ``(first, pos, min_delta, packed)`` with the middle two
        shaped ``[n_pages, page_size - 1]``.
        """
        if self._plan is None:
            ps = self.page_size or self.packed.shape[1]
            d = np.arange(max(ps - 1, 1))
            n_mini = self.bit_widths.shape[1]
            mini = np.minimum(d // MINIBLOCK, n_mini - 1)
            within = d % MINIBLOCK
            bw = self.bit_widths[:, mini].astype(np.int64)
            bit_pos = within[None, :] * bw
            widx = (self.word_offsets[:, mini] + bit_pos // 32) \
                .astype(np.int64)
            if widx.size and int(widx.max()) >= (1 << 20):
                raise ValueError(
                    "word offset overflows the packed position encoding")
            valid = d[None, :] < (self.counts - 1)
            bw_eff = np.where(valid, bw, 0)
            pos = ((widx << POS_WIDX_SHIFT)
                   | ((bit_pos % 32) << POS_SHIFT_SHIFT)
                   | bw_eff).astype(np.int32)
            mind = np.where(valid, self.min_deltas[:, mini], 0) \
                .astype(np.int32)
            self._plan = (self.first, pos, mind, self.packed)
        return self._plan

    def device_plan(self, device) -> Tuple[torch.Tensor, ...]:
        """Device-keyed mirror of the unpack plan (once per device).

        Four contiguous int32 tensors ``(first, pos, mind, packed)``; the
        uint32 packed words travel as their int32 bit patterns and the
        kernels reinterpret them."""
        return self._mirror(device)[0]

    def device_pages(self, device):
        """Device-keyed mirror of the raw miniblock arrays (a
        ``ResidentPages`` of :meth:`host_arrays`), placed with
        :meth:`device_plan` in one populate: its ``first`` and ``packed``
        are the plan's tensors, so only the miniblock headers and the
        counts add to the device's bytes."""
        return self._mirror(device)[1]

    def _mirror(self, device) -> Tuple:
        """``(plan, pages)`` on ``device``, placed on first use (one
        transfer per device)."""
        key = str(torch.device(device))
        mirror = self._device_plans.get(key)
        if mirror is None:
            from repro_torch.kernels.pac_decode.kernel import ResidentPages
            _, pos, mind, _ = self.unpack_plan()
            first, pos, mind, packed, md, bw, wo, counts = (
                torch.from_numpy(np.ascontiguousarray(a)).to(key) for a in
                (self.first, pos, mind, self.packed.view(np.int32),
                 self.min_deltas, self.bit_widths, self.word_offsets,
                 self.counts))
            mirror = ((first, pos, mind, packed),
                      ResidentPages((first, md, bw, wo, packed, counts),
                                    self.page_size or self.packed.shape[1]))
            self._device_plans[key] = mirror
            self.device_transfers += 1
        return mirror

    def poison(self) -> None:
        """Mark the device mirror unusable (an explicit call: a simulated
        transfer fault, or a caller that found the mirror corrupt):
        consumers degrade to the host oracle; the next version bump
        rebuilds a clean mirror.  The only way into that host route."""
        self.poisoned = True

    def device_stats(self) -> Dict[str, object]:
        """The device mirror's counters, under the reference's keys.
        ``engines`` names the devices the plan was shipped to (``cpu``
        for the ``torch`` engine, ``cuda:0`` for ``cuda``)."""
        return {"engines": sorted(self._device_plans),
                "transfers": self.device_transfers,
                "version": self.version,
                "poisoned": self.poisoned,
                "fallbacks": self.fallbacks}

    def slice(self, p0: int, p1: int) -> Tuple[np.ndarray, ...]:
        """Zero-copy views of pages [p0, p1)."""
        return (self.first[p0:p1], self.min_deltas[p0:p1],
                self.bit_widths[p0:p1], self.word_offsets[p0:p1],
                self.packed[p0:p1], self.counts[p0:p1])

    def gather(self, pages) -> Tuple[np.ndarray, ...]:
        """Row-gathered copies for an arbitrary (sorted) page list."""
        idx = np.asarray(pages, np.int64)
        return (self.first[idx], self.min_deltas[idx], self.bit_widths[idx],
                self.word_offsets[idx], self.packed[idx], self.counts[idx])

def packed_from_arrays(first, min_deltas, bit_widths, word_offsets, packed,
                       counts, page_size: int) -> PackedPages:
    """A :class:`PackedPages` from the six batch arrays of the JAX
    package's ``PackedPages.host_arrays()`` (or any source of the same
    layout), so both packages can be fed from one set of numpy arrays."""
    return PackedPages(
        np.ascontiguousarray(first, np.int32),
        np.ascontiguousarray(min_deltas, np.int32),
        np.ascontiguousarray(bit_widths, np.int32),
        np.ascontiguousarray(word_offsets, np.int32),
        np.ascontiguousarray(packed, np.uint32),
        np.ascontiguousarray(counts, np.int32), page_size=int(page_size))


@dataclasses.dataclass
class PagePruneStats:
    """Counters for page-granular statistics pushdown on one column.

    ``io_saved_bytes`` sums the physical :meth:`DeltaPage.nbytes` of the
    pages a qualifying hull eliminated -- an upper bound on the lake I/O
    avoided (a pruned page may also have been a decoded-LRU hit, in
    which case the avoided cost is the decode, not the bytes)."""

    dispatches: int = 0
    pages_considered: int = 0
    pages_pruned: int = 0
    io_saved_bytes: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"dispatches": self.dispatches,
                "pages_considered": self.pages_considered,
                "pages_pruned": self.pages_pruned,
                "io_saved_bytes": self.io_saved_bytes}


@dataclasses.dataclass
class DeltaColumn:
    count: int
    page_size: int
    pages: List[DeltaPage]
    #: lazily built by :func:`pack_column`; not part of the storage format.
    packed_cache: "PackedPages | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    #: optional decoded-page LRU (see :mod:`repro_torch.core.page_cache`);
    #: attached by :func:`~repro_torch.core.page_cache.attach_page_cache`,
    #: consulted by every batched decode path, not part of the storage
    #: format.
    page_cache: "object | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    #: monotonically increasing write counter; every derived cache
    #: (``packed_cache``, its device mirror, the decoded-page LRU, the
    #: partition plane) is keyed on it, so in-place page writes can never
    #: serve stale data.
    version: int = dataclasses.field(default=0, compare=False)
    #: requested partition count (0 = monolithic).  Set by
    #: :func:`repro_torch.core.partition.partition_column`; the partition
    #: plane rebuilds :attr:`partition_cache` lazily after a version bump.
    partitions: int = dataclasses.field(default=0, compare=False)
    #: lazily built :class:`repro_torch.core.partition.PartitionedColumn`
    #: (keyed on ``(version, partitions)``); not part of the storage
    #: format.
    partition_cache: "object | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    #: page-granular statistics-pushdown counters (see
    #: :func:`prune_page_list`); observability only, never keyed on.
    prune_stats: PagePruneStats = dataclasses.field(
        default_factory=PagePruneStats, repr=False, compare=False)
    #: lazily built per-page hull arrays (see :func:`page_hulls`), keyed
    #: on ``(n_pages, version)`` like :attr:`packed_cache`.
    _hull_cache: "Tuple | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    def nbytes(self) -> int:
        return sum(p.nbytes() for p in self.pages)

    def bump_version(self) -> None:
        """Mark the pages dirty.  Any code that writes a page in place
        (or replaces one) MUST call this -- :func:`pack_column` and the
        decoded-page LRU key their caches on :attr:`version`, and page
        count alone cannot see a rewrite of the last partial page."""
        self.version += 1

    def set_page(self, i: int, page: DeltaPage) -> None:
        """Replace page ``i`` and invalidate every derived cache.

        The row count follows the replacement (rewriting the last
        partial page may grow or shrink the column)."""
        self.count += page.count - self.pages[i].count
        self.pages[i] = page
        self.bump_version()

    def append_page(self, page: DeltaPage) -> None:
        """Append a page and invalidate every derived cache."""
        self.pages.append(page)
        self.count += page.count
        self.bump_version()

def build_packed(pages: "List[DeltaPage]", page_size: int,
                 version: int = 0) -> PackedPages:
    """Pack an arbitrary page list into the kernels' batch-array layout.

    Pads miniblock metadata to ``ceil((page_size - 1) / MINIBLOCK)``
    columns, the most miniblocks a page's ``page_size - 1`` deltas fill
    (the reference pads to ``page_size // MINIBLOCK``, which is the same
    wherever ``page_size % 32`` is 0 or 1 and too few elsewhere), and packed
    words to the worst case (bw=32) -- exactly the layout the pac_decode
    kernels read.  Per-page min/max id statistics ride along from the
    pages' encode-time stats.
    """
    ps = page_size
    n_mini = max(1, -(-(ps - 1) // MINIBLOCK))
    max_words = ps  # worst case: 32-bit deltas -> one word per delta
    n = len(pages)
    first = np.zeros((n, 1), np.int32)
    counts = np.zeros((n, 1), np.int32)
    mind = np.zeros((n, n_mini), np.int32)
    bw = np.zeros((n, n_mini), np.int32)
    woff = np.zeros((n, n_mini), np.int32)
    packed = np.zeros((n, max_words), np.uint32)
    pmin = np.zeros(n, np.int64)
    pmax = np.full(n, -1, np.int64)
    for i, pg in enumerate(pages):
        first[i, 0] = pg.first_value
        counts[i, 0] = pg.count
        k = len(pg.min_deltas)
        mind[i, :k] = pg.min_deltas
        bw[i, :k] = pg.bit_widths
        woff[i, :k] = pg.word_offsets
        packed[i, :len(pg.packed)] = pg.packed
        pmin[i], pmax[i] = pg.vmin, pg.vmax
    return PackedPages(first, mind, bw, woff, packed, counts,
                       page_size=ps, version=version,
                       page_min=pmin, page_max=pmax)


def pack_column(col: DeltaColumn) -> PackedPages:
    """Build (or return the cached) column-wide packed-page arrays.

    The cache is keyed on ``(n_pages, version)`` so both appended and
    in-place-rewritten pages rebuild it (and, transitively, the device
    mirror that lives on it).
    """
    if col.packed_cache is not None \
            and col.packed_cache.n_pages == len(col.pages) \
            and col.packed_cache.version == col.version:
        return col.packed_cache
    col.packed_cache = build_packed(col.pages, col.page_size,
                                    version=col.version)
    return col.packed_cache


def hull_intersects(vmin: int, vmax: int, lo: int, hi: int) -> bool:
    """Whether a closed value hull ``[vmin, vmax]`` can intersect the
    half-open qualifying range ``[lo, hi)``.

    The intersection predicate of the statistics pushdown; page zone
    maps (:func:`prune_page_list`) use its vectorized form.  An empty value hull
    (``vmax < vmin``) intersects nothing; an empty qualifying range
    (``hi <= lo``) is intersected by nothing."""
    return vmax >= vmin and hi > lo and vmin < hi and vmax >= lo


def page_hulls(col: DeltaColumn) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-page value hulls ``(pmin, pmax, prunable)`` for zone-map pruning.

    ``prunable[p]`` is True when page ``p``'s encode-time statistics are
    trustworthy: a non-empty hull (``vmax >= vmin``) or a provably empty
    page.  Pages with unknown stats (hand-built :class:`DeltaPage` objects
    that skipped the encoder, or a sentinel hull on non-empty data) are
    never pruned.  Cached on the column, keyed on ``(n_pages, version)``
    like :func:`pack_column`, and cheap enough to build eagerly -- it
    reads only the page headers, no packed words."""
    key = (len(col.pages), col.version)
    cached = col._hull_cache
    if cached is not None and cached[0] == key:
        return cached[1]
    n = len(col.pages)
    pmin = np.zeros(n, np.int64)
    pmax = np.full(n, -1, np.int64)
    counts = np.zeros(n, np.int64)
    for i, pg in enumerate(col.pages):
        pmin[i], pmax[i] = pg.vmin, pg.vmax
        counts[i] = pg.count
    prunable = (pmax >= pmin) | (counts == 0)
    hulls = (pmin, pmax, prunable)
    col._hull_cache = (key, hulls)
    return hulls


def prune_page_list(col: DeltaColumn, pages: np.ndarray,
                    qual: "Tuple[int, int] | None"
                    ) -> Tuple[np.ndarray, "np.ndarray | None"]:
    """Drop pages whose value hull cannot intersect the half-open
    qualifying range ``qual = [lo, hi)``.

    Returns ``(kept_pages, mask)`` where ``mask`` is the boolean keep
    mask over the input list, or ``None`` when nothing pruned (the
    allocation-free fast path -- callers skip their row-drop logic).
    Pages with unknown statistics are always kept, so pruning can only
    remove pages that provably contain no qualifying value: result ids
    stay bit-identical to the unpruned oracle.  Counters accumulate on
    ``col.prune_stats``; ``io_saved_bytes`` only counts actually-pruned
    dispatches."""
    pages = np.asarray(pages, np.int64)
    if qual is None or len(pages) == 0:
        return pages, None
    lo, hi = qual
    stats = col.prune_stats
    stats.dispatches += 1
    stats.pages_considered += len(pages)
    pmin, pmax, prunable = page_hulls(col)
    if hi <= lo:
        keep = ~prunable[pages]
    else:
        pmn, pmx = pmin[pages], pmax[pages]
        keep = ~prunable[pages] | ((pmx >= pmn) & (pmx >= lo) & (pmn < hi))
    if keep.all():
        return pages, None
    dropped = pages[~keep]
    stats.pages_pruned += len(dropped)
    stats.io_saved_bytes += int(sum(col.pages[p].nbytes() for p in dropped))
    return pages[keep], keep


def delta_encode_column(values: np.ndarray,
                        page_size: int = DEFAULT_PAGE_SIZE) -> DeltaColumn:
    v = np.asarray(values, dtype=np.int64)
    pages = [delta_encode_page(v[i:i + page_size])
             for i in range(0, max(len(v), 1), page_size)]
    if len(v) == 0:
        pages = [delta_encode_page(v)]
    return DeltaColumn(len(v), page_size, pages)


def delta_decode_column(col: DeltaColumn) -> np.ndarray:
    if col.count == 0:
        return np.zeros(0, np.int64)
    return np.concatenate([delta_decode_page(p) for p in col.pages])


def delta_decode_range(col: DeltaColumn, lo: int, hi: int) -> np.ndarray:
    """Decode rows [lo, hi) touching only the pages that overlap the range
    (the access pattern of neighbor retrieval: the ``<offset>`` index gives
    an edge-row range, and only its pages are loaded and decoded)."""
    if hi <= lo:
        return np.zeros(0, np.int64)
    ps = col.page_size
    p0, p1 = lo // ps, (hi - 1) // ps
    parts = [delta_decode_page(col.pages[p]) for p in range(p0, p1 + 1)]
    joined = np.concatenate(parts)
    return joined[lo - p0 * ps: hi - p0 * ps]


def pages_touched(col: DeltaColumn, lo: int, hi: int) -> Tuple[int, int, int]:
    """(first_page, last_page_exclusive, bytes) for a row range."""
    if hi <= lo:
        return 0, 0, 0
    ps = col.page_size
    p0, p1 = lo // ps, (hi - 1) // ps + 1
    nbytes = sum(col.pages[p].nbytes() for p in range(p0, p1))
    return p0, p1, nbytes
