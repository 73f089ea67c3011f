"""Edge-case inputs of kernels 5 (``khop_scan``), 6 (``two_hop``), 7
(``count_hop``), 3 (``cond_bitmap``), the per-dispatch kernels 8-10
(``fused_decode_bitmap_batch``, ``fused_decode_filter_bitmap_batch``,
``delta_decode``) and the resident kernels 1, 2 and 4
(``fused_gather_decode_bitmap_batch``, ``gather_decode``,
``fused_gather_decode_filter_bitmap_batch``), the single-range kernels 11
and 12, and the RLE-label and selection kernels 13 (``rle_to_bitmap``)
and 14 (``bitmap_select``), shared by their CPU tests
against the JAX refs and their card tests against the plain versions, so
both hold the same cases.

No JAX: ``test_torch_cuda.py`` imports it where JAX is not installed.
"""
import numpy as np
import torch

from repro_torch.core.encoding import packed_from_arrays
from repro_torch.kernels.pac_decode.ref import decode_pages

NE = 1013          # ids (rows of a label column), not a multiple of 32

KHOP_CASES = ["segments", "hub_last_row", "zero_filter", "all_visited"]


def edge_plan(rng, n_key=NE, n_value=NE):
    """``(key_sorted, voff)`` of a plan from ``n_key`` to ``n_value`` ids
    (more than 64): segments of 0, 1, 31, 32, 33 and 4096 rows, segments
    that straddle a 32-id word (and a tile of the counting kernel), padding
    keys (``n_key`` and above) among the rows and after them, and the last
    segment running to ``rows_pad``."""
    lens = rng.integers(0, 20, n_value)
    lens[rng.random(n_value) < 0.2] = 0
    for v, length in {0: 0, 1: 1, 2: 31, 3: 32, 4: 33, 5: 4096, 30: 40,
                      31: 300, 32: 5, 33: 0, 63: 33, 64: 31,
                      n_value - 1: 33}.items():
        lens[v] = length
    return plan_of(rng, lens, n_key, to_rows_pad=True)


def plan_of(rng, lens, n_key, to_rows_pad=False, n_pad=60):
    """``(key_sorted, voff)`` with segments of ``lens`` rows of random keys
    in ``[0, n_key)``, ``n_pad`` of them padding keys (``n_key`` and
    above), padded to a multiple of 32 plus 32 rows; with ``to_rows_pad``
    the last segment runs to ``rows_pad``, else the padding rows lie past
    every segment."""
    voff = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rows = int(voff[-1])
    ks = np.full(-(-rows // 32) * 32 + 32, n_key, np.int32)
    ks[:rows] = rng.integers(0, n_key, rows)
    pad = rng.choice(rows, n_pad, replace=False)
    ks[pad[:n_pad // 2]] = n_key
    ks[pad[n_pad // 2:]] = n_key + 7
    if to_rows_pad:
        voff[-1] = len(ks)
    return ks, voff


def khop_edge_case(case):
    """``(key_sorted, voff, seed_ids, filt_words)`` of one of
    :data:`KHOP_CASES`, with duplicate, negative and sentinel seeds."""
    rng = np.random.default_rng(KHOP_CASES.index(case))
    ks, voff = edge_plan(rng)
    n_words = -(-NE // 32)
    seeds = np.array([5, 5, 17, 999, NE - 1, -3, NE, NE, 4 * NE, NE],
                     np.int32)
    fw = np.full((2, n_words), -1, np.int32)
    if case == "segments":
        fw = rng.integers(0, 1 << 32, (3, n_words), dtype=np.uint64)
        fw = fw.astype(np.uint32)
        fw[:, -1] |= np.uint32(0xFFFF0000)  # bits set past NE
        fw[0] = np.uint32(0xFFFFFFFF)
        fw = fw.view(np.int32)
    elif case == "hub_last_row":            # 4096 rows, one hit, the last
        ks[voff[5]:voff[6]] = 900
        ks[voff[6] - 1] = 17
        seeds = np.array([17, NE, NE], np.int32)
        fw = fw[:1]
    elif case == "zero_filter":
        fw[:] = 0
    else:                                   # every id already visited
        seeds = np.arange(NE, dtype=np.int32)
    return ks, voff, seeds, fw


#: the heterogeneous chain of kernel 6's cases: A from N_KEY to NE ids, B
#: from NE to N_OUT ids (none a multiple of 32)
N_KEY = 700
N_OUT = 389
#: BI-2's shape at small size: a few targets with thousands of rows each,
#: two with none (one last), one across three counting tiles of 8192 rows
FEW_LENS = [3000, 0, 4096, 5000, 3500, 17000, 0]

TWO_HOP_CASES = ["segments", "few_targets", "hub_last_row", "zero_filter",
                 "every_key"]


def two_hop_edge_case(case):
    """``(ks_a, voff_a, ks_b, voff_b, seed_ids, filt_words, kw)`` of one of
    :data:`TWO_HOP_CASES`, ``kw`` the size keywords: a chain with
    ``n_key != n_mid != n_out``, padding keys in both plans, duplicate,
    negative and sentinel seeds, filter bits set past ``n_out``."""
    rng = np.random.default_rng(100 + TWO_HOP_CASES.index(case))
    ks_a, voff_a = edge_plan(rng, N_KEY, NE)
    n_out = len(FEW_LENS) if case == "few_targets" else N_OUT
    if case == "few_targets":           # and words past the last target
        ks_b, voff_b = plan_of(rng, FEW_LENS, NE)
        n_words = 3
    else:
        ks_b, voff_b = edge_plan(rng, NE, n_out)
        n_words = -(-n_out // 32)
    seeds = np.array([5, 5, 17, N_KEY - 1, -3, N_KEY, N_KEY, 4 * N_KEY,
                      N_KEY], np.int32)
    fw = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    fw[0] = np.uint32(0xFFFFFFFF)
    fw[-1] |= np.uint32(0xFFFF0000)     # bits set past n_out
    if case == "hub_last_row":          # 4096 rows, one hit, the last
        ks_a[voff_a[5]:voff_a[6]] = 600
        ks_a[voff_a[6] - 1] = 17
        seeds = np.array([17, N_KEY, N_KEY], np.int32)
    elif case == "zero_filter":
        fw[:] = 0
    elif case == "every_key":
        seeds = np.arange(N_KEY, dtype=np.int32)
    kw = dict(n_key=N_KEY, n_mid=NE, n_out=n_out, n_words=n_words)
    return ks_a, voff_a, ks_b, voff_b, seeds, fw.view(np.int32), kw


COUNT_HOP_CASES = ["segments", "few_targets", "hub_last_row", "every_key",
                   "overlap_end", "no_interval"]


def count_hop_edge_case(case):
    """``(key_sorted, voff, starts, ends, kw)`` of one of
    :data:`COUNT_HOP_CASES`: intervals over ``N_KEY`` keys padded with the
    sentinel ``N_KEY + 1`` to a power of two, with negative bounds (counted
    from the end once) among them; ``kw`` the size keywords."""
    rng = np.random.default_rng(200 + COUNT_HOP_CASES.index(case))
    n_out = NE
    if case == "few_targets":
        n_out = len(FEW_LENS)
        ks, voff = plan_of(rng, FEW_LENS, N_KEY)
    else:
        ks, voff = edge_plan(rng, N_KEY, NE)
    s = [3, 100, 333, 500, -60]
    e = [40, 290, 334, 530, -2]
    if case == "hub_last_row":          # 4096 rows, one in the frontier
        ks[voff[5]:voff[6]] = 650
        ks[voff[6] - 1] = 17
        s, e = [10], [20]
    elif case == "every_key":
        s, e = [0], [N_KEY]
    elif case == "overlap_end":
        s, e = [3, 20, 100, 110, 690, -9999], [50, 30, 400, 120, N_KEY, 12]
    elif case == "no_interval":
        s, e = [], []
    starts = np.full(8, N_KEY + 1, np.int32)
    ends = np.full(8, N_KEY + 1, np.int32)
    starts[:len(s)] = s
    ends[:len(e)] = e
    return ks, voff, starts, ends, dict(n_key=N_KEY, n_out=n_out)


def rle_rows(rng, count, k):
    """``(pos, meta)`` of ``k`` random label columns over ``count`` rows,
    each position list padded with ``count``."""
    rows = []
    for i in range(k):
        bits = rng.random(count) < 0.3 + 0.2 * i
        change = np.nonzero(np.diff(bits.astype(np.int8)))[0] + 1
        rows.append((np.r_[0, change], int(bits[0])))
    pos = np.full((k, max(len(r) for r, _ in rows) + 5), count, np.int32)
    meta = np.zeros((k, 2), np.int32)
    for i, (r, first) in enumerate(rows):
        pos[i, :len(r)] = r
        meta[i] = (first, count)
    return pos, meta


DEPTH_64 = tuple([("leaf", i % 3) for i in range(64)]
                 + [("and",), ("or",)] * 31 + [("and",)])

COND_CASES = ["depth_1", "depth_2", "depth_64", "not_first", "padding",
              "empty", "every_lane"]


def cond_case(case):
    """``(pos, meta, ops)`` of one of :data:`COND_CASES`: programs of depth
    1, 2 and 64, a NOT-first one, a list padded with thousands of copies
    of the row count (inside the last word), an empty position list and a
    boundary at every lane (a block's slice in several chunks); counts are
    not multiples of 32."""
    rng = np.random.default_rng(len(case))
    pos, meta = rle_rows(rng, NE, 3)
    ops = {"depth_1": (("leaf", 2),),
           "depth_2": (("leaf", 0), ("leaf", 1), ("and",), ("leaf", 2),
                       ("not",), ("or",)),
           "depth_64": DEPTH_64,
           "not_first": (("leaf", 1), ("not",), ("leaf", 0), ("and",))
           }.get(case, (("leaf", 0), ("not",), ("leaf", 1), ("or",)))
    if case == "padding":               # the row count 3000 times more
        pos = np.concatenate([pos, np.full((3, 3000), NE, np.int32)], 1)
    elif case == "empty":
        pos = np.zeros((2, 0), np.int32)
        meta = np.array([[1, NE], [1, NE]], np.int32)
    elif case == "every_lane":
        count = 20_013
        pos = np.stack([np.arange(count, dtype=np.int32),
                        np.sort(rng.integers(0, count, count))
                        .astype(np.int32)])
        meta = np.array([[1, count], [0, count]], np.int32)
    return pos, meta, ops


# ------------------- shipped pages (kernels 8-10) ---------------------------

#: page sizes of the shipped-page cases: two miniblocks, the tests' 256,
#: the main path's 2048, and two with a ragged tail (99 is no multiple of
#: 4; 4099 also spans three passes of 2048 positions)
PAGE_SIZES = (64, 99, 256, 2048, 4099)
#: the bit widths the packer writes (powers of two: no delta straddles a
#: word)
WIDTHS = (0, 1, 2, 4, 8, 16, 32)
#: miniblock widths the packer never writes; the plain version reads one
#: word per delta whatever the width
ODD_WIDTHS = (3, 5, 17, 31)
#: counts of the pages after the first (page_size - 1 and page_size added)
COUNTS = (0, 1, 2, 31, 32, 33)
MINI = 32


def _page(rng, page_size, widths, count, first, small=True):
    """One shipped page: ``(first, min_deltas, bit_widths, word_offsets,
    packed, count)`` rows with each miniblock's words laid out after the
    last (offsets are the running sum of the widths) in a row of
    ``32 * n_mini`` words, and random words in them; with ``small`` every
    field of width 8 or more keeps only its low 3 bits, so the ids stay
    small."""
    n_mini = -(-(page_size - 1) // MINI)
    bw = np.resize(np.asarray(widths, np.int32), n_mini)
    woff = np.concatenate([[0], np.cumsum(bw)[:-1]]).astype(np.int32)
    packed = np.zeros(MINI * n_mini, np.uint32)
    used = int(bw.sum())
    packed[:used] = rng.integers(0, 1 << 32, used, dtype=np.uint64)
    if small:
        for m in np.nonzero(bw >= 8)[0]:
            keep = {8: 0x07070707, 16: 0x00070007, 32: 0x7}.get(
                int(bw[m]), 0xFFFFFFFF)
            packed[woff[m]:woff[m] + bw[m]] &= np.uint32(keep)
    mind = rng.integers(0, 4, n_mini).astype(np.int32)
    return first, mind, bw, woff, packed, count


def _rows(pages, rows):
    """The six arrays of ``pages`` zero-padded to ``rows`` pages."""
    out = []
    for i, dtype in enumerate((np.int32, np.int32, np.int32, np.int32,
                               np.uint32, np.int32)):
        a = np.stack([np.asarray(p[i], dtype).reshape(-1) for p in pages])
        out.append(np.concatenate(
            [a, np.zeros((rows - len(a),) + a.shape[1:], dtype)]))
    return tuple(out)


def page_case(page_size):
    """The six arrays of a batch of shipped pages at ``page_size``
    (``packed`` uint32, the rest int32; ``first`` and ``counts`` [n, 1]),
    zero-padded to 16 pages: page 0 takes every width of :data:`WIDTHS`
    in turn, miniblock by miniblock, so the word offsets leave 16-byte
    alignment after a width of 1 or 2; pages 1-8 hold the counts of
    :data:`COUNTS`, ``page_size - 1`` and ``page_size`` over random
    widths; page 9's offsets point past its row from miniblock 2 on
    (count 40: only zeroed deltas read there); page 10 wraps int32 (its
    first id near 2**31, width 32, large min deltas); page 11 has the
    widths of :data:`ODD_WIDTHS` and negative min deltas."""
    rng = np.random.default_rng(page_size)
    pages = [_page(rng, page_size, WIDTHS, page_size, 17)]
    for count in COUNTS + (page_size - 1, page_size):
        pages.append(_page(rng, page_size, rng.choice(WIDTHS, 64), count,
                           int(rng.integers(0, 1000))))
    past = list(_page(rng, page_size, (32,), 40, 5))
    past[3] = past[3].copy()
    past[3][2:] = len(past[4]) + 100
    pages.append(tuple(past))
    wrap = list(_page(rng, page_size, (32,), page_size, (1 << 31) - 100,
                      small=False))
    wrap[1] = np.full_like(wrap[1], 1 << 30)
    pages.append(tuple(wrap))
    odd = list(_page(rng, page_size, ODD_WIDTHS, page_size, 900,
                     small=False))
    odd[1] = -rng.integers(0, 1 << 20, len(odd[1])).astype(np.int32)
    pages.append(tuple(odd))
    return _rows(pages, 16)


#: label programs of the filtered per-dispatch kernel: depth 1, a NOT
#: first, a NOT in the middle, depth 64
FUSED_PROGRAMS = {
    "depth_1": (("leaf", 2),),
    "not_first": (("leaf", 1), ("not",), ("leaf", 0), ("and",)),
    "mix": (("leaf", 0), ("leaf", 1), ("and",), ("leaf", 2), ("not",),
            ("or",)),
    "depth_64": DEPTH_64,
}
#: target words of the fused cases: the small pages' ids run past them
FUSED_WORDS = 300


def fused_case(page_size, warm=False):
    """``(pages, cached, gidx, gcount)`` of a fused per-dispatch call at
    ``page_size``: :func:`page_case`'s pages and 4 cached rows of ids from
    -40 to past the :data:`FUSED_WORDS` target words (``warm``: one zero
    page, m_pad = 1, and the 12 real pages' rows arriving in ``cached``,
    decoded by the plain version), and requested rows over the matrix:
    600 random positions, a negative one, one past the matrix and its
    last, then 29 past ``gcount``."""
    rng = np.random.default_rng(page_size + warm)
    pages = page_case(page_size)
    extra = rng.integers(-40, 32 * FUSED_WORDS + 40, (4, page_size))
    if warm:
        decoded = decode_pages(*(torch.from_numpy(a.view(np.int32))
                                 for a in pages), page_size).numpy()
        cached = np.concatenate([decoded[:12], extra])
        pages = _rows([tuple(np.zeros_like(a[0]) for a in pages)], 1)
    else:
        cached = extra
    cached = cached.astype(np.int32)
    end = (len(pages[0]) + len(cached)) * page_size
    pos = list(rng.integers(0, end, 600)) + [-7, end + 5, end - 1]
    total = len(pos)
    pos += list(rng.integers(-50, end + 50, 29))
    return (pages, cached, np.asarray(pos, np.int32),
            np.full((1, 1), total, np.int32))



# -------------------- the resident plan (kernels 1, 2 and 4) -----------------

#: a call with requested rows, one whose ``total`` is 0 (every row junk),
#: one with no requested row at all
RESIDENT_CASES = ["rows", "total_0", "empty"]
#: predicate words of kernel 4's cases: none set, all set, random with bits
#: set past the id space's last 13 ids
FWORDS_KINDS = ["zeros", "ones", "random"]
#: rows of the resident cases' matrix: 18 real rows, 14 padding rows
RESIDENT_P_PAD = 32


def resident_plan(page_size):
    """``(first, pos, mind, packed)``: the unpack plan of
    :func:`page_case`'s 16 pages (``packed`` uint32, the rest int32), with
    12 deltas of page 0 rewritten: 4 whose word index lies past the row's
    words (the kernels clamp it), 4 of width 40 and 4 of width 63 (read as
    all 32 bits of the word)."""
    plan = packed_from_arrays(*page_case(page_size),
                              page_size=page_size).unpack_plan()
    first, pos, mind, packed = (np.array(a) for a in plan)
    rng = np.random.default_rng(300 + page_size)
    n_words = packed.shape[1]
    j = rng.choice(pos.shape[1], 12, replace=False)
    shift = rng.integers(0, 32, 12)
    widx = np.r_[np.full(4, n_words + 5), rng.integers(0, n_words, 8)]
    bw = np.r_[np.full(4, 8), np.full(4, 40), np.full(4, 63)]
    pos[0, j] = (widx << 11) | (shift << 6) | bw
    return first, pos, mind, packed


def resident_case(page_size, case="rows"):
    """``(plan, staged, p_pad, n_words)`` of one resident fused call at
    ``page_size`` (one of :data:`RESIDENT_CASES`): :func:`resident_plan`,
    and the staged vector ``[idx | gidx | total]``.  ``idx`` names the 16
    pages in a shuffled order, pages 3 and 10 twice (equal ids in two rows;
    the zero pages 12-15 give equal ids too), then padding entries -7 and
    ``n_pages + 5``.  The requested rows, in no sorted order: none in row
    4, only position 0 of row 1, only the last position of row 2, one
    position of row 3 forty times, runs of consecutive positions in rows
    5-17 (row 5 whole), scattered positions in row 0 and rows 5 and up,
    the padding rows included, and the flat positions -7 (row 0's first),
    ``p_pad * page_size + 5`` and ``p_pad * page_size - 1``; then 29 junk
    entries past ``total``.  The ids run from below 0 (page 10 wraps
    int32) to past the :data:`FUSED_WORDS` target words."""
    plan = resident_plan(page_size)
    n_pages = plan[0].shape[0]
    rng = np.random.default_rng(page_size + RESIDENT_CASES.index(case))
    idx = [3, 0, 1, 2, 5, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 10, 3]
    p_pad = RESIDENT_P_PAD
    idx += [-7, n_pages + 5] * ((p_pad - len(idx)) // 2)
    ps = page_size
    end = p_pad * ps
    runs = [[ps], [3 * ps - 1], [3 * ps + 5] * 40,
            list(range(5 * ps, 6 * ps))]
    for row in range(6, 18):
        lo = int(rng.integers(0, ps))
        hi = min(ps, lo + int(rng.integers(1, ps + 1)))
        runs.append(list(range(row * ps + lo, row * ps + hi)))
    scattered = rng.integers(0, end, 300)
    keep = (scattered < ps) | (scattered >= 5 * ps)    # not rows 1-4
    runs.append(list(scattered[keep]))
    runs.append([-7, end + 5, end - 1])
    order = rng.permutation(len(runs))
    pos = [int(q) for r in order for q in runs[r]]
    total = len(pos)
    pos += [int(q) for q in rng.integers(-50, end + 50, 29)]
    if case == "total_0":
        total = 0
    elif case == "empty":
        pos, total = [], 0
    staged = np.asarray(idx + pos + [total], np.int32)
    return plan, staged, p_pad, FUSED_WORDS


def resident_fwords(kind, n_words=FUSED_WORDS):
    """Predicate words of kind ``kind`` (:data:`FWORDS_KINDS`) over
    ``32 * n_words`` ids, as int32."""
    if kind == "zeros":
        return np.zeros(n_words, np.int32)
    if kind == "ones":
        return np.full(n_words, -1, np.int32)
    rng = np.random.default_rng(n_words)
    fw = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    fw[-1] |= np.uint32(0xFFF80000)     # the last 13 ids, past the vertices
    return fw.view(np.int32)


# ------------- the single-range entries (kernels 11 and 12) ------------------

#: page sizes of the single-range cases: one miniblock (32, 33), a ragged
#: tail (99, 2047, 4099), the main path's 2048, and 16384 (64 passes of
#: a warp's 256 positions)
SINGLE_RANGE_PAGE_SIZES = (32, 33, 99, 2047, 2048, 4099, 16384)
#: words of a warp's window in shared memory in kernels 11 and 12
#: (``csrc/single_range.cu``: kWindow)
WARP_WINDOW = 128
#: target windows ``(base, n_words)``: one word at a negative base, 64
#: words at a positive one, one word more than a warp's window at a
#: negative base, and 409,601 words (13.1M ids) at a positive one
SINGLE_RANGE_WINDOWS = {"one_word": (-64, 1), "64_words": (96, 64),
                        "warp_window_plus_1": (-4096, WARP_WINDOW + 1),
                        "wide": (1 << 12, 409_601)}
#: every case page, the first page alone, no page, and 9,000 pages (more
#: than the persistent grid has warps; page sizes 32 and 33 only)
SINGLE_RANGE_KINDS = ("pages", "one_page", "no_page", "many_pages")
#: kernel 11's ids: sorted with long runs of repeats, the same shuffled,
#: all in one word (unsorted), every id in its own word
SINGLE_IDS_KINDS = ("sorted_runs", "unsorted", "one_word", "own_word")


def _const_page(page_size, first, step, count):
    """A page of ids first, first + step, ... (width 0, min delta step)."""
    n_mini = -(-(page_size - 1) // MINI)
    return (first, np.full(n_mini, step, np.int32),
            np.zeros(n_mini, np.int32), np.zeros(n_mini, np.int32),
            np.zeros(MINI * n_mini, np.uint32), count)


def single_range_case(page_size, window, kind="pages"):
    """``(pages, base, n_words)`` of one fused_decode_bitmap call: the six
    page arrays (``packed`` uint32, the rest int32) over the window
    :data:`SINGLE_RANGE_WINDOWS` ``[window]``.  ``kind`` "pages":
    :func:`page_case`'s 16 pages (every width in turn, counts 0, 1, 2, 31,
    32, 33, ``page_size - 1`` and ``page_size``, word offsets past the row,
    int32 wraparound, widths the packer never writes, ids below 0), then a
    page whose count lies above ``page_size``, one whose ids run across
    the window's end, 32 ids in the window's first word, and ids 32 apart
    (each in its own word); "one_page": page 0 alone; "no_page": no page;
    "many_pages": the 20 pages tiled to 9,000."""
    base, n_words = SINGLE_RANGE_WINDOWS[window]
    ps = page_size
    end = base + 32 * n_words
    rng = np.random.default_rng(ps + 7 * len(window))
    extra = [_page(rng, ps, rng.choice(WIDTHS, 64), ps + 7,
                   int(rng.integers(0, 1000))),
             _const_page(ps, end - ps // 2, 1, ps),
             _const_page(ps, base, 1, 32),
             _const_page(ps, base + 5, 32, ps)]
    pages = tuple(np.concatenate([a, b]) for a, b in
                  zip(page_case(ps), _rows(extra, len(extra))))
    if kind == "one_page":
        pages = tuple(a[:1] for a in pages)
    elif kind == "no_page":
        pages = tuple(a[:0] for a in pages)
    elif kind == "many_pages":
        pages = tuple(np.resize(a, (9000,) + a.shape[1:]) for a in pages)
    return pages, base, n_words


def single_range_oracle(pages, base, page_size, n_words):
    """numpy: uint32[n_words] with the bit of every valid id of ``pages``
    in the window set (the rows' deltas read as the plain version reads
    them: miniblock and word indices clamped, int32 wraparound)."""
    first, mind, bw, woff, packed, counts = pages
    n, n_mini = mind.shape
    ids = np.zeros((n, page_size), np.int64)
    if n:
        j = np.arange(page_size - 1)
        m = np.minimum(j // MINI, n_mini - 1)
        w = bw[:, m].astype(np.int64)
        bit = (j % MINI) * w
        widx = np.clip(woff[:, m] + (bit >> 5), 0, packed.shape[1] - 1)
        words = np.take_along_axis(packed.astype(np.int64), widx, 1)
        mask = np.where(w >= 32, 0xFFFFFFFF, (1 << np.minimum(w, 31)) - 1)
        d = ((words >> (bit & 31)) & mask) + mind[:, m]
        d = np.where(j < counts.astype(np.int64) - 1, d, 0)
        ids[:, 0] = first[:, 0]
        ids[:, 1:] = first.astype(np.int64) + np.cumsum(d, 1)
        ids = (ids + (1 << 31)) % (1 << 32) - (1 << 31)
    valid = np.arange(page_size) < counts.astype(np.int64)
    return ids_oracle(ids[valid], base, n_words)


def ids_oracle(ids, base, n_words):
    """numpy: uint32[n_words] over [base, base + 32 * n_words) with the
    bit of every id in it set."""
    rel = np.asarray(ids, np.int64) - base
    plane = np.zeros(32 * n_words, bool)
    plane[rel[(rel >= 0) & (rel < 32 * n_words)]] = True
    return np.packbits(plane, bitorder="little").view(np.uint32)


def single_ids_case(kind, window):
    """``(ids, count, base, n_words)`` of one ids_bitmap call
    (:data:`SINGLE_IDS_KINDS`) over :data:`SINGLE_RANGE_WINDOWS`
    ``[window]``: int32 ids on both sides of the window, at its first and
    last id and past its end; a length of 7 mod 16; ``count`` three below
    it."""
    base, n_words = SINGLE_RANGE_WINDOWS[window]
    end = base + 32 * n_words
    rng = np.random.default_rng(SINGLE_IDS_KINDS.index(kind) + len(window))
    if kind in ("sorted_runs", "unsorted"):
        vals = np.concatenate([rng.integers(base - 500, end + 500, 2000),
                               [base - 1, base, end - 1, end]])
        runs = rng.integers(1, 20, len(vals))
        runs[rng.choice(len(vals), 5, replace=False)] = 2000
        ids = np.repeat(np.sort(vals), runs)
        if kind == "unsorted":
            ids = rng.permutation(ids)
    elif kind == "one_word":
        ids = base + rng.integers(0, 32, 1001)
    else:
        ids = base + 32 * np.arange(min(n_words, 5000) + 23) \
            + rng.integers(0, 32)
    ids = ids[:len(ids) - (len(ids) - 7) % 16]
    return ids.astype(np.int32), len(ids) - 3, base, n_words


# ----------------- RLE label column and selection (13-14) ------------------

#: kernel 13's cases (:func:`rle_case`)
RLE_CASES = ("random", "every_lane", "padding", "late_start", "negative",
             "empty_column", "one_run", "past_count", "past_end")


def rle_case(case, want):
    """``(pos, meta, n_words)`` of one ``rle_to_bitmap`` call: ``pos``
    int32[1, n_pos] sorted and padded with the count, ``meta`` int32[1, 3]
    = (first_value, want, count).  "random": stretches of runs of 1 to 3
    lanes and of 30 to 3000 over 100,003 rows (13 blocks of 8192 lanes);
    "every_lane": a boundary at every lane of 25,589 rows (several blocks,
    and chunks of 2048 positions); "padding": "random" with 3,000 more
    copies of the count, inside the last word; "late_start": lanes before
    ``positions[0]`` (run -1); "negative": positions below 0 before the
    rest; "empty_column": an empty column as ``stage_rle`` pads it (count
    0); "one_run": the list ``[0]``; "past_count": words past
    ``ceil(count / 32)`` across several blocks; "past_end": a count and
    positions past ``32 * n_words``.  No count is a multiple of 32."""
    rng = np.random.default_rng(RLE_CASES.index(case))
    count, n_words, first = 100_003, None, int(rng.integers(0, 2))
    if case == "every_lane":
        count = 3 * 8192 + 1013
        pos = np.arange(count)
    elif case == "late_start":
        count = 301
        pos = np.array([5, 40, 41, 100, 250, 300])
    elif case == "negative":
        count = 5_001
        pos = np.r_[-9, -4, -4, -1, np.sort(rng.choice(count, 700, False))]
    elif case == "empty_column":
        count, pos = 0, np.zeros(0, np.int64)
    elif case == "one_run":
        count, pos = 20_013, np.zeros(1, np.int64)
    else:
        # stretches of 500 to 8000 lanes, alternately dense (runs of 1 to 3
        # lanes) and sparse (runs of 30 to 3000)
        parts, at, dense = [], 0, True
        while at < count:
            end = at + int(rng.integers(500, 8000))
            step = (1, 4) if dense else (30, 3000)
            run = np.cumsum(rng.integers(*step, (end - at) // step[0] + 1))
            parts.append(at + run[at + run < end])
            at, dense = end, not dense
        pos = np.concatenate([[0]] + parts)
        pos = pos[pos < count]
        if case == "past_count":
            count = 5_001
            pos = pos[pos < count]
            n_words = 1024
        elif case == "past_end":
            n_words = 64 * 5
    n_pos = -(-max(len(pos), 1) // 128) * 128
    if case == "padding":
        n_pos += 3000
    padded = np.full((1, n_pos), count, np.int32)
    padded[0, :len(pos)] = pos
    meta = np.array([[first, int(want), count]], np.int32)
    if n_words is None:
        n_words = -(-(-(-count // 32) or 1) // 64) * 64
    return padded, meta, n_words


#: kernel 14's cases (:func:`select_case`): page sizes 32, 64, 2048 and
#: 8192 with every kind of page, two pages of 2^18 lanes (past any tile of
#: shared memory), and 5,000 pages (more than one wave of the card)
SELECT_CASES = (("pages", 32), ("pages", 64), ("pages", 2048),
                ("pages", 8192), ("huge", 1 << 18), ("many", 256))

#: raw float32 patterns: a NaN with a payload, -0.0, the smallest and the
#: largest denormal, a negative NaN, +inf
SPECIAL_BITS = (0x7FC01234, 0x80000000, 0x00000001, 0x007FFFFF, 0xFFC00001,
                0x7F800000)


def select_case(kind, page_size):
    """``(vals, words)`` of one ``bitmap_select`` call: ``vals``
    float32[n, page_size] of random bit patterns (NaN payloads, -0.0 and
    denormals among them, :data:`SPECIAL_BITS` in the first page's
    selected lanes), ``words`` uint32[n, page_size / 32].  "pages": pages
    that select at random (densities 0.04, 0.5 and 0.97), nothing,
    everything, only the first lane, only the last lane, and one word;
    "huge": two pages of ``page_size`` lanes, at density 0.3 and 0.001;
    "many": 5,000 pages at densities from 0 to 1."""
    rng = np.random.default_rng(page_size + len(kind))
    wpp = page_size // 32
    if kind == "pages":
        dens = (0.5, 0.0, 1.0, None, None, 0.04, 0.97, None)
    elif kind == "huge":
        dens = (0.3, 0.001)
    else:
        dens = tuple(rng.random(5000) ** 2)
    n = len(dens)
    bits = np.zeros((n, page_size), bool)
    for i, d in enumerate(dens):
        if d is not None:
            bits[i] = rng.random(page_size) < d
    vals = rng.integers(0, 1 << 32, (n, page_size), dtype=np.uint64) \
        .astype(np.uint32)
    if kind == "pages":
        bits[3, 0] = True                   # only the first lane
        bits[4, -1] = True                  # only the last lane
        bits[7, 32 * (wpp // 2):32 * (wpp // 2 + 1)] = True  # one word
        bits[0, :len(SPECIAL_BITS)] = True
        vals[0, :len(SPECIAL_BITS)] = SPECIAL_BITS
    words = np.packbits(bits.reshape(n, wpp, 32), axis=2,
                        bitorder="little").view(np.uint32)[..., 0]
    return vals.view(np.float32), np.ascontiguousarray(words)
