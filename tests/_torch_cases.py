"""Edge-case inputs of kernels 5 (``khop_scan``) and 3 (``cond_bitmap``),
shared by their CPU tests against the JAX refs and their card tests
against the plain versions, so both hold the same cases.

numpy only: ``test_torch_cuda.py`` imports it where JAX is not installed.
"""
import numpy as np

NE = 1013          # ids (rows of a label column), not a multiple of 32

KHOP_CASES = ["segments", "hub_last_row", "zero_filter", "all_visited"]


def edge_plan(rng):
    """``(key_sorted, voff)`` of a plan over ``NE`` ids: segments of 0, 1,
    31, 32, 33 and 4096 rows, segments that straddle a 32-id word, padding
    keys (``NE`` and above) among the rows and after them, and the last
    segment running to ``rows_pad``."""
    lens = rng.integers(0, 20, NE)
    lens[rng.random(NE) < 0.2] = 0
    for v, length in {0: 0, 1: 1, 2: 31, 3: 32, 4: 33, 5: 4096, 30: 40,
                      31: 300, 32: 5, 33: 0, 63: 33, 64: 31,
                      NE - 1: 33}.items():
        lens[v] = length
    voff = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rows = int(voff[-1])
    ks = np.full(-(-rows // 32) * 32 + 32, NE, np.int32)
    ks[:rows] = rng.integers(0, NE, rows)
    pad = rng.choice(rows, 60, replace=False)
    ks[pad[:30]] = NE
    ks[pad[30:]] = NE + 7
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
