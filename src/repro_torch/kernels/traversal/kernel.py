"""Wrappers of the traversal CUDA kernels (``csrc/traversal.cu``).

As in :mod:`repro_torch.kernels.pac_decode.kernel`: CUDA tensors launch
the kernels, CPU tensors run the plain versions in :mod:`.ref`, and there
is no fallback from one to the other.  Each wrapper counts the CUDA
kernels it launches in a plain integer attribute, ``launches``: one for
the seeds and one per hop for :func:`khop_scan`; three for
:func:`two_hop` (the seeds, expansion A, expansion B); two for
:func:`count_hop` (the interval words, then the row tiles).

The partition plane's sharded k-hop (:mod:`repro_torch.kernels.shard`)
takes three wrappers of its own, each one launch: :func:`seed_words`
(the seed launch), :func:`expand_words` (one expansion of kernel 6, per
mesh entry and hop) and :func:`merge_hop` (``rt_merge_hop``, one a hop).

The seeds of ``khop_scan`` and ``two_hop`` go into zeroed frontier words
by a launch of their own (``rt_seed_words``), where JAX builds its seed
plane outside the ``pallas_call``; ``count_hop``'s interval bounds are
sorted by one ``torch.sort`` a call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels._pad import note_shape

from . import ref as R

#: the kernels index rows, ids and bit lanes (rounded up to whole
#: blocks) in int32
_INDEX_MAX = (1 << 31) - 1 - 1024


def _check_index(*sizes: int) -> None:
    if max(sizes) > _INDEX_MAX:
        raise ValueError(f"sizes {sizes} overflow the kernels' int32 "
                         "indexing")


def _check_plan(ks: torch.Tensor, voff: torch.Tensor, n: int,
                device: torch.device, name: str = "") -> None:
    """Validate one expansion plan: ``key_sorted`` int32[rows_pad] with
    ``rows_pad % 32 == 0`` and ``voff`` int32[n + 1]."""
    B.check(ks, f"key_sorted{name}", device, 1)
    B.check(voff, f"voff{name}", device, 1)
    if ks.shape[0] % 32:
        raise ValueError(f"key_sorted{name} has {ks.shape[0]} rows, not a "
                         "multiple of 32")
    if voff.shape[0] != n + 1:
        raise ValueError(f"voff{name} has {voff.shape[0]} entries, want "
                         f"{n + 1}")
    _check_index(ks.shape[0], n)


def _check_aligned(ks: torch.Tensor, name: str) -> None:
    """The kernels read ``key_sorted`` with 16-byte loads."""
    if ks.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_words(words: torch.Tensor, name: str, shape: Tuple[int, ...],
                 n: int, device: torch.device) -> None:
    B.check(words, name, device, len(shape))
    if tuple(words.shape) != shape or 32 * shape[-1] < n:
        raise ValueError(f"{name} has shape {tuple(words.shape)}, want "
                         f"{shape} covering {n} ids")


#: the most words of frontier summary a hop kernel block keeps in shared
#: memory (24 KB): one bit for each 2**g frontier words, g as small as fits
SUMMARY_WORDS = 6144

#: count_hop's summary takes two bits for each 2**g frontier words (some
#: set, not all set): at most 2 * COUNT_SUMMARY_WORDS words (40 KB) in a
#: tile block's shared memory
COUNT_SUMMARY_WORDS = 5120

#: rows of one count_hop tile (``kTile`` in ``csrc/traversal.cu``)
COUNT_TILE = 8192


def _summary_shape(n_words: int, cap: int = SUMMARY_WORDS
                   ) -> Tuple[int, int]:
    """``(g, n_sum)``: the frontier summary's bit ``w >> g`` covers
    frontier word ``w``, in ``n_sum <= cap`` words."""
    if n_words == 0:
        return 0, 0
    g = 0
    while ((n_words - 1) >> g) // 32 + 1 > cap:
        g += 1
    return g, ((n_words - 1) >> g) // 32 + 1


def khop_scan(key_sorted: torch.Tensor, voff: torch.Tensor,
              seed_ids: torch.Tensor, filt_words: torch.Tensor, n_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused k-hop (see :func:`.ref.khop_scan`): a seed launch, then
    ``filt_words.shape[0]`` hop launches, queued on the current stream
    with no host synchronisation.  Returns ``(visited, hop_planes,
    hop_sizes)``."""
    note_shape("khop_scan", key_sorted.shape[0], seed_ids.shape[0],
               tuple(filt_words.shape), n_out)
    if not B.on_cuda(seed_ids):
        return R.khop_scan(key_sorted, voff, seed_ids, filt_words, n_out)
    dev = seed_ids.device
    _check_plan(key_sorted, voff, n_out, dev)
    _check_aligned(key_sorted, "key_sorted")
    B.check(seed_ids, "seed_ids", dev, 1)
    hops = filt_words.shape[0] if filt_words.dim() == 2 else -1
    n_words = -(-n_out // 32)
    _check_words(filt_words, "filt_words", (hops, n_words), n_out, dev)
    visited = torch.zeros(n_out, dtype=torch.int32, device=dev)
    g, n_sum = _summary_shape(n_words)
    buf = torch.zeros(3 * (n_words + n_sum), dtype=torch.int32, device=dev)
    # the frontier words of even and odd hops, and the visited words
    words = buf[:3 * n_words].view(3, n_words)
    # the frontier words' summaries, three in turn: a hop reads one,
    # writes the next and zeroes the one after
    sums = buf[3 * n_words:].view(3, n_sum)
    planes = torch.empty((hops, n_out), dtype=torch.int32, device=dev)
    sizes = torch.empty(hops, dtype=torch.int32, device=dev)
    s = B.stream(dev)
    # the C entries launch nothing with no seed and no hop, or no id
    if max(seed_ids.shape[0], hops) > 0:
        B.launch("rt_seed_words", B.ptr(seed_ids), seed_ids.shape[0], n_out,
                 B.ptr(visited), B.ptr(words[0]), B.ptr(words[2]),
                 B.ptr(sums[0]), g, B.ptr(sizes), hops, s)
        khop_scan.launches += 1
    for h in range(hops if n_out > 0 else 0):
        B.launch("rt_khop_hop", B.ptr(key_sorted), B.ptr(voff), n_out,
                 B.ptr(words[h % 2]), B.ptr(sums[h % 3]),
                 B.ptr(sums[(h + 1) % 3]), B.ptr(sums[(h + 2) % 3]), n_sum,
                 g, B.ptr(words[2]), B.ptr(visited), B.ptr(filt_words[h]),
                 B.ptr(words[(h + 1) % 2]), B.ptr(planes[h]),
                 B.ptr(sizes[h:h + 1]), s)
        khop_scan.launches += 1
    return visited, planes, sizes


khop_scan.launches = 0


def two_hop(ks_a, voff_a, ks_b, voff_b, seed_ids: torch.Tensor,
            filt_words: torch.Tensor, *, n_key: int, n_mid: int, n_out: int,
            n_words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heterogeneous two-hop chain (see :func:`.ref.two_hop`): a seed
    launch and the two expansions, queued on the current stream.  Returns
    ``(mid_plane, out_words)``."""
    note_shape("two_hop", ks_a.shape[0], ks_b.shape[0], seed_ids.shape[0],
               n_key, n_mid, n_out, n_words)
    if not B.on_cuda(seed_ids):
        return R.two_hop(ks_a, voff_a, ks_b, voff_b, seed_ids, filt_words,
                         n_key=n_key, n_mid=n_mid, n_out=n_out,
                         n_words=n_words)
    dev = seed_ids.device
    _check_plan(ks_a, voff_a, n_mid, dev, "_a")
    _check_plan(ks_b, voff_b, n_out, dev, "_b")
    _check_aligned(ks_a, "key_sorted_a")
    _check_aligned(ks_b, "key_sorted_b")
    B.check(seed_ids, "seed_ids", dev, 1)
    _check_words(filt_words, "filt_words", (n_words,), n_out, dev)
    _check_index(32 * n_words, n_key)
    nw_key, nw_mid = -(-n_key // 32), -(-n_mid // 32)
    g_key, ns_key = _summary_shape(nw_key)
    g_mid, ns_mid = _summary_shape(nw_mid)
    # the seed words and their summary, the mid words and their summary
    buf = torch.zeros(nw_key + ns_key + nw_mid + ns_mid, dtype=torch.int32,
                      device=dev)
    seed_words, seed_sum, mid_words, mid_sum = buf.split(
        [nw_key, ns_key, nw_mid, ns_mid])
    mid = torch.empty(n_mid, dtype=torch.int32, device=dev)
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    s = B.stream(dev)
    if seed_ids.shape[0] > 0:
        B.launch("rt_seed_words", B.ptr(seed_ids), seed_ids.shape[0], n_key,
                 None, B.ptr(seed_words), None, B.ptr(seed_sum), g_key, None,
                 0, s)
        two_hop.launches += 1
    if n_mid > 0:
        B.launch("rt_expand_words", B.ptr(ks_a), B.ptr(voff_a), n_mid,
                 nw_mid, B.ptr(seed_words), B.ptr(seed_sum), n_key, ns_key,
                 g_key, B.ptr(mid_sum), g_mid, None, B.ptr(mid_words),
                 B.ptr(mid), s)
        two_hop.launches += 1
    if n_words > 0:
        B.launch("rt_expand_words", B.ptr(ks_b), B.ptr(voff_b), n_out,
                 n_words, B.ptr(mid_words), B.ptr(mid_sum), n_mid, ns_mid,
                 g_mid, None, 0, B.ptr(filt_words), B.ptr(words), None, s)
        two_hop.launches += 1
    return mid, words


two_hop.launches = 0


def seed_words(seed_ids: torch.Tensor, n: int, visited: torch.Tensor,
               words: torch.Tensor, vis_words: torch.Tensor,
               summary: torch.Tensor, g: int, sizes: torch.Tensor) -> None:
    """The seeds of the sharded k-hop (``rt_seed_words``, ``khop_scan``'s
    seed launch): each seed's bit into the frontier words, the visited
    words and the summary (``_summary_shape``'s ``g``), its 1 into the
    visited plane, and ``sizes`` zeroed.  The buffers come zeroed."""
    note_shape("seed_words", seed_ids.shape[0], n, sizes.shape[0])
    if not B.on_cuda(seed_ids):
        plane = R._seed_plane(seed_ids, n)
        w = R._pack_words(plane, words.shape[0])
        visited.copy_(plane)
        words.copy_(w)
        vis_words.copy_(w)
        summary.copy_(R.summary_words(w, g, summary.shape[0]))
        sizes.zero_()
        return
    dev = seed_ids.device
    B.check(seed_ids, "seed_ids", dev, 1)
    n_words = -(-n // 32)
    for name, t, size in (("visited", visited, n), ("words", words, n_words),
                          ("vis_words", vis_words, n_words),
                          ("summary", summary,
                           _summary_shape(n_words)[1]),
                          ("sizes", sizes, sizes.shape[0])):
        B.check(t, name, dev, 1)
        if t.shape[0] != size:
            raise ValueError(f"{name} has {t.shape[0]} entries, want {size}")
    if max(seed_ids.shape[0], sizes.shape[0]) > 0:
        B.launch("rt_seed_words", B.ptr(seed_ids), seed_ids.shape[0], n,
                 B.ptr(visited), B.ptr(words), B.ptr(vis_words),
                 B.ptr(summary), g, B.ptr(sizes), sizes.shape[0],
                 B.stream(dev))
        seed_words.launches += 1


seed_words.launches = 0


def expand_words(key_sorted: torch.Tensor, voff: torch.Tensor,
                 frontier: torch.Tensor, summary: torch.Tensor, g_in: int,
                 n_key: int, filt_words: torch.Tensor,
                 out_words: torch.Tensor, n: int) -> torch.Tensor:
    """One expansion of kernel 6 (``rt_expand_words``, expansion B's
    mode): the frontier words over the key space ``[0, n_key)`` with
    their summary (``2**g_in`` words a bit) -> ``out_words``
    int32[ceil(n / 32)] over the value space ``[0, n)``, ANDed with
    ``filt_words``.  Returns ``out_words``."""
    note_shape("expand_words", key_sorted.shape[0], n_key, n)
    n_words = out_words.shape[0]
    if not B.on_cuda(frontier):
        plane = R.expand_plane(key_sorted, voff,
                               R._filter_bits(frontier, n_key))
        out_words.copy_(R._pack_words(plane, n_words) & filt_words)
        return out_words
    dev = frontier.device
    _check_plan(key_sorted, voff, n, dev)
    _check_aligned(key_sorted, "key_sorted")
    _check_words(frontier, "frontier", (-(-n_key // 32),), n_key, dev)
    _check_words(filt_words, "filt_words", (n_words,), n, dev)
    _check_words(out_words, "out_words", (n_words,), n, dev)
    B.check(summary, "summary", dev, 1)
    if summary.shape[0] != _summary_shape(frontier.shape[0])[1]:
        raise ValueError(f"summary has {summary.shape[0]} words, want "
                         f"{_summary_shape(frontier.shape[0])[1]}")
    _check_index(32 * n_words, n_key)
    if n_words > 0:
        B.launch("rt_expand_words", B.ptr(key_sorted), B.ptr(voff), n,
                 n_words, B.ptr(frontier), B.ptr(summary), n_key,
                 summary.shape[0], g_in, None, 0, B.ptr(filt_words),
                 B.ptr(out_words), None, B.stream(dev))
        expand_words.launches += 1
    return out_words


expand_words.launches = 0


def merge_hop(partial: torch.Tensor, filt_words: torch.Tensor,
              vis_words: torch.Tensor, visited: torch.Tensor,
              out_words: torch.Tensor, summary: torch.Tensor, g: int,
              plane: torch.Tensor, size: torch.Tensor, n: int) -> None:
    """The sharded k-hop's merge of one hop (``rt_merge_hop``, see
    :func:`.ref.merge_hop`): the OR of the mesh entries' expansion words
    ``partial`` int32[g_mesh, n_words], ANDed with the hop's predicate
    words and ANDNOTed with the visited words, is written to
    ``out_words`` with its summary (``2**g`` words a bit, fully written)
    and its 0/1 int32[n] ``plane``; the visited words and plane take it,
    and its popcount is added into ``size`` (int32[1], zeroed by the seed
    launch)."""
    note_shape("merge_hop", tuple(partial.shape), n)
    if not B.on_cuda(partial):
        nxt, summ, pl, vw, sz = R.merge_hop(partial, filt_words, vis_words,
                                            n, g, summary.shape[0])
        out_words.copy_(nxt)
        summary.copy_(summ)
        plane.copy_(pl)
        vis_words.copy_(vw)
        visited.copy_(visited | pl)
        size.copy_(sz)
        return
    dev = partial.device
    n_words = -(-n // 32)
    B.check(partial, "partial", dev, 2)
    if partial.shape[1] != n_words or partial.shape[0] < 1:
        raise ValueError(f"partial has shape {tuple(partial.shape)}, want "
                         f"(g, {n_words})")
    for name, t, want in (("filt_words", filt_words, n_words),
                          ("vis_words", vis_words, n_words),
                          ("out_words", out_words, n_words),
                          ("visited", visited, n), ("plane", plane, n),
                          ("size", size, 1)):
        B.check(t, name, dev, 1)
        if t.shape[0] != want:
            raise ValueError(f"{name} has {t.shape[0]} entries, want {want}")
    B.check(summary, "summary", dev, 1)
    if (g, summary.shape[0]) != _summary_shape(n_words):
        raise ValueError(f"summary ({g}, {summary.shape[0]}) is not "
                         f"_summary_shape({n_words})")
    _check_index(32 * n_words)
    if n_words > 0:
        B.launch("rt_merge_hop", B.ptr(partial), partial.shape[0], n_words,
                 n, B.ptr(filt_words), B.ptr(vis_words), B.ptr(visited),
                 B.ptr(out_words), B.ptr(summary), summary.shape[0], g,
                 B.ptr(plane), B.ptr(size), B.stream(dev))
        merge_hop.launches += 1


merge_hop.launches = 0


def count_hop(key_sorted: torch.Tensor, voff: torch.Tensor,
              starts: torch.Tensor, ends: torch.Tensor, *, n_key: int,
              n_out: int) -> torch.Tensor:
    """Counting expansion (see :func:`.ref.count_hop`): per-target edge
    counts int32[n_out] of an interval frontier, by two launches: the
    interval words (and zeroed counts), then the row tiles."""
    note_shape("count_hop", key_sorted.shape[0], starts.shape[0],
               ends.shape[0], n_key, n_out)
    if not B.on_cuda(starts):
        return R.count_hop(key_sorted, voff, starts, ends, n_key=n_key,
                           n_out=n_out)
    dev = starts.device
    _check_plan(key_sorted, voff, n_out, dev)
    _check_aligned(key_sorted, "key_sorted")
    B.check(starts, "starts", dev, 1)
    B.check(ends, "ends", dev, 1)
    _check_index(n_key + 1)
    counts = torch.empty(n_out, dtype=torch.int32, device=dev)
    if n_out == 0:
        return counts
    # the bounds sorted as they came: the first launch reads them as the
    # plain version's mode="drop" scatter does (negatives from the end)
    if starts.shape == ends.shape:
        s, e = torch.sort(torch.stack([starts, ends])).values
    else:
        s, e = torch.sort(starts).values, torch.sort(ends).values
    n_words = -(-n_key // 32)
    g, n_sum = _summary_shape(n_words, COUNT_SUMMARY_WORDS)
    # tile 0 runs even with no row: it stores the empty segments' counts
    n_tiles = max(1, -(-key_sorted.shape[0] // COUNT_TILE))
    # the frontier words, their two-bit summary (zeroed: the first launch
    # ORs into it), each tile's first segment
    words, table, tile_seg = torch.zeros(
        n_words + 2 * n_sum + n_tiles + 1, dtype=torch.int32,
        device=dev).split([n_words, 2 * n_sum, n_tiles + 1])
    st = B.stream(dev)
    B.launch("rt_interval_words", B.ptr(s), s.shape[0], B.ptr(e),
             e.shape[0], n_key, B.ptr(words), B.ptr(table), g, B.ptr(voff),
             n_out, B.ptr(tile_seg), n_tiles, B.ptr(counts), st)
    B.launch("rt_count_tiles", B.ptr(key_sorted), B.ptr(voff), n_out,
             B.ptr(tile_seg), n_tiles, COUNT_TILE, B.ptr(words),
             B.ptr(table), n_sum, g, n_key, B.ptr(counts), st)
    count_hop.launches += 2
    return counts


count_hop.launches = 0
