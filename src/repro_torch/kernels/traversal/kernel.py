"""Wrappers of the traversal CUDA kernels (``csrc/traversal.cu``).

As in :mod:`repro_torch.kernels.pac_decode.kernel`: CUDA tensors launch
the kernels, CPU tensors run the plain versions in :mod:`.ref`, and there
is no fallback from one to the other.  Each wrapper counts the CUDA
kernels it launches in a plain integer attribute, ``launches``: one for
the seeds and one per hop for :func:`khop_scan`, two (one per expansion)
for :func:`two_hop` and for :func:`count_hop` (the interval plane, then
the count).

``khop_scan``'s seeds go into the zeroed visited plane and frontier
words by a launch of their own, where JAX builds its seed plane outside
the ``pallas_call``; ``two_hop``'s seed plane is a zero fill plus a
masked scatter, and the interval bounds are sorted once per call, small
torch ops around the kernels.
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


def _check_words(words: torch.Tensor, name: str, shape: Tuple[int, ...],
                 n: int, device: torch.device) -> None:
    B.check(words, name, device, len(shape))
    if tuple(words.shape) != shape or 32 * shape[-1] < n:
        raise ValueError(f"{name} has shape {tuple(words.shape)}, want "
                         f"{shape} covering {n} ids")


#: the most words of frontier summary a hop kernel block keeps in shared
#: memory (24 KB): one bit for each 2**g frontier words, g as small as fits
SUMMARY_WORDS = 6144


def _summary_shape(n_words: int) -> Tuple[int, int]:
    """``(g, n_sum)``: the frontier summary's bit ``w >> g`` covers
    frontier word ``w``, in ``n_sum <= SUMMARY_WORDS`` words."""
    if n_words == 0:
        return 0, 0
    g = 0
    while ((n_words - 1) >> g) // 32 + 1 > SUMMARY_WORDS:
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
    if key_sorted.data_ptr() % 16:
        raise ValueError("key_sorted is not 16-byte aligned")
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
        B.launch("rt_khop_seed", B.ptr(seed_ids), seed_ids.shape[0], n_out,
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
    """Heterogeneous two-hop chain (see :func:`.ref.two_hop`): the two
    expansions are two launches on the current stream.  Returns
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
    B.check(seed_ids, "seed_ids", dev, 1)
    _check_words(filt_words, "filt_words", (n_words,), n_out, dev)
    _check_index(32 * n_words, n_key)
    f0 = R._seed_plane(seed_ids, n_key)
    mid = torch.empty(n_mid, dtype=torch.int32, device=dev)
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    B.launch("rt_two_hop", B.ptr(ks_a), B.ptr(voff_a), n_key, B.ptr(f0),
             B.ptr(mid), n_mid, B.ptr(ks_b), B.ptr(voff_b), n_out,
             B.ptr(filt_words), B.ptr(words), n_words, B.stream(dev))
    two_hop.launches += 2
    return mid, words


two_hop.launches = 0


def _sorted_bounds(x: torch.Tensor, n_key: int) -> torch.Tensor:
    """Interval bounds as the kernel reads them: ``mode="drop"`` indices
    into ``n_key + 1`` slots (negatives normalised once, the rest mapped
    to the sentinel ``n_key + 1``, which is never <= a key), sorted."""
    i = x.long()
    size = n_key + 1
    i = torch.where(i < 0, i + size, i)
    i = torch.where((i < 0) | (i >= size), size, i)
    return torch.sort(i).values.to(torch.int32)


def count_hop(key_sorted: torch.Tensor, voff: torch.Tensor,
              starts: torch.Tensor, ends: torch.Tensor, *, n_key: int,
              n_out: int) -> torch.Tensor:
    """Counting expansion (see :func:`.ref.count_hop`): per-target edge
    counts int32[n_out] of an interval frontier."""
    note_shape("count_hop", key_sorted.shape[0], starts.shape[0],
               ends.shape[0], n_key, n_out)
    if not B.on_cuda(starts):
        return R.count_hop(key_sorted, voff, starts, ends, n_key=n_key,
                           n_out=n_out)
    dev = starts.device
    _check_plan(key_sorted, voff, n_out, dev)
    B.check(starts, "starts", dev, 1)
    B.check(ends, "ends", dev, 1)
    _check_index(n_key + 1)
    s, e = _sorted_bounds(starts, n_key), _sorted_bounds(ends, n_key)
    plane = torch.empty(n_key, dtype=torch.int32, device=dev)
    counts = torch.empty(n_out, dtype=torch.int32, device=dev)
    B.launch("rt_count_hop", B.ptr(key_sorted), B.ptr(voff), n_key,
             B.ptr(s), s.shape[0], B.ptr(e), e.shape[0], B.ptr(plane),
             B.ptr(counts), n_out, B.stream(dev))
    count_hop.launches += 2
    return counts


count_hop.launches = 0
