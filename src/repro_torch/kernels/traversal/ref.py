"""Plain PyTorch versions of the traversal CUDA kernels
(``csrc/traversal.cu``).

Shared representation (all entries):

* the **resident expansion plan** -- ``key_sorted`` int32[rows_pad] (the
  CSR key of every edge row, re-ordered so rows group by *value* id and
  padded to a word multiple with the key-space size) and ``voff``
  int32[n_value + 1] (each value id's row segment in that order) -- lives
  on the device across dispatches
  (:class:`repro_torch.kernels.traversal.ops.TraversalPlan`);
* frontiers are dense int32 0/1 **planes** over the vertex id space,
  built on the device from padded seed-id vectors (out-of-range padding
  drops), so a dispatch ships O(seeds) ids, never a plane;
* per-hop predicates arrive as **bitmap words** (uint32 bit patterns held
  in int32 tensors, the label-filter plane's convention).

These functions compute what the JAX package's jnp references compute,
the same way: the gathered row bits are packed into words and each value
id's count is a popcount rank difference at its segment bounds.  The JAX
index modes become explicit masks and clamps (``mode="drop"`` scatters
normalise negative indices once, as jnp does, and drop the rest), and all
uint32 arithmetic runs in int64 (PyTorch's ``>>`` on int32 is arithmetic,
and its integer ``cumsum`` returns int64), wrapped to int32 once.  They
work on any device; the kernel wrappers run them for CPU tensors, and
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.pac_decode.ref import MASK32, wrap_int32


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def _drop_index(idx: torch.Tensor, size: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of a ``mode="drop"`` scatter into ``size`` slots:
    ``(in-range int64 indices, keep mask)``.  Negative indices count from
    the end once (as jnp normalises them); anything else outside
    ``[0, size)`` drops."""
    i = idx.long()
    i = torch.where(i < 0, i + size, i)
    keep = (i >= 0) & (i < size)
    return i[keep], keep


def _seed_plane(seed_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Padded seed ids -> dense 0/1 int32 plane (padding == n drops)."""
    plane = torch.zeros(n, dtype=torch.int32, device=seed_ids.device)
    i, _ = _drop_index(seed_ids, n)
    plane[i] = 1
    return plane


def _filter_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Bitmap words -> dense 0/1 int32 plane over [0, n)."""
    ids = torch.arange(n, dtype=torch.int64, device=words.device)
    return ((words.long()[ids >> 5] >> (ids & 31)) & 1).to(torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern held in an int64 tensor."""
    x = x & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _pack32(bits: torch.Tensor) -> torch.Tensor:
    """int[rows, 32] -> int64[rows] uint32 words: the sum mod 2**32 of
    each entry (as uint32) shifted left by its column."""
    b = bits.long() & MASK32
    return (((b << _shifts(bits.device)) & MASK32).sum(1)) & MASK32


def expand_counts(key_sorted: torch.Tensor, voff: torch.Tensor,
                  frontier: torch.Tensor) -> torch.Tensor:
    """Per-value-id count of frontier-selected in-rows: int32[len(voff)-1].

    ``key_sorted`` groups edge rows by value id (padding keys >= the key
    space size select nothing); ``voff[v]:voff[v+1]`` is value ``v``'s
    segment.  The gathered row selection is packed to words, a popcount
    prefix runs over the words, and each segment's count is the rank
    difference at its bounds; a bound equal to ``rows_pad`` reads the
    clamped last word under a zero mask."""
    nk = frontier.shape[0]
    ks = key_sorted.long()
    sel = frontier[ks.clamp(max=nk - 1)].long() * (ks < nk)
    words = _pack32(sel.reshape(-1, 32))
    csw = torch.cat([torch.zeros(1, dtype=torch.int64, device=ks.device),
                     torch.cumsum(_popcount32(words), 0)])

    def rank(i):
        w = i >> 5
        part = (words[w.clamp(max=words.shape[0] - 1)]
                & ((torch.ones_like(i) << (i & 31)) - 1))
        return csw[w] + _popcount32(part)

    v = voff.long()
    return wrap_int32(rank(v[1:]) - rank(v[:-1]))


def expand_plane(key_sorted, voff, frontier) -> torch.Tensor:
    """One frontier expansion: 0/1 plane of every value id reachable by an
    edge whose key is on the frontier (count > 0 == OR)."""
    return (expand_counts(key_sorted, voff, frontier) > 0).to(torch.int32)


def khop_scan(key_sorted, voff, seed_ids, filt_words, n_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused k-hop: ``filt_words`` int32[hops, n_words] steps the hops.

    Returns ``(visited, hop_planes, hop_sizes)``: the final visited 0/1
    plane (seeds included), each hop's newly-discovered plane
    int32[hops, n_out], and per-hop frontier sizes int32[hops]."""
    f0 = _seed_plane(seed_ids, n_out)
    frontier, visited = f0, f0
    planes = []
    for fw in filt_words:
        plane = expand_plane(key_sorted, voff, frontier)
        nxt = plane * _filter_bits(fw, n_out) * (1 - visited)
        frontier, visited = nxt, visited + nxt
        planes.append(nxt)
    planes = torch.stack(planes) if planes else \
        torch.zeros((0, n_out), dtype=torch.int32, device=f0.device)
    return visited, planes, planes.sum(1).to(torch.int32)


def _pack_words(plane: torch.Tensor, n_words: int) -> torch.Tensor:
    """Dense 0/1 plane -> int32[n_words] bitmap words."""
    padded = torch.zeros(n_words * 32, dtype=torch.int32,
                         device=plane.device)
    padded[:plane.shape[0]] = plane
    return wrap_int32(_pack32(padded.reshape(n_words, 32)))


def two_hop(ks_a, voff_a, ks_b, voff_b, seed_ids, filt_words, *,
            n_key: int, n_mid: int, n_out: int, n_words: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heterogeneous two-hop chain (IC-8's shape): seeds in adjacency A's
    key space expand to a mid plane, which expands through adjacency B;
    the predicate words AND the result.  Returns ``(mid_plane,
    out_words)``, the output packed to int32[n_words] bitmap words."""
    f0 = _seed_plane(seed_ids, n_key)
    mid = expand_plane(ks_a, voff_a, f0)
    out = expand_plane(ks_b, voff_b, mid)
    return mid, _pack_words(out, n_words) & filt_words


def count_hop(key_sorted, voff, starts, ends, *, n_key: int, n_out: int
              ) -> torch.Tensor:
    """Counting expansion (BI-2's shape): the frontier arrives as id
    intervals over the key space (the padding index ``n_key + 1`` drops;
    an end equal to ``n_key`` lands in the slot that is sliced off); the
    rank difference at each target's segment bounds *is* its edge count,
    so multiplicity survives.  Returns int32[n_out] counts."""
    delta = torch.zeros(n_key + 1, dtype=torch.int64, device=starts.device)
    for idx, step in ((starts, 1), (ends, -1)):
        i, _ = _drop_index(idx, n_key + 1)
        delta.index_add_(0, i, torch.full_like(i, step))
    plane = (wrap_int32(torch.cumsum(delta, 0))[:n_key] > 0) \
        .to(torch.int32)
    return expand_counts(key_sorted, voff, plane)


def summary_words(words: torch.Tensor, g: int, n_sum: int) -> torch.Tensor:
    """A frontier's summary: int32[n_sum] words whose bit ``w >> g`` is set
    when frontier word ``w`` holds a set bit."""
    groups = torch.zeros(32 * n_sum, dtype=torch.int32, device=words.device)
    w = torch.nonzero(words != 0).flatten()
    groups[w >> g] = 1
    return _pack_words(groups, n_sum)


def merge_hop(partial: torch.Tensor, fw: torch.Tensor,
              vis_words: torch.Tensor, n: int, g: int, n_sum: int
              ) -> Tuple[torch.Tensor, ...]:
    """The sharded k-hop's merge of one hop: ``partial`` int32[g_mesh,
    n_words] holds each mesh entry's expansion words; their OR, ANDed with
    the hop's predicate words ``fw`` and ANDNOTed with the visited words,
    is the hop's new frontier.  Returns ``(words, summary, plane,
    vis_words | words, size)``: the frontier words, their summary
    (:func:`summary_words`), its 0/1 int32[n] plane, the visited words
    after the hop and the plane's popcount (int32[1])."""
    x = partial[0].clone()
    for row in partial[1:]:
        x |= row
    nxt = x & fw & ~vis_words
    plane = _filter_bits(nxt, n)
    return (nxt, summary_words(nxt, g, n_sum), plane, vis_words | nxt,
            plane.sum().to(torch.int32).view(1))
