"""The partition plane's multi-device tails.

A mesh is a tuple of ``torch.device``, ``g`` entries; entry ``i`` holds
the block of the stacked partition plan placed by
``PartitionedColumn.device_plan`` (the partitions ``[i * ppd, (i + 1) *
ppd)``, ``ppd = n_parts / g``).  Each entry takes **one launch** of the
existing kernel over its whole block, on its device's current stream --
never a launch per partition -- and the results merge on the mesh's
first device:

* :func:`sharded_fused` -- kernel 1 (or kernel 4 under a predicate) per
  entry, with its row of the ``staged`` matrix; the ``g`` bitmap planes
  are OR-merged (a target may be a neighbor through several partitions)
  and copied to the host once;
* :func:`sharded_decode` -- kernel 2 per entry over its block-local page
  indices; the page matrices come back in one copy;
* :func:`sharded_khop` -- per hop, kernel 6's expansion per entry through
  that entry's rank layout (``TraversalPlan.sharded_arrays``) into
  partial words, then one ``rt_merge_hop`` on the first device: OR of the
  partial words, AND of the hop's predicate, ANDNOT of the visited words,
  the next frontier and its summary, the hop's plane and size.  The
  frontier never leaves the devices between hops.

The JAX package runs these as ``shard_map`` entries; a mesh entry here is
a device and a block, and the same device may stand in several entries
(the tests and ``chip_smoke.py`` drive the tail so on one device).  The
CPU tensors of the ``torch`` engine run each wrapper's plain version.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Mesh = Tuple[torch.device, ...]


def _groups(mesh: Mesh) -> List[Tuple[torch.device, List[int]]]:
    """The mesh's distinct devices in order of first appearance, each
    with the entries it holds."""
    out: Dict[str, Tuple[torch.device, List[int]]] = {}
    for i, dev in enumerate(mesh):
        out.setdefault(str(dev), (dev, []))[1].append(i)
    return list(out.values())


def _on(device: torch.device):
    """Make ``device`` current for the launches in the block: a kernel
    runs on its stream's device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _or_rows(mat: torch.Tensor) -> torch.Tensor:
    """OR of the rows of an int32 [c, n] tensor, pairwise."""
    while mat.shape[0] > 1:
        h = mat.shape[0] // 2
        top = mat[:h] | mat[h:2 * h]
        mat = torch.cat([top, mat[2 * h:]]) if mat.shape[0] % 2 else top
    return mat[0]


def sharded_fused(mesh: Mesh, blocks: Sequence[Tuple[torch.Tensor, ...]],
                  staged: np.ndarray, n_words: int, p_pad: int,
                  want_ids: bool,
                  fwords: Optional[Sequence[torch.Tensor]] = None
                  ) -> Tuple[np.ndarray, Optional[List[torch.Tensor]]]:
    """The fused retrieval over a mesh: ``staged`` int32[g, L] holds entry
    ``i``'s block-local ``[idx | gidx | total]`` vector in row ``i``.
    Returns the merged uint32[n_words] words on the host and, under
    ``want_ids``, each entry's decoded int32[p_pad, page_size] matrix on
    its device.  ``fwords`` (one predicate plane per entry) takes kernel
    4 instead of kernel 1."""
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.pac_decode import kernel as K
    from repro_torch.kernels.pac_decode import ops as pac_ops
    ids: List[Optional[torch.Tensor]] = [None] * len(mesh)
    merged = None
    pooled = []
    for dev, entries in _groups(mesh):
        with _on(dev):
            st = torch.from_numpy(np.ascontiguousarray(staged[entries])) \
                .to(dev)
            shape = (len(entries), n_words)
            buf = pac_ops._words_buffer(dev, shape)
            for j, i in enumerate(entries):
                if fwords is None:
                    out = K.fused_gather_decode_bitmap_batch(
                        *blocks[i], st[j], buf[j], p_pad=p_pad,
                        want_ids=want_ids)
                else:
                    out = LK.fused_gather_decode_filter_bitmap_batch(
                        *blocks[i], st[j], fwords[i], buf[j], p_pad=p_pad,
                        want_ids=want_ids)
                if want_ids:
                    ids[i] = out[1]
            part = _or_rows(buf)
            pooled.append((dev, shape, buf))
        merged = part if merged is None else merged | part.to(mesh[0])
    host = merged.cpu().numpy().view(np.uint32)
    for dev, shape, buf in pooled:   # reused two dispatches later
        pac_ops._pool_words(dev, shape, buf)
    return host, (ids if want_ids else None)


def sharded_decode(mesh: Mesh, blocks: Sequence[Tuple[torch.Tensor, ...]],
                   idxmat: np.ndarray) -> np.ndarray:
    """The page-matrix decode over a mesh: ``idxmat`` int32[g, p_pad]
    holds entry ``i``'s block-local page indices.  Returns the int32
    [g, p_pad, page_size] matrices on the host."""
    from repro_torch.kernels.pac_decode import kernel as K
    outs: List[Optional[torch.Tensor]] = [None] * len(mesh)
    for dev, entries in _groups(mesh):
        with _on(dev):
            idx = torch.from_numpy(np.ascontiguousarray(idxmat[entries])) \
                .to(dev)
            for j, i in enumerate(entries):
                outs[i] = K.gather_decode(*blocks[i], idx[j])
    return torch.stack([o.to(mesh[0]) for o in outs]).cpu().numpy()


def sharded_khop(mesh: Mesh, layouts: Sequence[Tuple[torch.Tensor,
                                                     torch.Tensor]],
                 seed_ids: torch.Tensor, filt_words: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused k-hop over a mesh: ``layouts[i]`` is entry ``i``'s
    ``(key_sorted, voff)`` over all rows of its partitions and the whole
    value space; ``seed_ids`` (padded, as ``khop_scan`` takes them) and
    ``filt_words`` int32[hops, n_words] lie on the first device.  Returns
    ``(visited, hop_planes, hop_sizes)`` on the first device, as
    ``khop_scan`` does: a seed launch, then per hop ``g`` expansions and
    one merge, queued with no host synchronisation."""
    from repro_torch.kernels.traversal import kernel as TK
    first = mesh[0]
    hops = filt_words.shape[0]
    n_words = -(-n // 32)
    gs, n_sum = TK._summary_shape(n_words)
    visited = torch.zeros(n, dtype=torch.int32, device=first)
    buf = torch.zeros(3 * n_words + 2 * n_sum, dtype=torch.int32,
                      device=first)
    # the frontier words of even and odd hops, the visited words, and the
    # frontier summaries of even and odd hops
    fr = buf[:2 * n_words].view(2, n_words)
    vis_words = buf[2 * n_words:3 * n_words]
    sums = buf[3 * n_words:].view(2, n_sum)
    planes = torch.empty((hops, n), dtype=torch.int32, device=first)
    sizes = torch.empty(hops, dtype=torch.int32, device=first)
    partial = torch.empty((len(mesh), n_words), dtype=torch.int32,
                          device=first)
    if n_words == 0:
        return visited, planes, torch.zeros_like(sizes)
    with _on(first):
        TK.seed_words(seed_ids, n, visited, fr[0], vis_words, sums[0], gs,
                      sizes)
    # the expansions are unfiltered: the predicate ANDs in the merge
    ones = {str(dev): torch.full((n_words,), -1, dtype=torch.int32,
                                 device=dev) for dev, _ in _groups(mesh)}
    for h in range(hops):
        cur, nxt = h % 2, (h + 1) % 2
        for dev, entries in _groups(mesh):
            with _on(dev):
                if dev == first:
                    f, s = fr[cur], sums[cur]
                else:
                    f, s = fr[cur].to(dev), sums[cur].to(dev)
                for i in entries:
                    ks, voff = layouts[i]
                    out = partial[i] if dev == first else torch.empty(
                        n_words, dtype=torch.int32, device=dev)
                    TK.expand_words(ks, voff, f, s, gs, n, ones[str(dev)],
                                    out, n)
                    if dev != first:
                        partial[i].copy_(out)
        with _on(first):
            TK.merge_hop(partial, filt_words[h], vis_words, visited,
                         fr[nxt], sums[nxt], gs, planes[h], sizes[h:h + 1], n)
    return visited, planes, sizes
