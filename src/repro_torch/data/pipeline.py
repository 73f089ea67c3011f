"""Data pipeline: GraphAr lake -> packed token batches.

This is where the paper's two hot operations become the *inner loop of
pre-training ingestion*:

  1. **label filtering** selects the training subset (e.g.
     ``HighQuality & !Spam``) via the O(|P|) interval path;
  2. **neighbor retrieval** expands each selected document with its linked
     context (citations / replies) through the <offset>+delta CSR layout
     with PAC-bitmap property pushdown;
  3. documents + context are packed into fixed-length sequences with EOS
     separators (standard LM packing), sharded per data-parallel host.

The pipeline is deterministic given (seed, step) -- restartable from a
checkpointed cursor, which is what the FT layer relies on.  The JAX
package's ``data/pipeline.py`` over the port's ``core``: the same graph
and seed give the same batches.  The label filter runs on ``engine``,
``cuda`` by default as every entry of the port (the reference's runs on
numpy); ``numpy`` and ``torch`` run it on the host.

On a distributed mesh (``launch/mesh.py``) each data rank streams its own
shard: given the ``mesh``, the pipeline takes ``shard_id`` and
``num_shards`` from the rank's data coordinate (the ``pod`` and ``data``
axes, pod major), so ranks that differ only on ``model`` read the same
shard, and :func:`global_batch` makes their rank-local batches one
batch-sharded global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import BY_SRC, Graph, IOMeter
from repro_torch.core.labels import (Cond, filter_rle_interval,
                                     intervals_to_ids)
from repro_torch.data.tokenizer import EOS


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 512
    batch_size: int = 8
    context_hops: int = 1
    max_context_docs: int = 4
    shard_id: int = 0
    num_shards: int = 1
    seed: int = 0


def data_shard(mesh) -> Tuple[int, int]:
    """(shard_id, num_shards) of this rank on a distributed mesh: its
    position over the data axes (``pod`` major) and their size."""
    from repro_torch.distributed.sharding import data_axes
    coord = mesh.coordinate()
    shard, n = 0, 1
    for a in data_axes(mesh):
        shard = shard * mesh.shape[a] + coord[a]
        n *= mesh.shape[a]
    return shard, n


def global_batch(batch: Dict, mesh) -> Dict:
    """A data rank's local batch (arrays [b, ...]) as the global batch of
    DTensors [b * num_shards, ...], batch over the data axes and the same
    on every ``model`` rank, with no collective; other entries as they
    are."""
    import torch

    from repro_torch.distributed.sharding import (NamedSharding, P, _dp,
                                                  from_part)
    n = data_shard(mesh)[1]
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v) >= 1:
            t = torch.as_tensor(np.asarray(v) if isinstance(v, np.ndarray)
                                else v)
            spec = P(_dp(mesh), *([None] * (t.dim() - 1)))
            v = from_part(t, NamedSharding(mesh, spec),
                          (t.shape[0] * n,) + tuple(t.shape[1:]))
        out[k] = v
    return out


class GraphCorpusPipeline:
    """Streams packed LM batches from a GraphAr document graph."""

    def __init__(self, graph: Graph, cond: Optional[Cond],
                 cfg: PipelineConfig, doc_type: str = "doc",
                 edge_name: str = "doc-links-doc",
                 tokens_prop: str = "tokens", engine: str = "cuda",
                 mesh=None):
        if mesh is not None:
            sid, n = data_shard(mesh)
            cfg = dataclasses.replace(cfg, shard_id=sid, num_shards=n)
        self.graph = graph
        self.cfg = cfg
        self.meter = IOMeter()
        self.vt = graph.vertex(doc_type)
        self.adj = graph.adjacency(edge_name, BY_SRC)
        self.tokens_col = self.vt.table[tokens_prop]
        # label filtering -> eligible doc ids (interval fast path)
        if cond is not None:
            iv = filter_rle_interval(self.vt, cond, self.meter, engine)
            self.eligible = intervals_to_ids(iv)
        else:
            self.eligible = np.arange(self.vt.num_vertices, dtype=np.int64)
        # shard the eligible set across data-parallel hosts
        self.eligible = self.eligible[cfg.shard_id::cfg.num_shards]
        if len(self.eligible) == 0:
            raise ValueError("no eligible documents after filtering")

    def _doc_with_context(self, doc: int, rng) -> List[np.ndarray]:
        chunks = [self.tokens_col.read_rows(np.array([doc]), self.meter)[0]]
        ctx = self.adj.neighbor_ids(int(doc), self.meter)
        if len(ctx):
            take = min(self.cfg.max_context_docs, len(ctx))
            sel = rng.choice(ctx, size=take, replace=False)
            chunks.extend(
                self.tokens_col.read_rows(np.sort(sel), self.meter))
        return chunks

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite deterministic stream; resumable via ``start_step``."""
        cfg = self.cfg
        step = start_step
        need = cfg.seq_len + 1
        while True:
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) % (2 ** 63))
            buf: List[int] = []
            out = np.zeros((cfg.batch_size, need), np.int32)
            row = 0
            while row < cfg.batch_size:
                doc = int(rng.choice(self.eligible))
                for chunk in self._doc_with_context(doc, rng):
                    buf.extend(chunk.tolist())
                    buf.append(EOS)
                while len(buf) >= need and row < cfg.batch_size:
                    out[row] = buf[:need]
                    buf = buf[need:]
                    row += 1
            yield {"tokens": out[:, :-1], "labels": out[:, 1:],
                   "step": step}
            step += 1

    def io_stats(self) -> IOMeter:
        return self.meter
