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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

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


class GraphCorpusPipeline:
    """Streams packed LM batches from a GraphAr document graph."""

    def __init__(self, graph: Graph, cond: Optional[Cond],
                 cfg: PipelineConfig, doc_type: str = "doc",
                 edge_name: str = "doc-links-doc",
                 tokens_prop: str = "tokens", engine: str = "cuda"):
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
