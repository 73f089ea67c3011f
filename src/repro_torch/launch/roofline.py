"""Roofline terms of a traced step on NVIDIA H100 SXM cards.

The JAX package's ``launch/roofline.py`` on PyTorch.  Three terms, each in
seconds for one step:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = intra-node bytes / NVLINK_BW + inter-node bytes / NET_BW

The reference reads FLOPs and bytes from an XLA executable and parses its
collectives out of HLO text.  The port has neither: the dry-run
(``launch/dryrun.py``) traces a step on the ``meta`` device and counts
FLOPs (``torch.utils.flop_counter``) and the bytes every aten op reads and
writes, and :func:`parse_collectives` reads records of the collective
calls a traced step issues (``(op, result bytes, group ranks)``) with the
reference's summation and its rule for a group that crosses a node
boundary.  ``CollectiveStats`` keeps the reference's field names so that
rows keep its keys: ``ici_bytes`` is NVLink traffic inside a node of
``CHIPS_PER_NODE`` cards, ``dcn_bytes`` traffic between nodes.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) cross-checks how much of
the traced compute is useful (recompute shows up as a ratio < 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

# ------------------- hardware constants (one H100 SXM5) --------------------
# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 989 TFLOP/s dense
# bf16 tensor-core (1,979 with sparsity), 80 GB of HBM3 at 3.35 TB/s,
# fourth-generation NVLink at 900 GB/s a card (450 GB/s each way), and
# one 400 Gb/s (50 GB/s) NDR InfiniBand port a card between nodes (DGX
# H100: 8 cards a node, 8 ConnectX-7 ports).
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card, dense
HBM_BW = 3.35e12             # bytes/s per card
HBM_BYTES = 80e9             # bytes per card
NVLINK_BW = 450e9            # bytes/s per card, one direction, in a node
NET_BW = 50e9                # bytes/s per card between nodes
CHIPS_PER_NODE = 8

#: the reference's collective names (HLO ops), which the records use
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: one collective call: (op, result bytes, the ranks of its group)
Record = Tuple[str, int, Sequence[int]]


def _crosses_node(ranks: Sequence[int], chips_per_node: int) -> bool:
    """True if the group spans a node boundary (the reference's
    ``_crosses_pod`` on one replica group)."""
    ranks = [int(r) for r in ranks]
    return bool(ranks) and (min(ranks) // chips_per_node
                            != max(ranks) // chips_per_node)


@dataclasses.dataclass
class CollectiveStats:
    ici_bytes: int = 0
    dcn_bytes: int = 0
    by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    count: int = 0

    @property
    def total_bytes(self) -> int:
        return self.ici_bytes + self.dcn_bytes


def parse_collectives(records: Iterable[Record],
                      chips_per_node: int = CHIPS_PER_NODE
                      ) -> CollectiveStats:
    """Sum collective records as the reference sums HLO lines: an op that
    is no collective, or a result of 0 bytes, is skipped; each other adds
    its bytes to its op and to the inter-node total when its group
    crosses a node boundary, else to the intra-node one."""
    stats = CollectiveStats()
    for op, nbytes, ranks in records:
        if op not in COLLECTIVES or not nbytes:
            continue
        stats.count += 1
        stats.by_op[op] = stats.by_op.get(op, 0) + int(nbytes)
        if _crosses_node(ranks, chips_per_node):
            stats.dcn_bytes += int(nbytes)
        else:
            stats.ici_bytes += int(nbytes)
    return stats


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll: CollectiveStats
    model_flops: float            # 6*N_active*D (global, per step)
    per_device_memory: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.coll.ici_bytes / NVLINK_BW
                + self.coll.dcn_bytes / NET_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        traced_global = self.flops_per_device * self.chips
        return self.model_flops / traced_global if traced_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the step would achieve if the dominant term were
        the wall clock: useful_FLOPs / (chips * peak * t_dominant)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.flops_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_ici_bytes": self.coll.ici_bytes,
            "coll_dcn_bytes": self.coll.dcn_bytes,
            "coll_count": self.coll.count,
            "memory": self.per_device_memory,
        }


# ------------------------- model FLOPs (6*N*D) ------------------------------

def active_params(cfg) -> float:
    """Active (per-token) parameter count: MoE counts top_k + shared only.

    The head is always materialized (decoupled-tied), so embedding params
    count twice regardless of ``tie_embeddings``.
    """
    d = cfg.d_model
    total = cfg.vocab_size * d * 2
    specs = list(cfg.prefix) + list(cfg.unit) * cfg.n_units
    for i, spec in enumerate(specs):
        if spec.kind == "attn":
            total += d * cfg.head_dim * (cfg.num_heads * 2
                                         + cfg.num_kv_heads * 2)
        else:
            s = cfg.ssm
            din = s.num_heads * s.head_dim
            total += d * (2 * din + 2 * s.n_groups * s.state_dim
                          + s.num_heads) + din * d
        if spec.cross:
            total += d * cfg.head_dim * (cfg.num_heads * 2
                                         + cfg.num_kv_heads * 2)
        if spec.mlp:
            if spec.moe:
                m = cfg.moe
                total += m.top_k * 3 * d * m.d_expert
                if m.num_shared:
                    total += 3 * d * (m.d_shared or m.d_expert)
            else:
                ff = (cfg.prefix_d_ff if (i < len(cfg.prefix)
                                          and cfg.prefix_d_ff) else cfg.d_ff)
                total += (3 if cfg.gated_mlp else 2) * d * ff
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (
            d * cfg.head_dim * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
            + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff)
    return float(total)


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6*N_active*D for training; 2*N_active*D for inference steps."""
    n = active_params(cfg)
    if kind == "train":
        tokens = batch * seq
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = batch * seq
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * batch
