"""Elastic resharding: the chunk-movement plan.

The JAX package's ``checkpoint/reshard.py``, its plan only.  Checkpoints
store *global* logical arrays, so moving between meshes is a metadata
problem, not a data problem: ``plan_reshard`` reports, per leaf, which
ranges of the old shards each new shard reads -- on a real cluster this
drives host-to-host transfer planning.  Placing a restored tree onto a
mesh (the reference's ``device_put_resharded`` and ``elastic_restore``)
needs the port's mesh sharding rules, which do not exist yet.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def plan_reshard(shape: Tuple[int, ...], old_spec_shards: int,
                 new_spec_shards: int, axis: int = 0) -> List[Dict]:
    """Chunk-movement plan for one leaf resharded along ``axis``.

    Returns, for each new shard, the list of (old_shard, slice) pairs it
    reads -- the host transfer schedule for elastic restore.
    """
    n = shape[axis]
    assert n % old_spec_shards == 0 and n % new_spec_shards == 0
    old_sz = n // old_spec_shards
    new_sz = n // new_spec_shards
    plan = []
    for new_i in range(new_spec_shards):
        lo, hi = new_i * new_sz, (new_i + 1) * new_sz
        reads = []
        o = lo // old_sz
        while o * old_sz < hi:
            s = max(lo, o * old_sz)
            e = min(hi, (o + 1) * old_sz)
            reads.append({"old_shard": o,
                          "offset": s - o * old_sz,
                          "length": e - s})
            o += 1
        plan.append({"new_shard": new_i, "reads": reads,
                     "bytes_factor": sum(r["length"] for r in reads) / n})
    return plan
