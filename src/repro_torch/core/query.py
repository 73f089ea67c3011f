"""End-to-end LDBC-SNB-style workloads (paper §6.5): IS-3, IC-8, BI-2.

Each query has two implementations with identical results:

* ``*_graphar`` -- hand-written over the GraphAr APIs, exercising neighbor
  retrieval (offset + delta + PAC pushdown) and interval label filtering;
* ``*_acero``   -- the baseline over plain/unsorted tables via the
  scan/filter/hash-join/aggregate operators in
  :mod:`repro_torch.core.acero`.

The graphar forms take an ``engine``: ``cuda`` (the default, the
hand-written kernels on the card), ``torch`` (their plain versions on the
CPU) or ``numpy`` (the host oracle).  On the kernel engines each query
picks its route at call time from ``REPRO_DEVICE_RESIDENT``
(``pac_decode.ops.DEVICE_RESIDENT``): resident, IC-8 runs ``two_hop_pac``
and BI-2 ``frontier_edge_counts``; per-dispatch, IC-8's second hop is a
batched retrieval over shipped pages and BI-2 decodes its edge ranges,
as IS-3 does on both.

Graph layout (built by :func:`build_snb_graphar` from a
:class:`repro_torch.data.synthetic.SnbGraph`):

  vertex types : person(firstName, birthday; labels Asian/Enrollee/Student)
                 message(creationDate, length; labels TagClass*)
                 tag(tagclass)
  edge types   : person-knows-person       (prop creationDate; by_src+by_dst)
                 message-hasCreator-person (by_src + by_dst)
                 message-replyOf-message   (by_src + by_dst)
                 message-hasTag-tag        (by_src + by_dst)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from . import acero
from .builder import Graph, GraphArBuilder
from .edge import BY_DST, BY_SRC
from .labels import L, LabelFilter, filter_rle_interval
from .neighbor import (decode_edge_ranges, fetch_properties,
                       fetch_properties_batch, retrieve_neighbors_batch)
from .pac import PAC
from .schema import EdgeTypeSchema, PropertySchema, VertexTypeSchema
from .storage import IOMeter
from .vertex import LABEL_ENC_STRING, VertexTable


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def build_snb_graphar(snb, page_size: int = 2048) -> Graph:
    b = GraphArBuilder("snb")
    b.add_vertices(
        VertexTypeSchema("person",
                         [PropertySchema("firstName", "string"),
                          PropertySchema("birthday", "int64")],
                         labels=list(snb.person_labels),
                         page_size=page_size),
        {"firstName": snb.person_first_name, "birthday": snb.person_birthday},
        snb.person_labels)
    b.add_vertices(
        VertexTypeSchema("message",
                         [PropertySchema("creationDate", "int64"),
                          PropertySchema("length", "int64")],
                         labels=list(snb.message_labels),
                         page_size=page_size),
        {"creationDate": snb.message_creation, "length": snb.message_length},
        snb.message_labels)
    b.add_vertices(
        VertexTypeSchema("tag", [PropertySchema("tagclass", "int64")],
                         page_size=page_size),
        {"tagclass": snb.tag_class_of_tag})
    b.add_edges(EdgeTypeSchema("person", "knows", "person",
                               [PropertySchema("creationDate", "int64")],
                               adjacency=["by_src", "by_dst"],
                               page_size=page_size),
                snb.knows_src, snb.knows_dst,
                {"creationDate": snb.knows_creation})
    b.add_edges(EdgeTypeSchema("message", "hasCreator", "person",
                               adjacency=["by_src", "by_dst"],
                               page_size=page_size),
                snb.has_creator_msg, snb.has_creator_person)
    b.add_edges(EdgeTypeSchema("message", "replyOf", "message",
                               adjacency=["by_src", "by_dst"],
                               page_size=page_size),
                snb.reply_of_src, snb.reply_of_dst)
    b.add_edges(EdgeTypeSchema("message", "hasTag", "tag",
                               adjacency=["by_src", "by_dst"],
                               page_size=page_size),
                snb.has_tag_msg, snb.has_tag_tag)
    return b.build()


@dataclasses.dataclass
class SnbBaseline:
    """Plain/unsorted tables + string labels for the Acero engine."""

    person: VertexTable
    message: VertexTable
    tag: VertexTable
    knows: "acero.Table"
    has_creator: "acero.Table"
    reply_of: "acero.Table"
    has_tag: "acero.Table"


def build_snb_baseline(snb, page_size: int = 2048) -> SnbBaseline:
    from .table import PlainColumn, Table
    person = VertexTable.build(
        VertexTypeSchema("person",
                         [PropertySchema("firstName", "string"),
                          PropertySchema("birthday", "int64")],
                         labels=list(snb.person_labels), page_size=page_size),
        {"firstName": snb.person_first_name, "birthday": snb.person_birthday},
        snb.person_labels, LABEL_ENC_STRING)
    message = VertexTable.build(
        VertexTypeSchema("message",
                         [PropertySchema("creationDate", "int64"),
                          PropertySchema("length", "int64")],
                         labels=list(snb.message_labels),
                         page_size=page_size),
        {"creationDate": snb.message_creation, "length": snb.message_length},
        snb.message_labels, LABEL_ENC_STRING)
    tag = VertexTable.build(
        VertexTypeSchema("tag", [PropertySchema("tagclass", "int64")],
                         page_size=page_size),
        {"tagclass": snb.tag_class_of_tag})

    def coo(name, s, d, props=None):
        t = Table(name, len(s), page_size)
        t.add(PlainColumn("<src>", np.asarray(s, np.int64), page_size))
        t.add(PlainColumn("<dst>", np.asarray(d, np.int64), page_size))
        for k, v in (props or {}).items():
            t.add(PlainColumn(k, np.asarray(v), page_size))
        return t

    return SnbBaseline(
        person=person, message=message, tag=tag,
        knows=coo("knows", snb.knows_src, snb.knows_dst,
                  {"creationDate": snb.knows_creation}),
        has_creator=coo("hasCreator", snb.has_creator_msg,
                        snb.has_creator_person),
        reply_of=coo("replyOf", snb.reply_of_src, snb.reply_of_dst),
        has_tag=coo("hasTag", snb.has_tag_msg, snb.has_tag_tag))


# --------------------------------------------------------------------------
# IS-3: friends of a person with friendship creationDate, newest first
# --------------------------------------------------------------------------

def is3_graphar(g: Graph, person: int, meter: Optional[IOMeter] = None,
                engine: str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    adj = g.adjacency("person-knows-person", BY_SRC)
    vt = g.vertex("person")
    # batch-of-one through the shared batched plane
    los, his = adj.edge_ranges_batch(np.array([person]), meter)
    friends = decode_edge_ranges(adj, los, his, meter, engine)
    dates = np.asarray(
        adj.table["creationDate"].read_rows_concat(los, his, meter),
        np.int64)
    # bitmap-pushdown fetch of friend names (order restored by id below)
    pac = PAC.from_ids(friends, vt.page_size)
    _ = fetch_properties(pac, vt, "firstName", meter)
    order = np.argsort(-dates, kind="stable")
    return friends[order], dates[order]


def is3_acero(b: SnbBaseline, person: int,
              meter: Optional[IOMeter] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    rel = acero.scan(b.knows, ["<src>", "<dst>", "creationDate"], meter,
                     predicate=("<src>", "==", person))
    rel = acero.filter_rel(rel, rel["<src>"] == person)
    names = acero.Relation({
        "pid": np.arange(b.person.num_vertices, dtype=np.int64),
        "firstName": np.asarray(
            b.person.table["firstName"].read_all(meter), dtype=object)})
    joined = acero.hash_join(rel, names, "<dst>", "pid")
    joined = acero.order_by(joined, "creationDate", desc=True)
    return joined["<dst>"], joined["creationDate"]


# --------------------------------------------------------------------------
# IC-8: latest 20 replies to any message created by `person`
# --------------------------------------------------------------------------

def _traversal_fusable(adj) -> bool:
    """Whether the fused traversal plane may serve this adjacency under
    the process's transfer regime (``DEVICE_RESIDENT`` read at call time
    so env/monkeypatch overrides are honored)."""
    from repro_torch.kernels.pac_decode import ops as pac_ops
    from repro_torch.kernels.traversal.ops import plan_supported
    return pac_ops.DEVICE_RESIDENT and plan_supported(adj)


def _two_hop_fusable(adj_a, adj_b, vt: VertexTable) -> bool:
    return (_traversal_fusable(adj_a) and _traversal_fusable(adj_b)
            and adj_a.num_value_vertices == adj_b.num_key_vertices
            and vt.page_size % 32 == 0)


def ic8_graphar(g: Graph, person: int, limit: int = 20,
                meter: Optional[IOMeter] = None,
                engine: str = "cuda",
                reply_label: Optional[str] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    # hop 1: messages created by person  (hasCreator, incoming = by_dst)
    creator_adj = g.adjacency("message-hasCreator-person", BY_DST)
    # hop 2: replies to those messages (replyOf, incoming = by_dst)
    reply_adj = g.adjacency("message-replyOf-message", BY_DST)
    vt = g.vertex("message")
    filt = LabelFilter(vt, L(reply_label)) if reply_label else None
    if engine != "numpy" and _two_hop_fusable(creator_adj, reply_adj, vt):
        # both hops + the label AND as ONE device dispatch over the
        # adjacencies' resident traversal plans: the created-message
        # frontier never comes back to the host between hops
        # (kernels/traversal.two_hop_pac; oracle I/O replayed for the
        # meter)
        from repro_torch.kernels.traversal.ops import two_hop_pac
        pac = two_hop_pac(creator_adj, reply_adj, [person], vt.page_size,
                          filt, meter, engine)
    else:
        # staged host path: hop-1 decode, then one batched hop-2
        # retrieval (vectorized offsets gather + page-deduplicated
        # multi-range decode) with the label predicate pushed down
        created = creator_adj.neighbor_ids(person, meter)
        pac = retrieve_neighbors_batch(reply_adj, created, vt.page_size,
                                       meter, engine, filter=filt)
    replies = pac.to_ids()
    if replies.size == 0:
        return replies, replies
    # fetch reply creationDate via PAC pushdown; top-`limit` newest
    dates = np.asarray(
        fetch_properties_batch(pac, vt, ["creationDate"],
                               meter)["creationDate"], np.int64)
    order = np.lexsort((-replies, -dates))[:limit]
    return replies[order], dates[order]


def ic8_acero(b: SnbBaseline, person: int, limit: int = 20,
              meter: Optional[IOMeter] = None,
              reply_label: Optional[str] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    created = acero.scan(b.has_creator, ["<src>", "<dst>"], meter,
                         predicate=("<dst>", "==", person))
    created = acero.filter_rel(created, created["<dst>"] == person)
    replies = acero.scan(b.reply_of, ["<src>", "<dst>"], meter)
    j = acero.hash_join(replies, created, "<dst>", "<src>")
    reply_ids = np.unique(j["<src>"])
    if reply_label is not None and reply_ids.size:
        strings = b.message.table["<labels>"].read_all(meter)
        mask = acero.string_label_mask(strings, reply_label)
        reply_ids = reply_ids[mask[reply_ids]]
    if reply_ids.size == 0:
        return reply_ids, reply_ids
    msg = acero.scan(b.message.table, ["creationDate"], meter)
    dates = msg["creationDate"][reply_ids]
    order = np.lexsort((-reply_ids, -dates))[:limit]
    return reply_ids[order], dates[order]


# --------------------------------------------------------------------------
# BI-2: per-tag message counts within one tag class (label filtering)
# --------------------------------------------------------------------------

def bi2_graphar(g: Graph, tagclass: str,
                meter: Optional[IOMeter] = None,
                engine: str = "cuda") -> Dict[int, int]:
    msg_vt = g.vertex("message")
    # interval label filter: messages labeled with the tag class,
    # engine-dispatched (kernel engines evaluate the compiled predicate
    # on-device and hand back interval planes; numpy keeps the host path)
    iv = filter_rle_interval(msg_vt, L(tagclass), meter, engine=engine)
    starts, ends = iv
    adj = g.adjacency("message-hasTag-tag", BY_SRC)
    tag_vt = g.vertex("tag")
    cls_id = int(tagclass.removeprefix("TagClass"))
    tag_classes = np.asarray(tag_vt.table["tagclass"].read_all(meter))
    if starts.size == 0:
        return {}
    # intervals of sorted messages -> contiguous edge-row ranges via one
    # deduplicated gather of the <offset> column; the ranges then flow
    # through the shared multi-range decode (multiplicity preserved --
    # BI-2 counts edges, so no PAC/set collapse here).
    bounds = adj.offsets_at(np.concatenate([starts, ends]), meter)
    los, his = bounds[:starts.size], bounds[starts.size:]
    if engine != "numpy" and _traversal_fusable(adj):
        # counting expansion over the resident traversal plan: the
        # interval frontier ships as O(intervals) ids and the per-tag
        # edge counts come back directly -- no per-edge id
        # materialization on the host
        from repro_torch.kernels.traversal.ops import frontier_edge_counts
        counts = frontier_edge_counts(adj, starts, ends, los, his, meter,
                                      engine)
        counts[tag_classes != cls_id] = 0
        return {int(t): int(counts[t]) for t in np.flatnonzero(counts)}
    tags = decode_edge_ranges(adj, los, his, meter, engine)
    tags = tags[tag_classes[tags] == cls_id]
    keys, cnts = np.unique(tags, return_counts=True)
    return {int(t): int(c) for t, c in zip(keys, cnts)}


def bi2_acero(b: SnbBaseline, tagclass: str,
              meter: Optional[IOMeter] = None) -> Dict[int, int]:
    # string label filter over messages
    strings = b.message.table["<labels>"].read_all(meter)
    mask = acero.string_label_mask(strings, tagclass)
    msg_ids = np.flatnonzero(mask)
    msgs = acero.Relation({"mid": msg_ids.astype(np.int64)})
    ht = acero.scan(b.has_tag, ["<src>", "<dst>"], meter)
    j = acero.hash_join(msgs, ht, "mid", "<src>")
    tags_rel = acero.scan(b.tag.table, ["tagclass"], meter)
    cls_id = int(tagclass.removeprefix("TagClass"))
    tag_ids = np.flatnonzero(tags_rel["tagclass"] == cls_id)
    sel = np.isin(j["<dst>"], tag_ids)
    keys, counts = acero.aggregate_count(
        acero.Relation({"t": j["<dst>"][sel]}), "t")
    return {int(k): int(c) for k, c in zip(keys, counts)}
