"""Synthetic graph generators (the JAX package's, same random streams).

``powerlaw_graph`` produces a degree-skewed graph with tunable ID
locality (sparse, clustered adjacency -> few bits per delta, paper §4.2);
``clustered_labels`` produces boolean label columns arranged in runs
(short RLE interval lists, paper §5.1); ``ldbc_like`` produces an
LDBC-SNB-flavoured property graph (persons, messages, tags with tagclass
labels) for the end-to-end queries (paper §6.5); ``document_graph``
produces a corpus-with-links lake (ragged token lists, a link graph,
five clustered labels, a quality score) for the serving retriever and
the LM data pipeline.  All draw from the same
``np.random.default_rng`` streams as the JAX package's generators, so one
seed gives the same graph in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


def powerlaw_graph(num_vertices: int, avg_degree: float,
                   locality: float = 0.9, alpha: float = 2.1,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list (src, dst) with Zipf-ish out-degrees and ID locality.

    ``locality`` is the fraction of edges whose endpoint is drawn from a
    narrow window around the source ID (log-normal offsets), matching the
    clustering the paper exploits; the rest are uniform (long-range links).
    """
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    # power-law out-degree: sample sources via Zipf ranks
    ranks = rng.zipf(alpha, size=num_edges).astype(np.int64)
    src = (ranks * 9973 + rng.integers(0, num_vertices, num_edges)) \
        % num_vertices
    local = rng.random(num_edges) < locality
    offs = np.maximum(rng.lognormal(3.0, 1.5, num_edges).astype(np.int64), 1)
    sign = rng.choice([-1, 1], num_edges)
    dst_local = (src + sign * offs) % num_vertices
    dst_rand = rng.integers(0, num_vertices, num_edges)
    dst = np.where(local, dst_local, dst_rand)
    keep = src != dst
    return src[keep].astype(np.int64), dst[keep].astype(np.int64)


def clustered_labels(num_vertices: int, names: List[str],
                     density: float = 0.3, run_scale: int = 4096,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Boolean label columns arranged in runs (short RLE interval lists)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k, name in enumerate(names):
        col = np.zeros(num_vertices, bool)
        pos = 0
        r = np.random.default_rng(seed * 1000003 + k)
        while pos < num_vertices:
            run = max(int(r.exponential(run_scale)), 32)
            val = r.random() < density
            col[pos:pos + run] = val
            pos += run
        out[name] = col
    return out


def scattered_labels(num_vertices: int, names: List[str],
                     density: float = 0.3, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """Adversarial (unclustered) labels -- worst case for RLE (Fig. 14)."""
    rng = np.random.default_rng(seed)
    return {n: rng.random(num_vertices) < density for n in names}


# --------------------------------------------------------------------------
# LDBC-SNB-like social graph (paper §6.5)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SnbGraph:
    """Raw arrays of a scaled-down LDBC-SNB-like interactive dataset."""

    num_persons: int
    num_messages: int
    num_tags: int
    num_tagclasses: int
    # edges
    knows_src: np.ndarray
    knows_dst: np.ndarray
    knows_creation: np.ndarray       # creationDate per knows edge
    has_creator_msg: np.ndarray      # message -> person
    has_creator_person: np.ndarray
    reply_of_src: np.ndarray         # message -> message (reply -> parent)
    reply_of_dst: np.ndarray
    has_tag_msg: np.ndarray          # message -> tag
    has_tag_tag: np.ndarray
    # vertex properties
    person_first_name: List[str]
    person_birthday: np.ndarray
    message_creation: np.ndarray
    message_length: np.ndarray
    tag_class_of_tag: np.ndarray     # tag -> tagclass id
    tagclass_names: List[str]
    # labels (tagclass labels attached to messages, paper §6.5)
    message_labels: Dict[str, np.ndarray]
    person_labels: Dict[str, np.ndarray]


def ldbc_like(scale: int = 1, seed: int = 0) -> SnbGraph:
    """Scale 1 ~ 10k persons / 80k messages; grows linearly with ``scale``."""
    rng = np.random.default_rng(seed)
    n_person = 10_000 * scale
    n_msg = 80_000 * scale
    n_tagclass = 8
    n_tag = 64

    # person-knows-person: power-law + community locality
    ks, kd = powerlaw_graph(n_person, avg_degree=12, locality=0.85,
                            seed=seed + 1)
    # dedup self/duplicate edges cheaply
    key = ks * n_person + kd
    _, idx = np.unique(key, return_index=True)
    ks, kd = ks[idx], kd[idx]
    k_creation = rng.integers(2010_00_00, 2023_00_00, len(ks)).astype(np.int64)

    # messages: creator follows a power law over persons; creation dates
    # clustered per creator so message ids correlate with persons.
    creator = np.sort(
        (rng.zipf(1.9, n_msg) * 7919 + rng.integers(0, n_person, n_msg))
        % n_person).astype(np.int64)
    msg_creation = (2019_00_00
                    + np.cumsum(rng.integers(0, 3, n_msg))
                    % 5_00_00).astype(np.int64)
    msg_length = rng.integers(5, 2000, n_msg).astype(np.int64)

    # replyOf: a reply points to an earlier message (~60% of messages)
    is_reply = rng.random(n_msg) < 0.6
    reply_src = np.flatnonzero(is_reply & (np.arange(n_msg) > 10))
    reply_dst = (reply_src
                 - np.maximum(rng.lognormal(2.0, 1.2, len(reply_src))
                              .astype(np.int64), 1))
    ok = reply_dst >= 0
    reply_src, reply_dst = reply_src[ok], reply_dst[ok]

    # hasTag: 1-3 tags per message; tag choice is *topically clustered* --
    # consecutive messages (threads) share tags, the locality GraphAr's RLE
    # label columns exploit (paper §5.1: |P| << n in real graphs).
    tags_per = rng.integers(1, 4, n_msg)
    ht_msg = np.repeat(np.arange(n_msg, dtype=np.int64), tags_per)
    topic_block = (ht_msg // 512) * 13  # slowly-varying topic per thread blk
    ht_tag = ((topic_block + (rng.zipf(1.6, len(ht_msg)) - 1))
              % n_tag).astype(np.int64)

    tag_class = rng.integers(0, n_tagclass, n_tag).astype(np.int64)
    tagclass_names = [f"TagClass{c}" for c in range(n_tagclass)]

    # message labels: tagclass c attached iff any of the message's tags is
    # in class c (this is the 'static type info as labels' trick of §6.5).
    message_labels: Dict[str, np.ndarray] = {}
    msg_tagclass = np.zeros((n_msg, n_tagclass), bool)
    msg_tagclass[ht_msg, tag_class[ht_tag]] = True
    for c, nm in enumerate(tagclass_names):
        message_labels[nm] = msg_tagclass[:, c]

    person_labels = clustered_labels(
        n_person, ["Asian", "Enrollee", "Student"],
        density=0.35, run_scale=512, seed=seed + 7)

    first_names = [f"p{i % 997}" for i in range(n_person)]
    birthday = rng.integers(1950_00_00, 2005_00_00, n_person).astype(np.int64)

    return SnbGraph(
        num_persons=n_person, num_messages=n_msg, num_tags=n_tag,
        num_tagclasses=n_tagclass,
        knows_src=ks, knows_dst=kd, knows_creation=k_creation,
        has_creator_msg=np.arange(n_msg, dtype=np.int64),
        has_creator_person=creator,
        reply_of_src=reply_src, reply_of_dst=reply_dst,
        has_tag_msg=ht_msg, has_tag_tag=ht_tag,
        person_first_name=first_names, person_birthday=birthday,
        message_creation=msg_creation, message_length=msg_length,
        tag_class_of_tag=tag_class, tagclass_names=tagclass_names,
        message_labels=message_labels, person_labels=person_labels)


# --------------------------------------------------------------------------
# document-link lake for serving and LM pre-training
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DocumentLake:
    num_docs: int
    tokens: List[np.ndarray]            # ragged token arrays per doc
    links_src: np.ndarray               # citation/link graph
    links_dst: np.ndarray
    labels: Dict[str, np.ndarray]       # quality / topic / source labels
    quality: np.ndarray                 # float score property


def document_graph(num_docs: int = 5000, vocab: int = 4096,
                   mean_len: int = 256, seed: int = 0) -> DocumentLake:
    rng = np.random.default_rng(seed)
    lens = np.maximum(rng.poisson(mean_len, num_docs), 16)
    # Zipf token distribution (natural-language-like)
    tokens = [((rng.zipf(1.3, l) - 1) % vocab).astype(np.int32)
              for l in lens]
    src, dst = powerlaw_graph(num_docs, avg_degree=8, locality=0.8,
                              seed=seed + 3)
    labels = clustered_labels(
        num_docs, ["HighQuality", "Spam", "Code", "News", "Reference"],
        density=0.25, run_scale=256, seed=seed + 11)
    quality = rng.random(num_docs).astype(np.float32)
    return DocumentLake(num_docs, tokens, src, dst, labels, quality)
