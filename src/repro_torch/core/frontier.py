"""Frontier: a dense bitmap over a vertex id space (the traversal unit).

Multi-hop traversal's working set -- "which vertices are on the frontier /
already visited" -- is a subset of one id space, and every per-hop
operation on it (expand, union, subtract-visited, predicate mask) is a
bitwise op over that space.  :class:`Frontier` makes the representation
explicit: uint32 words over ``[0, n)`` with the same bit convention as
:class:`~repro_torch.core.pac.PAC` and the label-filter bitmaps (bit
``i & 31`` of word ``i >> 5``), so frontiers, predicate bitmaps, and PAC
planes compose by plain word-wise AND/OR/ANDNOT.

A frontier keeps **device-keyed mirrors**: ``device_plane(device)`` is the
dense int32 0/1 plane the traversal kernels consume, placed once per
``torch.device`` and invalidated by any mutating op (``or_`` / ``andnot``
/ ``and_`` / ``set_ids``).  The fused k-hop path never ships planes per
hop -- it builds them on the card from seed ids -- but callers that pin a
long-lived frontier amortize the transfer here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .pac import PAC, bitmap_to_ids, popcount


def _words_for(n: int) -> int:
    return -(-max(n, 0) // 32)


def ids_to_words(ids: np.ndarray, n: int) -> np.ndarray:
    """uint32 bitmap words over ``[0, n)`` with the given bits set."""
    words = np.zeros(_words_for(n), np.uint32)
    ids = np.asarray(ids, np.int64)
    if ids.size:
        np.bitwise_or.at(words, ids >> 5,
                         np.uint32(1) << (ids & 31).astype(np.uint32))
    return words


def plane_to_words(plane: np.ndarray) -> np.ndarray:
    """Dense 0/1 (or bool) plane -> uint32 bitmap words (little-endian
    bit order, matching the PAC / label-filter convention)."""
    bits = np.asarray(plane) != 0
    pad = (-bits.size) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, bool)])
    return np.packbits(bits, bitorder="little").view(np.uint32)


class Frontier:
    """A set of vertex ids in ``[0, n)`` as a dense uint32 bitmap."""

    __slots__ = ("n", "words", "_device", "device_transfers")

    def __init__(self, n: int, words: "np.ndarray | None" = None):
        self.n = int(n)
        if words is None:
            words = np.zeros(_words_for(n), np.uint32)
        else:
            words = np.asarray(words, np.uint32)
            if words.size != _words_for(n):
                raise ValueError(f"want {_words_for(n)} words for n={n}, "
                                 f"got {words.size}")
        self.words = words
        self._device: Dict[str, torch.Tensor] = {}
        self.device_transfers = 0

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_ids(cls, ids, n: int) -> "Frontier":
        return cls(n, ids_to_words(ids, n))

    @classmethod
    def from_dense_plane(cls, plane, n: "int | None" = None) -> "Frontier":
        """From a 0/1 plane (the representation the kernels carry)."""
        plane = np.asarray(plane)
        if n is None:
            n = plane.size
        return cls(n, plane_to_words(plane[:n]))

    # -- views --------------------------------------------------------------
    def to_ids(self) -> np.ndarray:
        """Sorted member ids (int64)."""
        return bitmap_to_ids(self.words, 0)

    def to_pac(self, page_size: int) -> PAC:
        """The frontier as a PAC over ``page_size`` pages (32-aligned)."""
        return PAC.from_dense_bitmap(self.words, page_size)

    def count(self) -> int:
        """Member count (popcount over the words)."""
        return popcount(self.words)

    def __len__(self) -> int:
        return self.count()

    def __contains__(self, i: int) -> bool:
        return 0 <= i < self.n and bool(
            (self.words[i >> 5] >> np.uint32(i & 31)) & 1)

    def copy(self) -> "Frontier":
        return Frontier(self.n, self.words.copy())

    # -- set algebra (in place; device mirrors are invalidated) -------------
    def or_(self, other: "Frontier") -> "Frontier":
        """``self |= other`` (union)."""
        self._check(other)
        np.bitwise_or(self.words, other.words, out=self.words)
        self._device.clear()
        return self

    def andnot(self, other: "Frontier") -> "Frontier":
        """``self &= ~other`` (difference -- e.g. drop visited ids)."""
        self._check(other)
        np.bitwise_and(self.words, ~other.words, out=self.words)
        self._device.clear()
        return self

    def and_(self, other: "Frontier") -> "Frontier":
        """``self &= other`` (e.g. AND a predicate bitmap in place)."""
        self._check(other)
        np.bitwise_and(self.words, other.words, out=self.words)
        self._device.clear()
        return self

    def set_ids(self, ids) -> "Frontier":
        ids = np.asarray(ids, np.int64)
        if ids.size:
            np.bitwise_or.at(self.words, ids >> 5,
                             np.uint32(1) << (ids & 31).astype(np.uint32))
            self._device.clear()
        return self

    def _check(self, other: "Frontier") -> None:
        if other.n != self.n:
            raise ValueError(f"id-space mismatch: {self.n} vs {other.n}")

    # -- device mirrors (keyed by torch.device) -----------------------------
    def device_plane(self, device: torch.device) -> torch.Tensor:
        """Dense int32 0/1 plane ``[n]`` on ``device``; placed once per
        device and reused until the frontier mutates."""
        key = str(torch.device(device))
        plane = self._device.get(key)
        if plane is None:
            ids = np.arange(self.n, dtype=np.int64)
            host = ((self.words[ids >> 5]
                     >> (ids & 31).astype(np.uint32)) & 1).astype(np.int32)
            plane = torch.from_numpy(host).to(key)
            self._device[key] = plane
            self.device_transfers += 1
        return plane

    def device_stats(self) -> Dict[str, int]:
        return {"devices": len(self._device),
                "transfers": self.device_transfers}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Frontier(n={self.n}, count={self.count()})"
