"""Shared kernel-dispatch helpers: padding size classes + a shape-class counter.

The dispatch layer pads variable-length inputs (page-index vectors, the
requested-row position vector) up to a small set of shared
**power-of-two size classes**, so the number of distinct launch shapes
stays bounded however the batch sizes vary.  The classes are the JAX
package's, so the staged vectors of both packages are equal.

PyTorch runs eagerly and compiles nothing per shape, so the JAX
package's retrace counter becomes a **shape-class counter**: each kernel
entry calls :func:`note_shape` with the shapes it launches at, and
:func:`shape_class_count` reports how many distinct ones it has seen.  A
steady-state run that keeps minting new classes would defeat the
padding; tests assert the count stays flat.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple


def next_multiple(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x``."""
    return -(-x // m) * m


def next_pow2(x: int) -> int:
    """Smallest power of two >= ``x`` (``next_pow2(0) == 1``)."""
    return 1 << max(x - 1, 0).bit_length()


def size_class(x: int, minimum: int = 1) -> int:
    """Shared pow2 padding class: smallest power of two >= max(x, minimum).

    The ``minimum`` floor collapses the long tail of tiny frontier shapes
    into one bucket.
    """
    return max(next_pow2(x), next_pow2(minimum))


_SHAPES: Dict[str, Set[Tuple]] = {}


def note_shape(name: str, *shape) -> None:
    """Record one launch of the named kernel entry at ``shape``."""
    _SHAPES.setdefault(name, set()).add(tuple(shape))


def shape_class_count(prefix: str = "") -> int:
    """Distinct launch shapes seen by entries whose name starts with
    ``prefix``."""
    return sum(len(v) for k, v in _SHAPES.items() if k.startswith(prefix))


def shape_class_counts() -> Dict[str, int]:
    """Per-entry distinct launch shapes (a copy)."""
    return {k: len(v) for k, v in _SHAPES.items()}


def reset_shape_classes() -> None:
    _SHAPES.clear()
