"""Semiring folds over a grid row or column, in the carousel's order —
counterpart of the tile-loop form of ``combblas_tpu/parallel/collectives.py``.

A grid lives on one device, so the reference's all-reduce over a mesh
axis (``axis_reduce``) is ``grid.combine_tiles`` over the tiles of that
row or column. ``axis_ring_reduce`` is the reference's explicit neighbour
ring (``collectives.py:54-84``): over ``size - 1`` steps each device
receives the running partial of the device before it and folds it in.
Here the fold is walked for one position of the ring. The reference's
form over several cards (``ppermute``, NCCL here) comes with the grids
over several cards (ROADMAP item 12c).
"""

from __future__ import annotations

import torch

from ..semiring import Semiring


def ring_order(size: int, pos: int = 0) -> list[int]:
    """The order in which the device at ``pos`` of a ring of ``size`` folds
    the partials: its own, then the one that arrives after k steps from
    ``pos - k``."""
    return [(pos - k) % size for k in range(size)]


def axis_ring_reduce(sr: Semiring, ys, pos: int = 0) -> torch.Tensor:
    """Fold the partials ``ys`` (one a tile of a grid row or column, in grid
    order) with ``sr.add`` in the ring order of position ``pos``. The add
    must be commutative (every position folds in another order), so a
    generic monoid raises, as in the reference."""
    if sr.add_kind not in ("sum", "min", "max"):
        raise ValueError(
            f"axis_ring_reduce needs a commutative add monoid; semiring {sr.name} "
            f"has add_kind={sr.add_kind!r}: use grid.combine_tiles"
        )
    order = ring_order(len(ys), pos)
    acc = ys[order[0]]
    for k in order[1:]:
        acc = sr.add(acc, ys[k])
    return acc
