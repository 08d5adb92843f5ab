"""Semiring folds over a grid row or column — counterpart of
``combblas_tpu/parallel/collectives.py``.

On a one-process grid the tiles live on one device, so the reference's
all-reduce over a mesh axis (``axis_reduce``) is ``grid.combine_tiles``
over the tiles of that row or column. On a grid over several processes
``axis_reduce`` and ``axis_reduce_scatter`` run over the process group of
a grid row or column (``multihost``): ``sum`` / ``min`` / ``max`` through
one ``all_reduce``, a generic monoid by gathering the ranks' partials
(a ``broadcast`` from each) and folding them in rank order, as the
reference's ``all_gather`` + fold does. Their float sums take the
backend's order; ``grid.fold_grid``, which exchanges the partials and
folds them in grid order, is the form that gives the one-process bits.

``axis_ring_reduce`` is the reference's explicit neighbour ring
(``collectives.py:54-84``): over ``size - 1`` steps each device receives
the running partial of the device before it and folds it in. Here the
fold is walked for one position of the ring on one process; its ring
across ranks comes with the BFS ring (ROADMAP item 12c.1).
"""

from __future__ import annotations

import torch

from ..semiring import Semiring


def _line_ranks(grid, line: str, index: int) -> list[int]:
    if line == "row":
        return grid.row_ranks(index)
    if line == "col":
        return grid.col_ranks(index)
    raise ValueError(f"line must be 'row' or 'col', got {line!r}")


def axis_reduce(sr: Semiring, x: torch.Tensor, grid, line: str, index: int) -> torch.Tensor:
    """``x``, this rank's partial, reduced with ``sr.add`` over the ranks
    that hold tiles of grid row (``line="row"``) or column ``index``; each
    of those ranks calls it and gets the result. Reference:
    ``axis_reduce`` (``collectives.py:21``) over a mesh axis."""
    from . import multihost

    members = _line_ranks(grid, line, index)
    if grid.rank not in members:
        raise ValueError(f"rank {grid.rank} holds no tile of grid {line} {index}")
    if len(members) == 1:
        return x
    if sr.add_kind in ("sum", "min", "max"):
        return multihost.all_reduce_(x.clone(), sr.add_kind, members)
    parts = []
    for r in members:
        buf = x.clone() if r == grid.rank else torch.empty_like(x)
        parts.append(multihost.broadcast_(buf, r, members))
    acc = parts[0]
    for y in parts[1:]:
        acc = sr.add(acc, y)
    return acc


def axis_reduce_scatter(sr: Semiring, x: torch.Tensor, grid, line: str,
                        index: int) -> torch.Tensor:
    """``axis_reduce`` of ``x`` ([m * L, ...] for the line's m ranks), then
    this rank's L-row chunk (by its place among the line's ranks). The
    reduction is whole, then cut: gloo takes no reduce-scatter of CUDA
    tensors, and one route serves both backends. Reference:
    ``axis_reduce_scatter`` (``collectives.py:39``)."""
    members = _line_ranks(grid, line, index)
    full = axis_reduce(sr, x, grid, line, index)
    chunk = x.shape[0] // len(members)
    pos = members.index(grid.rank)
    return full[pos * chunk:(pos + 1) * chunk]


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
