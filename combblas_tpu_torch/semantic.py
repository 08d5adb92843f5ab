"""Semantic (attributed-edge) graphs and runtime edge filters — counterpart
of ``combblas_tpu/semantic.py`` (≈ ``FilteredBFS.cpp``, ``FilteredMIS.cpp``).

The attributes are a struct of arrays: one ``[pr, pc, cap]`` tensor a
field, slot-aligned with the structure matrix's tuples, so that a
predicate is one elementwise op over them. Two modes, as in the reference:

* ``materialize(pred)`` compacts the passing entries into a plain
  ``SpParMat``;
* ``mask(pred)`` keeps the layout and writes the predicate as 0/1 values,
  for a value-aware semiring (``FILTERED_SELECT2ND_MAX``) whose ``mul``
  gives the additive identity on a masked-out edge: no data moves when the
  filter changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.bfs import bfs
from .models.mis import mis
from .parallel.grid import Grid
from .parallel.spmat import SpParMat, bucket_by_tile
from .semiring import Semiring, _minval


def _sel_zero(dt: torch.dtype):
    signed_int = not dt.is_floating_point and dt != torch.bool and dt.is_signed
    return -1 if signed_int else _minval(dt)


#: SELECT2ND_MAX whose edge of value 0 sends nothing: the on-the-fly
#: filter. A masked edge gives the additive identity of x's dtype.
FILTERED_SELECT2ND_MAX = Semiring(
    name="filtered_select2nd_max",
    add=torch.maximum,
    mul=lambda a, x: torch.where(a != 0, x, _sel_zero(x.dtype)),
    zero_fn=_sel_zero,
    one_fn=None,
    add_kind="max",
)


@dataclasses.dataclass(frozen=True)
class SemanticGraph:
    """A structure matrix and its attributes: ``attrs`` maps a field name
    to a ``[pr, pc, cap]`` tensor aligned with ``structure``'s slots."""

    structure: SpParMat
    attrs: dict

    @staticmethod
    def from_edges(grid: Grid, rows, cols, attrs: dict, nrows: int, ncols: int,
                   capacity: int | None = None) -> "SemanticGraph":
        """Bucket the edges and every attribute column by owner tile on the
        host, then upload; the structure's values are float32 ones."""
        rows, cols, order, counts, starts, cap, lr, lc = bucket_by_tile(
            grid, rows, cols, nrows, ncols, capacity)
        attrs = {k: np.asarray(v)[order] for k, v in attrs.items()}
        pr_, pc_ = grid.pr, grid.pc
        R = np.full((pr_, pc_, cap), lr, np.int32)
        C = np.full((pr_, pc_, cap), lc, np.int32)
        V = np.zeros((pr_, pc_, cap), np.float32)
        F = {k: np.zeros((pr_, pc_, cap), v.dtype) for k, v in attrs.items()}
        for t in range(grid.size):
            i, j = divmod(t, pc_)
            s, e = starts[t], starts[t + 1]
            R[i, j, : e - s] = rows[s:e] - i * lr
            C[i, j, : e - s] = cols[s:e] - j * lc
            V[i, j, : e - s] = 1.0
            for k in attrs:
                F[k][i, j, : e - s] = attrs[k][s:e]

        def up(x):
            return torch.from_numpy(x).to(grid.device)

        structure = SpParMat(rows=up(R), cols=up(C), vals=up(V),
                             nnz=up(counts.reshape(pr_, pc_).astype(np.int32)),
                             nrows=int(nrows), ncols=int(ncols), grid=grid)
        return SemanticGraph(structure=structure, attrs={k: up(v) for k, v in F.items()})

    def materialize(self, pred) -> SpParMat:
        """A plain ``SpParMat`` of the edges passing ``pred(attrs) -> bool``
        (``pred`` gets a dict of per-slot tensors)."""
        return self._filter(pred, "materialize")

    def mask(self, pred) -> SpParMat:
        """The same structure with ``pred`` as 0/1 values, for
        ``FILTERED_SELECT2ND_MAX`` or another value-aware semiring."""
        return self._filter(pred, "mask")

    def _filter(self, pred, mode: str) -> SpParMat:
        """Both modes, tile by tile: ``"materialize"`` compacts the passing
        entries, ``"mask"`` writes the predicate as the values."""
        def f(t, i, j):
            ok = t.valid_mask() & pred({k: a[i, j] for k, a in self.attrs.items()})
            if mode == "materialize":
                return t._select(ok)
            return dataclasses.replace(t, vals=ok.to(t.vals.dtype))

        return self.structure.tile_map_ij(f)


def filtered_bfs(g: SemanticGraph, pred, source, *, materialize: bool = False):
    """BFS over the edges passing ``pred``: ``(parents, levels,
    num_iters)``, as ``bfs``. ``materialize=False`` masks the values and
    runs ``FILTERED_SELECT2ND_MAX``; ``True`` compacts a filtered copy
    first (the better choice when many searches share one filter)."""
    if materialize:
        return bfs(g.materialize(pred), source)
    return bfs(g.mask(pred), source, sr=FILTERED_SELECT2ND_MAX)


def filtered_mis(g: SemanticGraph, pred, generator: torch.Generator | None = None):
    """Luby's MIS on the filtered graph, materialized (MIS iterates on
    one structure): ``(status, num_iters)`` as ``mis``, which takes a
    ``torch.Generator`` where the reference takes a key."""
    return mis(g.materialize(pred), generator)
