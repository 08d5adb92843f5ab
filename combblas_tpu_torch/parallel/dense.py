"""DenseParMat — a dense matrix over the grid (≈ DenseParMat), counterpart
of ``combblas_tpu/parallel/dense.py``.

Blocks are one ``[pr, pc, lr, lc]`` tensor on the grid's device, blocked
as ``SpParMat``'s tiles, so the sparse ↔ dense elementwise ops pair tile
(i, j) with block (i, j) and move nothing. Betweenness centrality keeps its
path counts and dependencies here. Cells past ``nrows`` / ``ncols`` start
at zero and must stay inert for the ops applied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.segment import DROP_SPREAD, fold_dim, spread_drops
from ..ops.tuples import SpTuples
from ..semiring import Semiring
from .grid import Grid, fold_grid, require_local
from .spmat import SpParMat
from .vec import DistVec


@dataclasses.dataclass(frozen=True)
class DenseParMat:
    """blocks: ``[pr, pc, lr, lc]``."""

    blocks: torch.Tensor
    nrows: int
    ncols: int
    grid: Grid

    def __post_init__(self):
        require_local(self.grid, "DenseParMat", 4)

    @property
    def local_rows(self) -> int:
        return self.blocks.shape[2]

    @property
    def local_cols(self) -> int:
        return self.blocks.shape[3]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @staticmethod
    def zeros(grid: Grid, nrows: int, ncols: int, dtype=torch.float32) -> "DenseParMat":
        lr, lc = grid.local_rows(nrows), grid.local_cols(ncols)
        blocks = torch.zeros((grid.pr, grid.pc, lr, lc), dtype=dtype, device=grid.device)
        return DenseParMat(blocks=blocks, nrows=nrows, ncols=ncols, grid=grid)

    @staticmethod
    def from_global(grid: Grid, dense) -> "DenseParMat":
        dense = np.asarray(dense)
        m, n = dense.shape
        lr, lc = grid.local_rows(m), grid.local_cols(n)
        padded = np.zeros((grid.pr * lr, grid.pc * lc), dense.dtype)
        padded[:m, :n] = dense
        blocks = np.ascontiguousarray(padded.reshape(grid.pr, lr, grid.pc, lc).transpose(0, 2, 1, 3))
        return DenseParMat(blocks=torch.from_numpy(blocks).to(grid.device), nrows=m, ncols=n,
                           grid=grid)

    def to_global(self) -> np.ndarray:
        b = self.blocks.cpu().numpy()
        full = b.transpose(0, 2, 1, 3).reshape(self.grid.pr * self.local_rows,
                                               self.grid.pc * self.local_cols)
        return full[: self.nrows, : self.ncols]

    # --- elementwise ---------------------------------------------------------

    def apply(self, fn) -> "DenseParMat":
        return dataclasses.replace(self, blocks=fn(self.blocks))

    def ewise(self, other: "DenseParMat", fn) -> "DenseParMat":
        if self.grid != other.grid:
            raise ValueError("the matrices must share a grid")
        return dataclasses.replace(self, blocks=fn(self.blocks, other.blocks))

    # --- with a sparse matrix ------------------------------------------------

    def _check(self, S: SpParMat) -> None:
        if self.grid != S.grid:
            raise ValueError("the matrices must share a grid")
        if (self.nrows, self.ncols) != (S.nrows, S.ncols):
            raise ValueError(f"shapes differ: {self.nrows}x{self.ncols} and "
                             f"{S.nrows}x{S.ncols}")

    def _at(self, i: int, j: int, t: SpTuples) -> torch.Tensor:
        """Block (i, j)'s cell under each slot of ``t`` (padding slots
        clamped into the block)."""
        lr, lc = self.local_rows, self.local_cols
        flat = (torch.clamp(t.rows, max=lr - 1).long() * lc
                + torch.clamp(t.cols, max=lc - 1).long())
        return self.blocks[i, j].reshape(-1).index_select(0, flat)

    def add_spmat(self, S: SpParMat, combine=None) -> "DenseParMat":
        """``self[i, j] ← combine(self[i, j], S[i, j])`` on S's entries
        (default: +). Reference: ``DenseParMat::operator+=(SpParMat)``."""
        self._check(S)
        lr, lc = self.local_rows, self.local_cols
        out = []
        for i in range(self.grid.pr):
            row = []
            for j in range(self.grid.pc):
                t = S.local_tile(i, j)
                valid = t.valid_mask()
                flat = spread_drops(t.rows.long() * lc + t.cols.long(), valid, lr * lc)
                b = torch.cat([self.blocks[i, j].reshape(-1),
                               self.blocks.new_zeros(DROP_SPREAD)])
                if combine is None:
                    b.index_add_(0, flat, torch.where(valid, t.vals, 0).to(b.dtype))
                else:
                    cur = self._at(i, j, t)
                    new = combine(cur, t.vals.to(b.dtype))
                    b[flat] = torch.where(valid, new, cur).to(b.dtype)
                row.append(b[: lr * lc].view(lr, lc))
            out.append(torch.stack(row))
        return dataclasses.replace(self, blocks=torch.stack(out))

    def filter_spmat(self, S: SpParMat, keep) -> SpParMat:
        """S without the entries where ``keep(s_val, self[i, j])`` is false.
        Reference: ``EWiseMult(fringe, nsp, exclude)`` in BetwCent."""
        self._check(S)
        return S.tile_map_ij(lambda t, i, j: t._select(
            t.valid_mask() & keep(t.vals, self._at(i, j, t))))

    def scale_spmat(self, S: SpParMat, fn) -> SpParMat:
        """S with values ``fn(s_val, self[i, j])``. Reference: ``EWiseScale``
        in BetwCent."""
        self._check(S)
        return S.tile_map_ij(lambda t, i, j: dataclasses.replace(
            t, vals=torch.where(t.valid_mask(), fn(t.vals, self._at(i, j, t)), t.vals)))

    # --- reductions ----------------------------------------------------------

    def reduce(self, sr: Semiring, axis: str, map_fn=None) -> DistVec:
        """Fold with ``sr.add`` as ``SpParMat.reduce``: ``axis="rows"`` gives
        a col-aligned vector of ``ncols``, ``axis="cols"`` a row-aligned
        one of ``nrows``; each block folds (``ops.segment.fold_dim``), the
        blocks combine over the grid (``grid.fold_grid``)."""
        if axis not in ("rows", "cols"):
            raise ValueError(f"axis must be 'rows' or 'cols', got {axis!r}")
        by_col = axis == "rows"

        def local(i, j):
            b = self.blocks[i, j]
            return fold_dim(sr, map_fn(b) if map_fn is not None else b, 0 if by_col else 1)

        return DistVec(blocks=fold_grid(sr, self.grid, local, down_cols=by_col),
                       length=self.ncols if by_col else self.nrows,
                       align="col" if by_col else "row", grid=self.grid)
