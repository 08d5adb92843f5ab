"""SpParMat — sparse matrix over a pr×pc grid, counterpart of
``combblas_tpu/parallel/spmat.py``.

Tiles are stacked as ``[pr, pc, cap]`` tensors on ``grid.device``, with
tile-local indices: padding slots hold ``(local_rows, local_cols)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.tuples import SpTuples
from ..semiring import Semiring
from .grid import Grid, HostGrid


@dataclasses.dataclass(frozen=True)
class SpParMat:
    """rows/cols: int32[pr, pc, cap]; vals: [pr, pc, cap]; nnz: int32[pr, pc]."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    nrows: int
    ncols: int
    grid: Grid

    @property
    def capacity(self) -> int:
        return self.rows.shape[2]

    @property
    def local_rows(self) -> int:
        return self.grid.local_rows(self.nrows)

    @property
    def local_cols(self) -> int:
        return self.grid.local_cols(self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def getnnz(self) -> torch.Tensor:
        """Total nonzeros (a 0-dim device tensor)."""
        return self.nnz.sum()

    def local_tile(self, i: int, j: int) -> SpTuples:
        """Tile (i, j) as an SpTuples with tile-local indices."""
        return SpTuples(
            rows=self.rows[i, j],
            cols=self.cols[i, j],
            vals=self.vals[i, j],
            nnz=self.nnz[i, j],
            nrows=self.local_rows,
            ncols=self.local_cols,
        )

    @staticmethod
    def from_tiles(
        tiles: list[list[SpTuples]], nrows: int, ncols: int, grid: Grid
    ) -> "SpParMat":
        """Stack a pr×pc nested list of equal-capacity tiles."""

        def stack(field):
            return torch.stack(
                [torch.stack([getattr(t, field) for t in row]) for row in tiles]
            )

        return SpParMat(
            rows=stack("rows"),
            cols=stack("cols"),
            vals=stack("vals"),
            nnz=stack("nnz").to(torch.int32),
            nrows=int(nrows),
            ncols=int(ncols),
            grid=grid,
        )

    def tile_map(self, fn) -> "SpParMat":
        """Apply ``fn: SpTuples -> SpTuples`` to every tile."""
        tiles = [
            [fn(self.local_tile(i, j)) for j in range(self.grid.pc)]
            for i in range(self.grid.pr)
        ]
        return SpParMat.from_tiles(tiles, self.nrows, self.ncols, self.grid)

    @staticmethod
    def from_global_coo(
        grid: Grid,
        rows,
        cols,
        vals,
        nrows: int,
        ncols: int,
        capacity: int | None = None,
        dedup_sr: Semiring | None = None,
    ) -> "SpParMat":
        """Bucket global host tuples by owner tile, upload, and with
        ``dedup_sr`` combine duplicates per tile (``SpTuples.compact``)."""
        vals = np.asarray(vals)
        rows, cols, order, counts, starts, cap, lr, lc = bucket_by_tile(
            grid, rows, cols, nrows, ncols, capacity
        )
        vals = vals[order]
        pr_, pc_ = grid.pr, grid.pc
        R = np.full((pr_, pc_, cap), lr, dtype=np.int32)
        C = np.full((pr_, pc_, cap), lc, dtype=np.int32)
        V = np.zeros((pr_, pc_, cap), dtype=vals.dtype)
        for t in range(grid.size):
            i, j = divmod(t, pc_)
            s, e = starts[t], starts[t + 1]
            n = e - s
            R[i, j, :n] = rows[s:e] - i * lr
            C[i, j, :n] = cols[s:e] - j * lc
            V[i, j, :n] = vals[s:e]
        mat = SpParMat(
            rows=torch.from_numpy(R).to(grid.device),
            cols=torch.from_numpy(C).to(grid.device),
            vals=torch.from_numpy(V).to(grid.device),
            nnz=torch.from_numpy(counts.reshape(pr_, pc_).astype(np.int32)).to(
                grid.device
            ),
            nrows=int(nrows),
            ncols=int(ncols),
            grid=grid,
        )
        if dedup_sr is not None:
            mat = mat.tile_map(lambda t: t.compact(dedup_sr))
        return mat

    @staticmethod
    def from_dense(grid: Grid, dense, capacity=None, dedup_sr=None) -> "SpParMat":
        dense = np.asarray(dense)
        r, c = np.nonzero(dense)
        return SpParMat.from_global_coo(
            grid, r, c, dense[r, c], dense.shape[0], dense.shape[1],
            capacity=capacity, dedup_sr=dedup_sr,
        )

    def to_global_coo(self):
        """Host (rows, cols, vals) of every valid entry, tile by tile."""
        lr, lc = self.local_rows, self.local_cols
        R = self.rows.cpu().numpy()
        C = self.cols.cpu().numpy()
        V = self.vals.cpu().numpy()
        N = self.nnz.cpu().numpy()
        out_r, out_c, out_v = [], [], []
        for i in range(self.grid.pr):
            for j in range(self.grid.pc):
                m = R[i, j] < lr
                if m.sum() != N[i, j]:
                    raise ValueError(
                        f"tile ({i}, {j}) holds {m.sum()} valid slots, nnz says {N[i, j]}"
                    )
                out_r.append(R[i, j, m].astype(np.int64) + i * lr)
                out_c.append(C[i, j, m].astype(np.int64) + j * lc)
                out_v.append(V[i, j, m])
        return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)

    def to_dense(self) -> np.ndarray:
        r, c, v = self.to_global_coo()
        out = np.zeros((self.nrows, self.ncols), dtype=v.dtype)
        np.add.at(out, (r, c), v)
        return out


def bucket_by_tile(
    grid: HostGrid, rows, cols, nrows: int, ncols: int, capacity: int | None
):
    """Sort global tuples by owner tile. Returns
    ``(rows_sorted, cols_sorted, order, counts, starts, cap, lr, lc)``;
    raises ValueError when an explicit ``capacity`` is too small."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    lr, lc = grid.local_rows(nrows), grid.local_cols(ncols)
    tile_id = (rows // lr) * grid.pc + (cols // lc)
    order = np.argsort(tile_id, kind="stable")
    rows, cols = rows[order], cols[order]
    counts = np.bincount(tile_id, minlength=grid.size)
    cap = int(capacity) if capacity is not None else max(int(counts.max()), 1)
    if counts.max() > cap:
        raise ValueError(f"tile nnz {counts.max()} exceeds capacity {cap}")
    starts = np.concatenate([[0], np.cumsum(counts)])
    return rows, cols, order, counts, starts, cap, lr, lc


def ones_i32(v: torch.Tensor) -> torch.Tensor:
    """Structural-one map for ``reduce(map_fn=...)``: int32 ones of ``v``'s
    shape (degrees as entry counts)."""
    return torch.ones(v.shape, dtype=torch.int32, device=v.device)


def ones_f32(v: torch.Tensor) -> torch.Tensor:
    return torch.ones(v.shape, dtype=torch.float32, device=v.device)
