"""Grid — the pr×pc process grid (≈ CommGrid), counterpart of
``combblas_tpu/parallel/grid.py``.

The owner math is the reference's: every tile is ``ceil(m/pr) ×
ceil(n/pc)`` and the owner of global row r is ``r // local_rows``. A grid
lives on one device: a distributed matrix is held as ``[pr, pc, ...]``
tile tensors there, and the tiles are walked in a loop, so the 2×2 parity
cases run in one process. Grids over several cards come later.
"""

from __future__ import annotations

import dataclasses

import torch

from ..semiring import Semiring, _maxval, _minval


@dataclasses.dataclass(frozen=True)
class HostGrid:
    """Device-free grid carrying only the owner math."""

    pr: int
    pc: int

    @property
    def size(self) -> int:
        return self.pr * self.pc

    @property
    def is_square(self) -> bool:
        return self.pr == self.pc

    def local_rows(self, nrows: int) -> int:
        return -(-nrows // self.pr)

    def local_cols(self, ncols: int) -> int:
        return -(-ncols // self.pc)

    def row_owner(self, nrows: int, gr):
        return gr // self.local_rows(nrows)

    def col_owner(self, ncols: int, gc):
        return gc // self.local_cols(ncols)


@dataclasses.dataclass(frozen=True)
class Grid(HostGrid):
    """A pr×pc grid whose tiles live on ``device``."""

    device: torch.device = torch.device("cuda")

    @staticmethod
    def make(pr: int, pc: int, device: str | torch.device | None = None) -> "Grid":
        """A pr×pc grid on ``device`` (default: the current CUDA card).
        Raises when CUDA is asked for, explicitly or by default, and is
        absent; pass ``device="cpu"`` to run on the CPU."""
        if pr < 1 or pc < 1:
            raise ValueError(f"grid dims must be positive, got {pr}x{pc}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return Grid(pr=pr, pc=pc, device=dev)


def combine_tiles(sr: Semiring, ys) -> torch.Tensor:
    """Combine per-tile results ``ys`` (one a grid column or a grid row, in
    grid order) with ``sr.add``: the reference's ``axis_reduce`` as it runs
    on the CPU. A running sum, a running ``sr.add`` for a generic monoid,
    and for min and max a pass from the dtype's extreme that takes a value
    only where it is strictly better. So over two or more tiles a NaN drops
    out and the first of two equal zeros stays; one tile's value passes as
    it is."""
    acc = ys[0]
    if sr.add_kind in ("min", "max") and len(ys) > 1:
        better = torch.lt if sr.add_kind == "min" else torch.gt
        acc = torch.full_like(acc, (_maxval if sr.add_kind == "min" else _minval)(acc.dtype))
        for y in ys:
            acc = torch.where(better(y, acc), y, acc)
        return acc
    for y in ys[1:]:
        acc = sr.add(acc, y)
    return acc


def fold_grid(sr: Semiring, grid: HostGrid, local, active=None,
              down_cols: bool = False) -> torch.Tensor:
    """``local(i, j)`` for every tile, combined with ``combine_tiles`` over
    each grid row in column order: ``[pr, ...]`` row-aligned blocks, each
    tile's result first masked by the row block ``active[i]`` where given.
    ``down_cols``: combined over each grid column in row order instead,
    ``[pc, ...]`` col-aligned blocks (no mask)."""
    if down_cols:
        return torch.stack([combine_tiles(sr, [local(i, j) for i in range(grid.pr)])
                            for j in range(grid.pc)])
    out = []
    for i in range(grid.pr):
        ys = [local(i, j) for j in range(grid.pc)]
        if active is not None:
            ys = [torch.where(active[i], y, sr.zero(y.dtype)) for y in ys]
        out.append(combine_tiles(sr, ys))
    return torch.stack(out)


def check_length(A, x) -> None:
    """Raise unless the vector ``x`` has one slot per column of ``A``."""
    if x.length != A.ncols:
        raise ValueError(f"vector of length {x.length} for a matrix of {A.ncols} columns")
