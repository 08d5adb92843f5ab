"""Distributed dense vectors (≈ FullyDistVec) — counterpart of
``combblas_tpu/parallel/vec.py``.

A vector is held as ``[pa, L]`` blocks (``DistMultiVec``: ``[pa, L, W]``
for W stacked vectors) on the grid's device, ``L = ceil(length / pa)``:

  * ``"col"``-aligned: ``pa = pc``, block j belongs to grid column j (what
    a product consumes);
  * ``"row"``-aligned: ``pa = pr``, block i belongs to grid row i (what a
    product produces).

A grid lives on one device, so ``realign`` moves no data between devices:
on a square grid block i of one alignment is block i of the other, and
on a rectangular grid the flattened blocks are zero-padded and cut anew.
Padding slots (past ``length``) must hold values that are inert for the
ops applied to them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grid import Grid

_LATER = "is not ported yet (ROADMAP queue 1, item 9: the DistVec op pack)"


def _nblocks(grid: Grid, align: str) -> int:
    if align not in ("row", "col"):
        raise ValueError(f"align must be 'row' or 'col', got {align!r}")
    return grid.pr if align == "row" else grid.pc


def _reblock(blocks: torch.Tensor, grid: Grid, align: str) -> torch.Tensor:
    """``blocks`` ([pa, L, ...]) cut into the blocks of ``align``."""
    dst_pa = _nblocks(grid, align)
    if grid.is_square:
        return blocks
    tail = blocks.shape[2:]
    full = blocks.reshape(-1, *tail)
    L = -(-full.shape[0] // dst_pa)
    pad = dst_pa * L - full.shape[0]
    if pad:
        full = torch.cat([full, full.new_zeros((pad, *tail))])
    return full.reshape(dst_pa, L, *tail)


@dataclasses.dataclass(frozen=True)
class DistVec:
    """Dense distributed vector: ``blocks[pa, L]``."""

    blocks: torch.Tensor
    length: int
    align: str  # "row" | "col"
    grid: Grid

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def block_len(self) -> int:
        return self.blocks.shape[1]

    @staticmethod
    def from_global(grid: Grid, x, align: str = "col", fill=0) -> "DistVec":
        x = np.asarray(x)
        pa = _nblocks(grid, align)
        L = -(-x.shape[0] // pa)
        out = np.full((pa * L,), fill, dtype=x.dtype)
        out[: x.shape[0]] = x
        return DistVec(
            blocks=torch.from_numpy(out.reshape(pa, L)).to(grid.device),
            length=int(x.shape[0]), align=align, grid=grid,
        )

    @staticmethod
    def full(grid: Grid, length: int, value, dtype, align: str = "col") -> "DistVec":
        pa = _nblocks(grid, align)
        L = -(-length // pa)
        blocks = torch.full((pa, L), value, dtype=dtype, device=grid.device)
        return DistVec(blocks=blocks, length=length, align=align, grid=grid)

    @staticmethod
    def iota(grid: Grid, length: int, dtype=torch.int32, align: str = "col") -> "DistVec":
        """Reference: ``FullyDistVec::iota`` (padding slots count on)."""
        pa = _nblocks(grid, align)
        L = -(-length // pa)
        vals = torch.arange(pa * L, dtype=dtype, device=grid.device).reshape(pa, L)
        return DistVec(blocks=vals, length=length, align=align, grid=grid)

    def to_global(self) -> np.ndarray:
        return self.blocks.cpu().numpy().reshape(-1)[: self.length]

    def realign(self, align: str) -> "DistVec":
        if align == self.align:
            return self
        return DistVec(
            blocks=_reblock(self.blocks, self.grid, align),
            length=self.length, align=align, grid=self.grid,
        )


def _later(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"DistVec.{name} {_LATER}")

    stub.__name__ = name
    return stub


for _name in ("apply", "ewise", "mask_padding", "gather", "scatter_combine", "reduce",
              "sort", "find_inds", "invert", "uniq", "randperm"):
    setattr(DistVec, _name, _later(_name))


@dataclasses.dataclass(frozen=True)
class DistMultiVec:
    """W stacked distributed vectors: ``blocks[pa, L, W]`` — the carrier of
    batched frontiers. Same alignment and padding contract as DistVec."""

    blocks: torch.Tensor
    length: int
    align: str  # "row" | "col"
    grid: Grid

    @property
    def width(self) -> int:
        return self.blocks.shape[2]

    @property
    def block_len(self) -> int:
        return self.blocks.shape[1]

    @staticmethod
    def from_global(grid: Grid, x, align: str = "col", fill=0) -> "DistMultiVec":
        """x: [length, W] host array."""
        x = np.asarray(x)
        n, W = x.shape
        pa = _nblocks(grid, align)
        L = -(-n // pa)
        out = np.full((pa * L, W), fill, dtype=x.dtype)
        out[:n] = x
        return DistMultiVec(
            blocks=torch.from_numpy(out.reshape(pa, L, W)).to(grid.device),
            length=int(n), align=align, grid=grid,
        )

    def to_global(self) -> np.ndarray:
        b = self.blocks.cpu().numpy()
        return b.reshape(-1, b.shape[2])[: self.length]

    def realign(self, align: str) -> "DistMultiVec":
        if align == self.align:
            return self
        return DistMultiVec(
            blocks=_reblock(self.blocks, self.grid, align),
            length=self.length, align=align, grid=self.grid,
        )
