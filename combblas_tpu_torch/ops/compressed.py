"""Compressed local tiles (CSR / CSC) built on sorted tuples — counterpart
of ``combblas_tpu/ops/compressed.py``.

``CSR``: a row-pointer array ``indptr`` (int32 ``[nrows + 1]``) beside the
row-major sorted column ids and values; ``CSC`` the column-major twin. Both
keep the ``SpTuples`` slot arrays as they are: padding slots (ids past the
count) stay at the tail with their out-of-range ids, and ``indptr`` counts
valid entries only.
"""

from __future__ import annotations

import dataclasses

import torch

from .segment import expand_ranges
from .spgemm import pack_support_bits
from .tuples import SpTuples


def _indptr(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``[n + 1]``: the start of each id's run in sorted ``ids`` (a
    binary search, no scatter); ids >= n (padding, at the tail) are not
    counted."""
    bounds = torch.arange(n + 1, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids, bounds, out_int32=True)


def _to_tuples(major_lens: torch.Tensor, capacity: int, n_major: int):
    """The major-axis id of every slot: its range's owner, ``n_major`` past
    the valid entries."""
    owner, _, valid, _ = expand_ranges(major_lens, capacity)
    return torch.where(valid, owner, n_major)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Row-compressed tile: ``indices`` are column ids, row-major sorted
    (padding: ``ncols``)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    nrows: int
    ncols: int

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @staticmethod
    def from_tuples(t: SpTuples, *, assume_sorted: bool = False) -> "CSR":
        if not assume_sorted:
            t = t.sort_rowmajor()
        return CSR(indptr=_indptr(t.rows, t.nrows), indices=t.cols, vals=t.vals, nnz=t.nnz,
                   nrows=t.nrows, ncols=t.ncols)

    def row_lens(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to_tuples(self) -> SpTuples:
        return SpTuples(rows=_to_tuples(self.row_lens(), self.capacity, self.nrows),
                        cols=self.indices, vals=self.vals, nnz=self.nnz,
                        nrows=self.nrows, ncols=self.ncols)

    def to_bitmask(self) -> torch.Tensor:
        """Packed ``[nrows, ceil(ncols / 32)]`` int32 support words
        (``ops.spgemm.pack_support_bits``); entries are unique, so no
        dedup pass."""
        t = self.to_tuples()
        return pack_support_bits(t.rows, t.cols, self.nrows, self.ncols, assume_unique=True)


@dataclasses.dataclass(frozen=True)
class CSC:
    """Column-compressed tile: ``indices`` are row ids, column-major sorted
    (padding: ``nrows``)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    nrows: int
    ncols: int

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @staticmethod
    def from_tuples(t: SpTuples, *, assume_sorted: bool = False) -> "CSC":
        if not assume_sorted:
            t = t.sort_colmajor()
        return CSC(indptr=_indptr(t.cols, t.ncols), indices=t.rows, vals=t.vals, nnz=t.nnz,
                   nrows=t.nrows, ncols=t.ncols)

    def col_lens(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to_tuples(self) -> SpTuples:
        return SpTuples(rows=self.indices,
                        cols=_to_tuples(self.col_lens(), self.capacity, self.ncols),
                        vals=self.vals, nnz=self.nnz, nrows=self.nrows, ncols=self.ncols)

    def to_bitmask(self) -> torch.Tensor:
        """Packed ``[ncols, ceil(nrows / 32)]`` int32 column-support words:
        bit (j, i) is set iff entry (i, j) exists."""
        t = self.to_tuples()
        return pack_support_bits(t.cols, t.rows, self.ncols, self.nrows, assume_unique=True)
