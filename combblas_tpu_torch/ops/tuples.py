"""SpTuples — padded static-capacity COO tile, counterpart of
``combblas_tpu/ops/tuples.py``.

A tile carries a fixed ``capacity`` of slots and an ``nnz`` count. The
padding contract is the reference's: invalid slots hold ``row == nrows``
and ``col == ncols``, so row-major sorts push them to the tail and the
compacting scatters below send them to one drop slot past the end.
Compacted tiles hold their entries as a row-major prefix with padding
values 0. ``nnz`` stays a 0-dim device tensor: nothing here reads it back
to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..semiring import Semiring
from .segment import segment_reduce


@dataclasses.dataclass(frozen=True)
class SpTuples:
    """rows/cols: int32[cap]; vals: [cap]; nnz: int32 0-dim tensor."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    nrows: int
    ncols: int

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @staticmethod
    def from_coo(rows, cols, vals, nrows: int, ncols: int, capacity: int | None = None,
                 device: str | torch.device = "cuda") -> "SpTuples":
        """Build from host index and value arrays (unsorted is fine) on
        ``device`` (default: the CUDA card)."""
        rows = np.asarray(rows, dtype=np.int32)
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals)
        n = rows.shape[0]
        cap = int(capacity) if capacity is not None else max(n, 1)
        if n > cap:
            raise ValueError(f"nnz {n} exceeds capacity {cap}")
        pr = np.full(cap, nrows, dtype=np.int32)
        pc = np.full(cap, ncols, dtype=np.int32)
        pv = np.zeros(cap, dtype=vals.dtype)
        pr[:n], pc[:n], pv[:n] = rows, cols, vals
        return SpTuples(
            rows=torch.from_numpy(pr).to(device),
            cols=torch.from_numpy(pc).to(device),
            vals=torch.from_numpy(pv).to(device),
            nnz=torch.tensor(n, dtype=torch.int32, device=device),
            nrows=int(nrows),
            ncols=int(ncols),
        )

    @staticmethod
    def from_dense(dense, capacity: int | None = None, zero=0,
                   device: str | torch.device = "cuda") -> "SpTuples":
        """The entries of a host array that differ from ``zero``."""
        dense = np.asarray(dense)
        r, c = np.nonzero(dense != zero)
        return SpTuples.from_coo(r, c, dense[r, c], dense.shape[0], dense.shape[1],
                                 capacity, device=device)

    @staticmethod
    def empty(nrows: int, ncols: int, capacity: int, dtype: torch.dtype,
              device: str | torch.device = "cuda") -> "SpTuples":
        return SpTuples(
            rows=torch.full((capacity,), nrows, dtype=torch.int32, device=device),
            cols=torch.full((capacity,), ncols, dtype=torch.int32, device=device),
            vals=torch.zeros((capacity,), dtype=dtype, device=device),
            nnz=torch.zeros((), dtype=torch.int32, device=device),
            nrows=int(nrows),
            ncols=int(ncols),
        )

    def valid_mask(self) -> torch.Tensor:
        return self.rows < self.nrows

    def to_dense(self, sr: Semiring | None = None) -> torch.Tensor:
        """Densify; duplicates combine with ``sr.add`` (default: sum). For
        min and max the reference scatters into a buffer of ``sr.zero``,
        so each cell is ``sr.add``-ed with the zero once more; any other
        monoid folds by ``segment_reduce`` over the flattened cell ids."""
        cells = (self.nrows + 1) * (self.ncols + 1)
        flat = self.rows.long() * (self.ncols + 1) + self.cols.long()  # padding: the corner cell
        if sr is None or sr.add_kind == "sum":
            vals = torch.where(self.valid_mask(), self.vals, 0).to(self.dtype)
            out = torch.zeros(cells, dtype=self.dtype, device=self.vals.device)
            out.index_add_(0, flat, vals)
        else:
            out = segment_reduce(sr, self.vals, flat, cells)
            if sr.add_kind in ("min", "max"):
                out = sr.add(torch.full_like(out, sr.zero(self.dtype)), out)
        return out.view(self.nrows + 1, self.ncols + 1)[: self.nrows, : self.ncols]

    def sort_rowmajor(self) -> "SpTuples":
        """Stable sort by (row, col); padding goes to the tail."""
        key = self.rows.long() * (self.ncols + 1) + self.cols.long()
        order = torch.sort(key, stable=True).indices
        return dataclasses.replace(
            self, rows=self.rows[order], cols=self.cols[order], vals=self.vals[order]
        )

    def sort_colmajor(self) -> "SpTuples":
        """Stable sort by (col, row); padding goes to the tail."""
        key = self.cols.long() * (self.nrows + 1) + self.rows.long()
        order = torch.sort(key, stable=True).indices
        return dataclasses.replace(
            self, rows=self.rows[order], cols=self.cols[order], vals=self.vals[order]
        )

    def transpose(self) -> "SpTuples":
        """Swap rows and cols; padding slots become (ncols, nrows)."""
        valid = self.valid_mask()
        return SpTuples(
            rows=torch.where(valid, self.cols, self.ncols),
            cols=torch.where(valid, self.rows, self.nrows),
            vals=self.vals,
            nnz=self.nnz,
            nrows=self.ncols,
            ncols=self.nrows,
        )

    def with_capacity(self, capacity: int) -> "SpTuples":
        """Grow (padding slots appended) or shrink (a compacted tile keeps
        its first ``capacity`` entries; ``nnz`` is clamped to match)."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity > cap:
            pad = capacity - cap
            return dataclasses.replace(
                self,
                rows=torch.cat([self.rows, self.rows.new_full((pad,), self.nrows)]),
                cols=torch.cat([self.cols, self.cols.new_full((pad,), self.ncols)]),
                vals=torch.cat([self.vals, self.vals.new_zeros((pad,))]),
            )
        return dataclasses.replace(
            self,
            rows=self.rows[:capacity],
            cols=self.cols[:capacity],
            vals=self.vals[:capacity],
            nnz=torch.clamp(self.nnz, max=capacity),
        )

    def compact_counted(
        self, sr: Semiring, *, capacity: int | None = None, assume_sorted: bool = False
    ) -> tuple["SpTuples", torch.Tensor]:
        """Sort row-major, combine duplicates with ``sr.add``, drop entries
        equal to ``sr.zero`` and pack to the front. Also returns the exact
        distinct-key count before truncation to ``capacity``."""
        cap = capacity if capacity is not None else self.capacity
        t = self if assume_sorted else self.sort_rowmajor()
        valid = t.valid_mask()
        same = (t.rows[1:] == t.rows[:-1]) & (t.cols[1:] == t.cols[:-1])
        prev_same = torch.cat([same.new_zeros(1), same])
        is_new = valid & ~prev_same
        seg = torch.cumsum(is_new, 0) - 1
        seg = torch.where(valid, seg, cap)
        vals = segment_reduce(sr, t.vals, seg, cap)
        distinct = is_new.sum().to(torch.int32)
        # first slot of each segment, by one scatter into a drop-slot buffer
        slot_ids = torch.arange(t.capacity, device=t.rows.device)
        first = torch.where(is_new & (seg < cap), seg, cap)
        perm = torch.zeros(cap + 1, dtype=torch.long, device=t.rows.device)
        perm = perm.scatter_(0, first, slot_ids)[:cap]
        out_valid = torch.arange(cap, device=t.rows.device) < distinct
        out = SpTuples(
            rows=torch.where(out_valid, t.rows[perm], self.nrows),
            cols=torch.where(out_valid, t.cols[perm], self.ncols),
            vals=vals,
            nnz=torch.clamp(distinct, max=cap),
            nrows=self.nrows,
            ncols=self.ncols,
        )
        return out.prune_zeros(sr), distinct

    def compact(
        self, sr: Semiring, *, capacity: int | None = None, assume_sorted: bool = False
    ) -> "SpTuples":
        out, _ = self.compact_counted(sr, capacity=capacity, assume_sorted=assume_sorted)
        return out

    def prune_zeros(self, sr: Semiring) -> "SpTuples":
        """Drop entries equal to the additive identity."""
        return self._select(self.valid_mask() & (self.vals != sr.zero(self.dtype)))

    def prune(self, pred) -> "SpTuples":
        """Drop the entries where ``pred(val)`` holds."""
        return self._select(self.valid_mask() & ~pred(self.vals))

    def select_ij(self, keep_fn) -> "SpTuples":
        """Keep the entries where ``keep_fn(row, col)`` (tile-local ids)
        holds."""
        return self._select(self.valid_mask() & keep_fn(self.rows, self.cols))

    def apply(self, fn) -> "SpTuples":
        """``fn`` on the values of the valid entries."""
        return dataclasses.replace(self, vals=torch.where(self.valid_mask(), fn(self.vals),
                                                          self.vals))

    @staticmethod
    def concat(tiles: list["SpTuples"]) -> "SpTuples":
        """The slots of same-shape tiles one after another (capacity: the
        sum)."""
        t0 = tiles[0]
        return SpTuples(
            rows=torch.cat([t.rows for t in tiles]),
            cols=torch.cat([t.cols for t in tiles]),
            vals=torch.cat([t.vals for t in tiles]),
            nnz=sum((t.nnz for t in tiles[1:]), start=t0.nnz),
            nrows=t0.nrows,
            ncols=t0.ncols,
        )

    def _select(self, keep: torch.Tensor) -> "SpTuples":
        """Stable-compact the entries where ``keep`` to the front."""
        cap = self.capacity
        nkeep = keep.sum().to(torch.int32)
        pos = torch.cumsum(keep, 0) - 1
        slot_ids = torch.arange(cap, device=keep.device)
        perm = torch.zeros(cap + 1, dtype=torch.long, device=keep.device)
        perm = perm.scatter_(0, torch.where(keep, pos, cap), slot_ids)[:cap]
        out_valid = slot_ids < nkeep
        return SpTuples(
            rows=torch.where(out_valid, self.rows[perm], self.nrows),
            cols=torch.where(out_valid, self.cols[perm], self.ncols),
            vals=torch.where(out_valid, self.vals[perm], 0),
            nnz=nkeep,
            nrows=self.nrows,
            ncols=self.ncols,
        )
