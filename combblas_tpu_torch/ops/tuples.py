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

    def valid_mask(self) -> torch.Tensor:
        return self.rows < self.nrows

    def sort_rowmajor(self) -> "SpTuples":
        """Stable sort by (row, col); padding goes to the tail."""
        key = self.rows.long() * (self.ncols + 1) + self.cols.long()
        order = torch.sort(key, stable=True).indices
        return dataclasses.replace(
            self, rows=self.rows[order], cols=self.cols[order], vals=self.vals[order]
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
