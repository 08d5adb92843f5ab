"""Local SpGEMM building blocks — counterpart of the parts of
``combblas_tpu/ops/spgemm.py`` that the dense (mxu) tier uses: tile
densification, dense-to-sparse extraction (``sparsify_windowed``,
``sparsify``) with its exact sizing (``dense_support_nnz``) and the COO
duplicate check.
"""

from __future__ import annotations

import torch

from ..semiring import Semiring
from .segment import expand_ranges
from .tuples import SpTuples

#: Semiring add-monoid -> the torch scatter combiner implementing it.
_SCATTER_COMBINERS = {"sum": "add", "min": "min", "max": "max"}


def scatter_combine_for(sr: Semiring) -> str | None:
    """``"add"``/``"min"``/``"max"`` for monoids with a native scatter
    combiner, None for generic monoids."""
    return _SCATTER_COMBINERS.get(sr.add_kind)


def densify(t: SpTuples, pad_rows: int, pad_cols: int, zero) -> torch.Tensor:
    """Tile tuples -> dense ``[pad_rows, pad_cols]``, other cells ``zero``.

    The tile must hold UNIQUE (row, col) entries (the reference's
    unique-indices scatter; callers check with ``coo_has_duplicates``).
    Padding slots write to one drop cell past the end.
    """
    ncell = pad_rows * pad_cols
    flat = t.rows.long() * pad_cols + t.cols.long()
    flat = torch.where(t.valid_mask(), flat, ncell)
    dense = torch.full((ncell + 1,), zero, dtype=t.vals.dtype, device=t.vals.device)
    dense[flat] = t.vals
    return dense[:ncell].view(pad_rows, pad_cols)


def _support_mask(dense: torch.Tensor, zero, nrows: int, ncols: int) -> torch.Tensor:
    """``dense != zero`` restricted to the first ``nrows x ncols`` cells."""
    R, C = dense.shape
    mask = dense != zero
    if C != ncols:
        mask = mask & (torch.arange(C, device=dense.device) < ncols)[None, :]
    if R != nrows:
        mask = mask & (torch.arange(R, device=dense.device) < nrows)[:, None]
    return mask


def dense_support_nnz(dense: torch.Tensor, zero, nrows: int, ncols: int) -> torch.Tensor:
    """Exact count (int32, 0-dim, on the device) of the cells ``!= zero`` in
    the first ``nrows x ncols`` of a (possibly padded) dense block: sizes
    an extraction's capacity exactly instead of guessing and retrying."""
    return _support_mask(dense, zero, nrows, ncols).sum().to(torch.int32)


def sparsify(
    dense: torch.Tensor, zero, nrows: int, ncols: int, capacity: int
) -> tuple[SpTuples, torch.Tensor]:
    """Dense ``[R, C]`` -> (row-major SpTuples of ``capacity`` slots, exact
    nonzero count), row by row: per-row counts feed ``expand_ranges``, and
    each slot finds its column by a binary search over its own row's
    prefix counts. Padding slots hold ``(nrows, ncols)`` and value 0."""
    R, C = dense.shape
    m32 = _support_mask(dense, zero, nrows, ncols).to(torch.int32)
    rowcnt = m32.sum(1, dtype=torch.int32)
    rowcum = torch.cumsum(m32, 1, dtype=torch.int32).reshape(-1)
    owner, offset, valid, total = expand_ranges(rowcnt, capacity)
    # the smallest c with rowcum[owner, c] >= offset + 1
    want = offset + 1
    lo = torch.zeros(capacity, dtype=torch.int32, device=dense.device)
    hi = torch.full((capacity,), C - 1, dtype=torch.int32, device=dense.device)
    base = owner.long() * C
    for _ in range(max((max(C, 2) - 1).bit_length(), 1)):  # ceil(log2(C)) steps
        mid = (lo + hi) >> 1
        below = rowcum[base + mid] < want
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(below, hi, mid)
    out = SpTuples(
        rows=torch.where(valid, owner, nrows).to(torch.int32),
        cols=torch.where(valid, hi, ncols).to(torch.int32),
        vals=torch.where(valid, dense.reshape(-1)[base + hi], 0),
        nnz=torch.clamp(total, max=capacity).to(torch.int32),
        nrows=nrows,
        ncols=ncols,
    )
    return out, total


def sparsify_windowed(
    dense: torch.Tensor, zero, nrows: int, ncols: int, capacity: int
) -> tuple[SpTuples, torch.Tensor]:
    """Dense ``[R, C]`` -> compacted row-major SpTuples of ``capacity``
    slots, and the exact count of cells ``!= zero`` in the first
    ``nrows x ncols`` (exact even when it exceeds ``capacity``).

    One mask, one cumsum rank and one scatter of cell ids into a
    ``capacity``-slot buffer (plus a drop slot); ``total`` stays on the
    device. Padding slots hold ``(nrows, ncols)`` and value 0 — 0, not the
    semiring zero, as in the reference. The reference narrowed windows to
    suit a TPU's memory costs; that has no counterpart here.
    """
    R, C = dense.shape
    dev = dense.device
    mask = _support_mask(dense, zero, nrows, ncols).reshape(-1)
    rank = torch.cumsum(mask, 0)  # inclusive, int64
    total = rank[-1] if rank.numel() else rank.new_zeros(())
    slot = torch.where(mask & (rank <= capacity), rank - 1, capacity)
    cell = torch.zeros(capacity + 1, dtype=torch.long, device=dev)
    cell = cell.scatter_(0, slot, torch.arange(R * C, device=dev))[:capacity]
    valid = torch.arange(capacity, device=dev) < total
    out = SpTuples(
        rows=torch.where(valid, cell // C, nrows).to(torch.int32),
        cols=torch.where(valid, cell % C, ncols).to(torch.int32),
        vals=torch.where(valid, dense.reshape(-1)[cell], 0),
        nnz=torch.clamp(total, max=capacity).to(torch.int32),
        nrows=nrows,
        ncols=ncols,
    )
    return out, total


def coo_sort_dedup(
    rows: torch.Tensor, cols: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable two-key sort (rows major, cols minor) and the per-slot
    ``dup`` mask (True on every repeat after the first of a group)."""
    order_c = torch.sort(cols, stable=True).indices
    r1, c1 = rows[order_c], cols[order_c]
    order_r = torch.sort(r1, stable=True).indices
    rows, cols = r1[order_r], c1[order_r]
    same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
    return rows, cols, torch.cat([same.new_zeros(1), same])
