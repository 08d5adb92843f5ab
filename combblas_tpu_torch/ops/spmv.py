"""Local (one tile) semiring mat-vec kernels — counterpart of
``combblas_tpu/ops/spmv.py``.

``spmv``: dense x, a gather of x at the tile's columns, ``sr.mul`` and a
segment fold by row; the padding slots fold into a spread of sink rows
(``spread_drops``), not into one. ``spmv_masked``: the same with rows
switched off.
``spmspv_dense_out`` / ``spmspv``: sparse x over a ``CSC`` tile, walking
the active columns' ranges only.

The reference walks a fixed ``exp_capacity`` of slots and lets the ones
past the walked entries drop in its scatter. Here the slots past them are
cut before the fold: every inert slot would add to one sink row, and
atomics on one address serialise (about 79 ms for 2 M slots on an H100,
PERF.md section 6). The cut needs the walked-entry count on the host:
``spmspv_dense_out`` and ``spmspv`` read it back (one readback a call);
``spmspv_dense_out`` takes it as ``live`` instead, as ``parallel/spmv.py``
passes it for all tiles of a grid at once. What lies past ``exp_capacity`` is dropped
in ``expand_ranges``' order, as the reference drops it.
"""

from __future__ import annotations

import torch

from ..semiring import Semiring
from .compressed import CSC
from .segment import DROP_SPREAD, expand_ranges, segment_reduce, spread_drops
from .tuples import SpTuples


def spmv(sr: Semiring, a: SpTuples, x: torch.Tensor,
         fold_rows: torch.Tensor | None = None) -> torch.Tensor:
    """``y[i] = ⊕_j a[i, j] ⊗ x[j]``: x ``[ncols]``, y ``[nrows]``; rows
    without an entry get ``sr.zero``. ``fold_rows``: the row each slot
    folds into, ``spread_drops(a.rows, a.valid_mask(), a.nrows)``; made
    here when None (``SpParMat.fold_rows`` keeps it for a matrix)."""
    if tuple(x.shape) != (a.ncols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, want ({a.ncols},)")
    if fold_rows is None:
        fold_rows = spread_drops(a.rows, a.valid_mask(), a.nrows)
    x_pad = torch.cat([x, x.new_full((1,), sr.zero(x.dtype))])
    prods = sr.mul(a.vals, x_pad.index_select(0, a.cols))
    return segment_reduce(sr, prods, fold_rows, a.nrows + DROP_SPREAD)[:a.nrows]


def spmv_masked(sr: Semiring, a: SpTuples, x: torch.Tensor,
                row_active: torch.Tensor) -> torch.Tensor:
    """``spmv`` with ``sr.zero`` in the rows where ``row_active`` is False."""
    y = spmv(sr, a, x)
    return torch.where(row_active, y, sr.zero(y.dtype))


def _expand_products(sr: Semiring, a_csc: CSC, x_ind: torch.Tensor, x_val: torch.Tensor,
                     exp_capacity: int, live: int | None = None):
    """Walk the active columns: (row ids, products) of the walked entries,
    at most ``exp_capacity`` of them, in the order of the reference's
    slots. ``live``: the walked-entry count if the caller has it (else read
    back here)."""
    x_ind = torch.clamp(x_ind, max=a_csc.ncols)
    lens = a_csc.col_lens()
    lens_pad = torch.cat([lens, lens.new_zeros(1)])
    starts_pad = torch.cat([a_csc.indptr[:-1], lens.new_zeros(1)])
    xlens = lens_pad.index_select(0, x_ind)
    if live is None:
        live = int(xlens.sum())
    live = min(live, exp_capacity)
    owner, offset, _, _ = expand_ranges(xlens, live)  # every slot valid
    slot = starts_pad.index_select(0, x_ind.index_select(0, owner)) + offset
    row = a_csc.indices.index_select(0, slot)
    prod = sr.mul(a_csc.vals.index_select(0, slot), x_val.index_select(0, owner))
    return row, prod


def spmspv_dense_out(sr: Semiring, a_csc: CSC, x_ind: torch.Tensor, x_val: torch.Tensor, *,
                     exp_capacity: int, live: int | None = None) -> torch.Tensor:
    """Sparse x, dense y: ``y[i] = ⊕ a[i, j] ⊗ x[j]`` over the active
    columns j (``x_ind``; ids >= ncols are padding), the walk cut at
    ``exp_capacity`` entries; untouched rows get ``sr.zero``."""
    row, prod = _expand_products(sr, a_csc, x_ind, x_val, exp_capacity, live)
    return segment_reduce(sr, prod, row, a_csc.nrows)


def spmspv(sr: Semiring, a_csc: CSC, x_ind: torch.Tensor, x_val: torch.Tensor,
           x_nnz: torch.Tensor, *, out_capacity: int):
    """Sparse x, sparse y: ``(y_ind, y_val, y_nnz)``, the touched rows in
    ascending order compacted into ``out_capacity`` slots (padding: id
    ``nrows``, value ``sr.zero``), ``y_nnz`` clamped to ``out_capacity``.
    A touched row keeps its value even where it equals ``sr.zero``. The
    valid ``x_ind`` must be distinct (the walk is bounded by the tile's
    capacity); ``x_nnz`` is bookkeeping only, validity comes from the
    ids."""
    del x_nnz
    row, prod = _expand_products(sr, a_csc, x_ind, x_val, a_csc.capacity)
    nrows = a_csc.nrows
    y_dense = segment_reduce(sr, prod, row, nrows)
    touched = torch.zeros(nrows, dtype=torch.bool, device=row.device)
    touched[row.long()] = True  # every walked entry is valid: no sink row
    y_nnz = torch.clamp(touched.sum(dtype=torch.int32), max=out_capacity)
    idx = torch.nonzero(touched).squeeze(1)[:out_capacity]  # ascending rows
    k = idx.shape[0]
    y_ind = torch.full((out_capacity,), nrows, dtype=torch.int32, device=row.device)
    y_ind[:k] = idx.to(torch.int32)
    y_val = torch.full((out_capacity,), sr.zero(y_dense.dtype), dtype=y_dense.dtype,
                       device=row.device)
    y_val[:k] = y_dense.index_select(0, idx)
    return y_ind, y_val, y_nnz
