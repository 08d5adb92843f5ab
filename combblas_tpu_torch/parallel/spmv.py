"""Distributed semiring SpMV over the pr×pc grid — counterpart of
``combblas_tpu/parallel/spmv.py``.

``dist_spmv`` / ``dist_spmv_masked``: every tile's local ``spmv`` over its
x block, combined over each grid row in column order
(``grid.fold_grid``, the reference's ``axis_reduce`` as it runs on the
CPU); the mask applies to each tile's result before the combine. An
``EllParMat`` dispatches to the ELL family (``dist_spmv_ell*``).
``dist_spmspv``: the sparse-output form (values, active rows, count).
``dist_spmspv_masked``: the top-down BFS step, which walks only the active
columns of each tile's ``CSC``.

The reference's ``dist_spmspv_masked`` builds every tile's ``CSC`` on each
call. Here the caller may build them once (``csc_tiles``) and pass them
(``csc=``), as ``bfs_diropt`` does for a search; without them each call
builds its own, as the reference does. The outputs are the same either
way. The walk's per-tile counts (active columns and walked entries, cut at
the budgets) are read back once a call, or passed in (``counts=``) by a
caller that read them with its own readback.

On a grid over several processes ``dist_spmv`` and ``dist_spmv_masked``
compute each rank's own tiles and fold the exchanged partials in grid
order (``grid.fold_grid``): the one-process result bit for bit, on every
rank. ``dist_spmspv`` and ``dist_spmspv_masked`` raise ``LocalOnlyError``
there (ROADMAP item 12c.1).

Telemetry: each entry point counts ``spmv.dispatch{kernel}``, as the
reference does. The reference's ``dist_spmspv`` and
``dist_spmspv_masked`` are jitted, and its other entries are often called
from jitted code, so there the count is one a trace; the port runs
eagerly and counts one a call.
"""

from __future__ import annotations

import torch

from .. import obs
from ..ops.compressed import CSC
from ..ops.segment import expand_ranges
from ..ops.spmv import spmspv_dense_out, spmv
from ..semiring import Semiring
from .ellmat import EllParMat, dist_spmv_ell, dist_spmv_ell_masked
from .grid import check_length, fold_grid, require_local
from .spmat import SpParMat
from .vec import DistVec


def _row_vec(A: SpParMat, blocks: torch.Tensor) -> DistVec:
    return DistVec(blocks=blocks, length=A.nrows, align="row", grid=A.grid)


def _local_spmv(sr: Semiring, A: SpParMat, xb: torch.Tensor):
    """The ``local(i, j)`` that ``fold_grid`` takes: tile (i, j)'s ``spmv``
    over x block j."""
    return lambda i, j: spmv(sr, A.local_tile(i, j), xb[j],
                             A.fold_rows[A.grid.tile_index(i, j)])


def dist_spmv(sr: Semiring, A, x: DistVec) -> DistVec:
    """y = A ⊗ x: x in either alignment, y row-aligned. ``A``: an
    ``SpParMat`` or an ``EllParMat``."""
    if obs.ENABLED:
        obs.count("spmv.dispatch", kernel="dist_spmv")
    if isinstance(A, EllParMat):
        return dist_spmv_ell(sr, A, x)
    check_length(A, x)
    xb = x.realign("col").blocks
    return _row_vec(A, fold_grid(sr, A.grid, _local_spmv(sr, A, xb)))


def dist_spmv_masked(sr: Semiring, A, x: DistVec, row_active: DistVec) -> DistVec:
    """``dist_spmv`` with ``sr.zero`` in the rows where ``row_active``
    (bool) is False."""
    if obs.ENABLED:
        obs.count("spmv.dispatch", kernel="dist_spmv_masked")
    if isinstance(A, EllParMat):
        return dist_spmv_ell_masked(sr, A, x, row_active)
    check_length(A, x)
    xb = x.realign("col").blocks
    return _row_vec(A, fold_grid(sr, A.grid, _local_spmv(sr, A, xb),
                                 row_active.realign("row").blocks))


def dist_spmspv(sr: Semiring, A: SpParMat, x: DistVec, x_active: DistVec):
    """The sparse-output SpMSpV: ``(y, y_active, nnz)``, y row-aligned
    (``dist_spmv`` of x with its inactive slots at ``sr.zero``), y_active
    the rows with an entry in an active column, nnz their count (0-dim
    int32)."""
    require_local(A.grid, "dist_spmspv", 1)
    check_length(A, x)
    if obs.ENABLED:
        obs.count("spmv.dispatch", kernel="dist_spmspv")
    lr = A.local_rows
    xa = x_active.realign("col").blocks
    act = []
    for i in range(A.grid.pr):
        hit = torch.zeros(lr + 1, dtype=torch.bool, device=xa.device)
        for j in range(A.grid.pc):
            t = A.local_tile(i, j)
            xapad = torch.cat([xa[j], xa.new_zeros(1)])
            touched = t.valid_mask() & xapad.index_select(0, torch.clamp(t.cols, max=xa.shape[1]))
            hit[torch.where(touched, t.rows, lr).long()] = True
        act.append(hit[:lr])
    act = torch.stack(act)
    xb = x.realign("col").blocks
    masked = DistVec(blocks=torch.where(xa, xb, sr.zero(xb.dtype)), length=x.length,
                     align="col", grid=A.grid)
    y = dist_spmv(sr, A, masked)
    y_active = DistVec(blocks=act, length=A.nrows, align="row", grid=A.grid)
    return y, y_active, act.sum(dtype=torch.int32)


def csc_tiles(A: SpParMat) -> list[list[CSC]]:
    """Every tile of A as a ``CSC`` (``[pr][pc]``): what
    ``dist_spmspv_masked`` walks."""
    return [[CSC.from_tuples(A.local_tile(i, j)) for j in range(A.grid.pc)]
            for i in range(A.grid.pr)]


def spmspv_counts(csc, x_active: torch.Tensor, frontier_capacity: int,
                  exp_capacity: int) -> torch.Tensor:
    """On the device, the walk's per-tile counts for a col-aligned active
    mask ``[pc, lc]``: int64 ``[pc + pr * pc]``, the active columns of each
    x block cut at ``frontier_capacity`` (the first ones, ascending), then
    per tile the entries of those columns cut at ``exp_capacity``."""
    sel = x_active & (torch.cumsum(x_active, 1) <= frontier_capacity)
    walked = torch.stack([
        torch.stack([(t.col_lens() * sel[j]).sum() for j, t in enumerate(row)])
        for row in csc])
    return torch.cat([sel.sum(1), torch.clamp(walked, max=exp_capacity).reshape(-1)])


def dist_spmspv_masked(sr: Semiring, A: SpParMat, x: DistVec, x_active: DistVec,
                       row_active: DistVec, *, frontier_capacity: int, exp_capacity: int,
                       csc=None, counts=None) -> DistVec:
    """Masked SpMV in which only the columns where ``x_active`` holds take
    part, and each tile walks only those columns' entries: per tile the
    first ``frontier_capacity`` active local columns, their ranges cut at
    ``exp_capacity`` entries (what lies past a budget is dropped, as in the
    reference; callers keep the frontier within them).

    ``csc``: ``csc_tiles(A)``, built here when None. ``counts``:
    ``spmspv_counts``' values as host ints, read back here when None.
    """
    require_local(A.grid, "dist_spmspv_masked", 1)
    check_length(A, x)
    if obs.ENABLED:
        obs.count("spmv.dispatch", kernel="dist_spmspv_masked")
    xb = x.realign("col").blocks
    xa = x_active.realign("col").blocks
    if csc is None:
        csc = csc_tiles(A)
    if counts is None:
        counts = spmspv_counts(csc, xa, frontier_capacity, exp_capacity).tolist()
    pc_ = A.grid.pc
    nsel, nwalk = counts[:pc_], counts[pc_:]
    sel = [expand_ranges(xa[j], nsel[j])[0] for j in range(pc_)]  # active columns, ascending

    def local(i, j):
        if not nwalk[i * pc_ + j]:  # nothing walked: the fold of no product
            dtype = sr.mul(A.vals[i, j, :0], xb[j, :0]).dtype
            return torch.full((A.local_rows,), sr.zero(dtype), dtype=dtype, device=xb.device)
        return spmspv_dense_out(sr, csc[i][j], sel[j], xb[j].index_select(0, sel[j]),
                                exp_capacity=exp_capacity, live=nwalk[i * pc_ + j])

    return _row_vec(A, fold_grid(sr, A.grid, local, row_active.realign("row").blocks))
