"""Tuple redistribution to owner tiles (≈ SpParMat::SparseCommon) —
counterpart of ``combblas_tpu/parallel/redistribute.py``.

Each tile of a pr×pc grid holds a chunk of GLOBAL tuples (``[pr, pc,
chunk]``; invalid slots have row >= nrows), for example straight out of
the device R-MAT generator. Routing is the reference's two hops: first by
owner column along each grid row, then by owner row along each grid
column. A hop packs each tile's tuples into ``[ndest, stage_capacity]``
padded buckets, and the exchange the reference makes with ``all_to_all``
is a transpose of the ``[pr, pc, ndest, cap]`` bucket tensor here, as the
grid lives on one device. Tuples past a full bucket or a full tile are
dropped and counted, as in the reference: callers check the count (or let
``from_device_coo`` retry with doubled capacities).

Telemetry (the reference's sites): ``from_device_coo`` gauges
``redistribute.stage_capacity`` / ``redistribute.tile_capacity`` on the
deferred path, and otherwise runs in a ``redistribute`` span with a
``route`` event, a ``redistribute.dropped`` count an attempt and
``redistribute.retries`` a doubling. The reference's
``trace.redistribute_coo`` counts JAX retraces; eager torch has none, so
it is left out.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..ops.segment import DROP_SPREAD, spread_drops
from ..ops.tuples import SpTuples
from ..semiring import Semiring
from .grid import Grid
from .spmat import SpParMat


def _bucket_route(dest, rows, cols, vals, ndest: int, cap: int, pad_row: int, pad_col: int):
    """Scatter flat tuples into ``[ndest, cap]`` padded buckets by ``dest``
    (ids outside ``[0, ndest)`` are dropped uncounted). A tuple's slot is
    its rank among the tuples of its bucket, in input order; slots past
    ``cap`` are dropped and counted. Returns (rows, cols, vals, dropped):
    padding slots carry (pad_row, pad_col, 0), ``dropped`` is a 0-dim
    int64 tensor.

    The reference scatters with ``mode="drop"``; here the dropped slots go
    to spread sinks past the end (``spread_drops``) that are cut off. Each
    run's first slot comes from the run starts (``searchsorted`` of the
    sorted ids), where the reference takes a running maximum: the same
    ranks."""
    dev = dest.device
    dest = torch.where((dest >= 0) & (dest < ndest), dest, ndest).to(torch.int32)
    dsorted, order = torch.sort(dest, stable=True)
    starts = torch.searchsorted(dsorted, torch.arange(ndest + 1, dtype=torch.int32, device=dev))
    counts = starts[1:] - starts[:-1]
    pos = torch.arange(dest.shape[0], device=dev) - starts.index_select(0, dsorted.long())
    ok = (pos < cap) & (dsorted < ndest)
    slot = spread_drops(dsorted.long() * cap + pos, ok, ndest * cap)
    size = ndest * cap + DROP_SPREAD

    def place(x, fill):
        out = torch.full((size,), fill, dtype=x.dtype, device=dev)
        out[slot] = x.index_select(0, order)
        return out[: ndest * cap].view(ndest, cap)

    dropped = torch.clamp(counts - cap, min=0).sum()
    return place(rows, pad_row), place(cols, pad_col), place(vals, 0), dropped


def _route_tiles(dest, rows, cols, vals, ndest: int, cap: int, pad_row: int, pad_col: int):
    """``_bucket_route`` of every tile at once: ``dest`` etc. are ``[pr,
    pc, m]``; returns ``[pr, pc, ndest, cap]`` buckets and the total drop
    count. Tile t's ids become ``t·ndest + dest``, so one stable sort ranks
    every tile's tuples as the per-tile sorts would."""
    pr_, pc_, m = dest.shape
    ntiles = pr_ * pc_
    tile = torch.arange(ntiles, dtype=torch.int32, device=dest.device).view(pr_, pc_, 1)
    ok = (dest >= 0) & (dest < ndest)
    flat = torch.where(ok, tile * ndest + dest.to(torch.int32), ntiles * ndest).reshape(-1)
    br, bc, bv, dropped = _bucket_route(flat, rows.reshape(-1), cols.reshape(-1),
                                        vals.reshape(-1), ntiles * ndest, cap, pad_row, pad_col)
    shape = (pr_, pc_, ndest, cap)
    return br.view(shape), bc.view(shape), bv.view(shape), dropped


def redistribute_coo(
    grid: Grid,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    nrows: int,
    ncols: int,
    *,
    stage_capacity: int,
    tile_capacity: int,
    dedup_sr: Semiring | None = None,
) -> tuple[SpParMat, torch.Tensor]:
    """Route tile-resident global tuples to their owner tiles.

    rows/cols/vals: ``[pr, pc, chunk]``, each tile's chunk of GLOBAL
    tuples (invalid slots: row >= nrows). Returns (SpParMat with
    ``tile_capacity`` slots a tile, total dropped tuple count as a 0-dim
    int32 tensor on the grid's device). With ``dedup_sr`` each tile's
    duplicates combine (``SpTuples.compact``) and the tile-overflow term
    counts DISTINCT keys, so a zero count always means a complete matrix.
    """
    lr, lc = grid.local_rows(nrows), grid.local_cols(ncols)
    pr_, pc_ = grid.pr, grid.pc
    cap = stage_capacity
    # hop 1: by owner column along each grid row; tile (i, j') receives the
    # j'-bucket of every (i, j), in order of j
    oj = torch.where(rows < nrows, torch.div(cols, lc, rounding_mode="floor"), pc_)
    br, bc, bv, drop1 = _route_tiles(oj, rows, cols, vals, pc_, cap, nrows, ncols)
    r1, c1, v1 = (x.transpose(1, 2).reshape(pr_, pc_, pc_ * cap) for x in (br, bc, bv))
    del br, bc, bv
    # hop 2: by owner row along each grid column; tile (i', j) receives the
    # i'-bucket of every (i, j), in order of i
    oi = torch.where(r1 < nrows, torch.div(r1, lr, rounding_mode="floor"), pr_)
    br, bc, bv, drop2 = _route_tiles(oi, r1, c1, v1, pr_, cap, nrows, ncols)
    del r1, c1, v1
    r2, c2, v2 = (x.permute(2, 1, 0, 3).reshape(pr_, pc_, pr_ * cap) for x in (br, bc, bv))
    del br, bc, bv
    drop3 = torch.zeros((), dtype=torch.int64, device=rows.device)

    def tile(i: int, j: int) -> SpTuples:
        nonlocal drop3
        r, c, v = r2[i, j], c2[i, j], v2[i, j]
        ok = r < nrows
        t = SpTuples(
            rows=torch.where(ok, r - i * lr, lr).to(torch.int32),
            cols=torch.where(ok, c - j * lc, lc).to(torch.int32),
            vals=torch.where(ok, v, 0).to(v.dtype),
            nnz=ok.sum().to(torch.int32), nrows=lr, ncols=lc,
        )
        if dedup_sr is not None:
            t, distinct = t.sort_rowmajor().compact_counted(
                dedup_sr, capacity=tile_capacity, assume_sorted=True)
            drop3 = drop3 + torch.clamp(distinct - tile_capacity, min=0)
            return t
        drop3 = drop3 + torch.clamp(t.nnz - tile_capacity, min=0)
        return t._select(ok).with_capacity(tile_capacity)

    mat = SpParMat.assemble(grid, nrows, ncols, tile)
    return mat, (drop1 + drop2 + drop3).to(torch.int32)


def from_device_coo(
    grid: Grid,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    nrows: int,
    ncols: int,
    *,
    slack: float = 2.0,
    max_retries: int = 3,
    dedup_sr: Semiring | None = None,
    defer_drop_check: bool = False,
):
    """``redistribute_coo`` at capacities sized from the chunk shape (powers
    of two: a stage bucket ``slack`` times the larger hop's balanced load, a
    tile ``slack`` times the chunk), and on drops a retry with both doubled,
    raising after ``max_retries`` doublings.

    ``defer_drop_check=True`` makes no retry and reads nothing back: it
    returns ``(mat, dropped)`` with the drop count as a device tensor, for
    timed pipelines that check ``int(dropped) == 0`` after their timed
    section."""
    chunk = rows.shape[-1]
    per_dest1 = -(-chunk // grid.pc)
    per_dest2 = -(-chunk // grid.pr)
    stage_cap = 1 << max(int(np.ceil(np.log2(max(max(per_dest1, per_dest2) * slack, 1)))), 0)
    tile_cap = 1 << max(int(np.ceil(np.log2(max(chunk * slack, 1)))), 0)
    if defer_drop_check:
        if obs.ENABLED:
            obs.gauge("redistribute.stage_capacity", stage_cap)
            obs.gauge("redistribute.tile_capacity", tile_cap)
        return redistribute_coo(grid, rows, cols, vals, nrows, ncols, stage_capacity=stage_cap,
                                tile_capacity=tile_cap, dedup_sr=dedup_sr)
    nd = 0
    with obs.span("redistribute", chunk=int(chunk)):
        for attempt in range(max_retries + 1):
            mat, dropped = redistribute_coo(grid, rows, cols, vals, nrows, ncols,
                                            stage_capacity=stage_cap, tile_capacity=tile_cap,
                                            dedup_sr=dedup_sr)
            nd = int(dropped)
            if obs.ENABLED:
                # the actual drop count per attempt — zero on success, so
                # the counter reads as total tuples ever bounced
                obs.count("redistribute.dropped", nd)
                obs.span_event("route", attempt=attempt, dropped=nd,
                               stage_capacity=stage_cap, tile_capacity=tile_cap)
            if nd == 0:
                return mat
            if obs.ENABLED:
                obs.count("redistribute.retries")
            stage_cap *= 2
            tile_cap *= 2
    raise ValueError(
        f"redistribute still dropped {nd} tuples after {max_retries} "
        "capacity doublings; call redistribute_coo with explicit capacities"
    )
