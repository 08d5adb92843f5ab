"""Carry matrices, vectors and random keys over from the JAX package.

The port imports nothing of ``combblas_tpu``; the caller hands over the
reference object's arrays as numpy (``np.asarray(A.rows)``, ...), and a
key as its data (``np.asarray(jax.random.key_data(k))``).
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.dense import DenseParMat
from .parallel.ellmat import EllParMat, upload_csc_companion
from .parallel.grid import Grid
from .parallel.spmat import SpParMat
from .parallel.vec import DistMultiVec
from .utils.threefry import ThreefryKey


def spparmat_from_arrays(
    grid: Grid, rows, cols, vals, nnz, nrows: int, ncols: int
) -> SpParMat:
    """The port's ``SpParMat`` on ``grid.device`` from the reference's
    ``[pr, pc, cap]`` tile arrays and ``[pr, pc]`` counts."""
    rows, cols, vals, nnz = (np.asarray(x) for x in (rows, cols, vals, nnz))
    tiles = (grid.pr, grid.pc)
    if rows.shape[:2] != tiles or nnz.shape != tiles:
        raise ValueError(f"arrays are not laid out on a {grid.pr}x{grid.pc} grid")
    if not rows.shape == cols.shape == vals.shape:
        raise ValueError(f"tile arrays differ: {rows.shape}, {cols.shape}, {vals.shape}")
    dev = grid.device
    return SpParMat(
        rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
        cols=torch.from_numpy(cols.astype(np.int32)).to(dev),
        vals=torch.from_numpy(np.array(vals)).to(dev),  # a writable copy
        nnz=torch.from_numpy(nnz.astype(np.int32)).to(dev),
        nrows=int(nrows),
        ncols=int(ncols),
        grid=grid,
    )


def _on_grid(grid: Grid, name: str, x, ndim: int) -> np.ndarray:
    x = np.asarray(x)
    if x.ndim != ndim or x.shape[:2] != (grid.pr, grid.pc):
        raise ValueError(f"{name} {x.shape} is not laid out on a {grid.pr}x{grid.pc} grid")
    return x


def ellparmat_from_arrays(grid: Grid, buckets, nrows: int, ncols: int) -> EllParMat:
    """The port's ``EllParMat`` from the reference's buckets: a sequence of
    (cols ``[pr, pc, nb, kb]``, vals ``[pr, pc, nb, kb]``, rowids
    ``[pr, pc, nb]``)."""
    host = []
    for b, (bc, bv, br) in enumerate(buckets):
        bc = _on_grid(grid, f"bucket {b} cols", bc, 4)
        bv = _on_grid(grid, f"bucket {b} vals", bv, 4)
        br = _on_grid(grid, f"bucket {b} rowids", br, 3)
        if bc.shape != bv.shape or bc.shape[:3] != br.shape:
            raise ValueError(f"bucket {b} arrays differ: {bc.shape}, {bv.shape}, {br.shape}")
        host.append((bc.astype(np.int32), np.array(bv), br.astype(np.int32)))
    return EllParMat.from_host_buckets(grid, host, nrows, ncols)


def csc_companion_from_arrays(grid: Grid, indptr, rowidx):
    """The reference's CSC (or CSR) companion arrays ``[pr, pc, l+1]`` and
    ``[pr, pc, cap]`` as int32 tensors on ``grid.device``."""
    indptr = _on_grid(grid, "indptr", indptr, 3).astype(np.int32)
    rowidx = _on_grid(grid, "rowidx", rowidx, 3).astype(np.int32)
    return upload_csc_companion(grid, indptr, rowidx)


def distmultivec_from_arrays(grid: Grid, blocks, length: int, align: str) -> DistMultiVec:
    """The port's ``DistMultiVec`` from the reference's ``[pa, L, W]``
    blocks."""
    blocks = np.asarray(blocks)
    pa = grid.pr if align == "row" else grid.pc
    if blocks.ndim != 3 or blocks.shape[0] != pa or blocks.shape[1] != -(-length // pa):
        raise ValueError(f"blocks {blocks.shape} do not hold {length} {align}-aligned rows")
    return DistMultiVec(
        blocks=torch.from_numpy(np.array(blocks)).to(grid.device),  # a writable copy
        length=int(length), align=align, grid=grid,
    )


def denseparmat_from_arrays(grid: Grid, blocks, nrows: int, ncols: int) -> DenseParMat:
    """The port's ``DenseParMat`` from the reference's ``[pr, pc, lr, lc]``
    blocks."""
    blocks = _on_grid(grid, "blocks", blocks, 4)
    if blocks.shape[2:] != (grid.local_rows(nrows), grid.local_cols(ncols)):
        raise ValueError(f"blocks {blocks.shape} do not hold a {nrows}x{ncols} matrix")
    return DenseParMat(blocks=torch.from_numpy(np.array(blocks)).to(grid.device),
                       nrows=int(nrows), ncols=int(ncols), grid=grid)


def key_from_jax(key_data) -> ThreefryKey:
    """The port's threefry key from the ``uint32[2]`` data of a JAX key
    (``jax.random.key_data(k)``, or a raw ``PRNGKey``): both packages then
    draw the same stream."""
    data = np.asarray(key_data)
    if data.shape != (2,) or data.dtype != np.uint32:
        raise ValueError(f"a threefry key is uint32[2], got {data.dtype}{list(data.shape)}")
    return ThreefryKey(int(data[0]), int(data[1]))
