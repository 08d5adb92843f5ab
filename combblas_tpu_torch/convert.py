"""Carry a matrix over from the JAX package.

The port imports nothing of ``combblas_tpu``; the caller hands over the
reference ``SpParMat``'s arrays as numpy (``np.asarray(A.rows)``, ...).
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.grid import Grid
from .parallel.spmat import SpParMat


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
