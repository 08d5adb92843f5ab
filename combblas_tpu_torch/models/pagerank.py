"""PageRank — counterpart of ``combblas_tpu/models/pagerank.py``: power
iteration with teleport (≈ ``PageRank.cpp``).

``pagerank``: out-degrees by ``reduce``, the column-stochastic matrix by
``apply`` and ``dim_apply``, then one ``dist_spmv`` over ``PLUS_TIMES`` a
round with the dangling columns' mass spread uniformly, until the L1
change is at most ``tol``. ``pagerank_batch``: W personalised chains at
once over a column-normalised ``EllParMat``, one ``dist_spmv_ell_multi`` a
round. The reference runs each loop as one device program; here it is a
host loop that reads back the convergence test once a round. Iteration
counts come back as Python ints.

Sums of floats are taken in another order than the reference's, so ranks
agree with it to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from ..parallel.ellmat import EllParMat, dist_spmv_ell_multi
from ..parallel.spmat import SpParMat, ones_f32
from ..parallel.spmv import dist_spmv
from ..parallel.vec import DistMultiVec, DistVec
from ..semiring import PLUS_TIMES
from . import PAD_ROOT


def _scale(a, s):
    return a * s


def pagerank(A: SpParMat, alpha: float = 0.85, tol: float = 1e-6, max_iters: int = 100):
    """Ranks over the column-stochastic normalisation of A (entry (i, j):
    j links to i): ``(ranks, num_iters)``, a row-aligned float32 DistVec
    summing to 1 and the rounds run. ``pagerank.last_run`` holds the
    readbacks (one a round)."""
    grid = A.grid
    n = A.nrows
    outdeg = A.reduce(PLUS_TIMES, axis="rows", map_fn=ones_f32)  # entries per column
    inv_deg = outdeg.apply(lambda d: torch.where(d > 0, 1.0 / torch.clamp(d, min=1.0), 0.0))
    P = A.apply(ones_f32).dim_apply(inv_deg, _scale, axis="cols")
    col_gids = DistVec.iota(grid, n, torch.int32, align="col").blocks
    dang_mask = torch.where(col_gids < n, (outdeg.blocks == 0).to(torch.float32), 0.0)
    row_valid = DistVec.iota(grid, n, torch.int32, align="row").blocks < n
    x = torch.where(row_valid, 1.0 / n, 0.0).to(torch.float32)

    it, going = 0, True
    while going and it < max_iters:
        x_col = DistVec(blocks=x, length=n, align="row", grid=grid).realign("col")
        spread = dist_spmv(PLUS_TIMES, P, x_col).blocks
        dmass = (dang_mask * x_col.blocks).sum()
        base = (1.0 - alpha) / n + alpha * dmass / n
        nxt = torch.where(row_valid, alpha * spread + base, 0.0)
        going = bool((nxt - x).abs().sum() > tol)  # in float32, as the reference tests
        x = nxt
        it += 1
    pagerank.last_run = {"readbacks": it}
    return DistVec(blocks=x, length=n, align="row", grid=grid), it


# the last call's device -> host readbacks (one a round)
pagerank.last_run = None


def pagerank_batch(P_ell: EllParMat, sources, dangling: DistVec, alpha: float = 0.85,
                   tol: float = 1e-6, max_iters: int = 100):
    """Personalised PageRank for W sources at once.

    ``P_ell``: the column-normalised transition matrix (entry (i, j) =
    1/outdeg(j) for an edge j → i). ``sources``: [W] vertex ids; a
    ``PAD_ROOT`` lane is all zeros. ``dangling``: 1.0 at the columns
    without an out-edge. Returns ``(ranks, num_iters)``: a row-aligned
    DistMultiVec ``[n, W]`` (each live lane sums to 1 and teleports to its
    source) and the rounds run, until the largest lane's L1 change is at
    most ``tol``. ``pagerank_batch.last_run`` holds the readbacks.
    """
    grid = P_ell.grid
    n = P_ell.nrows
    row_gids = DistVec.iota(grid, n, torch.int32, align="row").blocks[:, :, None]
    src = torch.as_tensor(sources).to(device=grid.device, dtype=torch.int32)[None, None, :]
    e_s = ((row_gids == src) & (src != PAD_ROOT)).to(torch.float32)
    dang_row = dangling.realign("row").blocks[:, :, None]
    row_valid = row_gids < n

    x = e_s
    it, going = 0, True
    while going and it < max_iters:
        spread = dist_spmv_ell_multi(
            PLUS_TIMES, P_ell, DistMultiVec(blocks=x, length=n, align="row", grid=grid)).blocks
        dmass = (dang_row * x).sum(dim=(0, 1))  # [W]: each lane's dangling mass
        nxt = alpha * (spread + dmass * e_s) + (1.0 - alpha) * e_s
        nxt = torch.where(row_valid, nxt, 0.0)
        going = bool((nxt - x).abs().sum(dim=(0, 1)).max() > tol)
        x = nxt
        it += 1
    pagerank_batch.last_run = {"readbacks": it}
    return DistMultiVec(blocks=x, length=n, align="row", grid=grid), it


# the last call's device -> host readbacks (one a round)
pagerank_batch.last_run = None
