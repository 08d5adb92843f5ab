"""Batched single-source shortest paths — counterpart of ``sssp_batch`` in
``combblas_tpu/models/sssp.py``: Bellman-Ford over MIN_PLUS from W sources
at once, one ``dist_spmv_ell_multi`` an iteration.

The reference runs the loop as one device program (``lax.while_loop``);
here it is a host loop that reads back one flag an iteration (did any
distance improve). The single-source ``sssp`` runs on a ``SpParMat`` SpMV,
which is not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import torch

from ..operations import minimum
from ..parallel.ellmat import EllParMat, dist_spmv_ell_multi
from ..parallel.vec import DistMultiVec, DistVec
from ..semiring import MIN_PLUS
from . import PAD_ROOT


def sssp_batch(E: EllParMat, sources):
    """Distances from W sources over a weighted ``EllParMat`` (entry
    (i, j) = w(j → i), non-negative).

    ``sources``: [W] vertex ids; a ``PAD_ROOT`` lane is all ``+inf``.
    Returns ``(dist, num_iters)``: a row-aligned DistMultiVec ``[n, W]`` of
    E's dtype (``+inf``, the integer maximum for integer weights, where
    unreachable) and the number of relaxation rounds as an int (the
    reference returns an int32 array), at most n. ``sssp_batch.last_run``
    holds the readbacks (one a round).
    """
    grid = E.grid
    n = E.nrows
    inf = MIN_PLUS.zero(E.dtype)
    gids = DistVec.iota(grid, n, torch.int32, align="row").blocks[:, :, None]  # [pr, lr, 1]
    src = torch.as_tensor(sources).to(device=grid.device, dtype=torch.int32)[None, None, :]
    at_src = (gids == src) & (src != PAD_ROOT)
    d = torch.full(at_src.shape, inf, dtype=E.dtype, device=grid.device).masked_fill(at_src, 0)

    it, changed = 0, True
    while changed and it < n:
        relaxed = dist_spmv_ell_multi(
            MIN_PLUS, E, DistMultiVec(blocks=d, length=n, align="row", grid=grid)).blocks
        nxt = minimum(d, relaxed)
        changed = bool((nxt != d).any())
        d = nxt
        it += 1
    sssp_batch.last_run = {"readbacks": it}
    return DistMultiVec(blocks=d, length=n, align="row", grid=grid), it


# the last call's device -> host readbacks (one a round)
sssp_batch.last_run = None
