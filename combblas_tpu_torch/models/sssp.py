"""Single-source shortest paths — counterpart of
``combblas_tpu/models/sssp.py``: Bellman-Ford over MIN_PLUS (≈
``SSSP.cpp``). ``sssp`` relaxes every edge a round with one ``dist_spmv``;
``sssp_batch`` runs W sources at once, one ``dist_spmv_ell_multi`` a round.

The reference runs each loop as one device program (``lax.while_loop``);
here it is a host loop that reads back one flag a round (did any distance
improve). Round counts come back as Python ints (the reference's are int32
arrays; the values are equal).
"""

from __future__ import annotations

import torch

from ..operations import minimum
from ..parallel.ellmat import EllParMat, dist_spmv_ell_multi
from ..parallel.grid import require_local
from ..parallel.spmv import dist_spmv
from ..parallel.vec import DistMultiVec, DistVec
from ..semiring import MIN_PLUS
from . import PAD_ROOT


def sssp(A, source):
    """Distances from ``source`` over a weighted matrix (entry (i, j) = w(j
    → i), non-negative): ``(dist, num_iters)``, a row-aligned DistVec of
    A's dtype (``+inf``, the integer maximum for integer weights, where
    unreachable; MIN_PLUS's ``+`` saturates there) and the number of
    rounds as an int, at most n. ``sssp.last_run`` holds the readbacks
    (one a round)."""
    require_local(A.grid, "sssp", 1)
    grid = A.grid
    n = A.nrows
    gids = DistVec.iota(grid, n, torch.int32, align="row").blocks
    d = torch.full(gids.shape, MIN_PLUS.zero(A.dtype), dtype=A.dtype,
                   device=grid.device).masked_fill(gids == int(source), 0)
    it, changed = 0, True
    while changed and it < n:
        relaxed = dist_spmv(MIN_PLUS, A, DistVec(blocks=d, length=n, align="row",
                                                 grid=grid).realign("col")).blocks
        nxt = minimum(d, relaxed)
        changed = bool((nxt != d).any())
        d = nxt
        it += 1
    sssp.last_run = {"readbacks": it}
    return DistVec(blocks=d, length=n, align="row", grid=grid), it


# the last call's device -> host readbacks (one a round)
sssp.last_run = None


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
