"""Maximal independent set — counterpart of ``combblas_tpu/models/mis.py``:
Luby's algorithm (≈ ``FilteredMIS.cpp``).

Priorities are a random permutation of the padded vertex ids (unique, so
no ties). Each round, an undecided vertex whose priority is below every
undecided neighbour's (one ``SELECT2ND_MIN`` SpMV) joins the set, and the
undecided neighbours of the new members (one ``SELECT2ND_MAX`` SpMV over
the candidate indicator) leave it. The reference runs the rounds as one
device program; here they are a host loop that reads back one flag a
round.

``mis`` draws the priorities from a ``torch.Generator`` where the reference
draws them from a JAX key, so its set is another one; ``_mis_rounds``
takes the priorities, and given the reference's, gives its set and round
count bit for bit.
"""

from __future__ import annotations

import torch

from ..parallel.spmv import dist_spmv
from ..parallel.vec import DistVec
from ..semiring import SELECT2ND_MAX, SELECT2ND_MIN

UNDECIDED, IN_SET, EXCLUDED = 0, 1, -1


def mis(A, generator: torch.Generator | None = None):
    """A maximal independent set of the symmetric loop-free matrix A:
    ``(status, num_iters)``, a row-aligned int32 DistVec (1 in the set, -1
    excluded, padding -1) and the rounds run. ``generator`` draws the
    priorities on its own device; when None, the default generator of the
    grid's device draws them there."""
    gids = DistVec.iota(A.grid, A.nrows, torch.int32, align="row").blocks
    dev = generator.device if generator is not None else gids.device
    prio = torch.randperm(gids.numel(), generator=generator, device=dev)
    return _mis_rounds(A, prio.to(device=gids.device, dtype=torch.int32).view(gids.shape))


def _mis_rounds(A, prio: torch.Tensor):
    """Luby's rounds for the priorities ``prio`` (int32, row-aligned
    ``[pr, lr]``, a permutation of the padded ids). ``mis.last_run`` holds
    the readbacks (one a round)."""
    grid = A.grid
    n = A.nrows
    gids = DistVec.iota(grid, n, torch.int32, align="row").blocks
    status = torch.where(gids < n, UNDECIDED, EXCLUDED).to(torch.int32)
    big = SELECT2ND_MIN.zero(torch.int32)

    def mk(b):
        return DistVec(blocks=b, length=n, align="row", grid=grid)

    it = 0
    while it < n and bool((status == UNDECIDED).any()):
        undecided = status == UNDECIDED
        nbr_min = dist_spmv(SELECT2ND_MIN, A, mk(torch.where(undecided, prio, big)).realign("col"))
        cand = undecided & (prio < nbr_min.blocks)
        ci = mk(torch.where(cand, 1, -1).to(torch.int32)).realign("col")
        nbr_cand = dist_spmv(SELECT2ND_MAX, A, ci)
        status = torch.where(cand, IN_SET, status)
        status = torch.where((status == UNDECIDED) & (nbr_cand.blocks == 1), EXCLUDED, status)
        it += 1
    mis.last_run = {"readbacks": it + 1 if it < n else it}
    return mk(status), it


# the last call's device -> host readbacks (one a round, and the one that
# ends the loop)
mis.last_run = None
