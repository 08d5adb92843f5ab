"""Fill- and bandwidth-reducing orderings — counterpart of
``combblas_tpu/models/ordering.py`` (≈ ``Applications/Ordering/``).

RCM (``RCM.cpp:61-160``): BFS levels from a pseudo-peripheral vertex,
vertices ordered by (level, degree, id) and reversed. The reference sorts
with one multi-key ``lax.sort``; here the same order comes from stable
sorts, least significant key first (a fused int64 key would need 1 + 3 ×
21 bits at scale 20). Minimum degree (``MD.cpp``): the reference's
prototype, one elimination a host step. Every value is an integer, so
results equal the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.grid import require_local
from ..parallel.indexing import col_selector
from ..parallel.spgemm import spgemm
from ..parallel.spmat import SpParMat, ones_f32, ones_i32
from ..parallel.vec import DistVec, _lexsort
from ..semiring import PLUS_TIMES
from .bfs import bfs


def pseudo_peripheral_vertex(A: SpParMat, max_probes: int = 6) -> int:
    """George-Liu probe: start at a least-degree vertex, BFS, and jump to a
    least-degree vertex of the last level until the eccentricity stops
    growing (``RCM.cpp``'s FindPeripheral loop). Ties go to the least id
    (numpy ``argmin``)."""
    require_local(A.grid, "pseudo_peripheral_vertex", 4)
    deg = np.asarray(A.reduce(PLUS_TIMES, "rows", map_fn=ones_i32).to_global())
    # least degree among the non-isolated vertices (isolated ones order last)
    noniso = np.nonzero(deg > 0)[0]
    if len(noniso) == 0:
        return 0
    root = int(noniso[np.argmin(deg[noniso])])
    best_ecc = -1
    for _ in range(max_probes):
        _, levels, _ = bfs(A, root)
        lv = np.asarray(levels.to_global())
        ecc = int(lv.max())
        if ecc <= best_ecc:
            break
        best_ecc = ecc
        last = np.nonzero(lv == ecc)[0]
        root = int(last[np.argmin(deg[last])])
    return root


def _rcm_sort(levels_blocks: torch.Tensor, deg_blocks: torch.Tensor, length: int) -> torch.Tensor:
    """The permutation sorting the slots by (padding, level, degree, id)
    ascending, its first ``length`` (the real slots) reversed. Unreachable
    vertices (level -1) sort after every level, so they lead the reversed
    order."""
    flat_lv = levels_blocks.reshape(-1)
    flat_dg = deg_blocks.reshape(-1)
    gids = torch.arange(flat_lv.shape[0], dtype=torch.int32, device=flat_lv.device)
    pad = (gids >= length).to(torch.int32)
    lv = torch.where(flat_lv < 0, length, flat_lv)
    perm = _lexsort([pad, lv, flat_dg]).to(torch.int32)  # ties: slot (id) order
    return torch.cat([perm[:length].flip(0), perm[length:]])


def rcm_ordering(A: SpParMat, root: int | None = None) -> DistVec:
    """RCM permutation: ``perm[k]`` is the old vertex id placed at new
    position k (row-aligned; apply with ``indexing.subsref(A, p, p)``).
    Without ``root``, the pseudo-peripheral probe picks it."""
    require_local(A.grid, "rcm_ordering", 4)
    grid = A.grid
    n = A.nrows
    if root is None:
        root = pseudo_peripheral_vertex(A)
    _, levels, _ = bfs(A, root)
    deg = A.reduce(PLUS_TIMES, "rows", map_fn=ones_i32).realign("row")
    perm_flat = _rcm_sort(levels.blocks, deg.blocks, n)  # all pa * L slots
    pa, L = levels.blocks.shape
    return DistVec(blocks=perm_flat.reshape(pa, L), length=n, align="row", grid=grid)


def bandwidth(dense) -> int:
    """Host helper: max |i - j| over the nonzeros (RCM's quality metric)."""
    r, c = np.nonzero(np.asarray(dense))
    return int(np.abs(r - c).max()) if len(r) else 0


def minimum_degree_ordering(A: SpParMat, max_steps: int | None = None) -> DistVec:
    """Minimum-degree elimination ordering, the reference's prototype (as
    ``MD.cpp`` is): each step picks the least-degree live vertex v (least
    id on ties), joins its live neighbours into a clique (the structural
    outer product by ``spgemm``, added with ``ewise_add``) and masks v out.
    O(n) host steps, each with readbacks: for small graphs."""
    require_local(A.grid, "minimum_degree_ordering", 4)
    n = A.nrows
    grid = A.grid
    work = A.apply(ones_f32).remove_loops()
    alive = np.ones(n, bool)
    order = []
    steps = max_steps if max_steps is not None else n
    imax = np.iinfo(np.int32).max
    for _ in range(min(n, steps)):
        degv = work.reduce(PLUS_TIMES, "rows", map_fn=ones_i32).to_global()
        degv = np.where(alive, degv, imax)
        v = int(np.argmin(degv))
        if not alive[v]:
            break
        order.append(v)
        alive[v] = False
        nbrs = None
        if 0 < degv[v] < imax:
            # v's neighbourhood as a column selection
            sel = col_selector(grid, [v], n, torch.float32)  # n×1 at (·, v)
            col_v = spgemm(PLUS_TIMES, work, sel)
            nbr_mask = col_v.to_dense()[:, 0] > 0
            nbr_mask[v] = False
            nbrs = np.nonzero(nbr_mask & alive)[0]
        if nbrs is not None and len(nbrs) > 1:
            e = np.ones(len(nbrs), np.float32)
            u = SpParMat.from_global_coo(grid, nbrs, np.zeros(len(nbrs), np.int64), e, n, 1)
            ut = SpParMat.from_global_coo(grid, np.zeros(len(nbrs), np.int64), nbrs, e, 1, n)
            clique = spgemm(PLUS_TIMES, u, ut).remove_loops()
            # shrink after the union: ewise_add sums the capacities
            work = work.ewise_add(clique, PLUS_TIMES).apply(_clamp01).shrink_to_fit()
        rmask = DistVec.from_global(grid, alive, align="row", fill=False)
        cmask = DistVec.from_global(grid, alive, align="col", fill=False)
        work = work.prune_rowcol(rmask, cmask, _keep_both_alive)
    order.extend(np.nonzero(alive)[0].tolist())  # isolated leftovers
    return DistVec.from_global(grid, np.asarray(order, np.int32), align="row", fill=n)


def _clamp01(v):
    return torch.clamp(v, max=1.0)


def _keep_both_alive(v, r_alive, c_alive):
    return r_alive & c_alive
