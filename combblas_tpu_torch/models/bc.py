"""Betweenness centrality, batched Brandes — counterpart of
``combblas_tpu/models/bc.py`` (≈ Applications/BetwCent.cpp).

``bc_batch`` runs the reference's form: the frontier of W sources is a
sparse n × W matrix, each forward level one SpGEMM (``spgemm``), path
counts accumulate in a ``DenseParMat``, and the backward sweep re-walks the
stored levels. Orientation: A[i, j] != 0 is the edge j -> i, so path
counts pull from predecessors through A and dependencies from successors
through Aᵀ. ``bc_batch_dense`` keeps levels and path counts as dense
``[n, W]`` lanes and takes each step with one multi-lane ELL SpMV
(``dist_spmv_ell_multi``); the reference runs it as one program, the port
as host loops with one readback a forward level. ``last_run`` of each
records its readbacks and levels (``bc_batch``: each product's
capacities, from ``spgemm.last_capacities``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.dense import DenseParMat
from ..parallel.ellmat import dist_spmv_ell_multi
from ..parallel.grid import Grid, require_local
from ..parallel.spgemm import spgemm
from ..parallel.spmat import SpParMat
from ..parallel.vec import DistMultiVec, DistVec
from ..semiring import PLUS_TIMES
from . import PAD_ROOT


def _keep_unsettled(sval, nsp_val):
    return nsp_val == 0


def _replace_with_dense(sval, dval):
    return dval


def _mul_combine(a, b):
    return a * b


def _one_plus_a_over_b(delta_b, nsp_b):
    return torch.where(nsp_b > 0, (1.0 + delta_b) / torch.clamp(nsp_b, min=1e-30), 0.0)


def _sources_fringe(grid: Grid, sources, n: int, dtype: torch.dtype) -> SpParMat:
    """The n × W selector: column k holds one path at ``sources[k]``."""
    sources = np.asarray(sources, dtype=np.int64)
    ones = torch.ones(len(sources), dtype=dtype).numpy()
    return SpParMat.from_global_coo(grid, sources, np.arange(len(sources)), ones, n,
                                    len(sources))


def _product(A: SpParMat, X: SpParMat, caps: list) -> SpParMat:
    C = spgemm(PLUS_TIMES, A, X)
    caps.append(spgemm.last_capacities)
    return C


def bc_batch(A: SpParMat, sources, AT: SpParMat | None = None) -> DistVec:
    """Partial BC scores from one batch of sources: a row-aligned vector of
    dependency sums, endpoints excluded as Brandes does. ``AT``: Aᵀ, when
    the caller already has it. The forward loop reads the fringe's entry
    count back once a level (``last_run["readbacks"]``)."""
    require_local(A.grid, "bc_batch", 4)
    grid, n = A.grid, A.nrows
    if AT is None:
        AT = A.transpose()
    W = len(np.asarray(sources))
    fringe = _sources_fringe(grid, sources, n, A.dtype)
    nsp = DenseParMat.zeros(grid, n, W, A.dtype).add_spmat(fringe)
    levels, forward, backward = [fringe], [], []
    readbacks = 0
    while True:
        fringe = nsp.filter_spmat(_product(A, fringe, forward), _keep_unsettled)
        readbacks += 1
        if int(fringe.getnnz()) == 0:
            break
        nsp = nsp.add_spmat(fringe)
        levels.append(fringe)
    delta = DenseParMat.zeros(grid, n, W, A.dtype)
    # delta[v] = Σ_{succ w} (nsp[v] / nsp[w]) (1 + delta[w]): level d exports
    # (1 + delta) / nsp, Aᵀ carries it to level d - 1, whose fringe values
    # are nsp[v]
    for d in range(len(levels) - 1, 0, -1):
        w = delta.ewise(nsp, _one_plus_a_over_b).scale_spmat(levels[d], _replace_with_dense)
        upd = _product(AT, w, backward).ewise_mult(levels[d - 1], combine=_mul_combine)
        delta = delta.add_spmat(upd)
    total = delta.reduce(PLUS_TIMES, "cols")
    # a source's own dependency is not counted (Brandes sums w != s)
    correction = delta.scale_spmat(levels[0], _replace_with_dense).reduce(PLUS_TIMES, "cols")
    bc_batch.last_run = {"readbacks": readbacks, "levels": len(levels),
                         "forward_capacities": forward, "backward_capacities": backward}
    return total.ewise(correction, torch.subtract)


bc_batch.last_run = None


def betweenness_centrality(A: SpParMat, batch_size: int | None = None, sources=None,
                           normalize: bool = False) -> DistVec:
    """Exact (all sources) or sampled BC: ``sources`` (default: every
    vertex) in batches of ``batch_size`` (default: one batch). An
    undirected graph counts every pair twice; ``normalize=True`` halves."""
    require_local(A.grid, "betweenness_centrality", 4)
    n = A.nrows
    srcs = np.arange(n) if sources is None else np.asarray(sources)
    if len(srcs) == 0:
        return DistVec.full(A.grid, n, 0, A.dtype, align="row")
    bs = batch_size or len(srcs)
    AT = A.transpose()
    acc = None
    for s in range(0, len(srcs), bs):
        part = bc_batch(A, srcs[s:s + bs], AT=AT)
        acc = part if acc is None else acc.ewise(part, torch.add)
    if normalize:
        acc = acc.apply(lambda b: b * 0.5)
    return acc


def bc_batch_dense(E, ET, sources, max_depth: int | None = None) -> DistVec:
    """Partial BC of ``sources`` over dense ``[n, W]`` lanes (see
    ``_bc_batch_dense_impl``): a row-aligned vector."""
    total = _bc_batch_dense_impl(E, ET, sources, max_depth=max_depth)
    bc_batch_dense.last_run = _bc_batch_dense_impl.last_run
    return DistVec(blocks=total, length=E.nrows, align="row", grid=E.grid)


bc_batch_dense.last_run = None


def bc_batch_dense_lanes(E, ET, sources, max_depth: int | None = None) -> DistMultiVec:
    """Per-lane Brandes dependencies, ``[n, W]`` before the sum over lanes:
    lane k is the dependency vector of ``sources[k]``; ``PAD_ROOT`` lanes
    are zero. The lanes sum to ``bc_batch_dense``."""
    delta = _bc_batch_dense_impl(E, ET, sources, max_depth=max_depth, per_lane=True)
    bc_batch_dense_lanes.last_run = _bc_batch_dense_impl.last_run
    return DistMultiVec(blocks=delta, length=E.nrows, align="row", grid=E.grid)


bc_batch_dense_lanes.last_run = None


def _bc_batch_dense_impl(E, ET, sources, max_depth: int | None = None,
                         per_lane: bool = False) -> torch.Tensor:
    """Batched Brandes over dense ``[pr, lr, W]`` lanes. ``E``: adjacency
    with entry (i, j) the edge j -> i; ``ET``: its transpose (the same
    matrix for a symmetric graph). The forward sweep steps while a level
    found a vertex and fewer than ``max_depth`` (default n) levels ran, one
    readback a level; the backward sweep runs from the deepest level that
    holds vertices (the last one too where ``max_depth`` cut the forward
    sweep) down to level 1. Returns the summed row-aligned blocks, or the
    lanes with ``per_lane``."""
    grid, n = E.grid, E.nrows
    sources = torch.as_tensor(np.asarray(sources), dtype=torch.int32).to(grid.device)
    depth_max = max_depth if max_depth is not None else n
    gids = DistVec.iota(grid, n, torch.int32, align="row").blocks
    is_src = (gids[..., None] == sources[None, None, :]) & (sources != PAD_ROOT)[None, None, :]
    lvl = torch.where(is_src, 0, -1).to(torch.int32)
    nsp = is_src.to(E.dtype)

    def mk(blocks):
        return DistMultiVec(blocks=blocks, length=n, align="row", grid=grid)

    depth, active = 0, True
    while active and depth < depth_max:
        frontier = torch.where(lvl == depth, nsp, 0)
        arriving = dist_spmv_ell_multi(PLUS_TIMES, E, mk(frontier)).blocks
        new = (arriving > 0) & (lvl < 0)
        lvl = torch.where(new, depth + 1, lvl)
        nsp = nsp + torch.where(new, arriving, 0)
        depth += 1
        active = bool(new.any())
    delta = torch.zeros_like(nsp)
    # on a natural exit level `depth` is empty: its step would add nothing
    for d in range(depth if active else depth - 1, 0, -1):
        w = torch.where((lvl == d) & (nsp > 0), (1.0 + delta) / torch.clamp(nsp, min=1e-30),
                        0).to(E.dtype)
        collected = dist_spmv_ell_multi(PLUS_TIMES, ET, mk(w)).blocks
        delta = delta + torch.where(lvl == d - 1, collected * nsp, 0)
    _bc_batch_dense_impl.last_run = {"readbacks": depth, "forward_steps": depth}
    delta = torch.where(is_src, 0, delta)
    return delta if per_lane else delta.sum(-1)


_bc_batch_dense_impl.last_run = None
