"""Graph500 kernel 1 on the device — counterpart of
``combblas_tpu/models/graph500.py``.

The reference's Graph500 driver builds the matrix distributed
(``TopDownBFS.cpp:270-370``, ``DistEdgeList::GenGraph500Data``,
``PermEdges`` / ``RenameVertices``, then the ``SpParMat`` Graph500
constructor ``SpParMat.cpp:3140-3441``). The stages here run as torch ops
on the grid's device:

  generate (threefry R-MAT, ``utils/rmat.py:rmat_edges``)
  → symmetrize + drop loops (mask arithmetic on the edge list)
  → route to owner tiles + dedup (``redistribute.from_device_coo``)
  → optional extra random relabel (``permute_vertices``)
  → isolated-vertex compression (non-isolated vertices renumbered into a
    dense prefix [0, nkeep); the matrix keeps its n)

Fed the same key, every stage gives the reference's arrays bit for bit.
Each stage runs in its ``k1.*`` span, and with telemetry on the stage
seconds land in the ``k1.<stage>_s`` histograms, as in the reference. Its
``BENCH_K1_LOG`` debug print is left out.
"""

from __future__ import annotations

import time

import torch

from .. import obs
from ..parallel.grid import Grid, require_local
from ..parallel.redistribute import from_device_coo
from ..parallel.spmat import SpParMat
from ..parallel.vec import DistVec
from ..semiring import PLUS_TIMES, SELECT2ND_MAX
from ..utils import threefry
from ..utils.rmat import rmat_edges


def permute_vertices(A: SpParMat, p: DistVec, *, slack: float = 2.0,
                     max_retries: int = 3) -> SpParMat:
    """Symmetric relabel: ``A'[p[i], p[j]] = A[i, j]`` for a permutation
    ``p`` of [0, nrows) of a square matrix. Each tile maps its tuples to
    permuted global coordinates through the row- and col-aligned blocks of
    ``p``, then ``from_device_coo`` routes them to their new owners (with
    its capacity-doubling retry). Reference: ``DistEdgeList::RenameVertices``
    / ``PermEdges``."""
    require_local(A.grid, "permute_vertices", 4)
    if A.nrows != A.ncols:
        raise ValueError("vertex permutation needs a square matrix")
    n = A.nrows
    lr, lc = A.local_rows, A.local_cols
    prow = p.realign("row").blocks  # [pr, lr] new id of each local row
    pcol = p.realign("col").blocks  # [pc, lc] new id of each local col
    sink = prow.new_full((prow.shape[0], 1), n)
    prow = torch.cat([prow, sink], 1)
    pcol = torch.cat([pcol, sink[:1].expand(pcol.shape[0], 1)], 1)
    valid = A.rows < lr
    gr = torch.gather(prow[:, None, :].expand(-1, A.grid.pc, -1), 2,
                      torch.clamp(A.rows, max=lr).long())
    gc = torch.gather(pcol[None, :, :].expand(A.grid.pr, -1, -1), 2,
                      torch.clamp(A.cols, max=lc).long())
    gr = torch.where(valid, gr, n).to(torch.int32)
    gc = torch.where(valid, gc, n).to(torch.int32)
    return from_device_coo(A.grid, gr, gc, A.vals, n, n, slack=slack,
                           max_retries=max_retries)


def isolated_compression_perm(A: SpParMat) -> tuple[DistVec, torch.Tensor]:
    """The permutation that renumbers the vertices of nonzero degree (the
    column counts; A is symmetric on the Graph500 path) into [0, nkeep) in
    their order, and the others into [nkeep, n) in theirs. Padding slots
    of the degree blocks count as isolated, as in the reference. Returns
    (p, nkeep): a col-aligned DistVec and a 0-dim int32 tensor."""
    require_local(A.grid, "isolated_compression_perm", 4)
    deg = A.nnz_per_column().blocks  # [pc, lc]
    has = (deg > 0).to(torch.int32)
    iso = 1 - has

    def ranks(m):
        # exclusive scan within each block plus the totals of the blocks before
        within = torch.cumsum(m, 1, dtype=torch.int32) - m
        totals = m.sum(1, dtype=torch.int32)
        before = torch.cumsum(totals, 0, dtype=torch.int32) - totals
        return within + before[:, None], totals.sum(dtype=torch.int32)

    keep_rank, nkeep = ranks(has)
    iso_rank, _ = ranks(iso)
    rank = torch.where(has == 1, keep_rank, nkeep + iso_rank).to(torch.int32)
    p = DistVec(blocks=rank, length=A.ncols, align="col", grid=A.grid)
    return p, nkeep


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel1_device(
    grid: Grid,
    scale: int,
    edgefactor: int,
    key: threefry.ThreefryKey,
    *,
    extra_relabel: bool = False,
    compress_isolated: bool = True,
    slack: float = 2.0,
):
    """Graph500 kernel 1 from device stages, on the grid's device.

    Returns ``(A, degrees, nkeep, timings)``: the symmetric deduplicated
    adjacency ``SpParMat`` (vertices of nonzero degree renumbered into a
    dense prefix when ``compress_isolated``), its row-aligned degree
    ``DistVec`` (entries a row, in the values' float32), the number of
    non-isolated vertices (0-dim int32 tensor; n without compression) and
    the stage seconds (host clock, the device synchronised after each
    stage: ``generate_s``, ``route_dedup_s``, ``relabel_s`` with
    ``extra_relabel``, ``compress_isolated_s`` with ``compress_isolated``,
    ``degree_s``) with ``dropped_dev``, the routing's drop count as a
    device tensor: the routing defers its check, and the caller must see
    it 0."""
    require_local(grid, "kernel1_device", 4)
    dev = grid.device
    timings: dict = {}
    n = 1 << scale
    ndev = grid.size

    t0 = time.perf_counter()
    with obs.span("k1.generate", scale=scale):
        src, dst = rmat_edges(key, scale, edgefactor * n, device=dev)
        rows = torch.cat([src, dst])
        cols = torch.cat([dst, src])
        del src, dst
        keep = rows != cols
        rows = torch.where(keep, rows, n).to(torch.int32)
        cols = torch.where(keep, cols, n).to(torch.int32)
        del keep
        total = rows.shape[0]
        chunk = -(-total // ndev)
        pad = chunk * ndev - total
        if pad:
            rows = torch.cat([rows, rows.new_full((pad,), n)])
            cols = torch.cat([cols, cols.new_full((pad,), n)])
        shape = (grid.pr, grid.pc, chunk)
        rows, cols = rows.view(shape), cols.view(shape)
        _sync(dev)
    timings["generate_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with obs.span("k1.route_dedup"):
        vals = torch.ones(shape, dtype=torch.float32, device=dev)
        A, dropped = from_device_coo(grid, rows, cols, vals, n, n, slack=slack,
                                     dedup_sr=SELECT2ND_MAX, defer_drop_check=True)
        del rows, cols, vals
        _sync(dev)
    timings["route_dedup_s"] = time.perf_counter() - t0
    timings["dropped_dev"] = dropped

    if extra_relabel:
        t0 = time.perf_counter()
        with obs.span("k1.relabel"):
            p = DistVec.randperm(grid, n, threefry.fold_in(key, 1))
            A = permute_vertices(A, p)
            _sync(dev)
        timings["relabel_s"] = time.perf_counter() - t0

    nkeep = torch.tensor(n, dtype=torch.int32, device=dev)
    if compress_isolated:
        t0 = time.perf_counter()
        with obs.span("k1.compress_isolated"):
            p, nkeep = isolated_compression_perm(A)
            A = permute_vertices(A, p)
            _sync(dev)
        timings["compress_isolated_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with obs.span("k1.degree"):
        degrees = A.reduce(PLUS_TIMES, "cols", map_fn=lambda v: (v != 0).to(v.dtype))
        _sync(dev)
    timings["degree_s"] = time.perf_counter() - t0
    if obs.ENABLED:
        # kernel-1 stage times as histograms (the per-stage TIMING table)
        for k, v in timings.items():
            if isinstance(v, float):
                obs.observe("k1." + k, v)
    return A, degrees, nkeep, timings
