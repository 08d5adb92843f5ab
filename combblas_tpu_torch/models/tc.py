"""Triangle counting — counterpart of ``combblas_tpu/models/tc.py``
(≈ Applications/TC.cpp).

Kernels, by size:
  * ``dense`` (one tile, n <= ``DENSE_MAX_DIM``): ``sum((L · L) ⊙ L)`` over
    the dense strict lower triangle;
  * ``edgeharvest`` (one tile up to ``EDGE_HARVEST_BITS_MAX_DIM``, or a
    square grid within a per-tile mask budget): per edge (i > j) the
    common neighbours ``popcount(row_i & row_j)`` of the bit-packed
    adjacency, summed to 3·T; ``edgeharvest_bf16`` the same with bf16 rows
    (one tile, n <= ``EDGE_HARVEST_MAX_DIM``);
  * ``sparse``: the masked SpGEMM of TC.cpp, ``(L · L) .* L`` summed.

Counts are exact. The reference's dense products take bf16 0/1 inputs with
float32 sums; ``torch.matmul`` on bf16 would round its output past 256, so
the dense kernel multiplies float32 0/1 matrices: exact with TF32 on or
off (0 and 1 are exact in TF32, the sums accumulate in float32 and stay
below n < 2^24). The bf16 edge harvest multiplies its 0/1 rows in bf16 and
sums each edge's products in float32. Counts return as the reference's
int32 (hi, lo) 15-bit splits, summed in int64 inside. An edge-harvest
call counts ``spgemm.auto.tier{tier=<kernel>, sr=plus_times}``, as the
reference's does.
"""

from __future__ import annotations

import torch

from .. import obs
from ..ops.spgemm import (
    combine_hilo,
    coo_sort_dedup,
    hilo_split,
    pack_support_bits,
    popcount_pair_counts,
)
from ..parallel.spgemm import spgemm
from ..parallel.spmat import SpParMat, ones_f32
from ..semiring import PLUS_TIMES

#: Above this dimension the dense [n, n] product is not used.
DENSE_MAX_DIM = 32768

#: Edge-harvest ceilings: the dense adjacency (bf16: 2 n^2 bytes) or its
#: bitmask (n^2 / 8 bytes) must fit the card.
EDGE_HARVEST_MAX_DIM = 65536
EDGE_HARVEST_BITS_MAX_DIM = 262144


def _tc_dense(rows: torch.Tensor, cols: torch.Tensor, n: int) -> torch.Tensor:
    """``sum((L · L) ⊙ L)`` with L the dense strict lower triangle of the
    entries: the triangle count as the reference's int32 ``[2]`` (hi, lo),
    ``hi = Σ rowsum >> 15`` and ``lo = Σ rowsum & 0x7FFF`` over the int32
    row sums."""
    npad = -(-n // 128) * 128
    keep = rows > cols
    flat = torch.where(keep, rows.long() * npad + cols.long(), npad * npad)
    d = torch.zeros(npad * npad + 1, dtype=torch.float32, device=rows.device)
    d[flat] = 1.0
    d = d[: npad * npad].view(npad, npad)
    rowsum = (torch.matmul(d, d) * d).to(torch.int32).sum(1, dtype=torch.int64)
    return torch.stack([(rowsum >> 15).sum(), (rowsum & 0x7FFF).sum()]).to(torch.int32)


def _strict_lower_edges(rows, cols, dup):
    """The strict-lower, first-of-a-kind entries (the edges each triangle
    is counted through): their rows and cols."""
    keep = (rows > cols) & ~dup
    return rows[keep], cols[keep]


def _tc_edge_harvest(rows: torch.Tensor, cols: torch.Tensor, n: int,
                     chunk: int = 4096) -> torch.Tensor:
    """3·T as ``Σ_{edges i>j} <D[i, :], D[j, :]>`` over the dense symmetric
    bf16 adjacency D (loops dropped), ``chunk`` edges at a time; repeated
    entries are found on the device (``coo_sort_dedup``) and walked once.
    Returns the (hi, lo) split of 3·T."""
    npad = -(-n // 128) * 128
    rows, cols, dup = coo_sort_dedup(rows, cols)
    ok = (rows != cols) & (rows < npad) & (cols < npad)
    flat = torch.where(ok, rows.long() * npad + cols.long(), npad * npad)
    d = torch.zeros(npad * npad + 1, dtype=torch.bfloat16, device=rows.device)
    d[flat] = 1.0
    d = d[: npad * npad].view(npad, npad)
    er, ec = _strict_lower_edges(rows, cols, dup)
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for lo in range(0, er.shape[0], chunk):
        gi = d.index_select(0, er[lo:lo + chunk])
        gj = d.index_select(0, ec[lo:lo + chunk])
        total = total + (gi * gj).sum(1, dtype=torch.float32).to(torch.int64).sum()
    return hilo_split(total)


def _tc_edge_harvest_bits(rows: torch.Tensor, cols: torch.Tensor, n: int,
                          chunk: int = 8192) -> torch.Tensor:
    """The edge harvest over the bit-packed adjacency (``pack_support_bits``,
    ``[n, n / 32]`` int32 words): each edge's common neighbours are
    ``popcount(row_i & row_j)``. Repeated entries are dropped from the
    bits and the edge list. Returns the (hi, lo) split of 3·T."""
    rows, cols, dup = coo_sort_dedup(rows, cols)
    r_all = torch.where((rows == cols) | dup, n, rows)
    bits = pack_support_bits(r_all, cols, n, n, assume_unique=True)
    keep = (rows > cols) & ~dup
    return popcount_pair_counts(bits, bits, torch.where(keep, rows, 0),
                                torch.where(keep, cols, 0), keep.to(torch.int32), chunk=chunk)


def _tc_edge_harvest_dist(A: SpParMat, chunk: int = 8192) -> torch.Tensor:
    """The edge harvest over a p×p grid: each tile packs its entries into a
    ``[lr, lc / 32]`` bitmask of its local columns; a grid row's masks side
    by side are that row block's mask (column tiles are word-aligned, ``lc
    % 32 == 0``); tile (i, j) harvests its own strict-lower edges against
    row block i and row block j (the transpose partner's), and the tiles'
    (hi, lo) splits are summed, as the reference's ``psum``."""
    grid = A.grid
    p = grid.pr
    if not grid.is_square:
        raise ValueError("edge-harvest TC needs a square grid")
    n, lr, lc = A.nrows, A.local_rows, A.local_cols
    if lr != lc:
        raise ValueError("square blocking required (symmetric adjacency)")
    if lc % 32 and p > 1:
        raise ValueError(f"distributed edge-harvest needs word-aligned column tiles (local_cols "
                         f"{lc} % 32 != 0); pad the matrix or use kernel='sparse'")
    nw_loc = -(-lc // 32)
    edges, packed = {}, {}
    for i in range(p):
        for j in range(p):
            t = A.local_tile(i, j)
            valid = t.valid_mask()
            grows = torch.where(valid, t.rows + i * lr, n)
            gcols = torch.where(valid, t.cols + j * lc, n)
            grows, gcols, dup = coo_sort_dedup(grows, gcols)
            # an explicit drop mask: the sentinel n minus the last block's
            # offset would land inside the tile
            drop = dup | (grows == gcols) | (grows >= n)
            packed[i, j] = pack_support_bits(torch.where(drop, lr, grows - i * lr),
                                             torch.where(drop, lc, gcols - j * lc),
                                             lr, nw_loc * 32, assume_unique=True)
            keep = ~dup & (grows < n) & (grows > gcols)
            edges[i, j] = (torch.where(keep, grows - i * lr, 0),
                           torch.where(keep, gcols - j * lc, 0), keep.to(torch.int32))
    rowbits = [torch.cat([packed[i, j] for j in range(p)], dim=1) for i in range(p)]
    del packed
    return sum(popcount_pair_counts(rowbits[i], rowbits[j], *edges[i, j], chunk=chunk)
               for i in range(p) for j in range(p))


def triangle_count(A: SpParMat, kernel: str = "auto") -> int:
    """Triangles of the simple undirected graph A (symmetric, loop-free
    structure). ``kernel``: ``"auto"`` picks ``dense`` on one tile up to
    ``DENSE_MAX_DIM``, else ``edgeharvest`` (one tile up to
    ``EDGE_HARVEST_BITS_MAX_DIM``; a square grid with word-aligned tiles
    up to that bound times ``sqrt(p / 2)``), else ``sparse``. The harvest
    kernels deduplicate on the device; ``sparse`` expects an edge list
    without repeats (its values are wedge counts, summed in float32 as the
    reference's: exact below 2^24 triangles). Reference: TC.cpp."""
    p = A.grid.pr
    nmax = max(A.nrows, A.ncols)
    dist_bits_cap = int(EDGE_HARVEST_BITS_MAX_DIM * (p / 2) ** 0.5)
    if kernel == "auto":
        if A.grid.size == 1 and nmax <= DENSE_MAX_DIM:
            kernel = "dense"
        elif (A.grid.size == 1 and nmax <= EDGE_HARVEST_BITS_MAX_DIM) or (
                A.grid.size > 1 and A.grid.is_square and A.local_cols % 32 == 0
                and nmax <= dist_bits_cap):
            kernel = "edgeharvest"
        else:
            kernel = "sparse"
    if kernel == "dense":
        t = A.local_tile(0, 0)
        return combine_hilo(_tc_dense(t.rows, t.cols, A.nrows))
    harvest = {"edgeharvest": _tc_edge_harvest_bits, "edgeharvest_bf16": _tc_edge_harvest}
    if kernel in harvest:
        if obs.ENABLED:
            obs.count("spgemm.auto.tier", tier=kernel, sr="plus_times")
        if A.grid.size > 1:
            if kernel != "edgeharvest":
                raise ValueError(
                    f"distributed edge-harvest supports kernel='edgeharvest' only, got {kernel}")
            if nmax > dist_bits_cap:
                raise ValueError(
                    f"distributed edgeharvest needs two n^2/(8p)-byte bitmasks per device: "
                    f"n <= {dist_bits_cap} on this {p}x{p} grid, got {nmax}")
            return combine_hilo(_tc_edge_harvest_dist(A)) // 3
        cap = EDGE_HARVEST_BITS_MAX_DIM if kernel == "edgeharvest" else EDGE_HARVEST_MAX_DIM
        if nmax > cap:
            raise ValueError(f"{kernel} needs the dense adjacency in memory: n <= {cap}, "
                             f"got {nmax}")
        t = A.local_tile(0, 0)
        return combine_hilo(harvest[kernel](t.rows, t.cols, A.nrows)) // 3
    if kernel != "sparse":
        raise ValueError(f"unknown kernel {kernel!r}")
    L = A.remove_loops().tril(strict=True).apply(ones_f32)
    B = spgemm(PLUS_TIMES, L, L)  # B[i, j]: wedges i -> k -> j with i > k > j
    C = B.ewise_mult(L)  # wedges that an edge (i, j) closes
    return int(C.reduce(PLUS_TIMES, axis="rows").reduce(PLUS_TIMES))
