"""BFS — counterpart of ``combblas_tpu/models/bfs.py``.

``bfs`` is the level-synchronous search of ``TopDownBFS.cpp``: one masked
semiring SpMV a level over an ``SpParMat`` (or an ``EllParMat``, through
``dist_spmv_masked``'s dispatch). ``bfs_diropt`` is the
direction-optimising search: a level whose frontier fits the budgets walks
only the frontier's columns (``dist_spmspv_masked``, "td"), any other
level runs the masked SpMV ("bu"). ``traversed_edges`` counts the kernel-2
edges of its tree.

``bfs_batch_compact`` searches from W roots at once over an ``EllParMat``:
int8 frontiers through the level loop, parents rebuilt in one pass after
it (per vertex and root the max-id in-neighbour one level up, so the tree
is deterministic). ``bfs_batch`` is the int32 batch that carries parent
candidates through ``dist_spmv_ell_masked_multi``. ``bfs_single`` is
Graph500's sequential kernel 2: one root, each level a top-down or
bottom-up walk classed by degree, or the dense sweep, whichever the tier
budgets admit. ``batch_traversed_edges`` / ``single_traversed_edges``
count the kernel-2 edges and ``validate_bfs_device`` checks the trees on
the device. Every array is an integer or a bool: results equal the
reference's bit for bit.

The reference runs each level loop as one device program
(``lax.while_loop``, ``lax.cond``, ``lax.switch``); here it is a host loop
that reads back one small vector per level: the flag that ends the loop,
and what chooses the level's step (the union frontier's column and edge
counts of ``bfs_batch_compact`` with the CSC budgets; the class counts of
``bfs_single``). Each function's ``last_run`` records those readbacks and
the step each level took. Iteration counts come back as Python ints (the
reference's are int32 arrays; the values are equal).

``bfs`` reads back ``any(new)`` once a level; ``bfs_diropt`` reads back,
once a level, whether the last level found a vertex together with the
frontier's statistics that choose the next step (column count, edge count
accumulated in float32 as the reference does, and the walk's per-tile
counts). Its levels reuse one ``CSC`` per tile, built at the start of the
call (the reference builds them in every top-down step).

Not ported: ``bfs_levels_instrumented``, which is built on ``obs`` spans
(ROADMAP queue 1, item 13b). Nor are the reference's device-buffer caches
(``_gid_blocks``, ``_iota_operand``, the ``lru_cache`` of single-root
programs, ``clear_bfs_caches`` and its cache gauges): they exist for the
TPU's execution (closure-constant tables, one compiled program per tier
spec); eager torch compiles nothing, so the port keeps no such cache.
The ``obs`` gauges come with ROADMAP item 13b.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..ops.segment import expand_ranges
from ..parallel.ellmat import (
    EllParMat,
    _ell_levels_step,
    _ell_parents_from_levels,
    _ell_union_sparse_step,
    _gather_rows,
    _scatter_rows_max,
    dist_spmv_ell_masked_multi,
)
from ..parallel.spmat import SpParMat, ones_i32
from ..parallel.spmv import csc_tiles, dist_spmspv_masked, dist_spmv_masked, spmspv_counts
from ..parallel.vec import DistMultiVec, DistVec
from ..semiring import PLUS_TIMES, SELECT2ND_MAX, Semiring
from . import PAD_ROOT

MAX_LEVELS = 126  # levels are int8


def _global_ids(grid, nblocks: int, block_len: int, length: int, align: str) -> torch.Tensor:
    """int32 [nblocks, block_len] global ids, -1 in the padding slots."""
    gids = torch.arange(
        nblocks * block_len, dtype=torch.int32, device=grid.device
    ).reshape(nblocks, block_len)
    return torch.where(gids < length, gids, -1)


def _root_state(A, source: int):
    """A single-root search's start: row ids ``[pr, lr]`` (-1 in the
    padding), parents and levels (the root its own parent at level 0, -1
    elsewhere) and the col-aligned frontier of parent candidates."""
    grid = A.grid
    row_gids = _global_ids(grid, grid.pr, grid.local_rows(A.nrows), A.nrows, "row")
    col_gids = _global_ids(grid, grid.pc, grid.local_cols(A.ncols), A.ncols, "col")
    parents = torch.where(row_gids == source, source, -1).to(torch.int32)
    levels = torch.where(row_gids == source, 0, -1).to(torch.int32)
    x = torch.where(col_gids == source, source, -1).to(torch.int32)
    return row_gids, parents, levels, x


def _advance(A, y, parents, levels, row_gids, level: int):
    """Take a level's parent candidates ``y`` ([pr, lr], -1 where none):
    the newly discovered rows, the parents and levels with them, and the
    next col-aligned frontier (each new vertex its own candidate)."""
    new = (y >= 0) & (parents < 0) & (row_gids >= 0)
    parents = torch.where(new, y, parents)
    levels = torch.where(new, level + 1, levels)
    x = DistVec(blocks=torch.where(new, row_gids, -1), length=A.nrows, align="row",
                grid=A.grid).realign("col").blocks
    return new, parents, levels, x


def bfs(A, source, max_iters: int | None = None, sr: Semiring = SELECT2ND_MAX):
    """Level-synchronous BFS from ``source`` over a select-style semiring
    (default ``SELECT2ND_MAX``: the max-id frontier in-neighbour is the
    parent). Entry (i, j) of A means edge j → i; symmetrise for undirected
    graphs. ``A``: an ``SpParMat`` or an ``EllParMat``.

    Returns ``(parents, levels, num_iters)``: row-aligned int32 DistVecs
    (-1 where undiscovered) and the number of levels run as an int, the
    terminal empty level included (the reference returns an int32 array).
    ``bfs.last_run`` holds the readbacks (one a level).
    """
    grid = A.grid
    n = A.nrows
    iters = max_iters if max_iters is not None else n
    row_gids, parents, levels, x = _root_state(A, int(source))

    def mk(b):
        return DistVec(blocks=b, length=n, align="row", grid=grid)

    level, active = 0, True
    while active and level < iters:
        y = dist_spmv_masked(sr, A, DistVec(blocks=x, length=A.ncols, align="col", grid=grid),
                             mk(parents < 0)).blocks
        new, parents, levels, x = _advance(A, y, parents, levels, row_gids, level)
        level += 1
        active = bool(new.any())
    bfs.last_run = {"readbacks": level}
    return mk(parents), mk(levels), level


# the last call's device -> host readbacks (one a level)
bfs.last_run = None


def bfs_diropt(A: SpParMat, source, *, frontier_capacity: int, exp_capacity: int,
               max_iters: int | None = None):
    """Direction-optimising BFS (≈ ``DirOptBFS.cpp``, Beamer). A level takes
    the top-down walk ("td": ``dist_spmspv_masked`` over the frontier's
    columns, work in proportion to their entries) when the frontier has at
    most ``frontier_capacity`` columns and at most ``0.99 * exp_capacity``
    out-edges (counted in float32, hence the 1% margin), else the masked
    SpMV over every entry ("bu"). The step changes the cost, not the
    result: parents and levels are ``bfs``'s.

    Returns ``(parents, levels, num_iters)`` like ``bfs``.
    ``bfs_diropt.last_run`` holds the readbacks (one a level, plus the one
    that ends the loop), the step of each level and each level's frontier
    statistics.
    """
    grid = A.grid
    n = A.nrows
    iters = max_iters if max_iters is not None else n
    row_gids, parents, levels, x = _root_state(A, int(source))
    # out-degree per column (structural), for the edge budget
    deg = A.reduce(PLUS_TIMES, "rows", map_fn=ones_i32).blocks
    csc = csc_tiles(A)

    def mk(b):
        return DistVec(blocks=b, length=n, align="row", grid=grid)

    level, readbacks, steps, stats = 0, 0, [], []
    found = None  # the last level's new vertices (0-dim, on the device)
    while level < iters:
        act = x >= 0
        cnt = act.sum()
        edges = torch.where(act, deg, 0).to(torch.float32).sum()
        use_td = (cnt <= frontier_capacity) & (edges <= 0.99 * exp_capacity)
        head = torch.stack([found if found is not None else cnt.new_ones(()), cnt,
                            use_td.to(cnt.dtype)]).to(torch.float64)
        vals = torch.cat([head, edges.to(torch.float64)[None],
                          spmspv_counts(csc, act, frontier_capacity, exp_capacity)
                          .to(torch.float64)]).tolist()
        readbacks += 1
        if not vals[0]:
            break
        stats.append({"cnt": int(vals[1]), "edges": vals[3]})
        xv = DistVec(blocks=x, length=A.ncols, align="col", grid=grid)
        unvisited = mk(parents < 0)
        if vals[2]:
            y = dist_spmspv_masked(
                SELECT2ND_MAX, A, xv, DistVec(blocks=act, length=A.ncols, align="col", grid=grid),
                unvisited, frontier_capacity=frontier_capacity, exp_capacity=exp_capacity,
                csc=csc, counts=[int(v) for v in vals[4:]])
        else:
            y = dist_spmv_masked(SELECT2ND_MAX, A, xv, unvisited)
        steps.append("td" if vals[2] else "bu")
        new, parents, levels, x = _advance(A, y.blocks, parents, levels, row_gids, level)
        found = new.sum()
        level += 1
    bfs_diropt.last_run = {"readbacks": readbacks, "steps": steps, "frontiers": stats}
    return mk(parents), mk(levels), level


# what the last call's host loop did: device -> host readbacks, the step
# ("td" | "bu") and the frontier statistics of each level
bfs_diropt.last_run = None


def bfs_diropt_auto(A: SpParMat, source, max_iters: int | None = None):
    """``bfs_diropt`` with the reference's default budgets: lc/8 frontier
    columns and an eighth of the tile capacity in walked entries."""
    lc = A.grid.local_cols(A.ncols)
    cap = A.capacity
    fc = min(max(64, lc // 8 + 1), lc)
    ec = min(max(256, cap // 8 + 1), cap)
    return bfs_diropt(A, source, frontier_capacity=fc, exp_capacity=ec, max_iters=max_iters)


def traversed_edges(A, parents: DistVec) -> torch.Tensor:
    """Graph500 kernel-2 edge count (0-dim int32): the structural degrees
    of the discovered vertices, summed in int32 as the reference does, /
    2 (each undirected edge is stored twice)."""
    deg = A.reduce(PLUS_TIMES, "cols", map_fn=ones_i32).blocks
    disc = parents.realign("row").blocks >= 0
    return torch.where(disc, deg, 0).sum(dtype=torch.int32) // 2


def bfs_batch_compact(A: EllParMat, sources, max_iters: int | None = None,
                      ring: bool = False, csc=None,
                      frontier_capacity: int | None = None,
                      edge_capacity: int | None = None):
    """Level-compressed multi-source BFS from ``sources`` ([W] vertex ids;
    a ``PAD_ROOT`` lane discovers nothing).

    Entry (i, j) of A means edge j → i; symmetrize for undirected graphs.
    Returns ``(parents, levels, num_iters)``: row-aligned DistMultiVecs,
    int32 parents and int8 levels ``[n, W]`` (-1 where undiscovered; a
    root is its own parent), and the number of levels run as an int.

    Levels are int8, so at most 126 levels run; ``max_iters`` above that
    raises ValueError.

    Direction optimisation for the batch: with ``csc`` (the
    ``build_csc_companion`` arrays) and the budgets ``frontier_capacity``
    and ``edge_capacity``, a level whose union frontier over all W roots
    fits both budgets walks only those columns' edges
    (``_ell_union_sparse_step``, cost ∝ the union frontier's edges: eager
    shapes need no static capacity, so the step gets the counts just read
    back as its capacities) instead of the dense sweep
    (``_ell_levels_step``, cost ∝ stored slots). The result is the same
    either way.

    ``ring`` is accepted for the reference's signature. A grid lives on one
    device, where the ring (the reference's ``BitMapCarousel`` analog) and
    the grid-order fold give the same bits, so each dense level folds a
    grid row's tiles in the ring's order (``collectives.axis_ring_reduce``)
    for both values. The ring schedule across cards comes with item 12c.
    """
    grid = A.grid
    n = A.nrows
    pr_, lr = grid.pr, grid.local_rows(n)
    pc_, lc = grid.pc, grid.local_cols(A.ncols)
    if max_iters is not None and max_iters > MAX_LEVELS:
        raise ValueError(
            f"bfs_batch_compact stores levels as int8 (max depth {MAX_LEVELS}); "
            f"max_iters={max_iters} cannot be honored"
        )
    iters = max_iters if max_iters is not None else MAX_LEVELS

    row_gids = _global_ids(grid, pr_, lr, n, "row")[:, :, None]
    col_gids = _global_ids(grid, pc_, lc, A.ncols, "col")[:, :, None]
    src = torch.as_tensor(sources).to(device=grid.device, dtype=torch.int32)[None, None, :]
    live = src != PAD_ROOT
    is_root = (row_gids == src) & live  # [pr, lr, W]

    levels = is_root.to(torch.int8) - 1  # 0 at the roots, -1 elsewhere
    x = ((col_gids == src) & live).to(torch.int8)  # [pc, lc, W]

    def mk(b, align):
        return DistMultiVec(blocks=b, length=n, align=align, grid=grid)

    diropt = csc is not None and frontier_capacity is not None and edge_capacity is not None
    if diropt:
        csc_indptr, csc_rowidx = csc
        coldeg = (csc_indptr[:, :, 1:] - csc_indptr[:, :, :-1]).sum(0)  # [pc, lc]

    level, active, readbacks, steps = 0, True, 0, []
    while active and level < iters:
        undisc = (levels < 0).to(torch.int8)
        use_sparse = False
        if diropt:
            act = x.amax(dim=2) > 0  # [pc, lc] union frontier
            cnt, edges = torch.stack([act.sum(), (coldeg * act).sum()]).tolist()
            readbacks += 1
            use_sparse = cnt <= frontier_capacity and edges <= edge_capacity
        if use_sparse:
            # slots cut to what this level holds: no tile has more active
            # columns or edges than the whole union, and slots past those
            # are inert, so the result is that of the full budgets
            reached = _ell_union_sparse_step(
                A, csc_indptr, csc_rowidx, x, undisc, max(cnt, 1), max(edges, 1)
            )
        else:
            reached = _ell_levels_step(A, x, undisc)
        steps.append("sparse" if use_sparse else "dense")
        new = reached > 0
        level += 1
        levels = levels.masked_fill(new, level)
        x = mk(reached, "row").realign("col").blocks
        active = bool(new.any())
        readbacks += 1

    levels_col = mk(levels, "row").realign("col").blocks
    parents = _ell_parents_from_levels(A, levels_col, levels)
    # roots are their own parents; undiscovered and padding rows stay -1
    parents = torch.where(is_root, src, parents)
    parents = parents.masked_fill((levels < 0) | (row_gids < 0), -1)
    bfs_batch_compact.last_run = {"readbacks": readbacks, "steps": steps}
    return mk(parents, "row"), mk(levels, "row"), level


# what the last call's host loop did: device -> host readbacks, and the
# step ("dense" | "sparse") of each level
bfs_batch_compact.last_run = None


def bfs_batch(A: EllParMat, sources, max_iters: int | None = None,
              sr: Semiring = SELECT2ND_MAX, track_levels: bool = True):
    """Multi-source BFS carrying int32 parent candidates: W trees at once,
    one ``dist_spmv_ell_masked_multi`` a level (``sr`` picks among
    frontier in-neighbours; the default keeps the max id).

    ``sources``: [W] vertex ids (``PAD_ROOT`` lanes stay empty). Returns
    ``(parents, levels, num_iters)``: row-aligned int32 DistMultiVecs
    ``[n, W]`` (-1 where undiscovered, a root is its own parent) and the
    number of levels run as an int (the reference returns an int32 array).
    ``max_iters`` defaults to n. ``track_levels=False`` returns the
    discovery indicator (0 discovered, -1 not) in place of levels.
    """
    grid = A.grid
    n = A.nrows
    lr, lc = grid.local_rows(n), grid.local_cols(A.ncols)
    iters = max_iters if max_iters is not None else n
    row_gids = _global_ids(grid, grid.pr, lr, n, "row")[:, :, None]
    col_gids = _global_ids(grid, grid.pc, lc, A.ncols, "col")[:, :, None]
    src = torch.as_tensor(sources).to(device=grid.device, dtype=torch.int32)[None, None, :]
    live = src != PAD_ROOT
    is_src = (row_gids == src) & live
    parents = torch.where(is_src, src, -1)  # [pr, lr, W]
    levels = torch.where(is_src, 0, -1).to(torch.int32) if track_levels else None
    x = torch.where((col_gids == src) & live, src, -1)  # [pc, lc, W]

    def mk(b, align="row"):
        return DistMultiVec(blocks=b, length=n, align=align, grid=grid)

    level, active, readbacks = 0, True, 0
    while active and level < iters:
        unvisited = parents < 0
        y = dist_spmv_ell_masked_multi(sr, A, mk(x, "col"), mk(unvisited)).blocks
        new = (y >= 0) & unvisited & (row_gids >= 0)
        parents = torch.where(new, y, parents)
        if track_levels:
            levels = torch.where(new, level + 1, levels)
        x = mk(torch.where(new, row_gids, -1)).realign("col").blocks
        level += 1
        active = bool(new.any())
        readbacks += 1
    if not track_levels:
        levels = torch.where(parents >= 0, 0, -1).to(torch.int32)
    bfs_batch.last_run = {"readbacks": readbacks}
    return mk(parents), mk(levels), level


# the last call's device -> host readbacks (one a level)
bfs_batch.last_run = None


#: Degree classes shared by every ``bfs_single`` tier: class c holds the
#: vertices of degree in (LADDER[c-1], LADDER[c]]; a degree past the last
#: rung admits only the dense sweep.
BFS_CLASS_LADDER = (8, 64, 512, 4096, 32768, 131072)

#: Default tier ladder of the sequential-root search at Graph500 scale
#: about 20 (the reference's, sized from its level anatomy): a small
#: top-down tier for the levels before the peak, two bottom-up tiers for
#: those after it, the dense sweep at the peak.
DEFAULT_SEQ_TIERS = (
    "td:1024,1024,512,128,16,2"
    "|bu:524288,16384,1024,0,0,0"
    "|bu:1048576,32768,2048,128,0,0"
)


def parse_tier_spec(spec: str):
    """``"td:1024,1024,512,128,16,2|bu:524288,16384,1024,0,0,0"`` →
    ``bfs_single``'s tier tuple. An empty string gives () (always dense)."""
    tiers = []
    for part in spec.split("|"):
        if not part:
            continue
        kind, _, budg = part.partition(":")
        budgets = tuple(int(v) for v in budg.split(","))
        if kind not in ("td", "bu") or len(budgets) != len(BFS_CLASS_LADDER):
            raise ValueError(
                f"bad tier spec {part!r}: want kind td|bu and "
                f"{len(BFS_CLASS_LADDER)} budgets"
            )
        tiers.append((kind, budgets))
    return tuple(tiers)


def bfs_single(E: EllParMat, source, csc, *, tiers, csr=None, coldeg=None, rowdeg=None,
               max_iters: int | None = None):
    """Single-root BFS whose level cost follows the frontier (top-down) or
    the undiscovered side (bottom-up), with the dense sweep for the heavy
    levels — Graph500's sequential kernel 2.

    ``csc`` / ``csr``: the per-tile companions (``build_csc_companion``,
    ``build_csr_companion``; ``csr`` is needed by "bu" tiers only).
    ``coldeg`` / ``rowdeg``: global degrees as [pc, lc] / [pr, lr] blocks;
    missing, ``rowdeg`` is ``E.reduce(PLUS_TIMES, "cols", ones_i32)`` and
    ``coldeg`` that vector realigned (as the reference does). ``tiers``:
    ``parse_tier_spec``'s tuple; each level takes the first tier, in order,
    whose side (active columns for "td", undiscovered rows for "bu") has
    no vertex past the ladder and at most ``budgets[c]`` vertices in each
    class c, else the dense sweep. The step changes the cost, never the
    result: parents are the max-id frontier in-neighbour, levels the BFS
    depth. One exception the reference shares: a walk covers at most
    ``BFS_CLASS_LADDER[c]`` entries of a vertex's range, c its class by the
    degree passed in, so degrees below the true ones cut the walk.

    Returns ``(parents, levels, num_iters)``: row-aligned int32 DistVecs
    and the number of levels run as an int (the reference returns an int32
    array). ``max_iters`` defaults to n. ``bfs_single.last_run`` holds the
    readbacks (one a level, plus the one that ends the loop) and the step
    of each level ("td0", "bu1", ..., "dense"; the digit is the tier's
    index).
    """
    if any(kind == "bu" for kind, _ in tiers) and csr is None:
        raise ValueError(
            "bu tiers need the row-major companion: "
            "csr=build_csr_companion(grid, rows, cols, nrows, ncols)"
        )
    grid = E.grid
    if rowdeg is None:
        rowdeg = E.reduce(PLUS_TIMES, "cols", map_fn=ones_i32).blocks
    if coldeg is None:
        coldeg = DistVec(blocks=rowdeg, length=E.nrows, align="row", grid=grid) \
            .realign("col").blocks
    search = _SingleSearch(E, csc, csr, coldeg, rowdeg, tiers)
    n = E.nrows
    iters = max_iters if max_iters is not None else n
    row_gids, parents, levels, x = _root_state(E, int(source))
    new, counts = None, None
    level, readbacks, steps = 0, 0, []
    while level < iters:
        undisc = parents < 0
        if tiers:
            counts = search.counts(x, undisc, new)
            readbacks += 1
            if not counts["active"]:
                break
            step = search.select(counts)
        else:
            if new is not None:
                readbacks += 1
                if not bool(new.any()):
                    break
            step = "dense"
        y = search.step(step, x, undisc, counts)
        steps.append(step)
        new, parents, levels, x = _advance(E, y, parents, levels, row_gids, level)
        level += 1
    bfs_single.last_run = {"readbacks": readbacks, "steps": steps}

    def mk(b):
        return DistVec(blocks=b, length=n, align="row", grid=grid)

    return mk(parents), mk(levels), level


# what the last call's host loop did: device -> host readbacks, and the
# step of each level
bfs_single.last_run = None


class _SingleSearch:
    """The per-call tables and the level steps of ``bfs_single``.

    The reference compacts the selected vertices of each class by
    ``top_k`` into static ``[budget_c, K_c]`` rectangles (its backend needs
    static shapes and runs no cumsum fast). Here the host has read the
    exact counts: the selected vertices are compacted by ``expand_ranges``
    over their indicator, and their ranges, each cut to ``K_c`` entries,
    are walked by ``expand_ranges`` over exactly the entries the counts
    give, so no slot of a walk is inert.
    """

    def __init__(self, E: EllParMat, csc, csr, coldeg, rowdeg, tiers):
        grid = E.grid
        self.E, self.tiers, self.csc, self.csr = E, tuple(tiers), csc, csr
        n, dev = E.nrows, grid.device
        self.lr, self.lc = E.local_rows, E.local_cols
        self.row_gids = _global_ids(grid, grid.pr, self.lr, n, "row")
        self.col_gids = _global_ids(grid, grid.pc, self.lc, E.ncols, "col")
        ladder = torch.tensor(BFS_CLASS_LADDER, dtype=torch.int32, device=dev)
        nc = len(BFS_CLASS_LADDER)
        # class 0..nc-1 on the ladder, nc past it; K_c entries walked at most
        self.ccls = torch.bucketize(coldeg.to(torch.int32), ladder, out_int32=True)
        self.rcls = torch.bucketize(rowdeg.to(torch.int32), ladder, out_int32=True)
        self.classes = torch.arange(nc + 1, dtype=torch.int32, device=dev)
        kcap = torch.cat([ladder, ladder.new_zeros(1)])
        kinds = {kind for kind, _ in self.tiers}

        def walk_len(indptr, cls):
            return torch.minimum(indptr[..., 1:] - indptr[..., :-1], kcap[cls.long()])

        # entries walked per vertex and tile: [pr, pc, lc] / [pr, pc, lr]
        self.td_len = walk_len(csc[0], self.ccls[None]) if "td" in kinds else None
        self.bu_len = walk_len(csr[0], self.rcls[:, None]) if "bu" in kinds else None

    def counts(self, x, undisc, new) -> dict:
        """One readback: per class the active columns and the undiscovered
        rows (index nc = past the ladder), whether the last level found a
        vertex, and per tile the vertices and entries each walk would
        take."""
        nc = len(BFS_CLASS_LADDER)
        act = x >= 0  # [pc, lc]
        und = undisc & (self.row_gids >= 0)  # [pr, lr]

        def per_class(mask, cls):
            hit = (cls[..., None] == self.classes) & mask[..., None]
            return hit.sum(dim=(0, 1))

        parts = [per_class(act, self.ccls), per_class(und, self.rcls),
                 (new.any() if new is not None else torch.ones((), dtype=torch.bool,
                                                               device=x.device))[None]]
        if self.td_len is not None:
            parts += [act.sum(1), (self.td_len * act[None]).sum(2).reshape(-1)]
        if self.bu_len is not None:
            parts += [und.sum(1), (self.bu_len * und[:, None]).sum(2).reshape(-1)]
        vals = torch.cat([p.to(torch.int64) for p in parts]).tolist()
        pr, pc = self.E.grid.pr, self.E.grid.pc
        out = {"fc": vals[:nc + 1], "uc": vals[nc + 1:2 * nc + 2], "active": bool(vals[2 * nc + 2])}
        rest = vals[2 * nc + 3:]
        if self.td_len is not None:
            out["td"] = (rest[:pc], rest[pc:pc + pr * pc])
            rest = rest[pc + pr * pc:]
        if self.bu_len is not None:
            out["bu"] = (rest[:pr], rest[pr:pr + pr * pc])
        return out

    def select(self, counts) -> str:
        """The reference's rule: the first tier whose side has no vertex
        past the ladder and every class count within its budget (budgets
        not capped at the block length here), else the dense sweep."""
        nc = len(BFS_CLASS_LADDER)
        for t, (kind, budgets) in enumerate(self.tiers):
            cnts = counts["fc"] if kind == "td" else counts["uc"]
            if cnts[nc] == 0 and all(cnts[c] <= budgets[c] for c in range(nc)):
                return f"{kind}{t}"
        return "dense"

    def step(self, step: str, x, undisc, counts):
        """Parent candidates [pr, lr] (-1 where none) of one level."""
        if step == "dense":
            return self.dense(x, undisc)
        return self.walk(step[:2], x, undisc, counts[step[:2]])

    def dense(self, x, undisc):
        """The dense sweep: a scalar gather-max over every ELL slot,
        scattered into rows, masked by ``undisc``, combined over grid
        columns by max."""
        E, lr, lc = self.E, self.lr, self.lc
        out = []
        for i in range(E.grid.pr):
            acc = None
            for j in range(E.grid.pc):
                xpad = torch.cat([x[j], x.new_full((1,), -1)])
                y = x.new_full((lr + 1,), -1)  # lr: the sink row of padding bucket rows
                for bc, _bv, br in E.buckets:
                    bc = bc[i, j]
                    g = xpad.index_select(0, torch.clamp(bc, max=lc).reshape(-1)).view(bc.shape)
                    y.scatter_reduce_(0, br[i, j].long(), g.amax(dim=1), "amax")
                y = torch.where(undisc[i], y[:lr], -1)
                acc = y if acc is None else torch.maximum(acc, y)
            out.append(acc)
        return torch.stack(out)

    def walk(self, kind: str, x, undisc, tile_counts):
        """The class walk of every selected vertex over its local range,
        cut to K_c entries. "td": the active columns' CSC ranges, each
        column's id scatter-maxed into its rows. "bu": the undiscovered
        rows' CSR ranges, the frontier candidates gathered at the
        neighbours, folded per row (segment max), one row scatter."""
        E, lr = self.E, self.lr
        pr, pc = E.grid.pr, E.grid.pc
        nsel, nent = tile_counts
        indptr, idx = self.csc if kind == "td" else self.csr
        walk_len = self.td_len if kind == "td" else self.bu_len
        out = []
        for i in range(pr):
            acc = None
            for j in range(pc):
                F = nsel[j] if kind == "td" else nsel[i]
                m = nent[i * pc + j]
                y = x.new_full((lr,), -1)
                if F and m:
                    mask = x[j] >= 0 if kind == "td" else undisc[i] & (self.row_gids[i] >= 0)
                    sel = expand_ranges(mask, F)[0]  # the selected local ids, ascending
                    owner, offset, _, _ = expand_ranges(walk_len[i, j].index_select(0, sel), m)
                    entry = indptr[i, j].index_select(0, sel).index_select(0, owner) + offset
                    other = idx[i, j].index_select(0, entry)  # rows (td) / columns (bu)
                    if kind == "td":
                        cand = x[j].index_select(0, sel).index_select(0, owner)
                        y.scatter_reduce_(0, other.long(), cand, "amax")
                    else:
                        yb = x.new_full((F,), -1)
                        yb.scatter_reduce_(0, owner.long(), x[j].index_select(0, other), "amax")
                        y.index_copy_(0, sel.long(), yb)
                y = torch.where(undisc[i], y, -1)
                acc = y if acc is None else torch.maximum(acc, y)
            out.append(acc)
        return torch.stack(out)


def single_traversed_edges(deg_row_blocks: torch.Tensor, parents: DistVec) -> torch.Tensor:
    """Graph500 kernel-2 edge count of one root, on the device: int32
    (sum of degrees over discovered vertices) / 2. The reference sums in
    uint32; here the sum is int64, halved, then cast to int32, equal for
    every sum below 2**32."""
    disc = parents.blocks >= 0  # [pr, lr]
    te = torch.where(disc, deg_row_blocks, 0).sum(dtype=torch.int64)
    return (te // 2).to(torch.int32)


def batch_traversed_edges(deg_row_blocks: torch.Tensor, parents: DistMultiVec) -> torch.Tensor:
    """Graph500 kernel-2 edge count per root, on the device: int32 [W],
    (sum of degrees over discovered vertices) / 2.

    ``deg_row_blocks``: [pr, lr] structural degrees (row-aligned, padding
    0); ``parents``: the DistMultiVec from ``bfs_batch_compact``. The
    reference sums in uint32, which torch cannot reduce: the sum here is
    int64, halved, then cast to int32, equal for every sum below 2**32.
    """
    disc = parents.blocks >= 0  # [pr, lr, W]
    te = torch.where(disc, deg_row_blocks[:, :, None], 0).sum(dim=(0, 1), dtype=torch.int64)
    return (te // 2).to(torch.int32)


def validate_bfs_tree(A_dense, source, parents, levels) -> list[str]:
    """Host-side BFS tree validation (Graph500 verify.c-style checks) on a
    dense adjacency. Returns a list of violations (empty = valid)."""
    A_dense = np.asarray(A_dense)
    p = np.asarray(parents)
    lv = np.asarray(levels)
    n = A_dense.shape[0]
    errs = []
    if p[source] != source or lv[source] != 0:
        errs.append("source not its own parent at level 0")
    for v in range(n):
        if v == source or p[v] < 0:
            continue
        if not A_dense[v, p[v]]:
            errs.append(f"tree edge ({p[v]},{v}) not in graph")
        if lv[v] != lv[p[v]] + 1:
            errs.append(f"level[{v}]={lv[v]} != level[parent]+1={lv[p[v]] + 1}")
    # reachability: the discovered set must equal the BFS-reachable set
    seen = {source}
    q = deque([source])
    while q:
        u = q.popleft()
        for w in np.nonzero(A_dense[:, u])[0]:
            if w not in seen:
                seen.add(w)
                q.append(w)
    disc = {int(v) for v in range(n) if p[v] >= 0}
    if disc != seen:
        errs.append(f"discovered {len(disc)} != reachable {len(seen)}")
    return errs


def validate_bfs_device(E: EllParMat, parents: DistMultiVec, levels: DistMultiVec) -> torch.Tensor:
    """Graph500 tree validation on the device, for scales where the host
    checker (O(n·m) Python) is unusable.

    ``parents`` / ``levels``: int32 DistMultiVecs [n, W] (levels -1 =
    undiscovered). Per lane:

      v1  roots: exactly one self-parent vertex at level 0;
      v2  level step: level[v] == level[parent[v]] + 1 for discovered
          non-root v (and the parent discovered);
      v3  tree-edge membership: edge (parent[v], v) is in the graph;
      v4  edge consistency: no edge joins a discovered vertex to an
          undiscovered one, and discovered endpoints' levels differ by
          at most 1.

    Returns an int32 [4, W] matrix of violation counts (all zeros =
    valid). The bucket sweep's intermediates take slots × W elements:
    validate a few lanes at a time at large scales.
    """
    grid = E.grid
    n = E.nrows
    lr, lc = E.local_rows, E.local_cols
    dev = grid.device
    prow_all = parents.realign("row").blocks
    lrow_all = levels.realign("row").blocks
    lcol_all = levels.realign("col").blocks
    W = prow_all.shape[2]
    lvl_full = lcol_all.reshape(-1, W)[:n]  # per-lane level table for parent lookups

    def count(mask):
        return mask.sum(dim=tuple(range(mask.dim() - 1)), dtype=torch.int32)

    nroots, v2, v3, v4 = (torch.zeros(W, dtype=torch.int32, device=dev) for _ in range(4))
    for i in range(grid.pr):
        prow, lrow = prow_all[i], lrow_all[i]  # [lr, W]
        row_g = torch.arange(lr, dtype=torch.int32, device=dev) + i * lr
        rvalid = (row_g < n)[:, None]
        is_root = (prow == row_g[:, None]) & (lrow == 0) & rvalid
        nroots += count(is_root)
        disc = (lrow >= 0) & rvalid
        nonroot = disc & ~is_root
        pidx = torch.clamp(prow, 0, n - 1).long()
        lp = lvl_full.gather(0, pidx)  # lp[v, w] = level[parent[v, w], w]
        v2 += count(nonroot & ((lp < 0) | (lrow != lp + 1)))

        # v3 + v4: one sweep over the ELL buckets; a row's adjacency may
        # span several grid columns
        tree_found = torch.zeros((lr, W), dtype=torch.uint8, device=dev)
        for j in range(grid.pc):
            lpad = torch.cat([lcol_all[j], lcol_all.new_full((1, W), -1)])  # [lc+1, W]
            for bc, _bv, br in E.buckets:
                bc0, br0 = bc[i, j], br[i, j]
                rowok = br0 < lr  # padded bucket rows are inert
                slot_ok = ((bc0 < lc) & rowok[:, None])[..., None]  # [nb, kb, 1]
                colg = torch.where(slot_ok[..., 0], bc0 + j * lc, n)
                g = _gather_rows(lpad, torch.clamp(bc0, max=lc))  # [nb, kb, W] neighbour levels
                safe_row = torch.clamp(br0, max=lr - 1)
                rl = lrow.index_select(0, safe_row)[:, None, :]  # row levels
                rd, nd = rl >= 0, g >= 0
                bad_cross = slot_ok & (rd != nd)
                bad_far = slot_ok & rd & nd & ((g - rl).abs() > 1)
                v4 += count(bad_cross | bad_far)
                pv = prow.index_select(0, safe_row)[:, None, :]  # parent ids
                match = slot_ok & (colg[..., None] == pv)
                hit = match.any(dim=1) & rowok[:, None]  # [nb, W]
                _scatter_rows_max(tree_found, safe_row, hit.to(torch.uint8))
        v3 += count(nonroot & ~tree_found.bool())
    v1 = (nroots - 1).abs()
    return torch.stack([v1, v2, v3, v4])
