"""Bipartite matchings — counterpart of ``combblas_tpu/models/matching.py``
(≈ ``Applications/BipartiteMatchings/``).

1. Maximal matching (``maximal_matching``): greedy and Karp-Sipser rounds
   of (rows propose a free column; columns grant to their least proposer),
   each a per-row masked structural min over the free columns, a
   ``scatter_combine`` granting the columns and one back to the rows.
2. Maximum-cardinality matching: augmenting-path phases. ``device=True``
   (``_mcm_phase``): an alternating-layer BFS from the free rows, one
   ``dist_spmv(SELECT2ND_MIN, Aᵀ, frontier)`` a layer whose result is the
   parent of each newly reached column, stopped at the first layer with a
   free column; every free column found then walks its parent chain back
   in parallel, and disjointness is decided by winner selection (each
   path scatter-mins its id onto its rows and survives iff it won them
   all). ``device=False``: the host-augmentation oracle.
3. AWPM (``awpm``): heaviest-edge Karp-Sipser initialisation + cardinality
   augmentation.

Every value is an int32 or a comparison of the weights, so results equal
the reference's bit for bit. The reference runs each phase as one program
with three ``lax.while_loop``s; here the BFS is a host loop with one
readback a layer (whether a free column was found and whether the next
frontier is empty), and each back-chase runs exactly ``depth + 1`` steps
with no readback (a dead lane is a no-op in every step, so the extra steps
change nothing). A phase that finds no free column skips its chases.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.grid import require_local
from ..parallel.spmat import SpParMat, ones_f32
from ..parallel.spmv import dist_spmv
from ..parallel.vec import DistVec
from ..semiring import MAX_MIN, PLUS_TIMES, SELECT2ND_MIN

I32MAX = np.iinfo(np.int32).max


def _set_colid_vals(t, ro, co):
    vals = torch.where(t.valid_mask(), (t.cols + co).to(torch.int32), I32MAX)
    return dataclasses.replace(t, vals=vals.to(torch.int32))


def _colid_matrix(A: SpParMat) -> SpParMat:
    """A with values replaced by global column ids (int32)."""
    return A.tile_map_indexed(_set_colid_vals)


def _mask_free_ids(v, free):
    return torch.where(free, v, I32MAX)


def _mask_free_weights(v, free):
    return torch.where(free, v, float("-inf"))


def _one_if_free(v, free):
    return torch.where(free, 1, 0).to(torch.int32)


def _gids(shape, n: int, device) -> torch.Tensor:
    pa, L = shape
    g = torch.arange(pa * L, dtype=torch.int32, device=device).reshape(pa, L)
    return torch.where(g < n, g, I32MAX)


def _mark_best(Aw: SpParMat, Aid: SpParMat, colfree: DistVec, wrow: DistVec) -> SpParMat:
    """Aid with vals = col id where (col free AND weight == row max) else
    I32MAX: the argmax-column selector of weighted proposals. Aw and Aid
    share their slot layout."""
    free_b = colfree.realign("col").blocks
    rmax_b = wrow.realign("row").blocks

    def f(ti, i, j):
        tw = Aw.local_tile(i, j)
        free, rmax = free_b[j], rmax_b[i]
        fpad = torch.cat([free, free.new_zeros(1)])
        rpad = torch.cat([rmax, rmax.new_full((1,), float("inf"))])
        ci = torch.clamp(tw.cols, max=free.shape[0]).long()
        ri = torch.clamp(tw.rows, max=rmax.shape[0]).long()
        is_best = tw.valid_mask() & fpad[ci] & (tw.vals == rpad[ri])
        return dataclasses.replace(ti, vals=torch.where(is_best, ti.vals, I32MAX))

    return Aid.tile_map_ij(f)


def _matching_round(Aid: SpParMat, Aw: SpParMat | None, mate_row: torch.Tensor,
                    mate_col: torch.Tensor, only_deg1: bool, heaviest: bool = False):
    """One propose/grant round → ``(mate_row', mate_col', newly matched
    count)``, the count a 0-dim int32 tensor.

    mate_row: row-aligned int32 blocks (-1 = free); mate_col: col-aligned.
    ``only_deg1`` restricts proposers to rows with exactly one free-column
    neighbour (the Karp-Sipser rule)."""
    grid = Aid.grid
    nr, nc = Aid.nrows, Aid.ncols
    dev = grid.device

    colfree = DistVec(blocks=mate_col < 0, length=nc, align="col", grid=grid)
    if heaviest:
        masked_w = Aw.dim_apply(colfree, _mask_free_weights, "cols")
        wcand = masked_w.reduce(MAX_MIN, "cols")  # row-aligned max weight
        cand = _mark_best(Aw, Aid, colfree, wcand.realign("row")).reduce(SELECT2ND_MIN, "cols")
    else:
        masked_id = Aid.dim_apply(colfree, _mask_free_ids, "cols")
        cand = masked_id.reduce(SELECT2ND_MIN, "cols")  # least free col id

    deg_free = Aid.dim_apply(colfree, _one_if_free, "cols").reduce(PLUS_TIMES, "cols")
    eligible = (mate_row < 0) & (cand.blocks != I32MAX)
    if only_deg1:
        eligible = eligible & (deg_free.blocks == 1)

    row_gids = _gids(mate_row.shape, nr, dev)
    prop_col = DistVec(blocks=torch.where(eligible, cand.blocks, -1), length=nr, align="row",
                       grid=grid)
    prop_src = DistVec(blocks=torch.where(eligible, row_gids, I32MAX), length=nr, align="row",
                       grid=grid)
    # columns grant to the least proposing row
    grant0 = DistVec(blocks=torch.full(mate_col.shape, I32MAX, dtype=torch.int32, device=dev),
                     length=nc, align="col", grid=grid)
    granted = grant0.scatter_combine(SELECT2ND_MIN, idx=prop_col, src=prop_src)
    new_col = (granted.blocks != I32MAX) & (mate_col < 0)
    mate_col2 = torch.where(new_col, granted.blocks, mate_col)

    # rows learn their match by the reverse scatter
    col_gids = _gids(mate_col.shape, nc, dev)
    back_idx = DistVec(blocks=torch.where(new_col, granted.blocks, -1), length=nc, align="col",
                       grid=grid)
    back_src = DistVec(blocks=torch.where(new_col, col_gids, I32MAX), length=nc, align="col",
                       grid=grid)
    mrow0 = DistVec(blocks=torch.full(mate_row.shape, I32MAX, dtype=torch.int32, device=dev),
                    length=nr, align="row", grid=grid)
    got = mrow0.scatter_combine(SELECT2ND_MIN, idx=back_idx, src=back_src)
    new_row = got.blocks != I32MAX
    mate_row2 = torch.where(new_row, got.blocks, mate_row)
    return mate_row2, mate_col2, new_col.sum(dtype=torch.int32)


def maximal_matching(A: SpParMat, *, karp_sipser: bool = True,
                     weighted: bool = False) -> tuple[DistVec, DistVec]:
    """Maximal matching on A's nonzero pattern (rows = left, cols = right):
    ``(mate_row, mate_col)``, row- and col-aligned int32 DistVecs with -1
    for unmatched. ``karp_sipser`` gives degree-1 rows priority;
    ``weighted`` proposes heaviest edges (AWPM's initialisation). One
    readback a round; ``maximal_matching.last_run`` counts the rounds.
    Reference: ``BPMaximalMatching.h``."""
    require_local(A.grid, "maximal_matching", 4)
    grid = A.grid
    nr, nc = A.nrows, A.ncols
    Aid = _colid_matrix(A)
    Aw = A if weighted else None
    mate_row = DistVec.full(grid, nr, -1, torch.int32, align="row").blocks
    mate_col = DistVec.full(grid, nc, -1, torch.int32, align="col").blocks
    rounds = 0
    while True:
        nnew_total = 0
        if karp_sipser:
            mate_row, mate_col, nnew = _matching_round(Aid, Aw, mate_row, mate_col, True,
                                                       heaviest=weighted)
            nnew_total += int(nnew)
            rounds += 1
        if nnew_total == 0:
            mate_row, mate_col, nnew = _matching_round(Aid, Aw, mate_row, mate_col, False,
                                                       heaviest=weighted)
            nnew_total += int(nnew)
            rounds += 1
        if nnew_total == 0:
            break
    maximal_matching.last_run = {"rounds": rounds}
    return (DistVec(blocks=mate_row, length=nr, align="row", grid=grid),
            DistVec(blocks=mate_col, length=nc, align="col", grid=grid))


# the last call's propose/grant rounds (one readback each)
maximal_matching.last_run = None


def _mcm_phase(AT: SpParMat, mate_row: DistVec, mate_col: DistVec):
    """One augmenting phase: ``(mate_row', mate_col', n_augmented)``, the
    count a 0-dim int32 tensor. AT is Aᵀ with float32 ones (``[nc, nr]``,
    a square grid). ``_mcm_phase.last_run`` records the BFS depth and the
    layer readbacks."""
    grid = AT.grid
    nr, nc = AT.ncols, AT.nrows
    mr, mc = mate_row, mate_col
    dev = grid.device

    row_gids = DistVec.iota(grid, nr, align="row")
    col_gids = DistVec.iota(grid, nc, align="col")
    ifree_row = mr.blocks < 0

    def vec(blocks, length, align):
        return DistVec(blocks=blocks, length=length, align=align, grid=grid)

    def full_i32(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    # --- the alternating-layer BFS: one readback a layer ---------------------
    fr = torch.where(ifree_row & (row_gids.blocks < nr), row_gids.blocks, I32MAX)
    col_parent = full_i32(mc.blocks.shape, -1)
    col_seen = torch.zeros(mc.blocks.shape, dtype=torch.bool, device=dev)
    found, nonempty, depth = False, True, 0
    while (not found) and nonempty and depth < nr + 2:
        reach = dist_spmv(SELECT2ND_MIN, AT, vec(fr, nr, "row"))
        newc = (reach.blocks != I32MAX) & ~col_seen & (col_gids.blocks < nc)
        col_parent = torch.where(newc, reach.blocks, col_parent)
        col_seen = col_seen | newc
        free_new = newc & (mc.blocks < 0)
        # next frontier: the matched rows of the newly seen matched columns
        nxt_rows = torch.where(newc & (mc.blocks >= 0), mc.blocks, -1)
        fr = vec(full_i32(mr.blocks.shape, I32MAX), nr, "row").scatter_combine(
            SELECT2ND_MIN, idx=vec(nxt_rows, nc, "col"),
            src=vec(torch.where(nxt_rows >= 0, nxt_rows, I32MAX), nc, "col")).blocks
        flags = torch.stack([free_new.any(), (fr != I32MAX).any()]).cpu()
        found, nonempty = bool(flags[0]), bool(flags[1])
        depth += 1
    _mcm_phase.last_run = {"depth": depth, "readbacks": depth}
    if not found:  # no candidate path: the chases would change nothing
        return mr, mc, torch.zeros((), dtype=torch.int32, device=dev)
    col_parent_v = vec(col_parent, nc, "col")

    # --- the parallel back-chase (3 passes over the parent chains) -----------
    cand = col_seen & (mc.blocks < 0) & (col_gids.blocks < nc)
    path_id = torch.where(cand, col_gids.blocks, I32MAX)  # lane = free col

    def chase(step_fn, carry):
        """Walk every candidate chain at once, ``depth + 1`` steps (the
        reference's bound; a dead lane changes nothing)."""
        cur = torch.where(cand, col_gids.blocks, 0)
        alive = cand
        for step in range(depth + 1):
            r = col_parent_v.gather(vec(cur, nc, "col")).blocks
            r = torch.where(alive, r, -1)
            carry = step_fn(carry, cur, r, alive, step)
            nxt = mr.gather(vec(torch.where(r >= 0, r, 0), nr, "col")).blocks
            cont = alive & (r >= 0) & (nxt >= 0)
            cur = torch.where(cont, nxt, cur)
            alive = cont
        return carry

    # pass 1: claim rows (the least path id wins each row)
    def claim_step(claims, cur, r, alive, step):
        return claims.scatter_combine(SELECT2ND_MIN, idx=vec(torch.where(alive, r, -1), nc, "col"),
                                      src=vec(path_id, nc, "col"))

    claims = chase(claim_step, vec(full_i32(mr.blocks.shape, I32MAX), nr, "row"))

    # pass 2: a path survives iff it won every row of its chain
    def check_step(ok, cur, r, alive, step):
        won = claims.gather(vec(torch.where(r >= 0, r, 0), nr, "col")).blocks
        return ok & torch.where(alive, won == path_id, True)

    survive = chase(check_step, cand)

    # pass 3: augment the surviving (disjoint) paths at once
    def aug_step(mrmc, cur, r, alive, step):
        mrb, mcb = mrmc
        act = alive & survive & (r >= 0)
        mrb = mrb.scatter_combine(SELECT2ND_MIN, idx=vec(torch.where(act, r, -1), nc, "col"),
                                  src=vec(torch.where(act, cur, I32MAX), nc, "col"))
        mcb = mcb.scatter_combine(SELECT2ND_MIN, idx=vec(torch.where(act, cur, -1), nc, "col"),
                                  src=vec(torch.where(act, r, I32MAX), nc, "col"))
        return mrb, mcb

    upd_r0 = vec(full_i32(mr.blocks.shape, I32MAX), nr, "row")
    upd_c0 = vec(full_i32(mc.blocks.shape, I32MAX), nc, "col")
    upd_r, upd_c = chase(aug_step, (upd_r0, upd_c0))
    mr2 = torch.where(upd_r.blocks != I32MAX, upd_r.blocks, mr.blocks)
    mc2 = torch.where(upd_c.blocks != I32MAX, upd_c.blocks, mc.blocks)
    n_aug = (survive & cand).sum(dtype=torch.int32)
    return vec(mr2, nr, "row"), vec(mc2, nc, "col"), n_aug


_mcm_phase.last_run = None


def maximum_matching_device(A: SpParMat, init: tuple | None = None) -> tuple[DistVec, DistVec]:
    """Maximum-cardinality matching, augmented on the device (``_mcm_phase``
    until a phase augments nothing; one count readback a phase beside the
    BFS's). ``maximum_matching_device.last_run`` records the phases, the
    BFS depth of each and the readbacks. Reference:
    ``BPMaximumMatching.cpp:124-188``."""
    require_local(A.grid, "maximum_matching_device", 4)
    mate_row, mate_col = init if init is not None else maximal_matching(A)
    AT = A.transpose().apply(ones_f32)
    depths, readbacks = [], 0
    while True:
        mate_row, mate_col, n_aug = _mcm_phase(AT, mate_row, mate_col)
        depths.append(_mcm_phase.last_run["depth"])
        readbacks += _mcm_phase.last_run["readbacks"] + 1
        if int(n_aug) == 0:
            break
    maximum_matching_device.last_run = {"phases": len(depths), "depths": depths,
                                        "readbacks": readbacks}
    return mate_row, mate_col


maximum_matching_device.last_run = None


def maximum_matching(A: SpParMat, init: tuple | None = None, *,
                     device: bool = True) -> tuple[DistVec, DistVec]:
    """Maximum-cardinality matching by augmenting-path phases.
    ``device=True``: ``maximum_matching_device``. ``device=False``: the
    host-augmentation oracle (a distributed structural sweep a layer, a
    serial augment on the host over gathered pointer arrays)."""
    require_local(A.grid, "maximum_matching", 4)
    if device:
        return maximum_matching_device(A, init=init)
    grid = A.grid
    nr, nc = A.nrows, A.ncols
    mate_row, mate_col = init if init is not None else maximal_matching(A)
    mr = np.asarray(mate_row.to_global()).copy().astype(np.int64)
    mc = np.asarray(mate_col.to_global()).copy().astype(np.int64)
    AT = A.transpose().apply(ones_f32)
    # host CSC adjacency for the path reconstruction
    ar, ac, _ = A.to_global_coo()
    order = np.argsort(ac, kind="stable")
    ar_sorted = ar[order]
    col_ptr = np.searchsorted(ac[order], np.arange(nc + 1))

    def col_neighbors(j):
        return ar_sorted[col_ptr[j]: col_ptr[j + 1]]

    while True:
        col_parent = np.full(nc, -1, np.int64)
        col_seen = np.zeros(nc, bool)
        frontier_rows = np.nonzero(mr < 0)[0]
        found_free_cols: np.ndarray = np.array([], np.int64)
        guard = 0
        while len(frontier_rows) and guard <= nc + 1:
            guard += 1
            fmask = np.zeros(nr, np.float32)
            fmask[frontier_rows] = 1.0
            fr = DistVec.from_global(grid, fmask, align="col", fill=0)
            reach = dist_spmv(PLUS_TIMES, AT, fr)  # length nc, row-aligned
            reached = (np.asarray(reach.to_global()) > 0) & ~col_seen
            newcols = np.nonzero(reached)[0]
            if len(newcols) == 0:
                break
            in_frontier = np.zeros(nr, bool)
            in_frontier[frontier_rows] = True
            for j in newcols:  # the least adjacent frontier row
                nbrs = col_neighbors(j)
                col_parent[j] = nbrs[in_frontier[nbrs]].min()
            col_seen[newcols] = True
            free_new = newcols[mc[newcols] < 0]
            if len(free_new):
                found_free_cols = free_new
                break
            frontier_rows = mc[newcols]
        if len(found_free_cols) == 0:
            break
        used_rows: set[int] = set()
        augmented = 0
        for j in found_free_cols:
            path = []
            cj = int(j)
            ok = True
            while True:
                ri = int(col_parent[cj])
                if ri < 0 or ri in used_rows:
                    ok = False
                    break
                path.append((ri, cj))
                if mr[ri] < 0:
                    break
                cj = int(mr[ri])
            if not ok:
                continue
            for ri, _ in path:
                used_rows.add(ri)
            for ri, cj in path:
                mr[ri] = cj
                mc[cj] = ri
            augmented += 1
        if augmented == 0:
            break

    return (DistVec.from_global(grid, mr.astype(np.int32), align="row", fill=-1),
            DistVec.from_global(grid, mc.astype(np.int32), align="col", fill=-1))


def awpm(A: SpParMat) -> tuple[DistVec, DistVec]:
    """Approximate-weight perfect matching: heaviest-edge Karp-Sipser
    initialisation + cardinality augmentation (the composition of the
    reference's AWPM application, ``ApproxWeightPerfectMatching.h``)."""
    require_local(A.grid, "awpm", 4)
    init = maximal_matching(A, karp_sipser=True, weighted=True)
    return maximum_matching(A, init=init)


# --- host validation helpers (tests and scripts) ---------------------------------


def matching_weight(A_dense, mate_row) -> float:
    mr = np.asarray(mate_row)
    return float(sum(np.asarray(A_dense)[i, j] for i, j in enumerate(mr) if j >= 0))


def is_valid_matching(A_dense, mate_row, mate_col) -> bool:
    mr, mc = np.asarray(mate_row), np.asarray(mate_col)
    cols_used = [j for j in mr if j >= 0]
    if len(cols_used) != len(set(cols_used)):
        return False
    for i, j in enumerate(mr):
        if j >= 0 and (not A_dense[i, j] or mc[j] != i):
            return False
    return all(i < 0 or mr[i] == j for j, i in enumerate(mc))


def is_maximal(A_dense, mate_row, mate_col) -> bool:
    mr, mc = np.asarray(mate_row), np.asarray(mate_col)
    A_dense = np.asarray(A_dense)
    for i in range(len(mr)):
        if mr[i] < 0:
            for j in np.nonzero(A_dense[i])[0]:
                if mc[j] < 0:
                    return False
    return True
