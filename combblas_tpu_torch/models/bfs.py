"""Graph500 batched BFS — counterpart of the batched, level-compressed
search in ``combblas_tpu/models/bfs.py``.

``bfs_batch_compact`` searches from W roots at once over an ``EllParMat``:
int8 frontiers through the level loop, parents rebuilt in one pass after
it (per vertex and root the max-id in-neighbour one level up, so the tree
is deterministic). ``batch_traversed_edges`` counts the Graph500 kernel-2
edges per root and ``validate_bfs_device`` checks the trees on the device.
Every array is an integer or a bool: results equal the reference's bit for
bit.

The reference runs the level loop as one device program
(``lax.while_loop``, ``lax.cond``); here it is a host loop that reads one
flag per level back from the device (and, with the CSC budgets, the
union frontier's column and edge counts). ``bfs_batch_compact.last_run``
records those readbacks and the step each level took.

Not ported yet: ``bfs``, ``bfs_diropt``, ``bfs_batch`` (ROADMAP queue 1,
item 9), ``bfs_single`` and ``single_traversed_edges`` (item 7).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..parallel.ellmat import (
    EllParMat,
    _ell_levels_step,
    _ell_parents_from_levels,
    _ell_union_sparse_step,
    _gather_rows,
    _scatter_rows_max,
)
from ..parallel.vec import DistMultiVec
from . import PAD_ROOT

MAX_LEVELS = 126  # levels are int8


def _global_ids(grid, nblocks: int, block_len: int, length: int, align: str) -> torch.Tensor:
    """int32 [nblocks, block_len] global ids, -1 in the padding slots."""
    gids = torch.arange(
        nblocks * block_len, dtype=torch.int32, device=grid.device
    ).reshape(nblocks, block_len)
    return torch.where(gids < length, gids, -1)


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

    ``ring=True`` (the reference's carousel fold across devices, same
    result) is not ported.
    """
    if ring:
        raise NotImplementedError(
            "the ring (carousel) fold is a schedule across devices and is not "
            "ported yet (ROADMAP queue 1, item 12); its result equals ring=False"
        )
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
