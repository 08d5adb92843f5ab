"""EllParMat — degree-bucketed sliced ELL, counterpart of
``combblas_tpu/parallel/ellmat.py``.

Rows are grouped by degree class on a width ladder (1, 2, 3, 4, 6, 8, 12,
...; ``_width_ladder``); bucket b stores its rows densely as ``[nb, kb]``
with kb = ladder[b]. Every row's entries live in one bucket (a row wider
than ``max_k`` spans several bucket rows of it), each bucket's fold is a
dense reduction over its k axis, and the results combine by row id.

Ported: the host build (numpy, byte-equal to the reference's), the CSC /
CSR companions, the SpMV family (``dist_spmv_ell``, ``dist_spmv_ell_masked``
and their ``_multi`` forms over W stacked vectors, ``EllParMat.reduce``,
``from_spmat``, the shared gather-contract kernel ``_ell_local_spmm``) and
the three steps of the batched level-compressed BFS (``_ell_levels_step``,
``_ell_union_sparse_step``, ``_ell_parents_from_levels``). The reference
runs each of them as one program per device of a pr×pc mesh; here the
tiles of a grid live on one device and are walked in a loop, and where the
reference reduces over the grid's column axis a running ``sr.add`` combines
the tiles of a grid row in column order 0..pc-1. Integer and min/max
results equal the reference's bit for bit; a float ``plus_times`` sum may
differ in its last bits (the order of ``index_add_`` on CUDA is not fixed).

Scatters that the reference runs with ``mode="drop"`` (padding bucket rows
hold row id ``local_rows``) go to a sink row ``local_rows`` that is cut
off afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.segment import expand_ranges, fix_signed_zeros, float_bits, segment_reduce
from ..semiring import SELECT2ND_MAX, Semiring
from ..tuner import config as tuner_config
from .collectives import axis_ring_reduce
from .grid import Grid, HostGrid, check_length, fold_grid, require_local
from .spmat import bucket_by_tile
from .vec import DistMultiVec, DistVec

# Byte envelopes of one gather intermediate ([rows, kb, W] int8) in the
# level step and in the parents pass (whose int32 candidates take four
# times the bytes of the gather they are made from): `_bucket_row_slices`
# cuts a bucket into row slices that stay under them. Chosen on an H100
# 80GB at Graph500 scale 20, W = 256 (PERF.md, section 6): both steps run
# within 1% of their time at envelopes four times as large, and the
# search's peak memory halves.
LEVELS_BUDGET_BYTES = 1 << 30
PARENTS_BUDGET_BYTES = 1 << 29
# The same envelope for the SpMV family's gather ([rows, kb, F] of the
# input's dtype), at the level step's value; the reference's is 4 GB.
SPMV_BUDGET_BYTES = 1 << 30


def _put(grid: Grid, x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(grid.device)


@dataclasses.dataclass(frozen=True)
class EllParMat:
    """buckets: tuple of (cols int32 [pr, pc, nb, kb], vals [pr, pc, nb, kb],
    rowids int32 [pr, pc, nb]) — one entry per populated degree class.

    Padding: col slots hold local_cols (they gather the appended inert
    row), padded bucket rows hold rowid = local_rows (the sink row of the
    result scatter).
    """

    buckets: tuple
    nrows: int
    ncols: int
    grid: Grid

    def __post_init__(self):
        require_local(self.grid, "EllParMat", 1)

    @property
    def local_rows(self) -> int:
        return self.grid.local_rows(self.nrows)

    @property
    def local_cols(self) -> int:
        return self.grid.local_cols(self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.buckets[0][1].dtype if self.buckets else torch.float32

    def getnnz(self) -> torch.Tensor:
        """Stored entries (a 0-dim device tensor)."""
        lc = self.local_cols
        total = torch.zeros((), dtype=torch.int64, device=self.grid.device)
        for bc, _, _ in self.buckets:
            total = total + (bc < lc).sum()
        return total

    @staticmethod
    def from_host_coo(
        grid: Grid, rows, cols, vals, nrows: int, ncols: int,
        max_k: int | None = None, ladder: str = "fine", headroom: float | None = None,
    ) -> "EllParMat":
        """Build from host global COO: numpy, then one upload per array.
        See ``host_build`` for ``max_k``, ``ladder`` and ``headroom``."""
        host = EllParMat.host_build(
            grid, rows, cols, vals, nrows, ncols, max_k=max_k, ladder=ladder,
            headroom=headroom,
        )
        return EllParMat.from_host_buckets(grid, host, nrows, ncols)

    @staticmethod
    def from_host_buckets(grid: Grid, host_buckets, nrows: int, ncols: int) -> "EllParMat":
        """Upload host bucket arrays (``host_build``'s output)."""
        return EllParMat(
            buckets=tuple(tuple(_put(grid, a) for a in b) for b in host_buckets),
            nrows=int(nrows), ncols=int(ncols), grid=grid,
        )

    @staticmethod
    def host_build(
        grid: HostGrid, rows, cols, vals, nrows: int, ncols: int,
        max_k: int | None = None, ladder: str = "fine", headroom: float | None = None,
    ):
        """Host-only bucket construction: a list of (bc, bv, br) numpy
        arrays, ``[pr, pc, nb, kb]`` int32, ``[pr, pc, nb, kb]`` of
        ``vals.dtype`` and ``[pr, pc, nb]`` int32.

        ``max_k`` caps a bucket's width (default: local_cols); a row with
        more entries spans several bucket rows, whose partial folds
        recombine in the result scatter. ``ladder``: ``"fine"`` is the
        1.5-step ladder, ``"coarse"`` powers of two (fewer classes, more
        padding). ``headroom`` adds ``ceil(nb * headroom)`` free padding
        rows to every class (negative values count as 0); ``None`` reads
        ``COMBBLAS_DYNAMIC_HEADROOM`` (default 0, ``tuner.config``).
        """
        headroom = tuner_config.dynamic_headroom(headroom)
        vals = np.asarray(vals)
        rows, cols, order, counts, starts, _cap, lr, lc = bucket_by_tile(
            grid, rows, cols, nrows, ncols, None
        )
        vals = vals[order]
        pr_, pc_ = grid.pr, grid.pc
        if max_k is None:
            max_k = max(int(lc), 1)

        # Per tile: row-sort, then cut every nonempty row into chunks
        # (class, row, start, take) with take <= max_k.
        widths = _width_ladder(max_k, ladder)
        per_tile = []
        classes = set()
        for t in range(grid.size):
            s0, e0 = starts[t], starts[t + 1]
            r = rows[s0:e0] - (t // pc_) * lr
            c = cols[s0:e0] - (t % pc_) * lc
            v = vals[s0:e0]
            o = np.argsort(r, kind="stable")
            r, c, v = r[o], c[o], v[o]
            ptr = np.searchsorted(r, np.arange(lr + 1))
            deg = ptr[1:] - ptr[:-1]
            nz = np.nonzero(deg)[0]
            d_nz, s_nz = deg[nz], ptr[:-1][nz]
            nchunks = -(-d_nz // max_k)
            rep_row = np.repeat(nz, nchunks)
            rep_deg = np.repeat(d_nz, nchunks)
            rep_start = np.repeat(s_nz, nchunks)
            # chunk index within each row: global arange minus per-row base
            base = np.repeat(np.concatenate([[0], np.cumsum(nchunks)])[:-1], nchunks)
            chunk = np.arange(len(rep_row)) - base
            take = np.minimum(rep_deg - chunk * max_k, max_k).astype(np.int64)
            start = rep_start + chunk * max_k
            cls = np.searchsorted(widths, take)
            classes.update(np.unique(cls).tolist())
            per_tile.append((cls, rep_row, start, take, c, v))

        buckets = []
        for b in sorted(classes):
            kb = int(widths[b])
            nb = max(int((pt[0] == b).sum()) for pt in per_tile)
            nb = max(nb, 1)
            if headroom > 0:
                nb += int(np.ceil(nb * headroom))
            bc = np.full((pr_, pc_, nb, kb), lc, np.int32)
            bv = np.zeros((pr_, pc_, nb, kb), vals.dtype)
            br = np.full((pr_, pc_, nb), lr, np.int32)
            for t, (cls, rrow, rstart, rtake, c, v) in enumerate(per_tile):
                i, j = divmod(t, pc_)
                sel = cls == b
                if not sel.any():
                    continue
                srow, sstart, stake = rrow[sel], rstart[sel], rtake[sel]
                m = len(srow)
                # [m, kb] index matrix into the tile's sorted entry arrays
                idx = sstart[:, None] + np.arange(kb)[None, :]
                valid = np.arange(kb)[None, :] < stake[:, None]
                idx = np.where(valid, idx, 0)
                bc[i, j, :m] = np.where(valid, c[idx], lc)
                bv[i, j, :m] = np.where(valid, v[idx], 0)
                br[i, j, :m] = srow
            buckets.append((bc, bv, br))
        return buckets

    @staticmethod
    def from_spmat(A, max_k: int | None = None, ladder: str = "fine") -> "EllParMat":
        """Convert a ``SpParMat`` (read back to the host, then
        ``from_host_coo``)."""
        require_local(A.grid, "EllParMat", 1)
        r, c, v = A.to_global_coo()
        return EllParMat.from_host_coo(
            A.grid, r, c, v, A.nrows, A.ncols, max_k=max_k, ladder=ladder
        )

    def reduce(self, sr: Semiring, axis: str, map_fn=None) -> DistVec:
        """Row-wise fold (``axis="cols"`` → a row-aligned DistVec), e.g.
        degrees with ``map_fn=ones_i32``. Other axes raise: column folds
        belong to the SpParMat the ELL was converted from."""
        if axis != "cols":
            raise ValueError(f"EllParMat.reduce supports axis='cols' only, got {axis!r}")
        return _ell_reduce_rows(self, sr, map_fn)

    def to_host_coo(self):
        """Read the buckets back and rebuild the global COO sorted by
        (row, col): ``(rows, cols, vals)`` numpy arrays, independent of
        the bucket layout."""
        lr, lc = self.local_rows, self.local_cols
        rows_all, cols_all, vals_all = [], [], []
        for bc, bv, br in self.buckets:
            bc, bv, br = (x.cpu().numpy() for x in (bc, bv, br))
            pr_, pc_ = bc.shape[0], bc.shape[1]
            valid = (bc < lc) & (br[..., None] < lr)
            gr = np.broadcast_to(
                (np.arange(pr_, dtype=np.int64)[:, None, None] * lr + br)[..., None],
                bc.shape,
            )
            gc = np.arange(pc_, dtype=np.int64)[None, :, None, None] * lc + bc
            rows_all.append(gr[valid])
            cols_all.append(gc[valid])
            vals_all.append(bv[valid])
        if not rows_all:
            return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32)
        r = np.concatenate(rows_all)
        c = np.concatenate(cols_all)
        v = np.concatenate(vals_all)
        order = np.argsort(r * np.int64(self.ncols) + c, kind="stable")
        return r[order], c[order], v[order]


def _width_ladder(max_k: int, kind: str = "fine") -> np.ndarray:
    """Bucket widths up to and including max_k. "fine": 1, 2, 3, 4, 6, 8,
    12, ... (alternating ×1.5 and ×4/3 steps); "coarse": powers of two."""
    if kind not in ("fine", "coarse"):
        raise ValueError(f"ladder must be 'fine' or 'coarse', got {kind!r}")
    if kind == "coarse":
        widths = [1]
        while widths[-1] < max_k:
            widths.append(widths[-1] * 2)
    else:
        widths = [1, 2]
        while widths[-1] < max_k:
            n = widths[-1]
            widths.append(n * 3 // 2 if (n & (n - 1)) == 0 else n * 4 // 3)
    widths = [w for w in widths if w <= max_k]
    if not widths or widths[-1] != max_k:
        widths.append(max_k)
    return np.asarray(widths, np.int64)


# --- CSC / CSR companions (column and row walks) ----------------------------


def build_csc_companion(grid: Grid, rows, cols, nrows: int, ncols: int):
    """Per-tile CSC structure for column walks, on the grid's device:
    (indptr [pr, pc, lc+1], rowidx [pr, pc, cap]) int32, cap = the largest
    tile's entry count."""
    return upload_csc_companion(
        grid, *build_csc_companion_host(grid, rows, cols, nrows, ncols)
    )


def upload_csc_companion(grid: Grid, indptr, rowidx):
    """Upload host companion arrays (``build_csc_companion_host``)."""
    return _put(grid, indptr), _put(grid, rowidx)


def build_csr_companion(grid: Grid, rows, cols, nrows: int, ncols: int):
    """Row-major twin of ``build_csc_companion``: (indptr [pr, pc, lr+1],
    colidx [pr, pc, cap])."""
    return upload_csc_companion(
        grid, *build_csr_companion_host(grid, rows, cols, nrows, ncols)
    )


def build_csr_companion_host(grid: HostGrid, rows, cols, nrows: int, ncols: int):
    return _companion_host(grid, rows, cols, nrows, ncols, major="row")


def build_csc_companion_host(grid: HostGrid, rows, cols, nrows: int, ncols: int):
    return _companion_host(grid, rows, cols, nrows, ncols, major="col")


def _companion_host(grid, rows, cols, nrows, ncols, *, major):
    """Per tile: sort the tuples by the major axis, indptr over that axis,
    minor indices padded with the minor block size as the inert sentinel."""
    rows, cols, order, counts, starts, _cap, lr, lc = bucket_by_tile(
        grid, rows, cols, nrows, ncols, None
    )
    pr_, pc_ = grid.pr, grid.pc
    cap = max(int(counts.max()), 1)
    lmaj, lmin = (lr, lc) if major == "row" else (lc, lr)
    indptr = np.zeros((pr_, pc_, lmaj + 1), np.int32)
    minidx = np.full((pr_, pc_, cap), lmin, np.int32)
    for t in range(grid.size):
        i, j = divmod(t, pc_)
        s0, e0 = starts[t], starts[t + 1]
        r = rows[s0:e0] - i * lr
        c = cols[s0:e0] - j * lc
        maj, mino = (r, c) if major == "row" else (c, r)
        o = np.argsort(maj, kind="stable")
        indptr[i, j] = np.searchsorted(maj[o], np.arange(lmaj + 1))
        minidx[i, j, : e0 - s0] = mino[o]
    return indptr, minidx


# --- the SpMV family ---------------------------------------------------------


def _tile_buckets(E: EllParMat, i: int, j: int):
    return [(bc[i, j], bv[i, j], br[i, j]) for bc, bv, br in E.buckets]


def _bucket_fold(sr: Semiring, prods: torch.Tensor) -> torch.Tensor:
    """Fold ``prods`` over its axis 1 with ``sr.add``."""
    kind = sr.add_kind
    if kind == "sum":
        return prods.sum(dim=1, dtype=prods.dtype)
    if kind in ("min", "max"):
        fold = torch.amin if kind == "min" else torch.amax
        out = fold(prods, dim=1)
        if out.is_floating_point():
            out = fix_signed_zeros(out, fold(float_bits(prods), dim=1), kind)
        return out
    while prods.shape[1] > 1:  # any other monoid: a pairwise tree
        if prods.shape[1] % 2:
            pad = prods.new_full((prods.shape[0], 1, *prods.shape[2:]), sr.zero(prods.dtype))
            prods = torch.cat([prods, pad], dim=1)
        prods = sr.add(prods[:, 0::2], prods[:, 1::2])
    return prods[:, 0]


def _scatter_rows(sr: Semiring, y: torch.Tensor, rowids: torch.Tensor,
                  yb: torch.Tensor) -> torch.Tensor:
    """Combine bucket results ``yb`` into ``y`` (which carries the sink row)
    by row id with ``sr.add``. Split hub rows repeat inside a bucket, so
    every form combines repeated ids: ``index_add_``, ``scatter_reduce_``,
    or, for any other monoid, a segment reduction added in."""
    kind = sr.add_kind
    if kind == "sum":
        return y.index_add_(0, rowids.long(), yb)
    if kind in ("min", "max"):
        index = rowids.long().view(-1, *[1] * (yb.dim() - 1)).expand_as(yb)
        reduce = "amin" if kind == "min" else "amax"
        bits = None
        if y.is_floating_point():
            bits = float_bits(y).clone()
            bits.scatter_reduce_(0, index, float_bits(yb), reduce)
        y.scatter_reduce_(0, index, yb, reduce)
        return y if bits is None else fix_signed_zeros(y, bits, kind)
    return sr.add(y, segment_reduce(sr, yb, rowids, y.shape[0]))


def _ell_local_spmm(sr: Semiring, buckets, x2: torch.Tensor, lr: int, lc: int,
                    backend: str) -> torch.Tensor:
    """[lr, F] semiring fold of one tile's buckets over a [lc, F] block:
    the gather-contract kernel of the batched SpMV (W frontier lanes) and
    of the SpMM (F feature lanes).

    Per bucket one gather fetches each neighbour's whole row ([rows, kb,
    F]), then the k axis contracts: backend ``"mxu_gather"`` (its callers
    admit it for ``plus_times`` only) as a batched ``torch.bmm`` ([1, kb] ×
    [kb, F] per bucket row; float32 stays exact with TF32 off, torch's
    default), backend ``"scatter"`` as ``_bucket_fold`` + ``_scatter_rows``
    (every semiring). Buckets are cut into row slices whose gather stays
    under ``SPMV_BUDGET_BYTES`` at F × itemsize bytes a slot.
    """
    F = x2.shape[1]
    zero = sr.zero(x2.dtype)
    xpad = torch.cat([x2, x2.new_full((1, F), zero)])
    payload = F * max(x2.element_size(), 1)
    y = None
    for bc, bv, br in buckets:
        nb_, kb = bc.shape
        if y is None and (nb_, kb) == (1, 1) and sr.add_kind == "sum":
            # The reference's first bucket of one row and one slot adds no
            # zero: XLA folds its ``+ 0.0`` start and one-row scatter away,
            # so the lone product is stored as is (a -0.0 stays -0.0).
            g = _gather_rows(xpad, torch.clamp(bc, max=lc))
            yb = sr.mul(bv[:, :, None], g)[:, 0, :]
            y = torch.full((lr + 1, F), zero, dtype=yb.dtype, device=x2.device)
            y.index_copy_(0, br.long(), yb)
            continue
        for s0, s1 in _bucket_row_slices(nb_, kb, payload, SPMV_BUDGET_BYTES):
            g = _gather_rows(xpad, torch.clamp(bc[s0:s1], max=lc))  # [rows, kb, F]
            if backend == "mxu_gather":
                # padding slots hold value 0 (host_build), so they drop out
                out_dtype = torch.promote_types(bv.dtype, x2.dtype)
                yb = torch.bmm(bv[s0:s1, None, :].to(out_dtype), g.to(out_dtype))[:, 0, :]
            else:
                yb = _bucket_fold(sr, sr.mul(bv[s0:s1, :, None], g))  # [rows, F]
            if y is None:
                y = torch.full((lr + 1, F), sr.zero(yb.dtype), dtype=yb.dtype,
                               device=x2.device)
            y = _scatter_rows(sr, y, br[s0:s1], yb.to(y.dtype))
    if y is None:
        return torch.full((lr, F), zero, dtype=x2.dtype, device=x2.device)
    return y[:lr]


def _ell_local_spmv(sr: Semiring, buckets, x: torch.Tensor, lr: int, lc: int) -> torch.Tensor:
    """[lr] semiring row fold of one tile over a [lc] block."""
    return _ell_local_spmm(sr, buckets, x[:, None], lr, lc, "scatter")[:, 0]


def _ell_local_spmv_multi(sr: Semiring, buckets, x2: torch.Tensor, lr: int,
                          lc: int) -> torch.Tensor:
    """[lr, W] semiring row fold over a [lc, W] block: one gathered index
    feeds all W lanes."""
    return _ell_local_spmm(sr, buckets, x2, lr, lc, "scatter")


def col_blocks(E: EllParMat, blocks: torch.Tensor) -> torch.Tensor:
    """A col-aligned operand ``[pc, L, ...]`` as tile columns
    ``[pc, E.local_cols, ...]``: block j then holds global columns
    ``j·lc .. (j+1)·lc - 1``, the range tile column j's buckets index.

    ``DistVec.realign("col")`` of a row-aligned vector cuts blocks of
    ``⌈pr·⌈n/pr⌉ / pc⌉``, which is longer than ``⌈n/pc⌉`` on some
    rectangular grids (4x2 with n = 9, 17, 33; 2x1 with n = 9), so its
    block j ≥ 1 starts late against tile column j. This re-cuts such an
    operand from its global order (the flattened blocks), keeping the
    first ``pc·lc`` slots; the padding slots past n are read by no stored
    entry. Where the blocks already have ``E.local_cols`` slots (every
    square grid) it returns ``blocks`` itself: no copy and no kernel.

    Deviation: on those grids the reference's ELL loops raise (its
    ``while_loop`` carry changes shape) or, in ``sssp_batch``'s step,
    return wrong distances; the port re-cuts and answers as scipy does.
    """
    lc = E.local_cols
    if blocks.shape[1] == lc:
        return blocks
    tail = blocks.shape[2:]
    flat = blocks.reshape(-1, *tail)[: E.grid.pc * lc]
    return flat.reshape(E.grid.pc, lc, *tail)


def _tile_fold(E: EllParMat, f, x_blocks):
    """The ``local(i, j)`` that ``fold_grid`` takes: ``f(tile (i, j)'s
    buckets, x_blocks[j])``, the blocks cut as tile columns
    (``col_blocks``)."""
    x_blocks = col_blocks(E, x_blocks)
    return lambda i, j: f(_tile_buckets(E, i, j), x_blocks[j])


def dist_spmv_ell(sr: Semiring, E: EllParMat, x: DistVec) -> DistVec:
    """y = E ⊗ x: x is taken col-aligned, y comes back row-aligned."""
    check_length(E, x)
    lr, lc = E.local_rows, E.local_cols
    blocks = fold_grid(sr, E.grid, _tile_fold(
        E, lambda b, xb: _ell_local_spmv(sr, b, xb, lr, lc), x.realign("col").blocks))
    return DistVec(blocks=blocks, length=E.nrows, align="row", grid=E.grid)


def dist_spmv_ell_masked(sr: Semiring, E: EllParMat, x: DistVec,
                         row_active: DistVec) -> DistVec:
    """y = E ⊗ x where ``row_active`` (bool) holds, ``sr.zero`` elsewhere;
    the mask applies to each tile's fold before the combine over tiles."""
    check_length(E, x)
    lr, lc = E.local_rows, E.local_cols
    blocks = fold_grid(sr, E.grid, _tile_fold(
        E, lambda b, xb: _ell_local_spmv(sr, b, xb, lr, lc), x.realign("col").blocks),
        row_active.realign("row").blocks)
    return DistVec(blocks=blocks, length=E.nrows, align="row", grid=E.grid)


def dist_spmv_ell_multi(sr: Semiring, E: EllParMat, X: DistMultiVec) -> DistMultiVec:
    """Y = E ⊗ X for W stacked vectors (``sssp_batch``'s step)."""
    check_length(E, X)
    lr, lc = E.local_rows, E.local_cols
    blocks = fold_grid(sr, E.grid, _tile_fold(
        E, lambda b, xb: _ell_local_spmv_multi(sr, b, xb, lr, lc), X.realign("col").blocks))
    return DistMultiVec(blocks=blocks, length=E.nrows, align="row", grid=E.grid)


def dist_spmv_ell_masked_multi(sr: Semiring, E: EllParMat, X: DistMultiVec,
                               row_active: DistMultiVec) -> DistMultiVec:
    """Y = E ⊗ X with a per-lane row mask (``bfs_batch``'s step)."""
    check_length(E, X)
    lr, lc = E.local_rows, E.local_cols
    blocks = fold_grid(sr, E.grid, _tile_fold(
        E, lambda b, xb: _ell_local_spmv_multi(sr, b, xb, lr, lc), X.realign("col").blocks),
        row_active.realign("row").blocks)
    return DistMultiVec(blocks=blocks, length=E.nrows, align="row", grid=E.grid)


def _ell_reduce_rows(E: EllParMat, sr: Semiring, map_fn) -> DistVec:
    """``EllParMat.reduce(sr, "cols", map_fn)``: each row's stored values
    (mapped by ``map_fn``) folded with ``sr.add``."""
    lr, lc = E.local_rows, E.local_cols

    def local(i, j):
        y = None
        for bc, bv, br in _tile_buckets(E, i, j):
            v = map_fn(bv) if map_fn is not None else bv
            zero = sr.zero(v.dtype)
            yb = _bucket_fold(sr, torch.where(bc < lc, v, zero))
            if y is None:
                y = torch.full((lr + 1,), zero, dtype=v.dtype, device=v.device)
            y = _scatter_rows(sr, y, br, yb)
        if y is None:  # no bucket: the dtype map_fn gives
            probe = torch.zeros((), dtype=E.dtype, device=E.grid.device)
            dtype = (map_fn(probe) if map_fn is not None else probe).dtype
            return torch.full((lr,), sr.zero(dtype), dtype=dtype, device=E.grid.device)
        return y[:lr]

    blocks = fold_grid(sr, E.grid, local)
    return DistVec(blocks=blocks, length=E.nrows, align="row", grid=E.grid)


# --- the steps of the batched level-compressed BFS --------------------------


def _bucket_row_slices(nb: int, kb: int, W: int, budget_bytes: int):
    """Row-slice bounds that keep a [rows, kb] gather intermediate of W
    bytes a slot (W int8 lanes, or F lanes × itemsize) under about
    ``budget_bytes``. torch materialises the gather's output (and the
    candidates made from it), so an unsliced hub bucket at W = 256 would
    allocate gigabytes."""
    rows_per = max(budget_bytes // max(kb * max(W, 1), 1), 1)
    return [(s0, min(s0 + rows_per, nb)) for s0 in range(0, nb, rows_per)]


def _scatter_rows_max(y: torch.Tensor, rows: torch.Tensor, yb: torch.Tensor) -> None:
    """``y[rows[m]] = max(y[rows[m]], yb[m])`` in place, row ids repeated or
    not (a row wider than max_k has several bucket rows). ``y`` carries the
    sink row that padding bucket rows point at."""
    index = rows.long()[:, None].expand(-1, yb.shape[1])
    y.scatter_reduce_(0, index, yb, "amax", include_self=True)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an int32 index tensor of any shape: [*idx.shape, W]."""
    return table.index_select(0, idx.reshape(-1)).view(*idx.shape, table.shape[1])


def _ell_levels_step(E: EllParMat, x8: torch.Tensor,
                     undiscovered8: torch.Tensor) -> torch.Tensor:
    """One batched BFS level over int8 indicator frontiers.

    x8: [pc, lc, W] int8 col-aligned (1 = in frontier); undiscovered8:
    [pr, lr, W] int8 row-aligned (1 = not yet discovered). Returns
    reached8 [pr, lr, W]: 1 where an undiscovered row has a frontier
    in-neighbour. The gather payload is W bytes per stored slot.
    A grid row's tile results are folded in the carousel's order
    (``collectives.axis_ring_reduce``), the reference's ``ring=True``; its
    grid-order fold (``ring=False``) gives the same bits, as max commutes.
    """
    lr, lc = E.local_rows, E.local_cols
    x8 = col_blocks(E, x8)
    W = x8.shape[2]
    out = []
    for i in range(E.grid.pr):
        ys = []
        for j in range(E.grid.pc):
            xpad = torch.cat([x8[j], x8.new_zeros((1, W))])
            y = x8.new_zeros((lr + 1, W))
            for bc, _bv, br in E.buckets:
                bc, br = bc[i, j], br[i, j]
                nb_, kb = bc.shape
                for s0, s1 in _bucket_row_slices(nb_, kb, W, LEVELS_BUDGET_BYTES):
                    g = _gather_rows(xpad, torch.clamp(bc[s0:s1], max=lc))  # [rows, kb, W]
                    _scatter_rows_max(y, br[s0:s1], g.amax(dim=1))
            ys.append(torch.minimum(y[:lr], undiscovered8[i]))  # only undiscovered rows fire
        out.append(axis_ring_reduce(SELECT2ND_MAX, ys))
    return torch.stack(out)


def _ell_parents_from_levels(E: EllParMat, levels_col: torch.Tensor,
                             levels_row: torch.Tensor) -> torch.Tensor:
    """Parent reconstruction: for every (row, root) the max-id in-neighbour
    whose level is exactly level(row) - 1, else -1.

    levels_col: [pc, lc, W] int8 (col-aligned levels, -1 undiscovered);
    levels_row: [pr, lr, W]. Returns int32 [pr, lr, W]. One pass over the
    matrix with a W-byte gather payload.
    """
    lr, lc = E.local_rows, E.local_cols
    levels_col = col_blocks(E, levels_col)
    W = levels_col.shape[2]
    out = []
    for i in range(E.grid.pr):
        lvl_r = levels_row[i]
        # rows at level 0 (roots) or undiscovered never match
        want = torch.where(lvl_r > 0, lvl_r - 1, torch.full_like(lvl_r, -2))
        acc = None
        for j in range(E.grid.pc):
            cpad = torch.cat([levels_col[j], levels_col.new_full((1, W), -1)])
            y = torch.full((lr + 1, W), -1, dtype=torch.int32, device=cpad.device)
            for bc, _bv, br in E.buckets:
                bc, br = bc[i, j], br[i, j]
                nb_, kb = bc.shape
                for s0, s1 in _bucket_row_slices(nb_, kb, W, PARENTS_BUDGET_BYTES):
                    safe = torch.clamp(bc[s0:s1], max=lc)
                    g = _gather_rows(cpad, safe)  # [rows, kb, W] neighbour levels
                    brs = br[s0:s1]
                    wantb = want.index_select(0, torch.clamp(brs, max=lr - 1))[:, None, :]
                    gid = (safe + j * lc)[:, :, None]
                    cand = torch.where(g == wantb, gid, -1)  # int32 [rows, kb, W]
                    _scatter_rows_max(y, brs, cand.amax(dim=1))
            acc = y[:lr] if acc is None else torch.maximum(acc, y[:lr])
        out.append(acc)
    return torch.stack(out)


def _ell_union_sparse_step(
    E: EllParMat, csc_indptr: torch.Tensor, csc_rowidx: torch.Tensor,
    x8: torch.Tensor, undiscovered8: torch.Tensor,
    frontier_capacity: int, edge_capacity: int,
) -> torch.Tensor:
    """One batched BFS level that touches only the columns of the union
    frontier: compact the active columns of each tile into
    ``frontier_capacity`` slots, walk their CSC ranges in ``edge_capacity``
    slots (``expand_ranges``) and scatter-max the frontier bytes into the
    target rows. The caller guarantees the budgets (``bfs_batch_compact``
    checks them each level); what exceeds them is dropped. Semantics equal
    ``_ell_levels_step``'s.
    """
    lr, lc = E.local_rows, E.local_cols
    x8 = col_blocks(E, x8)
    W = x8.shape[2]
    dev = x8.device
    cap = csc_rowidx.shape[2]
    col_ids = torch.arange(lc, dtype=torch.int32, device=dev)
    out = []
    for i in range(E.grid.pr):
        acc = None
        for j in range(E.grid.pc):
            indptr, rowid, x = csc_indptr[i, j], csc_rowidx[i, j], x8[j]
            act = x.amax(dim=1) > 0  # [lc] union frontier
            # compact the active local columns into frontier_capacity slots
            pos = torch.cumsum(act, 0, dtype=torch.int32) - 1
            slot = torch.where(act, pos, frontier_capacity).clamp_(max=frontier_capacity)
            fcols = torch.full((frontier_capacity + 1,), lc, dtype=torch.int32, device=dev)
            fcols[slot.long()] = col_ids
            fcols = fcols[:frontier_capacity]
            fcols_l = fcols.long()
            ipt_pad = torch.cat([indptr, indptr[-1:]])
            deg = torch.where(fcols < lc, ipt_pad[fcols_l + 1] - ipt_pad[fcols_l], 0)
            owner, offset, valid, _ = expand_ranges(deg, edge_capacity)
            src_col = torch.clamp(fcols.index_select(0, owner), max=lc)  # local col per edge
            entry = torch.clamp(ipt_pad.index_select(0, src_col) + offset, max=cap - 1)
            tgt_row = torch.where(valid, rowid.index_select(0, entry), lr)
            # per-root frontier value of the edge's source column: [Ecap, W]
            xpad = torch.cat([x, x.new_zeros((1, W))])
            contrib = xpad.index_select(0, src_col) * valid[:, None]
            y = x.new_zeros((lr + 1, W))
            _scatter_rows_max(y, tgt_row, contrib)
            y = torch.minimum(y[:lr], undiscovered8[i])
            acc = y if acc is None else torch.maximum(acc, y)
        out.append(acc)
    return torch.stack(out)
