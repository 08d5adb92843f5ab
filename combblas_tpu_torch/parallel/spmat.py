"""SpParMat — sparse matrix over a pr×pc grid, counterpart of
``combblas_tpu/parallel/spmat.py``.

Tiles are stacked as ``[pr, pc, cap]`` tensors on ``grid.device``, with
tile-local indices: padding slots hold ``(local_rows, local_cols)``. The
whole class is ported: construction and host access, the per-tile maps
(``tile_map``, ``tile_map_indexed``, ``apply``, ``prune``, ``keep_ij`` and
its ``tril`` / ``triu`` / ``remove_loops``), the elementwise family
(``ewise_mult``, ``ewise_apply``, ``ewise_add``, ``add_loops``), the
per-column select and prune family (``nnz_per_column``, ``kselect``,
``kselect2``, ``prune_column``, ``prune_rowcol``), capacities
(``with_capacity``, ``shrink_to_fit``), the local splits (``col_split``,
``row_split``, ``block_split``, ``col_concatenate``), ``reduce``,
``transpose``, ``dim_apply``, ``square`` and ``induced_subgraphs``. The
tiles are walked in a loop where the reference runs one program per
device; ``reduce`` and ``kselect`` combine over the grid as the reference's
collectives do on the CPU (``grid.fold_grid``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.ewise import ewise_apply as _ewise_apply
from ..ops.ewise import ewise_mult as _ewise_mult
from ..ops.segment import segment_reduce, spread_drops
from ..ops.tuples import SpTuples
from ..semiring import PLUS_TIMES, Semiring, _minval
from .grid import Grid, HostGrid, fold_grid
from .vec import DistVec


@dataclasses.dataclass(frozen=True)
class SpParMat:
    """rows/cols: int32[pr, pc, cap]; vals: [pr, pc, cap]; nnz: int32[pr, pc]."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    nrows: int
    ncols: int
    grid: Grid

    @property
    def capacity(self) -> int:
        return self.rows.shape[2]

    @property
    def local_rows(self) -> int:
        return self.grid.local_rows(self.nrows)

    @property
    def local_cols(self) -> int:
        return self.grid.local_cols(self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @functools.cached_property
    def fold_rows(self) -> torch.Tensor:
        """``rows`` with the padding slots spread over sink rows past
        ``local_rows`` (``ops.segment.spread_drops``): the row each slot of
        a local ``spmv`` folds into. Made on first use and kept, as the
        matrix is never changed in place."""
        return spread_drops(self.rows, self.rows < self.local_rows, self.local_rows)

    def getnnz(self) -> torch.Tensor:
        """Total nonzeros (a 0-dim device tensor)."""
        return self.nnz.sum()

    def local_tile(self, i: int, j: int) -> SpTuples:
        """Tile (i, j) as an SpTuples with tile-local indices."""
        return SpTuples(
            rows=self.rows[i, j],
            cols=self.cols[i, j],
            vals=self.vals[i, j],
            nnz=self.nnz[i, j],
            nrows=self.local_rows,
            ncols=self.local_cols,
        )

    @staticmethod
    def assemble(grid: Grid, nrows: int, ncols: int, tile_fn) -> "SpParMat":
        """The matrix whose tile (i, j) is ``tile_fn(i, j)``, each tile
        written into the ``[pr, pc, cap]`` arrays as it comes (every tile
        holds one capacity), so that the tiles are never held twice."""
        out = None
        for i in range(grid.pr):
            for j in range(grid.pc):
                t = tile_fn(i, j)
                if out is None:
                    out = [x.new_empty((grid.pr, grid.pc, t.capacity))
                           for x in (t.rows, t.cols, t.vals)]
                    out.append(torch.empty((grid.pr, grid.pc), dtype=torch.int32,
                                           device=t.rows.device))
                for dst, x in zip(out, (t.rows, t.cols, t.vals, t.nnz)):
                    dst[i, j] = x
        return SpParMat(rows=out[0], cols=out[1], vals=out[2], nnz=out[3], nrows=int(nrows),
                        ncols=int(ncols), grid=grid)

    def tile_map_ij(self, fn) -> "SpParMat":
        """``fn(tile, i, j) -> SpTuples`` on every tile (at grid
        position (i, j))."""
        return SpParMat.assemble(self.grid, self.nrows, self.ncols,
                                 lambda i, j: fn(self.local_tile(i, j), i, j))

    def tile_map(self, fn) -> "SpParMat":
        """Apply ``fn: SpTuples -> SpTuples`` to every tile."""
        return self.tile_map_ij(lambda t, i, j: fn(t))

    def tile_map_indexed(self, fn) -> "SpParMat":
        """Apply ``fn(tile, row_offset, col_offset) -> SpTuples`` to every
        tile; the offsets are the tile's global origin."""
        lr, lc = self.local_rows, self.local_cols
        return self.tile_map_ij(lambda t, i, j: fn(t, i * lr, j * lc))

    def keep_ij(self, pred) -> "SpParMat":
        """Keep the entries where ``pred(global_row, global_col)`` holds.
        Reference: ``SpParMat::PruneI``."""
        return self.tile_map_indexed(
            lambda t, ro, co: t.select_ij(lambda r, c: pred(r + ro, c + co)))

    def tril(self, strict: bool = True) -> "SpParMat":
        """The lower triangle (strict by default)."""
        return self.keep_ij(_pred_tril_strict if strict else _pred_tril)

    def triu(self, strict: bool = True) -> "SpParMat":
        return self.keep_ij(_pred_triu_strict if strict else _pred_triu)

    def remove_loops(self) -> "SpParMat":
        """Drop the diagonal. Reference: ``SpParMat::RemoveLoops``."""
        return self.keep_ij(_pred_offdiag)

    def apply(self, fn) -> "SpParMat":
        """``fn`` on every stored value. Reference: ``SpParMat::Apply``."""
        return self.tile_map(lambda t: t.apply(fn))

    def prune(self, pred) -> "SpParMat":
        """Drop the entries where ``pred(val)``. Reference:
        ``SpParMat::Prune``."""
        return self.tile_map(lambda t: t.prune(pred))

    def reduce(self, sr: Semiring, axis: str, map_fn=None) -> DistVec:
        """Fold the entries with ``sr.add`` (values mapped by ``map_fn``
        first): ``axis="rows"`` folds each column into a col-aligned vector
        of ``ncols``, ``axis="cols"`` each row into a row-aligned vector of
        ``nrows``. Reference: ``SpParMat::Reduce``."""
        if axis not in ("rows", "cols"):
            raise ValueError(f"axis must be 'rows' or 'cols', got {axis!r}")
        by_col = axis == "rows"
        seg_n = self.local_cols if by_col else self.local_rows

        def local(i, j):
            t = self.local_tile(i, j)
            v = map_fn(t.vals) if map_fn is not None else t.vals
            return segment_reduce(sr, v, t.cols if by_col else t.rows, seg_n)

        return DistVec(blocks=fold_grid(sr, self.grid, local, down_cols=by_col),
                       length=self.ncols if by_col else self.nrows,
                       align="col" if by_col else "row", grid=self.grid)

    def transpose(self) -> "SpParMat":
        """Aᵀ: tile (i, j) moves to (j, i) and is transposed in place.
        Square grids only, as in the reference. Reference:
        ``SpParMat::Transpose``."""
        if not self.grid.is_square:
            raise ValueError("transpose requires a square grid")
        return SpParMat.assemble(self.grid, self.ncols, self.nrows,
                                 lambda i, j: self.local_tile(j, i).transpose())

    def dim_apply(self, vec: DistVec, fn, axis: str) -> "SpParMat":
        """Scale the entries by a vector: ``axis="cols"``: entry (i, j) ←
        ``fn(val, vec[j])``; ``axis="rows"``: ← ``fn(val, vec[i])``. A
        padding slot's index is clamped to the block's end, where a 0 is
        appended. Reference: ``SpParMat::DimApply``."""
        if axis not in ("rows", "cols"):
            raise ValueError(f"axis must be 'rows' or 'cols', got {axis!r}")
        on_cols = axis == "cols"
        blocks = vec.realign("col" if on_cols else "row").blocks

        def scaled(t: SpTuples, v: torch.Tensor) -> SpTuples:
            vpad = torch.cat([v, v.new_zeros(1)])
            idx = torch.clamp(t.cols if on_cols else t.rows, max=v.shape[0])
            new = torch.where(t.valid_mask(), fn(t.vals, vpad.index_select(0, idx)), t.vals)
            return dataclasses.replace(t, vals=new)

        return self.tile_map_ij(lambda t, i, j: scaled(t, blocks[j] if on_cols else blocks[i]))

    # --- elementwise (tiles align: no communication) ----------------------

    def _check_aligned(self, other: "SpParMat") -> None:
        if self.grid != other.grid:
            raise ValueError("the matrices must share a grid")
        if (self.nrows, self.ncols) != (other.nrows, other.ncols):
            raise ValueError(f"shapes differ: {self.nrows}x{self.ncols} and "
                             f"{other.nrows}x{other.ncols}")

    def tile_zip(self, other: "SpParMat", fn) -> "SpParMat":
        """``fn(tile_a, tile_b) -> SpTuples`` on every pair of aligned
        tiles."""
        self._check_aligned(other)
        return SpParMat.assemble(self.grid, self.nrows, self.ncols,
                                 lambda i, j: fn(self.local_tile(i, j), other.local_tile(i, j)))

    def ewise_mult(self, other: "SpParMat", negate: bool = False,
                   combine=None) -> "SpParMat":
        """``A .* structure(B)`` (``negate=False``) or ``A .* ¬structure(B)``;
        ``combine(a, b)`` gives the kept values. Reference: ``EWiseMult``."""
        return self.tile_zip(other, lambda a, b: _ewise_mult(a, b, negate, combine))

    def ewise_apply(self, other: "SpParMat", fn, *, allow_a_nulls: bool = False,
                    allow_b_nulls: bool = False, a_null=0, b_null=0) -> "SpParMat":
        """Elementwise apply with nulls (``ops.ewise.ewise_apply``): the
        intersection, extended to B-only entries when ``allow_a_nulls`` and
        to A-only entries when ``allow_b_nulls``. The nulls are taken in the
        operands' dtypes. Reference: ``EWiseApply``."""
        a_null = torch.tensor(a_null, dtype=self.dtype).item()
        b_null = torch.tensor(b_null, dtype=other.dtype).item()
        return self.tile_zip(other, lambda a, b: _ewise_apply(
            a, b, fn, allow_a_nulls=allow_a_nulls, allow_b_nulls=allow_b_nulls,
            a_null=a_null, b_null=b_null))

    def ewise_add(self, other: "SpParMat", sr: Semiring,
                  capacity: int | None = None) -> "SpParMat":
        """``A ⊕ B``, the union with common entries combined by ``sr.add``:
        the two tiles' slots concatenated and compacted (capacity: the sum
        of both, unless given). Reference: ``SpParMat::operator+=``."""
        return self.tile_zip(other, lambda a, b: SpTuples.concat([a, b]).compact(
            sr, capacity=capacity))

    def add_loops(self, value) -> "SpParMat":
        """Every diagonal entry set to ``value`` (an existing one replaced);
        each tile grows by ``local_rows`` slots. Needs square blocking.
        Reference: ``SpParMat::AddLoops``."""
        lr, lc = self.local_rows, self.local_cols
        if lr != lc:
            raise ValueError("add_loops requires square blocking")
        ndiag = min(self.nrows, self.ncols)
        d = torch.arange(lr, dtype=torch.int32, device=self.grid.device)

        def f(t: SpTuples, ro: int, co: int) -> SpTuples:
            base = t.select_ij(lambda r, c: (r + ro) != (c + co))
            ok = (d + ro < ndiag) & (ro == co)
            extra = SpTuples(rows=torch.where(ok, d, lr), cols=torch.where(ok, d, lc),
                             vals=torch.full((lr,), value, dtype=self.dtype, device=d.device),
                             nnz=ok.sum().to(torch.int32), nrows=lr, ncols=lc)
            return SpTuples.concat([base, extra])

        return self.tile_map_indexed(f)

    # --- per-column select and prune (MCL's support ops) -------------------

    def nnz_per_column(self) -> DistVec:
        """Col-aligned int32 entry counts of the columns. Reference:
        ``Reduce(Column, plus, 1)``."""
        return self.reduce(PLUS_TIMES, "rows", map_fn=ones_i32)

    def kselect(self, k) -> DistVec:
        """Per column the k-th largest value, as a col-aligned vector;
        columns with fewer than k entries get the dtype's least value.
        ``k``: a positive int or a col-aligned DistVec of per-column k's.

        A radix select over order-preserving 32-bit keys
        (``monotone_key_u32``, int64 in [0, 2^32)): 32 rounds, each a
        per-column count of the keys at or above a candidate, combined over
        the grid rows (``grid.fold_grid``). Reference: ``SpParMat::Kselect1``.
        """
        lc = self.local_cols
        dev = self.grid.device
        if isinstance(k, DistVec):
            kcol = k.realign("col").blocks.to(torch.int32)
        else:
            kcol = torch.full((self.grid.pc, lc), int(k), dtype=torch.int32, device=dev)
        live = {}  # per tile: the columns and keys of the valid slots
        for i in range(self.grid.pr):
            for j in range(self.grid.pc):
                t = self.local_tile(i, j)
                m = t.valid_mask()
                live[i, j] = (t.cols[m].long(), monotone_key_u32(t.vals[m]))

        def count(above):
            def local(i, j):
                ids, keys = live[i, j]
                hit = torch.ones_like(ids) if above is None else (
                    keys >= above[j].index_select(0, ids)).long()
                return torch.zeros(lc, dtype=torch.long, device=dev).index_add_(0, ids, hit)
            return fold_grid(PLUS_TIMES, self.grid, local, down_cols=True)

        total = count(None)
        thresh = torch.zeros((self.grid.pc, lc), dtype=torch.long, device=dev)
        for b in range(31, -1, -1):
            cand = thresh | (1 << b)
            thresh = torch.where(count(cand) >= kcol, cand, thresh)
        out = key_u32_to_val(thresh, self.dtype)
        out = torch.where(total < kcol, torch.full_like(out, _minval(self.dtype)), out)
        return DistVec(blocks=out, length=self.ncols, align="col", grid=self.grid)

    def kselect2(self, k: int):
        """``(thresholds, any_active)``: ``kselect(k)`` and a 0-dim bool, true
        when some column holds at least k entries. Reference:
        ``SpParMat::Kselect2``."""
        return self.kselect(k), (self.nnz_per_column().blocks >= k).any()

    def prune_column(self, vec: DistVec, keep) -> "SpParMat":
        """Keep entry (i, j) iff ``keep(val, vec[j])``. Reference:
        ``SpParMat::PruneColumn`` (there as the prune predicate)."""
        blocks = vec.realign("col").blocks

        def f(t: SpTuples, j: int) -> SpTuples:
            v = blocks[j]
            idx = torch.clamp(t.cols, max=v.shape[0] - 1)
            return t._select(t.valid_mask() & keep(t.vals, v.index_select(0, idx)))

        return self.tile_map_ij(lambda t, i, j: f(t, j))

    def prune_rowcol(self, rvec: DistVec, cvec: DistVec, keep) -> "SpParMat":
        """Keep entry (i, j) iff ``keep(val, rvec[i], cvec[j])``: the
        zero-out step of ``spasgn``. A padding slot's index is clamped to
        the block's end, where a 0 is appended."""
        rb, cb = rvec.realign("row").blocks, cvec.realign("col").blocks

        def f(t: SpTuples, i: int, j: int) -> SpTuples:
            rpad = torch.cat([rb[i], rb[i].new_zeros(1)])
            cpad = torch.cat([cb[j], cb[j].new_zeros(1)])
            rv = rpad.index_select(0, torch.clamp(t.rows, max=rb.shape[1]))
            cv = cpad.index_select(0, torch.clamp(t.cols, max=cb.shape[1]))
            return t._select(t.valid_mask() & keep(t.vals, rv, cv))

        return self.tile_map_ij(f)

    # --- capacities ----------------------------------------------------------

    def with_capacity(self, capacity: int) -> "SpParMat":
        """Every tile grown or cut to ``capacity`` slots (cutting needs
        compacted tiles of at most ``capacity`` entries)."""
        if capacity == self.capacity:
            return self
        return self.tile_map(lambda t: t.with_capacity(capacity))

    def shrink_to_fit(self, pow2: bool = True) -> "SpParMat":
        """Capacity cut to the largest tile count (read back on the host),
        rounded up to a power of two unless ``pow2=False``."""
        need = max(int(self.nnz.max()), 1)
        if pow2:
            need = 1 << (need - 1).bit_length()
        return self.with_capacity(min(need, self.capacity))

    # --- local splits (phased execution) -----------------------------------

    def col_split(self, nsplits: int) -> list["SpParMat"]:
        """``nsplits`` matrices, the s-th holding every tile's s-th chunk of
        local columns (globally a strided family of column blocks, which
        ``col_concatenate`` puts back). Needs ``ncols`` even over the grid
        and ``local_cols % nsplits == 0``. Reference: ``SpDCCols::ColSplit``."""
        lc = self.local_cols
        if self.ncols != lc * self.grid.pc:
            raise ValueError("col_split requires ncols to divide evenly over the grid")
        if lc % nsplits:
            raise ValueError(f"local cols {lc} not divisible by {nsplits}")
        lw = lc // nsplits

        def piece(lo: int):
            def f(t: SpTuples) -> SpTuples:
                sel = t._select(t.valid_mask() & (t.cols >= lo) & (t.cols < lo + lw))
                cols = torch.where(sel.valid_mask(), sel.cols - lo, lw)
                return SpTuples(rows=sel.rows, cols=cols, vals=sel.vals, nnz=sel.nnz,
                                nrows=t.nrows, ncols=lw)
            return dataclasses.replace(self.tile_map(f), ncols=lw * self.grid.pc)

        return [piece(s * lw) for s in range(nsplits)]

    def row_split(self, nsplits: int) -> list["SpParMat"]:
        """The row-wise ``col_split``. Reference: ``Dcsc::RowSplit``."""
        lr = self.local_rows
        if self.nrows != lr * self.grid.pr:
            raise ValueError("row_split requires nrows to divide evenly over the grid")
        if lr % nsplits:
            raise ValueError(f"local rows {lr} not divisible by {nsplits}")
        lw = lr // nsplits

        def piece(lo: int):
            def f(t: SpTuples) -> SpTuples:
                sel = t._select(t.valid_mask() & (t.rows >= lo) & (t.rows < lo + lw))
                rows = torch.where(sel.valid_mask(), sel.rows - lo, lw)
                return SpTuples(rows=rows, cols=sel.cols, vals=sel.vals, nnz=sel.nnz,
                                nrows=lw, ncols=t.ncols)
            return dataclasses.replace(self.tile_map(f), nrows=lw * self.grid.pr)

        return [piece(s * lw) for s in range(nsplits)]

    def block_split(self, row_blocks: int, col_blocks: int) -> list[list["SpParMat"]]:
        """``[row_blocks][col_blocks]`` local pieces: ``row_split`` then
        ``col_split``. Reference: ``SpParMat::BlockSplit``."""
        rows = self.row_split(row_blocks) if row_blocks > 1 else [self]
        return [r.col_split(col_blocks) if col_blocks > 1 else [r] for r in rows]

    @staticmethod
    def col_concatenate(mats: list["SpParMat"]) -> "SpParMat":
        """``col_split`` pieces (or phase outputs) stitched back: each tile's
        slots one piece after another, capacity the sum (not compacted).
        Reference: ``SpDCCols::ColConcatenate``."""
        g = mats[0].grid
        ncols = sum(m.ncols for m in mats)
        lc_out = sum(m.local_cols for m in mats)
        if ncols != lc_out * g.pc:
            raise ValueError("the pieces do not divide evenly over the grid")
        caps = [m.capacity for m in mats]
        shape = (g.pr, g.pc, sum(caps))
        out = SpParMat(rows=mats[0].rows.new_empty(shape), cols=mats[0].cols.new_empty(shape),
                       vals=mats[0].vals.new_empty(shape),
                       nnz=sum((m.nnz for m in mats[1:]), start=mats[0].nnz),
                       nrows=mats[0].nrows, ncols=ncols, grid=g)
        lo, off = 0, 0
        for m, cap in zip(mats, caps):  # piece by piece: one piece's temporaries at a time
            out.rows[:, :, lo:lo + cap] = m.rows
            out.cols[:, :, lo:lo + cap] = torch.where(m.rows < m.local_rows, m.cols + off, lc_out)
            out.vals[:, :, lo:lo + cap] = m.vals
            lo, off = lo + cap, off + m.local_cols
        return out

    # --- products ------------------------------------------------------------

    def square(self, sr: Semiring, slack: float = 1.05) -> "SpParMat":
        """``A ⊗ A`` through the ESC ``spgemm``. Reference:
        ``SpParMat::Square``."""
        from .spgemm import spgemm

        return spgemm(sr, self, self, slack)

    def induced_subgraphs(self, labels: DistVec, ngroups: int = 2) -> list[tuple]:
        """The components of ``labels`` put into ``ngroups`` groups (greedy,
        largest first, on the host) and each group's induced subgraph
        extracted with ``subsref``: ``[(vertex_ids, subgraph), ...]``.
        Reference: ``SpParMat::InducedSubgraphs2Procs``."""
        from .indexing import subsref

        lab = np.asarray(labels.to_global())
        uniq, inv = np.unique(lab, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        bounds = np.concatenate([[0], np.cumsum(np.bincount(inv, minlength=len(uniq)))])
        members = [order[bounds[i]:bounds[i + 1]] for i in range(len(uniq))]
        groups = [[] for _ in range(ngroups)]
        loads = [0] * ngroups
        for verts in sorted(members, key=len, reverse=True):
            g = loads.index(min(loads))
            groups[g].extend(verts.tolist())
            loads[g] += len(verts)
        out = []
        for verts in groups:
            if verts:
                vi = np.asarray(sorted(verts), dtype=np.int64)
                out.append((vi, subsref(self, vi, vi)))
        return out

    @staticmethod
    def from_global_coo(
        grid: Grid,
        rows,
        cols,
        vals,
        nrows: int,
        ncols: int,
        capacity: int | None = None,
        dedup_sr: Semiring | None = None,
    ) -> "SpParMat":
        """Bucket global host tuples by owner tile, upload, and with
        ``dedup_sr`` combine duplicates per tile (``SpTuples.compact``)."""
        vals = np.asarray(vals)
        rows, cols, order, counts, starts, cap, lr, lc = bucket_by_tile(
            grid, rows, cols, nrows, ncols, capacity
        )
        vals = vals[order]
        pr_, pc_ = grid.pr, grid.pc
        R = np.full((pr_, pc_, cap), lr, dtype=np.int32)
        C = np.full((pr_, pc_, cap), lc, dtype=np.int32)
        V = np.zeros((pr_, pc_, cap), dtype=vals.dtype)
        for t in range(grid.size):
            i, j = divmod(t, pc_)
            s, e = starts[t], starts[t + 1]
            n = e - s
            R[i, j, :n] = rows[s:e] - i * lr
            C[i, j, :n] = cols[s:e] - j * lc
            V[i, j, :n] = vals[s:e]
        mat = SpParMat(
            rows=torch.from_numpy(R).to(grid.device),
            cols=torch.from_numpy(C).to(grid.device),
            vals=torch.from_numpy(V).to(grid.device),
            nnz=torch.from_numpy(counts.reshape(pr_, pc_).astype(np.int32)).to(
                grid.device
            ),
            nrows=int(nrows),
            ncols=int(ncols),
            grid=grid,
        )
        if dedup_sr is not None:
            mat = mat.tile_map(lambda t: t.compact(dedup_sr))
        return mat

    @staticmethod
    def from_dense(grid: Grid, dense, capacity=None, dedup_sr=None) -> "SpParMat":
        dense = np.asarray(dense)
        r, c = np.nonzero(dense)
        return SpParMat.from_global_coo(
            grid, r, c, dense[r, c], dense.shape[0], dense.shape[1],
            capacity=capacity, dedup_sr=dedup_sr,
        )

    def to_global_coo(self):
        """Host (rows, cols, vals) of every valid entry, tile by tile."""
        lr, lc = self.local_rows, self.local_cols
        R = self.rows.cpu().numpy()
        C = self.cols.cpu().numpy()
        V = self.vals.cpu().numpy()
        N = self.nnz.cpu().numpy()
        out_r, out_c, out_v = [], [], []
        for i in range(self.grid.pr):
            for j in range(self.grid.pc):
                m = R[i, j] < lr
                if m.sum() != N[i, j]:
                    raise ValueError(
                        f"tile ({i}, {j}) holds {m.sum()} valid slots, nnz says {N[i, j]}"
                    )
                out_r.append(R[i, j, m].astype(np.int64) + i * lr)
                out_c.append(C[i, j, m].astype(np.int64) + j * lc)
                out_v.append(V[i, j, m])
        return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)

    def to_dense(self) -> np.ndarray:
        r, c, v = self.to_global_coo()
        out = np.zeros((self.nrows, self.ncols), dtype=v.dtype)
        np.add.at(out, (r, c), v)
        return out


def bucket_by_tile(
    grid: HostGrid, rows, cols, nrows: int, ncols: int, capacity: int | None
):
    """Sort global tuples by owner tile. Returns
    ``(rows_sorted, cols_sorted, order, counts, starts, cap, lr, lc)``;
    raises ValueError when an explicit ``capacity`` is too small."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    lr, lc = grid.local_rows(nrows), grid.local_cols(ncols)
    tile_id = (rows // lr) * grid.pc + (cols // lc)
    order = np.argsort(tile_id, kind="stable")
    rows, cols = rows[order], cols[order]
    counts = np.bincount(tile_id, minlength=grid.size)
    cap = int(capacity) if capacity is not None else max(int(counts.max()), 1)
    if counts.max() > cap:
        raise ValueError(f"tile nnz {counts.max()} exceeds capacity {cap}")
    starts = np.concatenate([[0], np.cumsum(counts)])
    return rows, cols, order, counts, starts, cap, lr, lc


def _pred_tril_strict(r, c):
    return r > c


def _pred_tril(r, c):
    return r >= c


def _pred_triu_strict(r, c):
    return r < c


def _pred_triu(r, c):
    return r <= c


def _pred_offdiag(r, c):
    return r != c


def monotone_key_u32(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving unsigned 32-bit keys of ``v``, held as int64 in
    [0, 2^32): floats flip all bits when negative and the sign bit when not
    (so -0.0 sorts just below +0.0, and a NaN with its sign bit clear above
    +inf), signed ints flip the sign bit, bools and unsigned ints widen.
    64-bit and 16-bit float dtypes raise ``TypeError`` (the reference keys
    the former only with x64 on and refuses the latter)."""
    dt = v.dtype
    if dt == torch.bool or dt == torch.uint8:
        return v.to(torch.int64)
    if dt in (torch.int8, torch.int16, torch.int32):
        return v.to(torch.int64) + (1 << 31)
    if dt == torch.float32:
        u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return u ^ torch.where(u >= (1 << 31), 0xFFFFFFFF, 1 << 31)
    raise TypeError(f"kselect keys int and 32-bit float values, got {dt}")


def key_u32_to_val(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``monotone_key_u32``."""
    if dtype == torch.bool or dtype == torch.uint8:
        return key.to(dtype)
    if dtype in (torch.int8, torch.int16, torch.int32):
        return (key - (1 << 31)).to(dtype)
    if dtype == torch.float32:
        bits = key ^ torch.where(key >= (1 << 31), 1 << 31, 0xFFFFFFFF)
        bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
        return bits.to(torch.int32).view(torch.float32)
    raise TypeError(f"kselect keys int and 32-bit float values, got {dtype}")


def ones_i32(v: torch.Tensor) -> torch.Tensor:
    """Structural-one map for ``reduce(map_fn=...)``: int32 ones of ``v``'s
    shape (degrees as entry counts)."""
    return torch.ones(v.shape, dtype=torch.int32, device=v.device)


def ones_f32(v: torch.Tensor) -> torch.Tensor:
    return torch.ones(v.shape, dtype=torch.float32, device=v.device)
