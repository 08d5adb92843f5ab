"""3D (layered) distribution — counterpart of
``combblas_tpu/parallel/mesh3d.py`` (≈ CommGrid3D / SpParMat3D /
Mult_AnXBn_SUMMA3D).

A layers × pr × pc grid: each layer runs 2D SUMMA on a column slice (A,
col-split) or row slice (B, row-split) of every 2D tile, and the layers'
partial products are exchanged and merged along the fiber (the layer
axis). Splits are local, as the reference's: layer l holds the l-th slice
of every 2D tile's local columns (col-split) or rows (row-split).

The layers are emulated on one device, as the 2D tiles are: a
``SpParMat3D`` holds its tiles as ``[L, pr, pc, cap]`` tensors with
layer-local tile indices and the reference's padding (row = ``tile_rows``,
col = ``tile_cols``). The layer axis's ``all_to_all`` is an exchange of
the ``[L_src, L_dst]`` piece axes; a layer's within-layer gathers are the
2D tile loops (``parallel/spgemm.py``).

  * construction and access: ``Grid3D``, ``SpParMat3D`` (``from_global_coo``,
    ``to_global_coo``, ``col_split`` / ``col_concatenate``,
    ``shrink_to_fit``), ``redistribute_coo3d`` (three routing hops: grid
    column, grid row, layer), the 2D ↔ 3D conversions and ``resplit3d``,
    all of which route the valid tuples alone (``_TupleRoute``);
  * the ESC 3D SUMMA (``summa3d_spgemm``, sized by ``summa3d_stage_flops``;
    entries ``spgemm3d``, ``mem_efficient_spgemm3d``) and the windowed 3D
    SUMMA (``summa3d_spgemm_windowed``, both backends, sized by the 3D
    window passes and ``windowed_plan3d``; entry ``spgemm3d_windowed``),
    each followed by the fiber exchange and one of the merge tiers
    (``MERGE_TIERS``: sort, runs, hash);
  * the column ops MCL's 3D loop runs (``reduce3d_cols``,
    ``nnz_per_column3d``, ``kselect3d``, ``prune_column3d``, ``prune3d``,
    ``apply3d``, ``dim_apply3d_cols``).

``spgemm3d`` resolves its tier through the tuner's chain (argument, plan
store, ``COMBBLAS_SPGEMM3D_TIER``, the probe on the real operands,
``"esc"``) and its merge tier through ``tuner.resolve.resolve_merge``
(argument, the record, ``COMBBLAS_SPGEMM_MERGE``, then the heuristic);
``spgemm3d_windowed`` reads ``COMBBLAS_SPGEMM_MERGE`` before its
heuristic. Deviations from the reference: no ``interpret`` argument (the
semiring GEMM's plain version is the CPU path); no ``obs`` counters
(ROADMAP item 13b); ``ring`` keeps the carousel's stage order and ``pipeline``
changes nothing, as in 2D. The fiber's partials are built one fiber (2D
tile position) at a time, cut to their live entries, so only one fiber's
pieces are alive; the capacities, output layouts, overflow vectors and
raises are the reference's.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..ops.segment import segment_reduce
from ..ops.spgemm import (
    hash_merge,
    hash_table_capacity,
    merge_sorted_runs,
    scatter_combine_for,
)
from ..ops.tuples import SpTuples
from ..semiring import Semiring, _minval
from ..tuner import config as tuner_config
from ..tuner import store as tuner_store
from ..tuner.resolve import resolve_merge
from .grid import Grid, combine_tiles
from .spgemm import (
    _PALLAS_KINDS,
    WINDOWED_CHUNK_W,
    TierRefusal,
    _carousel_stages,
    _check_dot_dtype,
    _stage_chunk,
    _window_stage_symbolic,
    _windowed_carousel_compute,
    _windowed_gathered_compute,
    _Windows,
    default_block_cols,
    default_block_rows,
    host_value,
    packed_windows,
    packed_windows_2d,
    panel_cap_from_bnnz,
    resolve_spgemm_backend,
    windowed_plan_2d,
)
from .spmat import SpParMat, key_u32_to_val, monotone_key_u32

#: The fiber reduce's combine tiers — the one definition lives with the
#: environment's vetting in ``tuner/config.py``.
MERGE_TIERS = tuner_config.MERGE_TIER_NAMES

#: Probe rounds of the hash merge tier before its counted overflow sends
#: the product through the sorted-runs tier (read at each call, so it can
#: be patched).
HASH_MERGE_PROBES = 16


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A layers × pr × pc grid whose tiles live on ``device`` (≈
    CommGrid3D)."""

    layers: int
    pr: int
    pc: int
    device: torch.device = torch.device("cuda")

    @staticmethod
    def make(layers: int, pr: int, pc: int,
             device: str | torch.device | None = None) -> "Grid3D":
        """A layers × pr × pc grid on ``device`` (default: the current CUDA
        card). Raises when CUDA is asked for, explicitly or by default, and
        is absent; pass ``device="cpu"`` to run on the CPU."""
        if min(layers, pr, pc) < 1:
            raise ValueError(f"grid dims must be positive, got {layers}x{pr}x{pc}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        return Grid3D(layers=layers, pr=pr, pc=pc, device=dev)

    @property
    def size(self) -> int:
        return self.layers * self.pr * self.pc

    def local_rows(self, nrows: int) -> int:
        return -(-nrows // self.pr)

    def local_cols(self, ncols: int) -> int:
        return -(-ncols // self.pc)


def _tiles(grid: Grid3D):
    return [(l_, i, j) for l_ in range(grid.layers) for i in range(grid.pr)
            for j in range(grid.pc)]


def _owner3d(rows, cols, grid: Grid3D, nrows: int, ncols: int, split: str):
    """The 3D owner of valid global ids (numpy or torch integer arrays) with
    the local split: ``(layer, i, j, local row, local col)`` and the tile
    dims ``(tr, tc)``. Raises where the split dim does not divide over the
    layers."""
    L = grid.layers
    lr, lc = grid.local_rows(nrows), grid.local_cols(ncols)
    split_dim = lc if split == "col" else lr
    if split_dim % L:
        raise ValueError(
            f"3D {split}-split needs the local {'column' if split == 'col' else 'row'} "
            f"count ({split_dim}) to divide evenly over {L} layers; pad the "
            f"matrix dims or choose a different grid")
    w = split_dim // L
    i, j = rows // lr, cols // lc
    lrow, lcol = rows - i * lr, cols - j * lc
    if split == "col":
        return (lcol // w, i, j, lrow, lcol % w), (lr, w)
    return (lrow // w, i, j, lrow % w, lcol), (w, lc)


@dataclasses.dataclass(frozen=True)
class SpParMat3D:
    """3D-distributed sparse matrix (≈ SpParMat3D). rows/cols: int32
    ``[L, pr, pc, cap]`` layer-local tile indices; a col-split layer tile
    spans ``local_rows × local_cols / L``, a row-split one ``local_rows / L
    × local_cols``. ``nrows`` / ``ncols`` are the global dims."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    nrows: int
    ncols: int
    split: str  # "col" | "row"
    grid: Grid3D

    @property
    def capacity(self) -> int:
        return self.rows.shape[3]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def tile_rows(self) -> int:
        lr = self.grid.local_rows(self.nrows)
        return lr // self.grid.layers if self.split == "row" else lr

    @property
    def tile_cols(self) -> int:
        lc = self.grid.local_cols(self.ncols)
        return lc // self.grid.layers if self.split == "col" else lc

    def getnnz(self) -> torch.Tensor:
        """Total nonzeros (a 0-dim device tensor)."""
        return self.nnz.sum()

    def local_tile(self, l_: int, i: int, j: int) -> SpTuples:
        """Tile (l, i, j) as an SpTuples with layer-local indices."""
        return SpTuples(rows=self.rows[l_, i, j], cols=self.cols[l_, i, j],
                        vals=self.vals[l_, i, j], nnz=self.nnz[l_, i, j],
                        nrows=self.tile_rows, ncols=self.tile_cols)

    @staticmethod
    def assemble(grid: Grid3D, nrows: int, ncols: int, split: str,
                 tile_fn) -> "SpParMat3D":
        """The matrix whose tile (l, i, j) is ``tile_fn(l, i, j)`` (every
        tile of one capacity), each written into the ``[L, pr, pc, cap]``
        arrays as it comes."""
        out = None
        for l_, i, j in _tiles(grid):
            t = tile_fn(l_, i, j)
            if out is None:
                shape = (grid.layers, grid.pr, grid.pc, t.capacity)
                out = [x.new_empty(shape) for x in (t.rows, t.cols, t.vals)]
                out.append(torch.empty(shape[:3], dtype=torch.int32, device=t.rows.device))
            for dst, x in zip(out, (t.rows, t.cols, t.vals, t.nnz)):
                dst[l_, i, j] = x
        return SpParMat3D(rows=out[0], cols=out[1], vals=out[2], nnz=out[3], nrows=int(nrows),
                          ncols=int(ncols), split=split, grid=grid)

    def tile_map(self, fn) -> "SpParMat3D":
        """``fn(tile, l, i, j) -> SpTuples`` on every tile, same dims."""
        return SpParMat3D.assemble(self.grid, self.nrows, self.ncols, self.split,
                                   lambda l_, i, j: fn(self.local_tile(l_, i, j), l_, i, j))

    # --- host construction and extraction -------------------------------------

    @staticmethod
    def from_global_coo(grid: Grid3D, rows, cols, vals, nrows: int, ncols: int,
                        split: str = "col", capacity: int | None = None) -> "SpParMat3D":
        """Bucket global host tuples by (layer, tile) with the local split:
        2D tile (i, j) = (r // lr, c // lc); layer = local col // (lc / L)
        (col-split) or local row // (lr / L) (row-split)."""
        if split not in ("col", "row"):
            raise ValueError(f"split must be 'col' or 'row', got {split!r}")
        vals = np.asarray(vals)
        L = grid.layers
        (layer, ti, tj, lrow, lcol), (tr, tc) = _owner3d(
            np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64), grid, nrows,
            ncols, split)
        flat = (layer * grid.pr + ti) * grid.pc + tj
        order = np.argsort(flat, kind="stable")
        flat, lrow, lcol, vals_s = flat[order], lrow[order], lcol[order], vals[order]
        counts = np.bincount(flat, minlength=grid.size)
        cap = int(capacity) if capacity else max(int(counts.max()) if counts.size else 0, 1)
        shape = (L, grid.pr, grid.pc, cap)
        R = np.full(shape, tr, np.int32)
        C = np.full(shape, tc, np.int32)
        V = np.zeros(shape, vals.dtype)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for t, (l_, i, j) in enumerate(_tiles(grid)):
            s, e = starts[t], starts[t + 1]
            R[l_, i, j, : e - s] = lrow[s:e]
            C[l_, i, j, : e - s] = lcol[s:e]
            V[l_, i, j, : e - s] = vals_s[s:e]
        dev = grid.device
        return SpParMat3D(
            rows=torch.from_numpy(R).to(dev), cols=torch.from_numpy(C).to(dev),
            vals=torch.from_numpy(V).to(dev),
            nnz=torch.from_numpy(counts.reshape(shape[:3]).astype(np.int32)).to(dev),
            nrows=int(nrows), ncols=int(ncols), split=split, grid=grid)

    def to_global_coo(self):
        """Host (rows, cols, vals) of every valid entry, tile by tile."""
        lr = self.grid.local_rows(self.nrows)
        lc = self.grid.local_cols(self.ncols)
        tr, tc = self.tile_rows, self.tile_cols
        R, C, V, N = (x.cpu().numpy() for x in (self.rows, self.cols, self.vals, self.nnz))
        out = ([], [], [])
        for l_, i, j in _tiles(self.grid):
            m = R[l_, i, j] < tr
            if m.sum() != N[l_, i, j]:
                raise ValueError(f"tile ({l_}, {i}, {j}) holds {m.sum()} valid slots, "
                                 f"nnz says {N[l_, i, j]}")
            rr = R[l_, i, j, m].astype(np.int64)
            cc = C[l_, i, j, m].astype(np.int64)
            if self.split == "col":
                gr, gc = i * lr + rr, j * lc + l_ * tc + cc
            else:
                gr, gc = i * lr + l_ * tr + rr, j * lc + cc
            out[0].append(gr)
            out[1].append(gc)
            out[2].append(V[l_, i, j, m])
        return tuple(np.concatenate(x) for x in out)

    def to_dense(self) -> np.ndarray:
        r, c, v = self.to_global_coo()
        out = np.zeros((self.nrows, self.ncols), v.dtype)
        np.add.at(out, (r, c), v)
        return out

    # --- 2D <-> 3D ---------------------------------------------------------------

    @staticmethod
    def from_spmat(A, grid3: Grid3D, split: str = "col", **kw) -> "SpParMat3D":
        """2D SpParMat → 3D (≈ ``SpParMat3D(SpParMat&)``)."""
        return spmat3d_from_spmat(A, grid3, split, **kw)

    def to_spmat(self, grid2: Grid, **kw):
        """3D → 2D SpParMat on ``grid2``."""
        return spmat_from_spmat3d(self, grid2, **kw)

    def shrink_to_fit(self, pow2: bool = True) -> "SpParMat3D":
        """Capacity cut to the largest tile count (read back), rounded up to
        a power of two unless ``pow2=False``; tiles must be compacted."""
        need = max(int(self.nnz.max()), 1)
        if pow2:
            need = 1 << (need - 1).bit_length()
        need = min(need, self.capacity)
        if need == self.capacity:
            return self
        return dataclasses.replace(self, rows=self.rows[..., :need], cols=self.cols[..., :need],
                                   vals=self.vals[..., :need])

    # --- local column split / concat (the phased 3D product) -----------------

    def col_split(self, nsplits: int) -> list["SpParMat3D"]:
        """Phase pieces of a row-split matrix (B's orientation). The split is
        strided per layer window: with w = tile_cols / L, piece s takes
        sub-window ``[s·w/nsplits, (s+1)·w/nsplits)`` of every layer window,
        so the phase outputs of SUMMA3D land fiber-aligned. Reference:
        ``SpParMat3D.col_split`` (``_col_split3d_jit``)."""
        if self.split != "row":
            raise ValueError("col_split phases a row-split operand")
        L = self.grid.layers
        tr, tc = self.tile_rows, self.tile_cols
        if tc % (L * nsplits):
            raise ValueError(f"tile cols {tc} must divide by layers*phases = {L * nsplits}")
        if self.ncols % nsplits:
            raise ValueError(f"ncols {self.ncols} must divide by {nsplits}")
        w = tc // L
        wp = w // nsplits
        valid = self.rows < tr
        l_win, within = self.cols // w, self.cols % w
        newcol = l_win * wp + within % wp
        outs = []
        for s in range(nsplits):
            keep = valid & (within // wp == s)
            # kept entries first, in slot order
            order = torch.sort((~keep).to(torch.uint8), dim=3, stable=True).indices

            def gather(x):
                return torch.take_along_dim(x, order, dim=3)

            outs.append(dataclasses.replace(
                self, rows=gather(torch.where(keep, self.rows, tr)),
                cols=gather(torch.where(keep, newcol, L * wp).to(torch.int32)),
                vals=gather(torch.where(keep, self.vals, torch.zeros_like(self.vals))),
                nnz=keep.sum(dim=3, dtype=torch.int32), ncols=self.ncols // nsplits))
        return outs

    @staticmethod
    def col_concatenate(mats: list["SpParMat3D"]) -> "SpParMat3D":
        """Stitch ``col_split`` pieces or SUMMA3D phase outputs back:
        col-split pieces by a tile-column offset, row-split pieces by
        undoing the strided interleave per layer window."""
        L = mats[0].grid.layers
        tcs = [m.tile_cols for m in mats]
        tc_out = sum(tcs)
        if mats[0].split == "row" and len(set(tcs)) != 1:
            raise ValueError("row-split concat needs equal widths")
        cols, off = [], 0
        for s, (m, tcp) in enumerate(zip(mats, tcs)):
            valid = m.rows < m.tile_rows
            if m.split == "col":
                newcol = m.cols + off
            else:
                wp, w_out = tcp // L, tc_out // L
                newcol = (m.cols // wp) * w_out + s * wp + (m.cols % wp)
            off += tcp
            cols.append(torch.where(valid, newcol, tc_out).to(torch.int32))
        return dataclasses.replace(
            mats[0], rows=torch.cat([m.rows for m in mats], dim=3), cols=torch.cat(cols, dim=3),
            vals=torch.cat([m.vals for m in mats], dim=3),
            nnz=sum((m.nnz for m in mats[1:]), start=mats[0].nnz),
            ncols=sum(m.ncols for m in mats))


# --- the fiber exchange and merge ------------------------------------------------


def _stage_pairs(A: SpParMat3D, B: SpParMat3D, l_: int, i: int, j: int, ring: bool):
    """Layer l's stage operands of output tile (i, j): ``A_lis · B_lsj``
    in stage order, or with ``ring`` the carousel's order (the 2D schedule
    within the layer)."""
    p = A.grid.pr
    if not ring:
        return [(A.local_tile(l_, i, s), B.local_tile(l_, s, j)) for s in range(p)]
    return [(A.local_tile(l_, *a[i * p + j]), B.local_tile(l_, *b[i * p + j]))
            for _, a, b in _carousel_stages(p)]


def _fiber_exchange(partial: SpTuples, L: int, w_out: int, piece_capacity: int,
                    sort_pieces: bool) -> tuple[list, int]:
    """One layer's side of the fiber exchange, its outgoing pieces: its
    partial's entries of each column range ``[l·w_out, (l+1)·w_out)``,
    rebased, in slot order and cut at ``piece_capacity`` (each ``SpTuples``
    holds its kept entries only, at least one slot), row-major sorted when
    ``sort_pieces``. Piece l goes to layer l (``_fibers``). Returns (pieces,
    the most entries a piece dropped, at least 0)."""
    valid = partial.valid_mask()
    pieces, worst = [], 0
    for l_ in range(L):
        lo = l_ * w_out
        idx = torch.nonzero(valid & (partial.cols >= lo) & (partial.cols < lo + w_out)).squeeze(1)
        worst = max(worst, idx.numel() - piece_capacity)
        idx = idx[:piece_capacity]
        if idx.numel() == 0:
            piece = SpTuples.empty(partial.nrows, w_out, 1, partial.dtype,
                                   device=partial.rows.device)
        else:
            piece = SpTuples(rows=partial.rows[idx], cols=partial.cols[idx] - lo,
                             vals=partial.vals[idx],
                             nnz=torch.tensor(idx.numel(), dtype=torch.int32,
                                              device=idx.device),
                             nrows=partial.nrows, ncols=w_out)
            if sort_pieces:
                piece = piece.sort_rowmajor()
        pieces.append(piece)
    return pieces, worst


def _fiber_merge(sr: Semiring, runs: list, out_capacity: int, merge: str):
    """Combine the received piece runs (one a source layer, in layer order)
    into one compacted tile of ``out_capacity`` slots: ``sort`` (concat
    and one sort), ``runs`` (a merge of the sorted runs, then a sort-free
    compaction), ``hash`` (``hash_merge``, unsorted output). Returns
    ``(out, distinct - out_capacity, hash overflow)``."""
    if merge == "runs":
        out, distinct = merge_sorted_runs(runs).compact_counted(
            sr, capacity=out_capacity, assume_sorted=True)
        return out, int(distinct) - out_capacity, 0
    if merge == "hash":
        out, hash_over, distinct = hash_merge(
            sr, SpTuples.concat(runs), out_capacity=out_capacity,
            table_capacity=hash_table_capacity(out_capacity), n_probes=HASH_MERGE_PROBES)
        return out, int(distinct) - out_capacity, int(hash_over)
    if merge != "sort":
        raise ValueError(f"merge must be one of {MERGE_TIERS}, got {merge!r}")
    out, distinct = SpTuples.concat(runs).compact_counted(sr, capacity=out_capacity)
    return out, int(distinct) - out_capacity, 0


def _merge_heuristic(sr: Semiring, L: int, expansion_ratio: float, pieces_sorted: bool) -> str:
    """The merge tier the reference's heuristic picks: ``runs`` when the
    pieces arrive sorted, ``hash`` for unsorted pieces at four or more
    layers with a collision estimate of at least 4 (and a scatter
    combiner), ``sort`` otherwise."""
    if pieces_sorted:
        return "runs"
    if scatter_combine_for(sr) is not None and L >= 4 and expansion_ratio >= 4.0:
        return "hash"
    return "sort"


def _fibers(sr: Semiring, A: SpParMat3D, B: SpParMat3D, partial_fn, *, out_capacity: int,
            piece_capacity: int, merge: str, sort_pieces: bool):
    """The layered product's outer loop, one fiber (2D tile position (i,
    j)) at a time: each layer's partial (``partial_fn(l, i, j)``), its
    fiber pieces, then each destination layer's merge, written into the
    ``[L, pr, pc, out_capacity]`` output. Returns (C col-split, piece
    overflow, merge overflow, hash overflow)."""
    grid = A.grid
    L = grid.layers
    lr, w_out = A.tile_rows, B.tile_cols // L
    dev = grid.device
    shape = (L, grid.pr, grid.pc, out_capacity)
    rows = torch.full(shape, lr, dtype=torch.int32, device=dev)
    cols = torch.full(shape, w_out, dtype=torch.int32, device=dev)
    vals = torch.zeros(shape, dtype=A.dtype, device=dev)
    nnz = torch.zeros(shape[:3], dtype=torch.int32, device=dev)
    piece_over, merge_over, hash_over = 0, None, 0
    for i in range(grid.pr):
        for j in range(grid.pc):
            pieces = []  # [source layer][destination layer]
            for l_ in range(L):
                got, over = _fiber_exchange(partial_fn(l_, i, j), L, w_out, piece_capacity,
                                            sort_pieces)
                pieces.append(got)
                piece_over = max(piece_over, over)
            for dst in range(L):
                runs = [pieces[src][dst] for src in range(L)]
                out, mo, ho = _fiber_merge(sr, runs, out_capacity, merge)
                for src in range(L):
                    pieces[src][dst] = None
                merge_over = mo if merge_over is None else max(merge_over, mo)
                hash_over = max(hash_over, ho)
                rows[dst, i, j], cols[dst, i, j] = out.rows, out.cols
                vals[dst, i, j], nnz[dst, i, j] = out.vals, out.nnz
    C = SpParMat3D(rows=rows, cols=cols, vals=vals, nnz=nnz, nrows=A.nrows, ncols=B.ncols,
                   split="col", grid=grid)
    return C, piece_over, merge_over, hash_over


def _check_summa3d(A: SpParMat3D, B: SpParMat3D, merge: str) -> None:
    if A.split != "col" or B.split != "row":
        raise ValueError("SUMMA3D multiplies a col-split A by a row-split B")
    if A.grid != B.grid or A.ncols != B.nrows:
        raise ValueError("A and B must share a grid and the contraction dim")
    if merge not in MERGE_TIERS:
        raise ValueError(f"merge must be one of {MERGE_TIERS}, got {merge!r}")
    if A.grid.pr != A.grid.pc:
        raise ValueError("SUMMA3D requires square layer grids")
    if A.tile_cols != B.tile_rows:
        raise ValueError("contraction blocking mismatch")
    if B.tile_cols % A.grid.layers:
        raise ValueError("C's local columns must divide over the layers")


def summa3d_spgemm(sr: Semiring, A: SpParMat3D, B: SpParMat3D, *, flop_capacity: int,
                   out_capacity: int, piece_capacity: int, ring: bool = False,
                   merge: str = "sort") -> tuple[SpParMat3D, torch.Tensor]:
    """C (col-split) = A (col-split) ⊗ B (row-split) over the 3D grid: layer
    l multiplies its contraction slice by a p-stage 2D SUMMA (ESC stage
    chunks, ``ring``: the carousel's order), the L partials are exchanged
    as column pieces along the fiber and each layer merges what it
    receives (``merge``; ``"runs"`` sorts each outgoing piece first).

    ``flop_capacity``: one stage's expansion on a tile; ``piece_capacity``:
    one outgoing fiber piece; ``out_capacity``: an output tile. Returns
    ``(C, overflow)``, ``overflow`` int32 ``[3]``: the most entries a
    piece dropped, the largest distinct-key count minus
    ``out_capacity``, and the hash tier's unplaced entries (positive: the
    caller reruns through a sorted tier). Reference: ``summa3d_spgemm``
    (``Mult_AnXBn_SUMMA3D``)."""
    _check_summa3d(A, B, merge)

    def partial(l_, i, j):
        chunks = [_stage_chunk(sr, a, b, flop_capacity)
                  for a, b in _stage_pairs(A, B, l_, i, j, ring)]
        return SpTuples.concat(chunks)

    C, po, mo, ho = _fibers(sr, A, B, partial, out_capacity=out_capacity,
                            piece_capacity=piece_capacity, merge=merge,
                            sort_pieces=merge == "runs")
    return C, torch.tensor([po, mo, ho], dtype=torch.int32, device=A.grid.device)


def summa3d_stage_flops(A: SpParMat3D, B: SpParMat3D) -> torch.Tensor:
    """float32 ``[p, L, pr, pc]`` expansion slots per stage and (layer,
    tile): the symbolic pass of the 3D product (B's row walks rounded up
    to ``CHUNK_W`` lanes). Counted in int64 and rounded to float32 once,
    as the 2D pass."""
    from ..ops.spgemm import CHUNK_W

    grid = A.grid
    p = grid.pr
    lrA, lrB = A.tile_rows, B.tile_rows
    out = torch.zeros((p, grid.layers, p, p), dtype=torch.int64, device=grid.device)
    for l_ in range(grid.layers):
        for s in range(p):
            blens = []
            for j in range(p):
                t = B.local_tile(l_, s, j)
                n = torch.bincount(torch.clamp(t.rows, max=lrB).long(), minlength=lrB + 1)
                n[lrB] = 0
                blens.append(-(-n // CHUNK_W) * CHUNK_W)
            for i in range(p):
                t = A.local_tile(l_, i, s)
                k = torch.clamp(t.cols, max=lrB).long()
                valid = t.rows < lrA
                for j in range(p):
                    out[s, l_, i, j] = torch.where(valid, blens[j][k], 0).sum()
    return out.to(torch.float32)


def _check_fiber_overflow(piece_over: int, piece_cap: int, who: str, slack: float) -> None:
    """Raise, naming the slack knob, when the fiber exchange dropped
    entries."""
    if piece_over <= 0:
        return
    raise TierRefusal(
        f"{who}: fiber exchange overflowed — a piece exceeded its "
        f"piece_capacity={piece_cap} by {piece_over} entries and the "
        f"all_to_all would have dropped them; raise the sizing slack "
        f"(slack={slack} at this call; spgemm3d(..., slack=) / "
        f"{who}(..., slack=)) or pass a larger explicit piece capacity")


def _esc3d_caps(A: SpParMat3D, B: SpParMat3D, slack: float):
    """The ESC 3D tier's ``(flop, piece, out)`` capacities from the symbolic
    pass (one readback): the largest stage expansion, the largest layer
    tile's total and L times it clamped to the dense output tile, each
    times ``slack``, rounded up to powers of two."""
    L = A.grid.layers
    per_stage = host_value(summa3d_stage_flops(A, B)).astype(np.float64)
    total = per_stage.sum(axis=0).max()
    dense_tile = A.tile_rows * (B.tile_cols // L)
    rnd = lambda x: 1 << (x - 1).bit_length()  # noqa: E731
    flop_cap = rnd(max(int(per_stage.max() * slack) + 1, 1))
    piece_cap = rnd(max(int(total * slack) + 1, 1))
    out_cap = min(rnd(max(min(int(total * L * slack) + 1, dense_tile), 1)), max(dense_tile, 1))
    return flop_cap, piece_cap, out_cap


def spgemm3d(sr: Semiring, A: SpParMat3D, B: SpParMat3D, slack: float = 1.05, *,
             tier: str | None = None, backend: str | None = None, mode: str = "f32",
             block_rows: int | None = None, block_cols: int | None = None,
             merge: str | None = None, ring: bool | None = None,
             pipeline: bool | None = None,
             merge_source: str | None = None) -> SpParMat3D:
    """The sized 3D product: ``tier`` ``"esc"`` (the symbolic pass,
    capacities rounded to powers of two, ``summa3d_spgemm``) or
    ``"windowed"`` (``spgemm3d_windowed`` at ``max(slack - 0.03, 1.02)``).
    The tier resolves argument > plan store (``op="spgemm3d"``; a record
    whose tier is not esc or windowed is discarded; it replays
    ``block_rows`` / ``block_cols``, ``ring`` and ``pipeline`` where the
    argument is ``None``) > ``COMBBLAS_SPGEMM3D_TIER`` > the probe
    (``COMBBLAS_TUNER_PROBE=1``: ``tuner.probe.probe_spgemm3d`` measures
    (tier, merge) candidates on these operands and persists the winner) >
    ``"esc"``; the store is asked only when it holds entries or probing is
    on. ``merge``: the fiber merge tier, argument > the record >
    ``COMBBLAS_SPGEMM_MERGE`` > the heuristic; a hash tier on a monoid
    with no scatter combiner runs as ``runs``, and a hash overflow reruns
    the sized kernel through ``runs``. ``ring`` None means False,
    ``pipeline`` None True. ``merge_source`` is accepted and ignored (it
    labels an ``obs`` counter in the reference). ``spgemm3d.last_run``
    records the tier, ``plan_source``, ``merge_source`` and, for esc, the
    capacities and the merge that ran."""
    del merge_source
    plan_source = "arg" if tier is not None else None
    st = key = rec = None
    if tier is None:
        st = tuner_store.get_store()
        if st is not None and (st.entries() > 0 or tuner_config.probe_enabled()):
            key = tuner_store.spgemm3d_plan_key(sr, A, B,
                                                backend or tuner_config.env_backend() or "")
            rec = st.lookup(key) if st.entries() > 0 else None
            if rec is not None and rec.tier not in ("esc", "windowed"):
                rec = None  # the record vetting
            if rec is not None:
                tier, plan_source = rec.tier, "store"
                block_rows = rec.block_rows if block_rows is None else block_rows
                block_cols = rec.block_cols if block_cols is None else block_cols
                ring = rec.ring if ring is None else ring
                pipeline = rec.pipeline if pipeline is None else pipeline
    if tier is None:
        tier = tuner_config.env_tier3d()
        if tier is not None:
            plan_source = "env"
    if tier is None and st is not None and tuner_config.probe_enabled():
        from ..tuner.probe import probe_spgemm3d

        prec = probe_spgemm3d(sr, A, B, store=st, key=key)
        if prec is not None:
            tier, plan_source, rec = prec.tier, "probe", prec
            ring = prec.ring if ring is None else ring
            pipeline = prec.pipeline if pipeline is None else pipeline
    if tier is None:
        tier, plan_source = "esc", "heuristic"
    merge, merge_source = resolve_merge(merge, rec)
    if merge_source == "store" and plan_source == "probe":
        merge_source = "probe"  # the record came from this call's probe
    if tier not in ("esc", "windowed"):
        raise ValueError(f"spgemm3d tier must be 'esc' or 'windowed', got {tier!r}")
    spgemm3d.last_run = {"tier": tier, "plan_source": plan_source,
                         "merge_source": merge_source}
    ring = False if ring is None else bool(ring)
    pipeline = True if pipeline is None else bool(pipeline)
    if tier == "windowed":
        return spgemm3d_windowed(sr, A, B, block_rows=block_rows, block_cols=block_cols,
                                 backend=backend, mode=mode, slack=max(slack - 0.03, 1.02),
                                 merge=merge, ring=ring, pipeline=pipeline)
    if ring and not pipeline:
        raise ValueError("spgemm3d: the esc tier's carousel has no serial "
                         "(pipeline=False) control — use tier='windowed' for the "
                         "pipelined-vs-serial A/B")
    L = A.grid.layers
    flop_cap, piece_cap, out_cap = _esc3d_caps(A, B, slack)
    if merge is None:
        merge = _merge_heuristic(sr, L, piece_cap * L / max(out_cap, 1), pieces_sorted=False)
    if merge == "hash" and scatter_combine_for(sr) is None:
        merge = "runs"
    if merge not in MERGE_TIERS:
        raise ValueError(f"merge must be one of {MERGE_TIERS}, got {merge!r}")

    def run_kernel(mg):
        return summa3d_spgemm(sr, A, B, flop_capacity=flop_cap, out_capacity=out_cap,
                              piece_capacity=piece_cap, ring=ring, merge=mg)

    C, overflow = run_kernel(merge)
    piece_over, merge_over, hash_over = (int(x) for x in host_value(overflow))
    spgemm3d.last_run.update(merge=merge, flop_capacity=flop_cap, piece_capacity=piece_cap,
                             out_capacity=out_cap, hash_overflow=hash_over)
    _check_fiber_overflow(piece_over, piece_cap, "spgemm3d", slack)
    if hash_over > 0:
        C, overflow = run_kernel("runs")
        piece_over, merge_over, _ = (int(x) for x in host_value(overflow))
        spgemm3d.last_run["merge"] = "runs"
        _check_fiber_overflow(piece_over, piece_cap, "spgemm3d", slack)
    if merge_over > 0:
        raise TierRefusal(f"spgemm3d: merge distinct keys exceeded out_capacity by "
                         f"{merge_over}; raise slack")
    return C


spgemm3d.last_run = None


def mem_efficient_spgemm3d(sr: Semiring, A: SpParMat3D, B: SpParMat3D, phases: int, *,
                           slack: float = 1.05, prune_fn=None) -> SpParMat3D:
    """Phased 3D SUMMA: B (row-split) ``col_split`` into ``phases`` strided
    pieces, one ``spgemm3d`` a piece (pruned by ``prune_fn`` where given),
    the outputs put back with ``col_concatenate``. A phase count that
    does not split the tile columns snaps down to the nearest one that
    does, with a warning. Reference: ``MemEfficientSpGEMM3D``."""
    L = B.grid.layers
    if B.split != "row":
        raise ValueError("mem_efficient_spgemm3d phases the row-split operand B; got "
                         f"split={B.split!r} (build B with split='row')")

    def splittable(ph: int) -> bool:
        return B.tile_cols % (L * ph) == 0 and B.ncols % ph == 0

    if phases > 1 and not splittable(phases):
        snapped = max((ph for ph in range(phases - 1, 0, -1) if splittable(ph)), default=1)
        warnings.warn(
            f"mem_efficient_spgemm3d: tile_cols={B.tile_cols} / ncols={B.ncols} not "
            f"splittable into {phases} phases with {L} layers (needs tile_cols % "
            f"(layers*phases) == 0 and ncols % phases == 0); snapping to {snapped} phases",
            stacklevel=2)
        phases = snapped
    if phases <= 1:
        C = spgemm3d(sr, A, B, slack)
        return prune_fn(C) if prune_fn is not None else C
    outs = []
    for Bs in B.col_split(phases):
        C = spgemm3d(sr, A, Bs.shrink_to_fit(), slack)
        outs.append(prune_fn(C) if prune_fn is not None else C)
    return SpParMat3D.col_concatenate(outs)


# --- the windowed 3D SUMMA -----------------------------------------------------------


def summa3d_window_flops_pair(A3: SpParMat3D, B3: SpParMat3D, block_rows: int,
                              block_cols: int, chunk_w: int = 1) -> torch.Tensor:
    """float32 ``[2, L, nblocks, ncolwin, p, pr, pc]``: per layer, (A row
    block, B column window), stage and tile, the counts padded to
    ``chunk_w`` (index 0) and true (index 1): the 2D window pass run on
    each layer's slices. Exact in int64, rounded to float32 once."""
    _check_summa3d(A3, B3, "sort")
    grid = A3.grid
    p = grid.pr
    lrA, lrB, lcB = A3.tile_rows, B3.tile_rows, B3.tile_cols
    nblocks = -(-lrA // block_rows)
    ncw = -(-lcB // block_cols)
    out = torch.zeros((2, grid.layers, nblocks, ncw, p, p, p), dtype=torch.int64,
                      device=grid.device)
    for l_, i, j in _tiles(grid):
        for s in range(p):
            out[:, l_, :, :, s, i, j] = _window_stage_symbolic(
                A3.local_tile(l_, i, s), B3.local_tile(l_, s, j), lrA, lrB, block_rows,
                block_cols, nblocks, ncw, chunk_w)
    return out.to(torch.float32)


def summa3d_window_flops_host(grid3: Grid3D, rows_a, cols_a, rows_b, cols_b, nrows_a: int,
                              ncols_a: int, ncols_b: int, block_rows: int, block_cols: int,
                              chunk_w: int = 0) -> np.ndarray:
    """``summa3d_window_flops_pair`` (one ``chunk_w`` at a time, 0 for the
    true counts) from global host COO arrays: float64 ``[L, nblocks,
    ncolwin, p, pr, pc]``, with no device work."""
    L = grid3.layers
    p = grid3.pr
    if grid3.pr != grid3.pc:
        raise ValueError("SUMMA3D requires square layer grids")
    lrA, lcA = grid3.local_rows(nrows_a), grid3.local_cols(ncols_a)
    lrB, lcB = grid3.local_rows(ncols_a), grid3.local_cols(ncols_b)
    if lcA != lrB or lcA % L or lrB % L:
        raise ValueError(f"A col-blocking must equal B row-blocking and divide over the "
                         f"layers ({lcA}, {lrB}, {L})")
    tcA = lcA // L  # A's per-layer contraction slice, B's tile rows
    nb = -(-lrA // block_rows)
    ncw = -(-lcB // block_cols)
    rows_a, cols_a, rows_b, cols_b = (np.asarray(x, np.int64)
                                      for x in (rows_a, cols_a, rows_b, cols_b))
    ia, sa = rows_a // lrA, cols_a // lcA
    la, ka = (cols_a % lcA) // tcA, (cols_a % lcA) % tcA
    ga = (rows_a % lrA) // block_rows
    count_a = np.bincount(((((la * p + ia) * p + sa) * nb) + ga) * tcA + ka,
                          minlength=L * p * p * nb * tcA).reshape(L, p, p, nb, tcA)
    sb, jb = rows_b // lrB, cols_b // lcB
    lb, kb = (rows_b % lrB) // tcA, (rows_b % lrB) % tcA
    hb = (cols_b % lcB) // block_cols
    count_b = np.bincount(((((lb * p + sb) * p + jb) * ncw) + hb) * tcA + kb,
                          minlength=L * p * p * ncw * tcA).reshape(L, p, p, ncw, tcA)
    if chunk_w:
        count_b = -(-count_b // chunk_w) * chunk_w
    # flops[l, g, h, s, i, j] = sum_k countA[l, i, s, g, k] * countB[l, s, j, h, k]
    return np.einsum("lisgk,lsjhk->lghsij", count_a, count_b).astype(np.float64)


def summa3d_window_bnnz(B3: SpParMat3D, block_cols: int) -> torch.Tensor:
    """int32 ``[L, pr, pc, ncolwin]``: B's entries per layer tile and column
    window (the 3D dot backend's panel slice capacity)."""
    lrB, lcB = B3.tile_rows, B3.tile_cols
    ncw = -(-lcB // block_cols)
    g = B3.grid
    out = torch.zeros((g.layers, g.pr, g.pc, ncw), dtype=torch.int32, device=g.device)
    for l_, i, j in _tiles(g):
        t = B3.local_tile(l_, i, j)
        valid = t.rows < lrB
        h = torch.where(valid, t.cols // block_cols, ncw).long()
        out[l_, i, j] = torch.bincount(h, minlength=ncw + 1)[:ncw].to(torch.int32)
    return out


def summa3d_window_bnnz_host(grid3: Grid3D, rows_b, cols_b, ncols_a: int, ncols_b: int,
                             block_cols: int) -> np.ndarray:
    """``summa3d_window_bnnz`` from global host COO arrays."""
    L = grid3.layers
    lrB, lcB = grid3.local_rows(ncols_a), grid3.local_cols(ncols_b)
    trB = lrB // L
    ncw = -(-lcB // block_cols)
    rows_b, cols_b = np.asarray(rows_b, np.int64), np.asarray(cols_b, np.int64)
    sb, jb = rows_b // lrB, cols_b // lcB
    lb = (rows_b % lrB) // trB
    hb = (cols_b % lcB) // block_cols
    return np.bincount((((lb * grid3.pr + sb) * grid3.pc + jb) * ncw) + hb,
                       minlength=L * grid3.pr * grid3.pc * ncw).reshape(
                           L, grid3.pr, grid3.pc, ncw)


def windowed_plan3d(per_window_padded, per_window_true, block_rows: int, block_cols: int,
                    tile_rows: int, tile_cols_b: int, slack: float = 1.02):
    """The 2D plan (``windowed_plan_2d``) over ``[L, nb, ncw, p, pr, pc]``
    counts with the layer axis folded into the tile axes: each window's
    caps are the largest over layers, and a window is skipped only when
    every layer's count is zero."""
    def fold(x):
        return None if x is None else np.moveaxis(np.asarray(x, np.float64), 0, 3)

    return windowed_plan_2d(fold(per_window_padded), fold(per_window_true), block_rows,
                            block_cols, tile_rows, tile_cols_b, slack=slack)


def summa3d_spgemm_windowed(sr: Semiring, A3: SpParMat3D, B3: SpParMat3D, *, block_rows: int,
                            flop_caps: tuple, out_caps: tuple, skip: tuple,
                            backend: str = "scatter", mode: str = "f32", chunk_w: int = 8,
                            block_cols: int | None = None, panel_cap: int | None = None,
                            piece_capacity: int, out_capacity: int, ring: bool = False,
                            pipeline: bool = True,
                            merge: str = "sort") -> tuple[SpParMat3D, torch.Tensor]:
    """C (col-split) = A (col-split) ⊗ B (row-split): the windowed 3D
    SUMMA. Each layer runs the 2D windowed tier's accumulate and extract
    core on its slices (``_windowed_gathered_compute``, or with ``ring``
    the carousel's ``_windowed_carousel_compute``), for both backends
    (``dot``: the tropical stage products are the semiring GEMM, K1 on
    the card, one launch a layer, tile, stage and live window); the L
    partials ride the fiber exchange and the ``merge`` tier. Scatter and
    1D-dot partials are row-sorted, so ``runs`` needs no pre-sort there;
    2D-dot pieces are sorted on the exchange side. ``pipeline`` changes
    nothing (eager torch has no rotation to overlap).

    Returns ``(C, overflow)``, int32 ``[4]``: the extraction's largest
    count over its cap, the fiber piece drop, the distinct-key count
    minus ``out_capacity``, the hash tier's unplaced entries. Reference:
    ``summa3d_spgemm_windowed``."""
    del pipeline
    _check_summa3d(A3, B3, merge)
    grid = A3.grid
    L = grid.layers
    lr, lrB, lcB = A3.tile_rows, B3.tile_rows, B3.tile_cols
    two_d = backend == "dot" and block_cols is not None
    if backend == "dot":
        if sr.name not in _PALLAS_KINDS:
            raise ValueError(f"backend='dot' supports semirings {sorted(_PALLAS_KINDS)}; "
                             f"got {sr.name}")
        _check_dot_dtype(sr, A3.dtype)
        if two_d and (panel_cap is None or panel_cap < 1):
            raise ValueError("the 2D dot backend needs panel_cap >= 1")
    elif backend != "scatter":
        raise ValueError(f"backend must be 'dot' or 'scatter', got {backend!r}")
    if scatter_combine_for(sr) is None:
        raise ValueError(f"semiring {sr.name} has no scatter combiner; use the esc tier")
    win = _Windows(sr, lrA=lr, lrB=lrB, lcB=lcB, block_rows=block_rows, flop_caps=flop_caps,
                   out_caps=out_caps, skip=skip, backend=backend, mode=mode, chunk_w=chunk_w,
                   block_cols=block_cols if two_d else None, panel_cap=panel_cap,
                   zero=float(sr.zero_fn(A3.dtype)), dtype=A3.dtype, device=grid.device)
    compute = _windowed_carousel_compute if ring else _windowed_gathered_compute
    worst = [0]

    def partial(l_, i, j):
        chunks, over = compute(win, _stage_pairs(A3, B3, l_, i, j, ring))
        worst[0] = max(worst[0], int(over))
        if not chunks:  # every window skipped on this layer
            return SpTuples.empty(lr, lcB, 1, A3.dtype, device=grid.device)
        return SpTuples.concat(chunks)

    C, po, mo, ho = _fibers(sr, A3, B3, partial, out_capacity=out_capacity,
                            piece_capacity=piece_capacity, merge=merge,
                            sort_pieces=merge == "runs" and two_d)
    return C, torch.tensor([worst[0], po, mo, ho], dtype=torch.int32, device=grid.device)


def summa3d_compatible(grid3: Grid3D, nrows_a: int, ncols_a: int, ncols_b: int) -> bool:
    """True iff (A: nrows_a × ncols_a) ⊗ (B: ncols_a × ncols_b) can be laid
    out on ``grid3``: a square layer grid, and A's col-split, B's row-split
    and C's fiber pieces all divide evenly over the layers (the router's
    gate before the 3D tier)."""
    L = grid3.layers
    if grid3.pr != grid3.pc:
        return False
    lcA = grid3.local_cols(ncols_a)
    lrB = grid3.local_rows(ncols_a)
    lcB = grid3.local_cols(ncols_b)
    return lcA == lrB and lcA % L == 0 and lrB % L == 0 and lcB % L == 0


def spgemm3d_windowed(sr: Semiring, A3: SpParMat3D, B3: SpParMat3D, *,
                      block_rows: int | None = None, block_cols: int | None = None,
                      backend: str | None = None, mode: str = "f32", slack: float = 1.02,
                      merge: str | None = None, ring: bool = False, pipeline: bool = True,
                      merge_source: str | None = None) -> SpParMat3D:
    """The windowed 3D tier's entry: the 3D window pass (one readback),
    ``windowed_plan3d`` (caps the largest over layers), then
    ``summa3d_spgemm_windowed``. The fiber piece and merge capacities come
    from the same symbolic bounds. ``merge`` None: ``COMBBLAS_SPGEMM_MERGE``,
    else the heuristic (``runs`` for scatter's sorted pieces, ``sort`` or
    ``hash`` for the 2D dot's);
    a hash overflow reruns the product through ``runs``; a fiber piece
    overflow raises naming ``slack``. ``merge_source`` is accepted and
    ignored (an ``obs`` label in the reference; ``obs`` waits for ROADMAP
    item 13b). ``spgemm3d_windowed.last_plan`` records the last
    call's plan (backend, blocks, windows, packed, caps, merge)."""
    del merge_source
    backend = resolve_spgemm_backend(backend)
    L = A3.grid.layers
    lr, lrB, lcB = A3.tile_rows, B3.tile_rows, B3.tile_cols
    chunk_w = WINDOWED_CHUNK_W
    if block_rows is None:
        block_rows = default_block_rows(lr, lcB)
    if backend == "dot":
        _check_dot_dtype(sr, A3.dtype)
        if block_cols is None:
            block_cols = default_block_cols(lrB, lcB)
        pair = host_value(summa3d_window_flops_pair(A3, B3, block_rows, block_cols, chunk_w=1))
        flop_caps, out_caps, skip = windowed_plan3d(None, pair[1], block_rows, block_cols, lr,
                                                    lcB, slack=slack)
        panel_cap = panel_cap_from_bnnz(host_value(summa3d_window_bnnz(B3, block_cols)),
                                        int(B3.capacity))
        packed = len(packed_windows_2d(skip))
        per_block_bound = [sum(row) for row in out_caps]
        pieces_sorted = False  # 2D dot chunks are window-major
    else:
        pair = host_value(summa3d_window_flops_pair(A3, B3, block_rows, lcB, chunk_w=chunk_w))
        fc2, oc2, sk2 = windowed_plan3d(pair[0], pair[1], block_rows, lcB, lr, lcB,
                                        slack=slack)
        flop_caps = tuple(row[0] for row in fc2)
        out_caps = tuple(row[0] for row in oc2)
        skip = tuple(row[0] for row in sk2)
        block_cols = panel_cap = None
        packed = len(packed_windows(skip))
        per_block_bound = list(out_caps)
        pieces_sorted = True
    rnd = lambda x: 1 << (max(int(x), 1) - 1).bit_length()  # noqa: E731
    piece_cap = rnd(min(sum(per_block_bound), lr * lcB))
    out_cap = min(rnd(piece_cap * L), max(lr * (lcB // L), 1))
    if merge is None:
        merge = tuner_config.env_merge()
    if merge is None:
        merge = _merge_heuristic(sr, L, piece_cap * L / max(out_cap, 1), pieces_sorted)
    if merge not in MERGE_TIERS:
        raise ValueError(f"merge must be one of {MERGE_TIERS}, got {merge!r}")
    C, overflow = summa3d_spgemm_windowed(
        sr, A3, B3, block_rows=block_rows, flop_caps=flop_caps, out_caps=out_caps, skip=skip,
        backend=backend, mode=mode, chunk_w=chunk_w, block_cols=block_cols,
        panel_cap=panel_cap, piece_capacity=piece_cap, out_capacity=out_cap, ring=ring,
        merge=merge)
    spgemm3d_windowed.last_plan = {
        "backend": backend, "block_rows": block_rows, "block_cols": block_cols,
        "panel_cap": panel_cap, "blocks": len(skip), "packed": packed, "merge": merge,
        "piece_capacity": piece_cap, "out_capacity": out_cap, "flop_caps": flop_caps,
        "out_caps": out_caps, "skip": skip}
    extract_over, piece_over, merge_over, hash_over = (int(x) for x in host_value(overflow))
    _check_fiber_overflow(piece_over, piece_cap, "spgemm3d_windowed", slack)
    if hash_over > 0:
        C = spgemm3d_windowed(sr, A3, B3, block_rows=block_rows, block_cols=block_cols,
                              backend=backend, mode=mode, slack=slack, merge="runs", ring=ring,
                              pipeline=pipeline)
        spgemm3d_windowed.last_plan["hash_overflow"] = hash_over
        return C
    if extract_over > 0 or merge_over > 0:
        raise TierRefusal(f"windowed 3D tier overflowed its symbolic bound (extraction "
                         f"{extract_over}, merge {merge_over})")
    return C


spgemm3d_windowed.last_plan = None


# --- 2D <-> 3D conversions and routing -------------------------------------------


def _globalize2d(A):
    """2D tile arrays → global-id ``[pr, pc, cap]`` arrays (padding →
    ``nrows`` / ``ncols``)."""
    g = A.grid
    lr, lc = A.local_rows, A.local_cols
    valid = A.rows < lr
    ioff = torch.arange(g.pr, dtype=torch.int32, device=g.device)[:, None, None]
    joff = torch.arange(g.pc, dtype=torch.int32, device=g.device)[None, :, None]
    gr = torch.where(valid, A.rows + ioff * lr, A.nrows)
    gc = torch.where(valid, A.cols + joff * lc, A.ncols)
    return gr.to(torch.int32), gc.to(torch.int32), A.vals


def _globalize3d(A3: SpParMat3D):
    """3D tile arrays → global-id ``[L, pr, pc, cap]`` arrays (split-aware)."""
    g = A3.grid
    lr, lc = g.local_rows(A3.nrows), g.local_cols(A3.ncols)
    tr, tc = A3.tile_rows, A3.tile_cols
    valid = A3.rows < tr
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=g.device)  # noqa: E731
    loff = ar(g.layers)[:, None, None, None]
    ioff = ar(g.pr)[None, :, None, None]
    joff = ar(g.pc)[None, None, :, None]
    if A3.split == "col":
        gr, gc = A3.rows + ioff * lr, A3.cols + joff * lc + loff * tc
    else:
        gr, gc = A3.rows + ioff * lr + loff * tr, A3.cols + joff * lc
    gr = torch.where(valid, gr, A3.nrows)
    gc = torch.where(valid, gc, A3.ncols)
    return gr.to(torch.int32), gc.to(torch.int32), A3.vals


def _route_with_retry(route, chunk_cap: int, dest_fanouts, total: int, ndev: int, slack: float,
                      max_retries: int, what: str):
    """Size stage and tile capacities from the chunk shape and the total
    nnz, route (``route(stage_cap, tile_cap)`` → (dropped count, a
    function that builds the matrix)), and double both on dropped
    tuples."""
    per_dest = max(-(-chunk_cap // f) for f in dest_fanouts)
    stage_cap = 1 << max(int(np.ceil(np.log2(max(per_dest * slack, 1)))), 0)
    tile_cap = 1 << max(int(np.ceil(np.log2(max(total / ndev * slack, 1)))), 0)
    nd = 0
    for _ in range(max_retries + 1):
        nd, build = route(stage_cap, tile_cap)
        if nd == 0:
            return build()
        stage_cap *= 2
        tile_cap *= 2
    raise TierRefusal(f"{what} dropped {nd} tuples after {max_retries} capacity doublings")


def _rechunk(arr: torch.Tensor, ndev: int, sentinel):
    """Flatten tuple chunks and re-split them over ``ndev`` tiles, the tail
    padded with ``sentinel`` (an invalid row id, which routing drops)."""
    flat = arr.reshape(-1)
    chunk = -(-flat.shape[0] // ndev)
    pad = ndev * chunk - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), sentinel)])
    return flat, chunk


def _ravel(coords, dims):
    out = coords[0]
    for x, d in zip(coords[1:], dims[1:]):
        out = out * d + x
    return out


def _keep_first(key, keep, nkeys: int, cap: int):
    """Keep the first ``cap`` tuples of each key in flat order, among those
    that ``keep`` holds (None: all of them). Returns (the new mask, None
    while all are kept; the number dropped)."""
    k = key if keep is None else torch.where(keep, key, nkeys)
    counts = torch.bincount(k, minlength=nkeys + 1)
    nd = int(torch.clamp(counts[:nkeys] - cap, min=0).sum())
    if nd == 0:
        return keep, 0
    ks, order = torch.sort(k, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(k.numel(), device=k.device) - starts[ks]
    ok = rank < cap
    return (ok if keep is None else keep & ok), nd


class _TupleRoute:
    """The reference's fixed-capacity multi-hop routing of flat tuple
    chunks, made on the valid tuples alone. Each hop delivers a tile's
    buckets in source order, so a tuple's slot in every tile it passes
    follows its flat position in the source arrays, whatever the chunks and
    their padding: a hop's (tile, destination) bucket keeps its first
    ``stage_cap`` tuples in that order and the owner tile its first
    ``tile_cap``, and the rest are dropped and counted as the reference
    counts them. ``dims``: the routing grid's axes; ``hops``: the axes
    routed along, in order; ``dest``: each tuple's owner coordinates;
    ``columns``: (values a tuple, padding fill) pairs; ``make(tiles,
    counts)``: the matrix of the ``[*dims, tile_cap]`` column tiles. The
    tuples come in ascending flat position ``flat_idx``."""

    def __init__(self, flat_idx, chunk: int, dims, hops, dest, columns, make):
        self.dims, self.hops, self.dest = dims, hops, dest
        self.columns, self.make = columns, make
        t, src = flat_idx // chunk, []
        for d in reversed(dims):
            src.append(t % d)
            t = t // d
        self.src = src[::-1]
        self.owner = _ravel(dest, dims)
        self.ntiles = int(np.prod(dims))

    def route(self, stage_cap: int, tile_cap: int):
        """(dropped count, a function that builds the matrix)."""
        keep, nd, pos = None, 0, list(self.src)
        for a in self.hops:
            key = _ravel(pos, self.dims) * self.dims[a] + self.dest[a]
            keep, d = _keep_first(key, keep, self.ntiles * self.dims[a], stage_cap)
            nd += d
            pos[a] = self.dest[a]
        keep, d = _keep_first(self.owner, keep, self.ntiles, tile_cap)
        return nd + d, lambda: self.make(*self._place(keep, tile_cap))

    def _place(self, keep, tile_cap: int):
        """The kept tuples' columns as ``[*dims, tile_cap]`` tiles in the
        owners' slot order, and the counts."""
        owner = self.owner if keep is None else self.owner[keep]
        dsorted, order = torch.sort(owner, stable=True)
        counts = torch.bincount(owner, minlength=self.ntiles)
        starts = torch.cumsum(counts, 0) - counts
        slot = dsorted * tile_cap + torch.arange(dsorted.numel(), device=dsorted.device) \
            - starts[dsorted]
        outs = []
        for x, fill in self.columns:
            x = x if keep is None else x[keep]
            out = torch.full((self.ntiles * tile_cap,), fill, dtype=x.dtype, device=x.device)
            out[slot] = x[order]
            outs.append(out.view(*self.dims, tile_cap))
        return outs, counts.to(torch.int32).view(*self.dims)


def _valid_flat(gr, gc, gv, nrows: int):
    """The valid tuples of globalized tile arrays, in flat slot order, and
    their flat slot indices."""
    idx = torch.nonzero(gr.reshape(-1) < nrows).squeeze(1)
    return idx, gr.reshape(-1)[idx], gc.reshape(-1)[idx], gv.reshape(-1)[idx]


def _route3d(grid3: Grid3D, idx, r, c, v, chunk: int, nrows: int, ncols: int, split: str):
    """``redistribute_coo3d`` of the valid tuples ``(r, c, v)`` at flat
    slots ``idx`` of ``chunk``-slot source tiles: ``route(stage_cap,
    tile_cap)`` → (dropped count, a function that builds the SpParMat3D)."""
    (layer, i, j, lrow, lcol), (tr, tc) = _owner3d(r, c, grid3, nrows, ncols, split)
    columns = ((lrow.to(torch.int32), tr), (lcol.to(torch.int32), tc), (v, 0))

    def make(tiles, nnz):
        R, C, V = tiles
        return SpParMat3D(rows=R, cols=C, vals=V, nnz=nnz, nrows=int(nrows), ncols=int(ncols),
                          split=split, grid=grid3)

    return _TupleRoute(idx, chunk, (grid3.layers, grid3.pr, grid3.pc), (2, 1, 0),
                       [layer.long(), i.long(), j.long()], columns, make).route


def redistribute_coo3d(grid: Grid3D, rows: torch.Tensor, cols: torch.Tensor,
                       vals: torch.Tensor, nrows: int, ncols: int, *, split: str,
                       stage_capacity: int, tile_capacity: int):
    """Route tile-resident GLOBAL tuples to their 3D owner tiles.

    rows/cols/vals: ``[L, pr, pc, chunk]`` global tuples a tile (invalid
    slots: row >= nrows). The reference's three fixed-capacity hops, each
    a bucketing and an exchange along one axis: by owner column along the
    grid row, by owner row along the grid column, by owner layer along the
    fiber. Tuples past a full bucket or a full tile are dropped and
    counted (``_TupleRoute``). Returns (SpParMat3D with ``tile_capacity``
    slots a tile, dropped count int32 0-dim). Reference:
    ``redistribute_coo3d``."""
    idx, r, c, v = _valid_flat(rows, cols, vals, nrows)
    nd, build = _route3d(grid, idx, r, c, v, rows.shape[-1], nrows, ncols, split)(
        stage_capacity, tile_capacity)
    return build(), torch.tensor(nd, dtype=torch.int32, device=grid.device)


def spmat3d_from_spmat(A, grid3: Grid3D, split: str = "col", *, slack: float = 2.0,
                       max_retries: int = 3) -> SpParMat3D:
    """2D → 3D on the device (≈ ``SpParMat3D(SpParMat&)``): globalize the
    2D tiles, re-split the tuple chunks over the 3D grid's tiles and route
    them (``redistribute_coo3d``'s hops, retried with doubled capacities).
    The 2D grid may have any shape; the 3D split dim must divide over the
    layers."""
    ndev3 = grid3.size
    gr, gc, gv = _globalize2d(A)
    cap = -(-gr.numel() // ndev3)
    idx, r, c, v = (x.to(grid3.device) for x in _valid_flat(gr, gc, gv, A.nrows))
    route = _route3d(grid3, idx, r, c, v, cap, A.nrows, A.ncols, split)
    return _route_with_retry(route, cap, (grid3.pc, grid3.pr, grid3.layers), int(A.nnz.sum()),
                             ndev3, slack, max_retries, "2D→3D conversion")


def spmat_from_spmat3d(A3: SpParMat3D, grid2: Grid, *, slack: float = 2.0,
                       max_retries: int = 3):
    """3D → 2D on the device: globalize, re-split the chunks over the 2D
    grid's tiles, route with the 2D ``redistribute_coo``'s two hops."""
    gr, gc, gv = _globalize3d(A3)
    cap = -(-gr.numel() // grid2.size)
    idx, r, c, v = (x.to(grid2.device) for x in _valid_flat(gr, gc, gv, A3.nrows))
    lr, lc = grid2.local_rows(A3.nrows), grid2.local_cols(A3.ncols)
    i, j = torch.div(r, lr, rounding_mode="floor"), torch.div(c, lc, rounding_mode="floor")
    columns = (((r - i * lr).to(torch.int32), lr), ((c - j * lc).to(torch.int32), lc), (v, 0))

    def make(tiles, nnz):
        R, C, V = tiles
        return SpParMat(rows=R, cols=C, vals=V, nnz=nnz, nrows=A3.nrows, ncols=A3.ncols,
                        grid=grid2)

    route = _TupleRoute(idx, cap, (grid2.pr, grid2.pc), (1, 0), [i.long(), j.long()], columns,
                        make).route
    return _route_with_retry(route, cap, (grid2.pc, grid2.pr), int(A3.nnz.sum()), grid2.size,
                             slack, max_retries, "3D→2D conversion")


def resplit3d_fixed(A3: SpParMat3D, split: str, *, stage_capacity: int,
                    tile_capacity: int) -> tuple[SpParMat3D, torch.Tensor]:
    """``resplit3d`` at the caller's capacities, with no retry: returns
    (converted matrix, dropped count as a 0-dim device tensor)."""
    if A3.split == split:
        return A3, torch.zeros((), dtype=torch.int32, device=A3.grid.device)
    gr, gc, gv = _globalize3d(A3)
    return redistribute_coo3d(A3.grid, gr, gc, gv, A3.nrows, A3.ncols, split=split,
                              stage_capacity=stage_capacity, tile_capacity=tile_capacity)


def resplit3d(A3: SpParMat3D, split: str, *, slack: float = 2.0,
              max_retries: int = 3) -> SpParMat3D:
    """Between col-split and row-split on the same 3D grid (SUMMA3D takes a
    col-split A and a row-split B and gives a col-split C): globalize and
    ``redistribute_coo3d``'s three hops, retried with doubled capacities."""
    if A3.split == split:
        return A3
    gr, gc, gv = _globalize3d(A3)
    g3 = A3.grid
    route = _route3d(g3, *_valid_flat(gr, gc, gv, A3.nrows), gr.shape[-1], A3.nrows, A3.ncols,
                     split)
    return _route_with_retry(route, gr.shape[-1], (g3.pc, g3.pr, g3.layers), int(A3.nnz.sum()),
                             g3.size, slack, max_retries, "3D resplit")


# --- 3D column operations (MCL's support ops on a col-split SpParMat3D) -------
#
# A col-split matrix keeps every global column inside one (layer, grid
# column) tile column, spread over the pr row tiles: a column fold is a
# per-tile segment fold combined over the grid rows, as in 2D. Column
# vectors are [L, pc, tile_cols].


def _check_colsplit(A3: SpParMat3D) -> None:
    if A3.split != "col":
        raise ValueError("3D column ops operate on col-split matrices (columns partitioned "
                         "over layer x grid-col); resplit row-split matrices first")


def reduce3d_cols(sr: Semiring, A3: SpParMat3D, map_fn=None) -> torch.Tensor:
    """Per-column fold over rows → ``[L, pc, tile_cols]`` (≈ ``Reduce(Column)``
    on each layer)."""
    _check_colsplit(A3)
    g, tc = A3.grid, A3.tile_cols

    def local(l_, i, j):
        t = A3.local_tile(l_, i, j)
        v = map_fn(t.vals) if map_fn is not None else t.vals
        return segment_reduce(sr, v, t.cols, tc)

    return torch.stack([torch.stack([combine_tiles(sr, [local(l_, i, j) for i in range(g.pr)])
                                     for j in range(g.pc)]) for l_ in range(g.layers)])


def nnz_per_column3d(A3: SpParMat3D) -> torch.Tensor:
    """int32 ``[L, pc, tile_cols]`` per-column entry counts."""
    _check_colsplit(A3)
    g, tc = A3.grid, A3.tile_cols
    out = torch.zeros((g.layers, g.pc, tc + 1), dtype=torch.int32, device=g.device)
    for l_, i, j in _tiles(g):
        t = A3.local_tile(l_, i, j)
        ids = torch.where(t.valid_mask(), t.cols, tc).long()
        out[l_, j] += torch.bincount(ids, minlength=tc + 1).to(torch.int32)
    return out[..., :tc]


def kselect3d(A3: SpParMat3D, k: int, kvec: torch.Tensor | None = None) -> torch.Tensor:
    """Per-column k-th largest value → ``[L, pc, tile_cols]``; columns with
    fewer than k entries get the dtype's least value. The 2D ``kselect``'s
    radix select over ``monotone_key_u32`` keys, 32 rounds. ``kvec``: an
    optional ``[L, pc, tile_cols]`` per-column k. Reference: ``kselect3d``
    (≈ ``SpParMat::Kselect1``)."""
    _check_colsplit(A3)
    g, tc = A3.grid, A3.tile_cols
    dev = g.device
    kcol = (kvec.to(torch.int32) if kvec is not None
            else torch.full((g.layers, g.pc, tc), int(k), dtype=torch.int32, device=dev))
    live = {}
    for l_, i, j in _tiles(g):
        t = A3.local_tile(l_, i, j)
        m = t.valid_mask()
        live[l_, i, j] = (t.cols[m].long(), monotone_key_u32(t.vals[m]))

    def count(above):
        out = torch.zeros((g.layers, g.pc, tc), dtype=torch.long, device=dev)
        for (l_, i, j), (ids, keys) in live.items():
            hit = torch.ones_like(ids) if above is None else (
                keys >= above[l_, j].index_select(0, ids)).long()
            out[l_, j].index_add_(0, ids, hit)
        return out

    total = count(None)
    thresh = torch.zeros((g.layers, g.pc, tc), dtype=torch.long, device=dev)
    for b in range(31, -1, -1):
        cand = thresh | (1 << b)
        thresh = torch.where(count(cand) >= kcol, cand, thresh)
    out = key_u32_to_val(thresh, A3.dtype)
    return torch.where(total < kcol, torch.full_like(out, _minval(A3.dtype)), out)


def prune_column3d(A3: SpParMat3D, colvec: torch.Tensor, keep) -> SpParMat3D:
    """Keep entry (i, j) iff ``keep(val, colvec[j])`` (≈
    ``SpParMat::PruneColumn``)."""
    _check_colsplit(A3)

    def f(t, l_, i, j):
        v = colvec[l_, j]
        idx = torch.clamp(t.cols, max=v.shape[0] - 1)
        return t._select(t.valid_mask() & keep(t.vals, v.index_select(0, idx)))

    return A3.tile_map(f)


def prune3d(A3: SpParMat3D, pred) -> SpParMat3D:
    """Drop the entries where ``pred(val)`` (≈ ``SpParMat::Prune``)."""
    return A3.tile_map(lambda t, l_, i, j: t.prune(pred))


def apply3d(A3: SpParMat3D, fn) -> SpParMat3D:
    """``fn`` on the values of the valid entries (≈ ``SpParMat::Apply``)."""
    valid = A3.rows < A3.tile_rows
    return dataclasses.replace(A3, vals=torch.where(valid, fn(A3.vals), A3.vals))


def dim_apply3d_cols(A3: SpParMat3D, colvec: torch.Tensor, fn) -> SpParMat3D:
    """``vals[i, j] = fn(vals[i, j], colvec[j])`` (≈
    ``SpParMat::DimApply(Column)``); a padding slot reads an appended 0."""
    _check_colsplit(A3)

    def f(t, l_, i, j):
        v = colvec[l_, j]
        vpad = torch.cat([v, v.new_zeros(1)])
        idx = torch.clamp(t.cols, max=v.shape[0])
        new = torch.where(t.valid_mask(), fn(t.vals, vpad.index_select(0, idx)), t.vals)
        return dataclasses.replace(t, vals=new)

    return A3.tile_map(f)
