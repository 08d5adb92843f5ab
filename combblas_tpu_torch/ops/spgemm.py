"""Local SpGEMM building blocks — counterpart of
``combblas_tpu/ops/spgemm.py``: the ESC kernel (expand, sort, compress:
``flops``, ``flops_padded``, ``expand``, ``local_spgemm``, ``mask_rows``),
the sorted-run merge (``merge_sorted_runs``), the bit-packed output-support
oracle (``pack_support_bits``, ``popcount32``, ``popcount_pair_counts``,
``combine_hilo``, ``spgemm_support_bits``), and what the dense (mxu) tier
uses: tile densification, dense-to-sparse extraction
(``sparsify_windowed``, ``sparsify``) with its exact sizing
(``dense_support_nnz``) and the COO duplicate check; and what the windowed
tier adds: the dense fold of its scatter backend
(``accumulate_block_scatter``), the duplicate-combining densify
(``densify_combine``) and the per-window output counts of the support
oracle (``support_window_counts``); and the 3D fiber merge's hash tier
(``hash_merge``, ``hash_table_capacity``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..semiring import Semiring
from .segment import DROP_SPREAD, expand_ranges, float_bits, spread_drops
from .tuples import SpTuples

#: Semiring add-monoid -> the torch scatter combiner implementing it.
_SCATTER_COMBINERS = {"sum": "add", "min": "min", "max": "max"}


def scatter_combine_for(sr: Semiring) -> str | None:
    """``"add"``/``"min"``/``"max"`` for monoids with a native scatter
    combiner, None for generic monoids."""
    return _SCATTER_COMBINERS.get(sr.add_kind)


def _row_lens_pad(b_csr) -> torch.Tensor:
    """B's row lengths with one 0 appended: the length of padding row
    ``nrows``."""
    return torch.cat([b_csr.row_lens(), b_csr.indptr.new_zeros(1)])


def _a_degrees(a: SpTuples, b_csr) -> torch.Tensor:
    """Per slot of ``a``: the length of B's row at its column (0 on
    padding slots)."""
    if a.ncols != b_csr.nrows:
        raise ValueError(f"dim mismatch {a.ncols} != {b_csr.nrows}")
    k = torch.clamp(a.cols, max=b_csr.nrows)
    return torch.where(a.valid_mask(), _row_lens_pad(b_csr)[k], 0)


def flops(a: SpTuples, b_csr) -> torch.Tensor:
    """Scalar multiplies of ``a · b`` (float32, 0-dim). The count is summed
    exactly in int64 and rounded to float32 once; the reference sums in
    float32, which can round its running sum past 2^24 (the capacities
    derived from either agree: ``tests/test_torch_spgemm_esc.py``).
    Reference: ``estimateFLOP``."""
    return _a_degrees(a, b_csr).sum(dtype=torch.int64).to(torch.float32)


#: Lanes of one expansion chunk: ``expand`` makes one virtual entry per
#: (A entry, 32-wide chunk of B's row).
CHUNK_W = 32


def expansion_slots(a: SpTuples, b_csr, chunk_w: int = CHUNK_W) -> torch.Tensor:
    """Slots of the chunked expansion, the slots ``expand`` fills: per A
    entry ``ceil(deg_B(col) / W) * W``, summed exactly (int64, 0-dim)."""
    return (-(-_a_degrees(a, b_csr) // chunk_w)).sum(dtype=torch.int64) * chunk_w


def flops_padded(a: SpTuples, b_csr, chunk_w: int = CHUNK_W) -> torch.Tensor:
    """``expansion_slots`` as the reference's float32 (0-dim): W is a power
    of two, so rounding the product once equals the reference's rounded
    chunk count times W."""
    return expansion_slots(a, b_csr, chunk_w).to(torch.float32)


def expand(sr: Semiring, a: SpTuples, b_csr, flop_capacity: int,
           chunk_w: int = CHUNK_W) -> SpTuples:
    """The EXPAND phase: the product tuples of ``a · b`` before combining
    (duplicates kept), capacity ``ceil(flop_capacity / W) * W``; work past
    it is cut off, so callers size it with ``flops_padded``.

    One virtual entry per (A entry, W-chunk of B's row) in A's slot order,
    each taking a contiguous W-window of B's column ids and values; lanes
    past the row's end are padding. The slot order is the reference's, so
    a later fold of equal keys sees the same operand order."""
    W = chunk_w
    dev = a.rows.device
    v_capacity = -(-flop_capacity // W)
    deg = _a_degrees(a, b_csr)
    # one window of padding: a row's last chunk may reach past the data
    b_indices = torch.cat([b_csr.indices, b_csr.indices.new_full((W,), b_csr.ncols)])
    b_vals = torch.cat([b_csr.vals, b_csr.vals.new_zeros(W)])
    lens_pad = _row_lens_pad(b_csr)
    starts_pad = torch.cat([b_csr.indptr[:-1], b_csr.indptr.new_zeros(1)])
    owner, chix, valid_v, _ = expand_ranges(-(-deg // W), v_capacity)
    a_rows_v = a.rows[owner]
    a_vals_v = a.vals[owner]
    k_v = torch.clamp(a.cols[owner], max=b_csr.nrows)
    deg_v = lens_pad[k_v]
    b0 = torch.where(valid_v, starts_pad[k_v] + chix * W, 0).to(torch.int32)
    lane = torch.arange(W, dtype=torch.int32, device=dev)
    win = (b0[:, None] + lane[None, :]).reshape(-1)
    bcols = b_indices.index_select(0, win).view(v_capacity, W)
    bvals = b_vals.index_select(0, win).view(v_capacity, W)
    lane_ok = valid_v[:, None] & (chix[:, None] * W + lane[None, :] < deg_v[:, None])
    return SpTuples(
        rows=torch.where(lane_ok, a_rows_v[:, None], a.nrows).reshape(-1).to(torch.int32),
        cols=torch.where(lane_ok, bcols, b_csr.ncols).reshape(-1).to(torch.int32),
        vals=sr.mul(a_vals_v[:, None], bvals).reshape(-1),
        nnz=lane_ok.sum().to(torch.int32),
        nrows=a.nrows,
        ncols=b_csr.ncols,
    )


def local_spgemm(sr: Semiring, a: SpTuples, b_csr, *, flop_capacity: int,
                 out_capacity: int) -> SpTuples:
    """``C = a ⊗ b`` on one tile: expand, sort, compress. Reference:
    ``LocalHybridSpGEMM`` with its hash/heap accumulator replaced by a
    sort and a segmented fold."""
    return expand(sr, a, b_csr, flop_capacity).compact(sr, capacity=out_capacity)


def mask_rows(t: SpTuples, row_lo: int, row_hi: int) -> SpTuples:
    """Entries with a row outside ``[row_lo, row_hi)`` become padding;
    capacity unchanged, ``nnz`` recounted."""
    keep = t.valid_mask() & (t.rows >= row_lo) & (t.rows < row_hi)
    return SpTuples(rows=torch.where(keep, t.rows, t.nrows),
                    cols=torch.where(keep, t.cols, t.ncols), vals=t.vals,
                    nnz=keep.sum().to(torch.int32), nrows=t.nrows, ncols=t.ncols)


# --- the dense fold of the windowed tier ---------------------------------------
#
# The reference folds into a dense block with one ``at[].{add,min,max}``
# scatter. Its float min and max keep a NaN and give min -0.0 and max +0.0
# for two equal zeros; torch's ``scatter_reduce_`` keeps whichever comes
# first. So a float min or max is folded on integer keys that order as the
# reference's fold (``fold_keys``), and turned back once at the end.


def fold_keys(v: torch.Tensor, kind: str) -> torch.Tensor:
    """Float values -> signed integer keys of their width whose order is
    the reference's min/max fold: -0.0 below +0.0, and every NaN on the
    side the fold keeps (the smallest key for ``"min"``, the largest for
    ``"max"``). No non-NaN value maps to either extreme key."""
    bits = float_bits(v)
    info = torch.iinfo(bits.dtype)
    key = torch.where(bits < 0, bits ^ info.max, bits)
    return torch.where(torch.isnan(v), info.min if kind == "min" else info.max, key)


def from_fold_keys(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``fold_keys`` (a NaN comes back as the quiet NaN)."""
    info = torch.iinfo(key.dtype)
    vals = torch.where(key < 0, key ^ info.max, key).view(dtype)
    return torch.where((key == info.min) | (key == info.max), float("nan"), vals)


def _keyed(sr: Semiring, dtype: torch.dtype) -> bool:
    return sr.add_kind in ("min", "max") and dtype.is_floating_point


def new_fold_buffer(sr: Semiring, cells: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A flat accumulator of ``cells`` cells holding ``sr.zero``, in the
    domain ``fold_into_`` folds in, with ``DROP_SPREAD`` sink cells past
    them for the slots a fold drops (``spread_drops``)."""
    zero = torch.full((1,), sr.zero(dtype), dtype=dtype, device=device)
    if _keyed(sr, dtype):
        zero = fold_keys(zero, sr.add_kind)
    elif dtype == torch.bool:
        zero = zero.to(torch.uint8)
    return zero.expand(cells + DROP_SPREAD).clone()


def fold_into_(sr: Semiring, buf: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """``buf[idx] ⊕= vals`` in place, the reference's ``at[idx].{add,min,
    max}``: a float min or max on ``fold_keys``, which is deterministic on
    every device. A sum is ``index_add_``: in slot order on the CPU, but
    with atomics on the card, so a float sum's order there is unordered
    and may change from run to run, as the reference's TPU scatter does.
    ``idx`` (int64) lies in the cells or the sink cells of a
    ``new_fold_buffer``."""
    comb = scatter_combine_for(sr)
    if comb is None:
        raise ValueError(f"semiring {sr.name} (add_kind={sr.add_kind}) has no scatter "
                         "combiner")
    if comb == "add":
        return buf.index_add_(0, idx, vals)
    if _keyed(sr, vals.dtype):
        vals = fold_keys(vals, sr.add_kind)
    elif vals.dtype == torch.bool:
        vals = vals.to(torch.uint8)
    return buf.scatter_reduce_(0, idx, vals, reduce="a" + comb, include_self=True)


def fold_buffer_values(sr: Semiring, buf: torch.Tensor, cells: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """The first ``cells`` cells of a fold buffer as values of ``dtype``
    (flat)."""
    out = buf[:cells]
    if _keyed(sr, dtype):
        return from_fold_keys(out, dtype)
    return out.to(dtype)


def fold_expansion_(sr: Semiring, buf: torch.Tensor, a: SpTuples, b_csr, *, row_lo: int,
                    rb: int, pad_cols: int, flop_capacity: int, chunk_w: int) -> None:
    """Fold the expansion of ``a · b`` (``expand`` at ``flop_capacity``)
    for the output rows ``[row_lo, row_lo + rb)`` into the fold buffer
    ``buf`` of ``rb * pad_cols`` cells; other slots drop."""
    t = expand(sr, a, b_csr, flop_capacity, chunk_w=chunk_w)
    ok = t.valid_mask() & (t.rows >= row_lo) & (t.rows < row_lo + rb)
    flat = (t.rows.long() - row_lo) * pad_cols + t.cols.long()
    fold_into_(sr, buf, spread_drops(flat, ok, rb * pad_cols), t.vals)


def accumulate_block_scatter(sr: Semiring, acc: torch.Tensor, a: SpTuples, b_csr, *,
                             row_lo: int, flop_capacity: int, chunk_w: int = 8) -> torch.Tensor:
    """Fold one stage's expansion for the output rows ``[row_lo, row_lo +
    Rb)`` into the dense block ``acc`` ``[Rb, pad_cols]`` with the
    semiring's scatter combiner: the windowed tier's sort-free accumulate.
    ``a`` is row-masked to the block (``mask_rows``); ``chunk_w`` is the
    expansion's chunk width (8: the scatter pays per slot, so narrow chunks
    keep the padding near 1.1x on R-MAT degree tails). Returns the new
    block. The windowed kernels keep their block in the fold's domain
    across stages (``fold_expansion_``)."""
    rb, pad_cols = acc.shape
    buf = new_fold_buffer(sr, rb * pad_cols, acc.dtype, acc.device)
    cells = buf[: rb * pad_cols]
    cells.copy_(fold_keys(acc.reshape(-1), sr.add_kind) if _keyed(sr, acc.dtype)
                else acc.reshape(-1))
    fold_expansion_(sr, buf, a, b_csr, row_lo=row_lo, rb=rb, pad_cols=pad_cols,
                    flop_capacity=flop_capacity, chunk_w=chunk_w)
    return fold_buffer_values(sr, buf, rb * pad_cols, acc.dtype).view(rb, pad_cols)


def densify_combine(sr: Semiring, t: SpTuples, pad_rows: int, pad_cols: int) -> torch.Tensor:
    """Tile tuples -> dense ``[pad_rows, pad_cols]`` with repeated (row,
    col) slots combined by the semiring's scatter combiner: the
    duplicate-safe twin of ``densify``, for semirings with one
    (``scatter_combine_for``). Cells with no entry hold ``sr.zero``;
    entries past the block drop."""
    cells = pad_rows * pad_cols
    ok = t.valid_mask() & (t.rows < pad_rows) & (t.cols < pad_cols)
    flat = t.rows.long() * pad_cols + t.cols.long()
    buf = new_fold_buffer(sr, cells, t.vals.dtype, t.vals.device)
    fold_into_(sr, buf, spread_drops(flat, ok, cells), t.vals)
    return fold_buffer_values(sr, buf, cells, t.vals.dtype).view(pad_rows, pad_cols)


def support_window_counts(bits: torch.Tensor, block_rows: int, block_cols: int, nrows: int,
                          ncols: int) -> torch.Tensor:
    """Exact output count per (row block, column window), int32 ``[nblocks,
    ncolwin]``, from packed support words (``spgemm_support_bits`` /
    ``pack_support_bits``): what tightens the windowed tier's 2D plan.
    ``block_cols`` must be a multiple of 32, so that each window covers
    whole words; the packers set no bit past ``ncols``."""
    if block_cols % 32:
        raise ValueError(f"block_cols must be a multiple of 32, got {block_cols}")
    m, nw = bits.shape
    if m != nrows:
        raise ValueError(f"bits hold {m} rows, want {nrows}")
    dev = bits.device
    nblocks = -(-nrows // block_rows)
    ncw = -(-ncols // block_cols)
    word_window = torch.arange(nw, device=dev) * 32 // block_cols
    per_window = torch.zeros((m, ncw), dtype=torch.int32, device=dev).index_add_(
        1, word_window, popcount32(bits))
    row_block = torch.arange(m, device=dev) // block_rows
    return torch.zeros((nblocks, ncw), dtype=torch.int32, device=dev).index_add_(
        0, row_block, per_window)


def densify(t: SpTuples, pad_rows: int, pad_cols: int, zero) -> torch.Tensor:
    """Tile tuples -> dense ``[pad_rows, pad_cols]``, other cells ``zero``.

    The tile must hold UNIQUE (row, col) entries (the reference's
    unique-indices scatter; callers check with ``coo_has_duplicates``).
    Padding slots write to one drop cell past the end.
    """
    ncell = pad_rows * pad_cols
    flat = t.rows.long() * pad_cols + t.cols.long()
    flat = torch.where(t.valid_mask(), flat, ncell)
    dense = torch.full((ncell + 1,), zero, dtype=t.vals.dtype, device=t.vals.device)
    dense[flat] = t.vals
    return dense[:ncell].view(pad_rows, pad_cols)


def _support_mask(dense: torch.Tensor, zero, nrows: int, ncols: int) -> torch.Tensor:
    """``dense != zero`` restricted to the first ``nrows x ncols`` cells."""
    R, C = dense.shape
    mask = dense != zero
    if C != ncols:
        mask = mask & (torch.arange(C, device=dense.device) < ncols)[None, :]
    if R != nrows:
        mask = mask & (torch.arange(R, device=dense.device) < nrows)[:, None]
    return mask


def dense_support_nnz(dense: torch.Tensor, zero, nrows: int, ncols: int) -> torch.Tensor:
    """Exact count (int32, 0-dim, on the device) of the cells ``!= zero`` in
    the first ``nrows x ncols`` of a (possibly padded) dense block: sizes
    an extraction's capacity exactly instead of guessing and retrying."""
    return _support_mask(dense, zero, nrows, ncols).sum().to(torch.int32)


def sparsify(
    dense: torch.Tensor, zero, nrows: int, ncols: int, capacity: int
) -> tuple[SpTuples, torch.Tensor]:
    """Dense ``[R, C]`` -> (row-major SpTuples of ``capacity`` slots, exact
    nonzero count), row by row: per-row counts feed ``expand_ranges``, and
    each slot finds its column by a binary search over its own row's
    prefix counts. Padding slots hold ``(nrows, ncols)`` and value 0."""
    R, C = dense.shape
    m32 = _support_mask(dense, zero, nrows, ncols).to(torch.int32)
    rowcnt = m32.sum(1, dtype=torch.int32)
    rowcum = torch.cumsum(m32, 1, dtype=torch.int32).reshape(-1)
    owner, offset, valid, total = expand_ranges(rowcnt, capacity)
    # the smallest c with rowcum[owner, c] >= offset + 1
    want = offset + 1
    lo = torch.zeros(capacity, dtype=torch.int32, device=dense.device)
    hi = torch.full((capacity,), C - 1, dtype=torch.int32, device=dense.device)
    base = owner.long() * C
    for _ in range(max((max(C, 2) - 1).bit_length(), 1)):  # ceil(log2(C)) steps
        mid = (lo + hi) >> 1
        below = rowcum[base + mid] < want
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(below, hi, mid)
    out = SpTuples(
        rows=torch.where(valid, owner, nrows).to(torch.int32),
        cols=torch.where(valid, hi, ncols).to(torch.int32),
        vals=torch.where(valid, dense.reshape(-1)[base + hi], 0),
        nnz=torch.clamp(total, max=capacity).to(torch.int32),
        nrows=nrows,
        ncols=ncols,
    )
    return out, total


def sparsify_windowed(
    dense: torch.Tensor, zero, nrows: int, ncols: int, capacity: int
) -> tuple[SpTuples, torch.Tensor]:
    """Dense ``[R, C]`` -> compacted row-major SpTuples of ``capacity``
    slots, and the exact count of cells ``!= zero`` in the first
    ``nrows x ncols`` (exact even when it exceeds ``capacity``).

    One mask, one cumsum rank and one scatter of cell ids into a
    ``capacity``-slot buffer (plus a drop slot); ``total`` stays on the
    device. Padding slots hold ``(nrows, ncols)`` and value 0 — 0, not the
    semiring zero, as in the reference. A -0.0 cell comes out +0.0: the
    reference reads each value as a lane sum with zeros. The reference
    narrowed windows to suit a TPU's memory costs; that has no counterpart
    here.
    """
    R, C = dense.shape
    dev = dense.device
    mask = _support_mask(dense, zero, nrows, ncols).reshape(-1)
    rank = torch.cumsum(mask, 0)  # inclusive, int64
    total = rank[-1] if rank.numel() else rank.new_zeros(())
    slot = torch.where(mask & (rank <= capacity), rank - 1, capacity)
    cell = torch.zeros(capacity + 1, dtype=torch.long, device=dev)
    cell = cell.scatter_(0, slot, torch.arange(R * C, device=dev))[:capacity]
    valid = torch.arange(capacity, device=dev) < total
    out = SpTuples(
        rows=torch.where(valid, cell // C, nrows).to(torch.int32),
        cols=torch.where(valid, cell % C, ncols).to(torch.int32),
        vals=_plus_zero(torch.where(valid, dense.reshape(-1)[cell], 0)),
        nnz=torch.clamp(total, max=capacity).to(torch.int32),
        nrows=nrows,
        ncols=ncols,
    )
    return out, total


def _plus_zero(v: torch.Tensor) -> torch.Tensor:
    """``v + 0.0`` for floats (-0.0 becomes +0.0, the rest is unchanged)."""
    return v + 0.0 if v.is_floating_point() else v


def coo_sort_dedup(
    rows: torch.Tensor, cols: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable two-key sort (rows major, cols minor) and the per-slot
    ``dup`` mask (True on every repeat after the first of a group)."""
    order_c = torch.sort(cols, stable=True).indices
    r1, c1 = rows[order_c], cols[order_c]
    order_r = torch.sort(r1, stable=True).indices
    rows, cols = r1[order_r], c1[order_r]
    same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
    return rows, cols, torch.cat([same.new_zeros(1), same])


# --- the merge of sorted runs ---------------------------------------------


def _lex_key(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One int64 key per (row, col) that orders as the pair does (ids are
    non-negative int32)."""
    return (r.long() << 32) | c.long()


def _lex_searchsorted(rs: torch.Tensor, cs: torch.Tensor, rq: torch.Tensor,
                      cq: torch.Tensor, side: str = "left") -> torch.Tensor:
    """For each query (rq, cq): the count of entries of the (row, col)-sorted
    run (rs, cs) below it (``side="left"``) or at most it (``"right"``),
    int32. The reference binary-searches the two keys; here one
    ``searchsorted`` over the fused key gives the same counts."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return torch.searchsorted(_lex_key(rs, cs), _lex_key(rq, cq), side=side, out_int32=True)


def _merge_two_sorted(x: SpTuples, y: SpTuples) -> SpTuples:
    """Merge two (row, col)-sorted tiles (padding at the tail) into one
    sorted tile of capacity ``x.capacity + y.capacity``: ``x[i]`` goes to
    ``i + |{y < x[i]}|``, ``y[j]`` to ``j + |{x <= y[j]}|``, so ties keep
    x before y (the order of a concatenation) and padding stays a suffix."""
    if (x.nrows, x.ncols) != (y.nrows, y.ncols):
        raise ValueError("runs differ in shape")
    mx, my = x.capacity, y.capacity
    dev = x.rows.device
    px = torch.arange(mx, device=dev) + _lex_searchsorted(y.rows, y.cols, x.rows, x.cols, "left")
    py = torch.arange(my, device=dev) + _lex_searchsorted(x.rows, x.cols, y.rows, y.cols, "right")

    def weave(ax, ay):
        out = ax.new_zeros(mx + my)
        out[px] = ax
        out[py] = ay
        return out

    return SpTuples(rows=weave(x.rows, y.rows), cols=weave(x.cols, y.cols),
                    vals=weave(x.vals, y.vals), nnz=x.nnz + y.nnz, nrows=x.nrows,
                    ncols=x.ncols)


def merge_sorted_runs(runs: list[SpTuples]) -> SpTuples:
    """k-way merge of (row, col)-sorted tiles of one shape into one sorted
    tile, duplicates kept and adjacent in run order: a pairwise tree of
    ``_merge_two_sorted``. Equals ``SpTuples.concat(runs).sort_rowmajor()``
    slot for slot."""
    if not runs:
        raise ValueError("merge_sorted_runs needs at least one run")
    while len(runs) > 1:
        nxt = [_merge_two_sorted(runs[i], runs[i + 1]) for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


# --- the hash merge (the 3D fiber reduce's hash tier) ---------------------------

_U32 = 0xFFFFFFFF


def hash_table_capacity(out_capacity: int) -> int:
    """``hash_merge``'s table size: the power of two at or above 4 times
    the distinct-key bound (at least 8), a load factor of at most 0.25."""
    return 1 << max(int(4 * max(out_capacity, 8)) - 1, 1).bit_length()


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The splitmix32 finalizer on uint32 values held in int64 (products
    wrap mod 2^64, so their low 32 bits are the uint32 products)."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def hash_merge(sr: Semiring, t: SpTuples, *, out_capacity: int, table_capacity: int,
               n_probes: int = 16) -> tuple[SpTuples, torch.Tensor, torch.Tensor]:
    """Combine the duplicate (row, col) keys of ``t`` through an
    open-addressing table of ``table_capacity`` slots (a power of two),
    probed by double hashing for ``n_probes`` rounds. A round: each
    unplaced entry reads its slot's key; an empty slot is claimed by the
    lowest-index entry proposing it, which installs its key; every entry
    whose slot now holds its key folds its value in with the add monoid's
    scatter combiner (``fold_into_``) and retires. Entries still unplaced
    after the last round are counted, not dropped.

    Returns ``(out, overflow, distinct)``: the table's entries in table
    order with ``sr.zero`` values pruned (unsorted), truncated to
    ``out_capacity``; the count of unplaced entries (the caller reruns
    through a sorted tier when it is positive); and the distinct key count
    before truncation. The hashes are the reference's uint32 arithmetic,
    done in int64 masked to 32 bits, so the table's order is the
    reference's. Each round walks only the entries not yet placed, and the
    rounds stop when none is left: the same table. Only for semirings with
    a scatter combiner. Reference: ``hash_merge``."""
    if scatter_combine_for(sr) is None:
        raise ValueError(f"semiring {sr.name} (add_kind={sr.add_kind}) has no scatter "
                         "combiner; use merge_sorted_runs or the sort path")
    T = int(table_capacity)
    if T < 2 or T & (T - 1):
        raise ValueError(f"table capacity {T} is not a power of two")
    dev = t.rows.device
    key = ((t.rows.long() * 0x9E3779B1) + (t.cols.long() * 0x85EBCA77)) & _U32
    h0 = _mix32(key) & (T - 1)
    step = ((_mix32(key ^ 0xC2B2AE35) | 1) & (T - 1)) | 1
    t_rows = torch.full((T,), t.nrows, dtype=torch.int32, device=dev)
    t_cols = torch.full((T,), t.ncols, dtype=torch.int32, device=dev)
    t_buf = new_fold_buffer(sr, T, t.vals.dtype, dev)
    # the unplaced entries, in index order, and their current slots
    ids = torch.nonzero(t.valid_mask()).squeeze(1)
    slot = h0[ids]
    step = step[ids]
    for round_ in range(n_probes):
        if ids.numel() == 0:
            break
        if round_:
            slot = (slot + step) & (T - 1)
        rows, cols = t.rows[ids], t.cols[ids]
        empty = t_rows[slot] == t.nrows
        ids32 = ids.to(torch.int32)
        winner = torch.full((T,), t.capacity, dtype=torch.int32, device=dev)
        winner.scatter_reduce_(0, slot[empty], ids32[empty], reduce="amin")
        inst = empty & (winner[slot] == ids32)
        t_rows[slot[inst]] = rows[inst]
        t_cols[slot[inst]] = cols[inst]
        match = (t_rows[slot] == rows) & (t_cols[slot] == cols)
        fold_into_(sr, t_buf, slot[match], t.vals[ids[match]])
        keep = ~match
        ids, slot, step = ids[keep], slot[keep], step[keep]
    overflow = torch.tensor(ids.numel(), dtype=torch.int32, device=dev)
    t_vals = fold_buffer_values(sr, t_buf, T, t.vals.dtype)
    live = torch.nonzero((t_rows < t.nrows) & (t_vals != sr.zero(t.vals.dtype))).squeeze(1)
    distinct = torch.tensor(live.numel(), dtype=torch.int32, device=dev)
    live = live[:out_capacity]
    n = live.numel()
    out = SpTuples.empty(t.nrows, t.ncols, out_capacity, t.vals.dtype, device=dev)
    out.rows[:n], out.cols[:n], out.vals[:n] = t_rows[live], t_cols[live], t_vals[live]
    return dataclasses.replace(out, nnz=torch.clamp(distinct, max=out_capacity)), overflow, distinct


# --- the bit-packed output-support oracle -----------------------------------


def pack_support_bits(rows: torch.Tensor, cols: torch.Tensor, nrows: int, ncols: int, *,
                      assume_unique: bool = False) -> torch.Tensor:
    """COO support -> packed ``[nrows, ceil(ncols / 32)]`` int32 bitmask
    (the reference's uint32 words, same bits): bit (i, j) is set iff some
    entry (i, j) has ``i < nrows`` and ``j < ncols``. Packing adds
    ``1 << (j & 31)`` into word (i, j >> 5); bit 31 adds -2^31, and a sum
    of distinct bits never carries, so the int32 words hold the bitwise OR.
    A repeated entry would carry, so the input is deduplicated first
    (``coo_sort_dedup``) unless ``assume_unique``."""
    nw = -(-ncols // 32)
    if not assume_unique:
        rows, cols, dup = coo_sort_dedup(rows, cols)
        rows = torch.where(dup, nrows, rows)
    keep = (rows < nrows) & (cols < ncols)
    word = spread_drops(rows.long() * nw + (cols >> 5).long(), keep, nrows * nw)
    bit = torch.ones_like(cols, dtype=torch.int32) << (cols.to(torch.int32) & 31)
    bits = torch.zeros(nrows * nw + DROP_SPREAD, dtype=torch.int32, device=rows.device)
    return bits.index_add_(0, word, bit)[: nrows * nw].view(nrows, nw)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 words, bit 31 included), int32:
    the SWAR count over the low 31 bits, where no step overflows, plus bit
    31 (the sign)."""
    x = words & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + (words < 0).to(words.dtype)


def popcount_pair_counts(bits_i: torch.Tensor, bits_j: torch.Tensor, ii: torch.Tensor,
                         jj: torch.Tensor, weights: torch.Tensor, *,
                         chunk: int = 8192) -> torch.Tensor:
    """``Σ_pairs weights · popcount(bits_i[ii] & bits_j[jj])`` as the
    reference's int32 ``[2]`` (hi, lo) 15-bit split (total = hi · 2^15 +
    lo). Summed exactly in int64 inside; pairs of weight 0 are skipped, and
    the rest are walked ``chunk`` at a time (two row gathers and a
    popcount each)."""
    live = weights != 0
    ii, jj, weights = ii[live], jj[live], weights[live].to(torch.int64)
    total = torch.zeros((), dtype=torch.int64, device=bits_i.device)
    for lo in range(0, ii.shape[0], chunk):
        gi = bits_i.index_select(0, ii[lo:lo + chunk])
        gj = bits_j.index_select(0, jj[lo:lo + chunk])
        cnt = popcount32(gi & gj).sum(1, dtype=torch.int64)
        total = total + (cnt * weights[lo:lo + chunk]).sum()
    return hilo_split(total)


def hilo_split(total: torch.Tensor) -> torch.Tensor:
    """A non-negative int64 count as the reference's int32 ``[2]`` (hi, lo)
    15-bit split."""
    return torch.stack([total >> 15, total & 0x7FFF]).to(torch.int32)


def combine_hilo(hilo) -> int:
    """The exact total of an int32 (hi, lo) 15-bit split."""
    hilo = np.asarray(hilo.cpu() if isinstance(hilo, torch.Tensor) else hilo, np.int64)
    return int((hilo[0] << 15) + hilo[1])


def _pack_rows(live: torch.Tensor) -> torch.Tensor:
    """Bool ``[R, 32 * nw]`` -> int32 words ``[R, nw]`` (bit l of word w is
    column 32 w + l); distinct bits summed in int32 never carry."""
    R, n = live.shape
    lanes = torch.ones(32, dtype=torch.int32, device=live.device) << torch.arange(
        32, dtype=torch.int32, device=live.device)
    return (live.view(R, n // 32, 32).to(torch.int32) * lanes).sum(-1, dtype=torch.int32)


def spgemm_support_bits(a: SpTuples, b: SpTuples, *,
                        row_block: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """The output-support oracle: the pattern of ``a · b`` as packed
    ``[a.nrows, ceil(b.ncols / 32)]`` int32 words and the exact per-row
    nonzero counts. The pattern is a row-blocked counts product of the 0/1
    supports in bf16 (the reference's inputs; only ``> 0`` is read, so
    the bf16 product is enough), thresholded and packed block by block."""
    if a.ncols != b.nrows:
        raise ValueError(f"dim mismatch {a.ncols} != {b.nrows}")
    m, k, n = a.nrows, a.ncols, b.ncols
    kpad = -(-k // 128) * 128
    npad = -(-n // 128) * 128
    nw = -(-n // 32)

    def support_dense(t: SpTuples, R: int, C: int) -> torch.Tensor:
        flat = torch.where(t.valid_mask(), t.rows.long() * C + t.cols.long(), R * C)
        d = torch.zeros(R * C + 1, dtype=torch.float32, device=t.rows.device)
        d.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
        return torch.clamp(d[:R * C], max=1.0).view(R, C).to(torch.bfloat16)

    nblocks = -(-m // row_block)
    da = support_dense(a, nblocks * row_block, kpad)
    db = support_dense(b, kpad, npad)
    out_bits, out_cnt = [], []
    for blk in range(nblocks):
        lo = blk * row_block
        live = torch.matmul(da[lo:lo + row_block], db)[:, :n] > 0
        out_cnt.append(live.sum(1, dtype=torch.int32))
        out_bits.append(_pack_rows(torch.nn.functional.pad(live, (0, nw * 32 - n))))
    return torch.cat(out_bits)[:m], torch.cat(out_cnt)[:m]
