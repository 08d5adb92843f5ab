"""Distributed SpGEMM — counterpart of ``combblas_tpu/parallel/spgemm.py``:
SUMMA over the grid's tiles, ``C_ij = ⊕_s A_is ⊗ B_sj``, in three tiers.

  * ESC (``summa_spgemm``, ``spgemm``): each stage's tile product is
    expanded (one slot a multiply, ``ops.spgemm.expand``); the stage chunks
    are merged by one sort (``merge="sort"``) or sorted one by one and
    merged as runs (``"runs"``), then compacted (the semiring fold). The
    symbolic pass (``summa_stage_flops``) sizes the capacities first.
  * scan (``summa_spgemm_scan``, ``spgemm_scan``): each stage's expansion is
    merged at once into a running accumulator of ``out_capacity`` slots;
    memory follows the output, and an overflow is retried larger.
  * mxu (``summa_spgemm_mxu``): dense stage products (``torch.matmul`` for
    plus_times, the hand-written semiring GEMM for min_plus and max_min),
    one extraction per output tile.

The phased (``mem_efficient_spgemm``) and blocked (``block_spgemm``) forms
run the ESC tier over column or row/column pieces. ``spgemm_auto`` routes
through ``choose_spgemm_tier``, the reference's rule; its windowed tier
(and the 3D one above it) is not ported yet, and a call routed or forced
there raises ``NotImplementedError``; it is never rerouted.

The tiles of a grid live on one device and are walked in loops, as the
reference's all-gather (or, with ``ring=True``, its carousel of
``ppermute``s) walks its stages. Capacities are the reference's (they are
part of the output layout). The stage expansions inside a product are
internal: they are sized from exact counts read back and cut to their
valid slots before the merge, which gives the same outputs, padding slots
included, with less memory.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops.compressed import CSR
from ..ops.semiring_matmul import semiring_matmul
from ..ops.spgemm import (
    CHUNK_W,
    coo_sort_dedup,
    densify,
    expand,
    expansion_slots,
    merge_sorted_runs,
    scatter_combine_for,
    sparsify_windowed,
)
from ..ops.tuples import SpTuples
from ..semiring import Semiring
from .spmat import SpParMat

#: Above this local tile dimension the reference leaves the dense tier.
MXU_MAX_TILE_DIM = 8192

#: The windowed tier's envelope (the router reads it): at most this many
#: dense cells scanned a symbolic flop, this many cells a tile, and for
#: the ``dot`` backend a B column panel of at most this many cells within
#: at most this many column windows.
WINDOWED_MAX_CELLS_PER_FLOP = 16.0
WINDOWED_MAX_TILE_CELLS = 1 << 33
WINDOWED_MAX_PANEL_CELLS = 1 << 27
WINDOWED_MAX_COL_WINDOWS = 32

#: Semirings with a dense stage-product kernel, by semiring name.
_PALLAS_KINDS = {
    "plus_times": "plus_times",
    "min_plus": "min_plus",
    "max_min": "max_min",
}

TIERS = ("mxu", "windowed", "scan", "esc", "windowed3d")
_UNPORTED_TIERS = ("windowed", "windowed3d")
_UNPORTED_NOTE = ("not ported yet (ROADMAP.md, queue 1, item 10: the windowed tier; "
                  "the 3D tier with mesh3d.py, item 12)")


def host_value(x: torch.Tensor) -> np.ndarray:
    """The host value of a device tensor (one process holds every tile)."""
    return x.cpu().numpy()


def _check_compat(A: SpParMat, B: SpParMat) -> None:
    """≈ CheckSpGEMMCompliance + ProductGrid."""
    if A.grid != B.grid:
        raise ValueError("A and B must share a grid")
    if not A.grid.is_square:
        raise ValueError("SUMMA requires a square grid (pr == pc)")
    if A.ncols != B.nrows:
        raise ValueError(f"dim mismatch {A.ncols} != {B.nrows}")
    if A.grid.local_cols(A.ncols) != A.grid.local_rows(B.nrows):
        raise ValueError("A col-blocking must equal B row-blocking")


def _pad128(x: int, to: int = 512) -> int:
    """Pad to a multiple of 512, as the reference does, so that dense
    stage shapes match it."""
    return -(-x // to) * to


def _mxu_dot(da: torch.Tensor, db: torch.Tensor, mode: str, out_dtype) -> torch.Tensor:
    """Dense plus_times stage product at the requested precision. Plain
    ``torch.matmul``: the reference leaves this product to XLA as well.

    "f32": float32 product (exact float32 needs TF32 off, the default).
    "bf16": bf16-rounded inputs with float32 sums, as the reference
    computes them — the rounded inputs go back to float32 before the
    product, because torch's bf16 matmul would round its output too.
    "bf16x3": the hi/lo split, three such products.
    """
    if mode == "f32":
        return torch.matmul(da, db).to(out_dtype)

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    if mode == "bf16":
        return torch.matmul(bf16(da), bf16(db)).to(out_dtype)
    if mode != "bf16x3":
        raise ValueError(f"unknown mode {mode!r}; expected f32, bf16 or bf16x3")
    ah, bh = bf16(da), bf16(db)
    al, bl = bf16(da - ah), bf16(db - bh)
    out = torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)
    return out.to(out_dtype)


def summa_spgemm_mxu(
    sr: Semiring, A: SpParMat, B: SpParMat, *, out_capacity: int, mode: str = "f32"
) -> tuple[SpParMat, torch.Tensor]:
    """Dense-block SUMMA. Returns ``(C, overflow)``, where ``overflow`` is
    a 0-dim device tensor: the largest tile nonzero count minus
    ``out_capacity``, floored at 0. Tiles are truncated to
    ``out_capacity`` but their counts stay exact."""
    _check_compat(A, B)
    kind = _PALLAS_KINDS.get(sr.name)
    if kind is None:
        raise ValueError(
            f"summa_spgemm_mxu supports semirings {sorted(_PALLAS_KINDS)}; got {sr.name}"
        )
    p = A.grid.pr
    lrA, lcA, lcB = A.local_rows, A.local_cols, B.local_cols
    pm, pk, pn = _pad128(lrA), _pad128(lcA), _pad128(lcB)
    zero = float(sr.zero_fn(A.dtype))
    worst = [torch.zeros((), dtype=torch.long, device=A.grid.device)]

    def tile(i, j):
        acc = torch.full((pm, pn), zero, dtype=A.dtype, device=A.grid.device)
        for s in range(p):
            da = densify(A.local_tile(i, s), pm, pk, zero)
            db = densify(B.local_tile(s, j), pk, pn, zero)
            if kind == "plus_times":
                prod = _mxu_dot(da, db, mode, acc.dtype)
            else:
                prod = semiring_matmul(kind, da, db)
            acc = sr.add(acc, prod)
        out, total = sparsify_windowed(acc, zero, lrA, lcB, out_capacity)
        worst[0] = torch.maximum(worst[0], total - out_capacity)
        return out

    C = SpParMat.assemble(A.grid, A.nrows, B.ncols, tile)
    return C, worst[0]


def coo_has_duplicates(M: SpParMat) -> bool:
    """True iff some tile holds a repeated (row, col) entry — the guard of
    the mxu tier's unique-entries precondition (``densify``). One host
    readback."""
    lr = M.local_rows
    found = torch.zeros((), dtype=torch.long, device=M.grid.device)
    for i in range(M.grid.pr):
        for j in range(M.grid.pc):
            rows, _, dup = coo_sort_dedup(M.rows[i, j], M.cols[i, j])
            # padding slots (row == lr) repeat each other — not duplicates
            found = found + (dup & (rows < lr)).sum()
    return bool(found > 0)


# --- the stage schedule ------------------------------------------------------


def _gather_stage_tiles(M: SpParMat, index: int, axis: str) -> list[SpTuples]:
    """The tiles a SUMMA stage loop walks: ``axis="row"``, grid row
    ``index`` of M (A's tiles (i, s)); ``axis="col"``, grid column
    ``index`` (B's tiles (s, j)). The reference all-gathers them over a
    mesh axis."""
    if axis == "row":
        return [M.local_tile(index, s) for s in range(M.grid.pc)]
    if axis == "col":
        return [M.local_tile(s, index) for s in range(M.grid.pr)]
    raise ValueError(f"axis must be 'row' or 'col', got {axis!r}")


def _carousel_perms(p: int):
    """The Cannon carousel's ``(src, dst)`` device tables over the joint
    (row, col) index ``i * p + j``: ``(skew_a, skew_b, rot_a, rot_b)``. The
    skews put ``A_{i,(i+j)%p}`` and ``B_{(i+j)%p,j}`` on device (i, j); each
    rotation moves A one device left and B one device up."""
    skew_a = [(i * p + (i + j) % p, i * p + j) for i in range(p) for j in range(p)]
    skew_b = [(((i + j) % p) * p + j, i * p + j) for i in range(p) for j in range(p)]
    rot_a = [(i * p + (j + 1) % p, i * p + j) for i in range(p) for j in range(p)]
    rot_b = [(((i + 1) % p) * p + j, i * p + j) for i in range(p) for j in range(p)]
    return skew_a, skew_b, rot_a, rot_b


def _permute(held: list, perm) -> list:
    """One ``ppermute`` over the joint index: device ``dst`` receives what
    device ``src`` held."""
    out = list(held)
    for src, dst in perm:
        out[dst] = held[src]
    return out


def _carousel_stages(p: int):
    """The carousel schedule: yields ``(s, a_held, b_held)`` for each of the
    p stages, where ``a_held[i * p + j]`` and ``b_held[i * p + j]`` are the
    (row, col) ids of the A and B tiles device (i, j) holds at stage s, so
    that both share the contraction index ``(i + j + s) % p``."""
    skew_a, skew_b, rot_a, rot_b = _carousel_perms(p)
    own = [(i, j) for i in range(p) for j in range(p)]
    a_cur, b_cur = _permute(own, skew_a), _permute(own, skew_b)
    for s in range(p):
        yield s, a_cur, b_cur
        a_cur, b_cur = _permute(a_cur, rot_a), _permute(b_cur, rot_b)


def _stage_operands(A: SpParMat, B: SpParMat, i: int, j: int, ring: bool):
    """Output tile (i, j)'s stage operands in the reference's order: stage
    s multiplies ``A_is · B_sj``, or with ``ring`` the carousel's
    ``A_ik · B_kj``, k = (i + j + s) % p."""
    p = A.grid.pr
    if not ring:
        return list(zip(_gather_stage_tiles(A, i, "row"), _gather_stage_tiles(B, j, "col")))
    return [(A.local_tile(*a[i * p + j]), B.local_tile(*b[i * p + j]))
            for _, a, b in _carousel_stages(p)]


def _live(t: SpTuples) -> SpTuples:
    """The valid slots of ``t`` in slot order (one padding slot where none
    is valid), sized by a readback. A stable sort and a compaction give
    the same result with or without the padding slots, which sort last and
    fold nowhere."""
    idx = torch.nonzero(t.valid_mask()).squeeze(1)
    if idx.numel() == 0:
        return t.with_capacity(1)
    return SpTuples(rows=t.rows[idx], cols=t.cols[idx], vals=t.vals[idx], nnz=t.nnz,
                    nrows=t.nrows, ncols=t.ncols)


def _stage_chunk(sr: Semiring, a: SpTuples, b: SpTuples, flop_capacity: int) -> SpTuples:
    """One stage's expansion ``a · b``, cut at ``flop_capacity`` slots as
    the reference cuts it, then cut to its valid slots."""
    b_csr = CSR.from_tuples(b)
    need = int(expansion_slots(a, b_csr))
    return _live(expand(sr, a, b_csr, min(flop_capacity, need)))


# --- the ESC tier --------------------------------------------------------------


def summa_spgemm(sr: Semiring, A: SpParMat, B: SpParMat, *, flop_capacity: int,
                 out_capacity: int, ring: bool = False, merge: str = "sort") -> SpParMat:
    """``C = A ⊗ B`` over the grid. ``flop_capacity`` bounds one stage's
    expansion on one tile, ``out_capacity`` every output tile.

    ``merge``: ``"sort"`` concatenates the stage chunks and compacts them
    with one sort; ``"runs"`` sorts each chunk alone and merges the sorted
    runs (``ops.spgemm.merge_sorted_runs``), so the compaction needs no
    sort. Equal keys keep stage order either way, so both give the same
    result for every semiring. ``ring`` walks the stages in the carousel's
    order (it decides a float ``plus``'s fold order)."""
    _check_compat(A, B)
    if merge not in ("sort", "runs"):
        raise ValueError(f"merge must be 'sort' or 'runs', got {merge!r}")

    def tile(i, j):
        chunks = [_stage_chunk(sr, a, b, flop_capacity)
                  for a, b in _stage_operands(A, B, i, j, ring)]
        if merge == "runs":
            merged = merge_sorted_runs([ch.sort_rowmajor() for ch in chunks])
            return merged.compact(sr, capacity=out_capacity, assume_sorted=True)
        return SpTuples.concat(chunks).compact(sr, capacity=out_capacity)

    return SpParMat.assemble(A.grid, A.nrows, B.ncols, tile)


def summa_stage_flops(A: SpParMat, B: SpParMat, padded: bool = True) -> torch.Tensor:
    """``[p, pr, pc]`` float32 multiplies per stage and output tile: the
    symbolic pass. ``padded=True`` counts the chunked expansion's slots
    (each B-row walk rounded up to ``CHUNK_W`` lanes, what ``expand``
    fills), ``padded=False`` true scalar multiplies. Counted exactly in
    int64 and rounded to float32 once (the reference's float32 sums can
    round past 2^24). Reference: ``EstimateFLOP``."""
    _check_compat(A, B)
    p = A.grid.pr
    lrA, lrB = A.local_rows, B.local_rows
    dev = A.grid.device
    blens = {}
    for s in range(p):
        for j in range(p):
            t = B.local_tile(s, j)
            n = torch.bincount(torch.clamp(t.rows, max=lrB).long(), minlength=lrB + 1)
            n[lrB] = 0
            blens[s, j] = -(-n // CHUNK_W) * CHUNK_W if padded else n
    out = torch.zeros((p, p, p), dtype=torch.int64, device=dev)
    for s in range(p):
        for i in range(p):
            t = A.local_tile(i, s)
            k = torch.clamp(t.cols, max=lrB).long()
            valid = t.rows < lrA
            for j in range(p):
                out[s, i, j] = torch.where(valid, blens[s, j][k], 0).sum()
    return out.to(torch.float32)


def _caps_from_stage_flops(per_stage: np.ndarray, dense_tile: int, slack: float):
    flop_cap = max(int(per_stage.max() * slack) + 1, 1)
    total_per_tile = per_stage.sum(axis=0).max()
    out_cap = max(min(int(total_per_tile * slack) + 1, dense_tile), 1)
    return flop_cap, out_cap


def summa_capacities(A: SpParMat, B: SpParMat, slack: float = 1.05):
    """``(flop_capacity, out_capacity)`` from the symbolic pass (one
    readback): the largest stage expansion of a tile, and the largest
    tile's total expansion clamped to the dense tile, each times
    ``slack``."""
    per_stage = host_value(summa_stage_flops(A, B)).astype(np.float64)
    return _caps_from_stage_flops(per_stage, A.local_rows * B.local_cols, slack)


def summa_stage_flops_host(grid, rows_a, cols_a, rows_b, cols_b, nrows_a: int,
                           ncols_a: int, ncols_b: int, padded: bool = True) -> np.ndarray:
    """``summa_stage_flops`` from global host COO arrays, with no device
    work (float64 ``[p, pr, pc]``)."""
    if grid.pr != grid.pc:
        raise ValueError("SUMMA requires a square grid")
    p = grid.pr
    lrA, lcA = grid.local_rows(nrows_a), grid.local_cols(ncols_a)
    lrB, lcB = grid.local_rows(ncols_a), grid.local_cols(ncols_b)
    if lcA != lrB:
        raise ValueError("A col-blocking must equal B row-blocking")
    rows_a, cols_a, rows_b, cols_b = (np.asarray(x, np.int64)
                                      for x in (rows_a, cols_a, rows_b, cols_b))
    ia, sa, ka = rows_a // lrA, cols_a // lcA, cols_a % lcA
    count_a = np.bincount((ia * p + sa) * lcA + ka, minlength=p * p * lcA).reshape(p, p, lcA)
    sb, jb, kb = rows_b // lrB, cols_b // lcB, rows_b % lrB
    count_b = np.bincount((sb * p + jb) * lrB + kb, minlength=p * p * lrB).reshape(p, p, lrB)
    if padded:
        count_b = -(-count_b // CHUNK_W) * CHUNK_W
    return np.einsum("isk,sjk->sij", count_a.astype(np.float64), count_b.astype(np.float64))


def summa_capacities_host(grid, rows_a, cols_a, rows_b, cols_b, nrows_a: int, ncols_a: int,
                          ncols_b: int, slack: float = 1.05,
                          per_stage: np.ndarray | None = None):
    """``summa_capacities`` from global host COO arrays (or a
    ``summa_stage_flops_host`` result)."""
    if per_stage is None:
        per_stage = summa_stage_flops_host(grid, rows_a, cols_a, rows_b, cols_b, nrows_a,
                                           ncols_a, ncols_b)
    dense_tile = grid.local_rows(nrows_a) * grid.local_cols(ncols_b)
    return _caps_from_stage_flops(per_stage, dense_tile, slack)


def spgemm(sr: Semiring, A: SpParMat, B: SpParMat, slack: float = 1.05, *,
           pow2_caps: bool = True, merge: str | None = None) -> SpParMat:
    """The symbolic pass, then the ESC SUMMA at its capacities, both
    rounded up to powers of two (``pow2_caps``; ``out_capacity`` clamped to
    the dense tile). ``merge``: ``"sort"`` (default) or ``"runs"``;
    ``"hash"`` (the 3D fiber tier's) runs as ``"runs"`` here, as in the
    reference. ``spgemm.last_capacities`` records the two capacities of
    the last call. Reference: ``Mult_AnXBn_Synch``."""
    merge = "sort" if merge is None else ("runs" if merge == "hash" else merge)
    flop_cap, out_cap = summa_capacities(A, B, slack)
    if pow2_caps:
        flop_cap = 1 << (flop_cap - 1).bit_length()
        out_cap = min(1 << (out_cap - 1).bit_length(), max(A.local_rows * B.local_cols, 1))
    spgemm.last_capacities = (flop_cap, out_cap)
    return summa_spgemm(sr, A, B, flop_capacity=flop_cap, out_capacity=out_cap, merge=merge)


spgemm.last_capacities = None


class PhaseAdjustedWarning(UserWarning):
    """``mem_efficient_spgemm`` moved the phase count to a divisor of the
    local column count: ``requested``, ``actual`` (at least ``requested``,
    at most 4 times it) and ``local_cols``."""

    def __init__(self, requested: int, actual: int, local_cols: int):
        self.requested = requested
        self.actual = actual
        self.local_cols = local_cols
        super().__init__(
            f"mem_efficient_spgemm: {requested} phases does not divide "
            f"local_cols={local_cols}; using the nearest divisor {actual} instead")


def mem_efficient_spgemm(sr: Semiring, A: SpParMat, B: SpParMat, phases: int, *,
                         slack: float = 1.05, prune_fn=None, scan: bool = False) -> SpParMat:
    """Phased SUMMA: B ``col_split`` into ``phases`` local column pieces,
    each piece's product (``spgemm``, or ``spgemm_scan`` with ``scan``)
    pruned by ``prune_fn`` where given, the outputs put back with
    ``col_concatenate``. A phase count that does not divide the local
    columns moves up to the nearest divisor (``PhaseAdjustedWarning``),
    within 4 times the request. Reference: ``MemEfficientSpGEMM``."""
    lc = B.local_cols
    if phases > 1 and B.ncols != lc * B.grid.pc:
        raise ValueError(
            f"mem_efficient_spgemm: ncols={B.ncols} is not evenly distributed over "
            f"pc={B.grid.pc} (local_cols={lc}); pad the matrix to a multiple of pc or "
            "run with phases=1")
    if phases > 1 and lc % phases:
        adj = min(phases, lc)
        while adj <= lc and lc % adj:
            adj += 1
        if adj > 4 * phases:
            raise ValueError(
                f"mem_efficient_spgemm: {phases} phases does not divide local_cols={lc} "
                f"and the nearest divisor above it ({adj}) is >4x the request; choose a "
                f"phase count dividing local_cols (divisors of {lc}) or repad the matrix")
        warnings.warn(PhaseAdjustedWarning(phases, adj, lc), stacklevel=2)
        phases = adj

    def mult(a, b):
        return spgemm_scan(sr, a, b, slack=slack) if scan else spgemm(sr, a, b, slack)

    if phases <= 1:
        C = mult(A, B)
        return prune_fn(C) if prune_fn is not None else C
    outs = []
    for Bs in B.col_split(phases):
        C = mult(A, Bs.shrink_to_fit())
        outs.append(prune_fn(C) if prune_fn is not None else C)
    return SpParMat.col_concatenate(outs)


def block_spgemm(sr: Semiring, A: SpParMat, B: SpParMat, row_blocks: int = 1,
                 col_blocks: int = 1, slack: float = 1.05):
    """Yields ``((i, j), C_ij)`` with ``C_ij = A[row block i, :] ⊗ B[:,
    col block j]`` (local splits, as ``col_split``), one block's expansion
    live at a time. Reference: ``BlockSpGEMM``."""
    a_rows = A.row_split(row_blocks) if row_blocks > 1 else [A]
    b_cols = B.col_split(col_blocks) if col_blocks > 1 else [B]
    b_cols = [b.shrink_to_fit() for b in b_cols]
    for i, Ai in enumerate(a_rows):
        Ai = Ai.shrink_to_fit()
        for j, Bj in enumerate(b_cols):
            yield (i, j), spgemm(sr, Ai, Bj, slack)


def estimate_flops(A: SpParMat, B: SpParMat) -> int:
    """Total scalar multiplies of ``A ⊗ B``. Reference: ``EstimateFLOP``."""
    return int(host_value(summa_stage_flops(A, B, padded=False)).astype(np.float64).sum())


def calculate_phases(A: SpParMat, B: SpParMat, per_device_memory_bytes: int,
                     slack: float = 1.05) -> int:
    """A phase count for ``mem_efficient_spgemm`` from a memory budget: the
    unphased product's peak expansion (p stage chunks of the largest
    stage's slots, 8 bytes of ids and the value a slot) over the budget,
    rounded up to a power of two and down to a divisor of B's local
    columns. Reference: ``CalculateNumberOfPhases``."""
    per_stage = host_value(summa_stage_flops(A, B)).astype(np.float64)
    slot_bytes = 4 + 4 + A.vals.element_size()
    peak = per_stage.max() * A.grid.pr * slot_bytes * slack
    phases = max(1, int(np.ceil(peak / max(per_device_memory_bytes, 1))))
    phases = 1 << (phases - 1).bit_length()
    lc = B.local_cols
    if B.ncols != lc * B.grid.pc:
        return 1
    phases = min(phases, max(lc, 1))
    while phases > 1 and lc % phases:
        phases >>= 1
    return phases


def estimate_nnz_upper(A: SpParMat, B: SpParMat) -> int:
    """An upper bound of nnz(C): each tile's true multiplies clamped to the
    dense tile, summed. Reference: ``EstPerProcessNnzSUMMA``'s role."""
    per_tile = host_value(summa_stage_flops(A, B, padded=False)).astype(np.float64).sum(axis=0)
    return int(np.minimum(per_tile, A.local_rows * B.local_cols).sum())


# --- the scan tier -------------------------------------------------------------


def summa_spgemm_scan(sr: Semiring, A: SpParMat, B: SpParMat, *, flop_capacity: int,
                      out_capacity: int, ring: bool = False) -> tuple[SpParMat, torch.Tensor]:
    """Output-bounded SUMMA: each stage's expansion is merged at once into
    a running accumulator of ``out_capacity`` slots (one compaction a
    stage). Returns ``(C, overflow)``: the largest, over tiles and stages,
    of the distinct keys seen minus ``out_capacity`` (a 0-dim tensor, 0
    when C is exact). Once a stage truncates, its dropped keys leave the
    later counts, so a positive overflow is a lower bound of the
    shortfall."""
    _check_compat(A, B)
    dev = A.grid.device
    worst = [torch.zeros((), dtype=torch.long, device=dev)]

    def tile(i, j):
        acc = SpTuples.empty(A.local_rows, B.local_cols, out_capacity, A.dtype, device=dev)
        for a, b in _stage_operands(A, B, i, j, ring):
            chunk = _stage_chunk(sr, a, b, flop_capacity)
            # acc is compacted: its valid slots are a prefix
            head = acc.with_capacity(max(int(acc.nnz), 1))
            acc, distinct = SpTuples.concat([head, chunk]).compact_counted(
                sr, capacity=out_capacity)
            worst[0] = torch.maximum(worst[0], distinct - out_capacity)
        return acc

    C = SpParMat.assemble(A.grid, A.nrows, B.ncols, tile)
    return C, worst[0]


def spgemm_scan(sr: Semiring, A: SpParMat, B: SpParMat, *, out_capacity: int | None = None,
                slack: float = 1.1, max_retries: int = 3, ring: bool = False) -> SpParMat:
    """The scan tier's entry: size, run, and on overflow run again larger.
    The first ``out_capacity`` (default: the inputs' larger capacity,
    within the flops bound, at least 64, rounded up to a power of two) is
    cheap; each retry grows it to the power of two above ``out_capacity +
    overflow``, and at least doubles it, since the overflow is a lower
    bound. One readback an attempt."""
    flop_cap, flops_out_cap = summa_capacities(A, B, slack)
    if out_capacity is None:
        out_capacity = max(min(flops_out_cap, max(A.capacity, B.capacity)), 64)
    out_capacity = 1 << (int(out_capacity) - 1).bit_length()
    over, tried = 0, []
    for _ in range(max_retries + 1):
        tried.append(out_capacity)
        C, overflow = summa_spgemm_scan(sr, A, B, flop_capacity=flop_cap,
                                        out_capacity=out_capacity, ring=ring)
        over = int(overflow)
        spgemm_scan.last_run = {"flop_capacity": flop_cap, "out_capacities": tried}
        if over <= 0:
            return C
        out_capacity = max(1 << (out_capacity + over - 1).bit_length(), out_capacity * 2)
    raise ValueError(f"spgemm_scan still overflowing by {over} after {max_retries} "
                     "retries; pass an explicit out_capacity")


spgemm_scan.last_run = None


# --- the router --------------------------------------------------------------------


def resolve_spgemm_backend(backend: str | None = None) -> str:
    """The windowed tier's accumulate backend: the explicit argument, else
    the platform default, ``"scatter"`` (the reference's default on every
    platform but the TPU, which has no scatter unit). The environment knob
    waits for the port of ``tuner/`` (ROADMAP.md, queue 1, item 13)."""
    backend = "scatter" if backend is None else backend
    if backend not in ("dot", "scatter"):
        raise ValueError(f"backend must be 'dot' or 'scatter', got {backend!r}")
    return backend


def dot_panel_feasible(k_dim: int, n_dim: int | None = None) -> bool:
    """True iff a column window of at least 512 columns (at least
    ``ceil(n / WINDOWED_MAX_COL_WINDOWS)`` when B's width is known) fits
    ``WINDOWED_MAX_PANEL_CELLS`` with B's padded row count: the ``dot``
    backend's envelope."""
    win = 512
    if n_dim is not None:
        floor_bc = -(-n_dim // WINDOWED_MAX_COL_WINDOWS)
        win = max(win, -(-floor_bc // 512) * 512)
    return _pad128(k_dim) * win <= WINDOWED_MAX_PANEL_CELLS


def choose_tier_from_counts(sr: Semiring, max_tile_dim: int, tile_cells: int, pr: int,
                            flops_total: float, backend: str | None = None,
                            k_dim: int | None = None, allow_mxu: bool = True,
                            n_dim: int | None = None) -> str:
    """The tier rule over counts already made (see ``choose_spgemm_tier``):
    ``mxu`` for small tiles of a dense-kernel semiring (unless
    ``allow_mxu=False``); ``windowed`` where the add monoid scatters, the
    tile is at most ``WINDOWED_MAX_TILE_CELLS`` cells and the grid's cells
    are at most ``WINDOWED_MAX_CELLS_PER_FLOP`` a multiply, on the
    ``scatter`` backend, or on ``dot`` for a dense-kernel semiring whose B
    panel fits; ``scan`` otherwise."""
    backend = resolve_spgemm_backend(backend)
    if allow_mxu and max_tile_dim <= MXU_MAX_TILE_DIM and sr.name in _PALLAS_KINDS:
        return "mxu"
    dense_ok = (scatter_combine_for(sr) is not None
                and tile_cells <= WINDOWED_MAX_TILE_CELLS
                and tile_cells * pr * pr <= WINDOWED_MAX_CELLS_PER_FLOP * max(flops_total, 1.0))
    if backend == "scatter" and dense_ok:
        return "windowed"
    if (backend == "dot" and dense_ok and sr.name in _PALLAS_KINDS
            and dot_panel_feasible(k_dim or max_tile_dim, n_dim)):
        return "windowed"
    return "scan"


def choose_spgemm_tier(sr: Semiring, A: SpParMat, B: SpParMat, *, backend: str | None = None,
                       assume_unique: bool = False) -> str:
    """The tier the reference's ``spgemm_auto`` picks:

      ``"mxu"``       tiles within ``MXU_MAX_TILE_DIM``, a semiring with a
                      dense kernel, and tiles of unique entries (checked
                      with ``coo_has_duplicates`` unless ``assume_unique``);
      ``"windowed"``  the add monoid has a scatter combiner, the tile's
                      dense cells are bounded and the output dense enough
                      (the symbolic pass counts the multiplies);
      ``"scan"``      everything else.

    It returns ``"windowed"`` where the reference does, though that tier is
    not ported yet (``spgemm_auto`` raises for it). The reference's upgrade
    of ``windowed`` to ``windowed3d`` on a layered mesh waits for
    ``mesh3d.py``."""
    return _choose_spgemm_tier_2d(sr, A, B, backend=backend, assume_unique=assume_unique)


def _choose_spgemm_tier_2d(sr: Semiring, A: SpParMat, B: SpParMat, *,
                           backend: str | None = None, assume_unique: bool = False) -> str:
    """The 2D rungs of ``choose_spgemm_tier``."""
    backend = resolve_spgemm_backend(backend)
    max_dim = max(A.local_rows, A.local_cols, B.local_cols)
    cells = A.local_rows * B.local_cols

    def flops_total():
        return float(host_value(summa_stage_flops(A, B, padded=False)).astype(np.float64).sum())

    if max_dim <= MXU_MAX_TILE_DIM and sr.name in _PALLAS_KINDS:
        if assume_unique or not (coo_has_duplicates(A)
                                 or (B is not A and coo_has_duplicates(B))):
            return "mxu"
        return choose_tier_from_counts(sr, max_dim, cells, A.grid.pr, flops_total(), backend,
                                       k_dim=B.local_rows, allow_mxu=False,
                                       n_dim=B.local_cols)
    # the static windowed preconditions first: the symbolic pass costs a readback
    if (scatter_combine_for(sr) is None or cells > WINDOWED_MAX_TILE_CELLS
            or (backend == "dot" and (sr.name not in _PALLAS_KINDS or not dot_panel_feasible(
                B.local_rows, B.local_cols)))):
        return "scan"
    return choose_tier_from_counts(sr, max_dim, cells, A.grid.pr, flops_total(), backend,
                                   k_dim=B.local_rows, n_dim=B.local_cols)


def spgemm_auto(sr: Semiring, A: SpParMat, B: SpParMat, *, out_capacity: int | None = None,
                slack: float = 1.1, max_retries: int = 3, mode: str = "f32",
                tier: str | None = None, backend: str | None = None,
                assume_unique: bool = False, merge: str | None = None) -> SpParMat:
    """Sparse-output SpGEMM ``C = A ⊗ B`` through the tier
    ``choose_spgemm_tier`` picks, or ``tier``:

      ``"esc"``   ``spgemm`` (``merge``: sort or runs);
      ``"scan"``  ``spgemm_scan`` (``out_capacity``, ``slack``,
                  ``max_retries``);
      ``"mxu"``   the dense tier: output capacity the next power of two of
                  ``out_capacity`` (default ``max(A.capacity, B.capacity,
                  64)``), rerun on overflow with the power of two above
                  ``out_capacity + overflow``, at most ``max_retries``
                  times; ``mode`` sets the plus_times precision. It needs
                  tiles of unique entries, which the router checks unless
                  ``assume_unique``.

    ``"windowed"`` and ``"windowed3d"``, asked for or routed to, raise
    ``NotImplementedError``: they are not ported yet. Env knobs and the
    plan store wait for the port of ``tuner/``."""
    if tier is None:
        tier = choose_spgemm_tier(sr, A, B, backend=backend, assume_unique=assume_unique)
    if tier in _UNPORTED_TIERS:
        raise NotImplementedError(f"spgemm tier {tier!r} is {_UNPORTED_NOTE}")
    if tier == "esc":
        return spgemm(sr, A, B, slack, merge=merge)
    if tier == "scan":
        return spgemm_scan(sr, A, B, out_capacity=out_capacity, slack=slack,
                           max_retries=max_retries)
    if tier != "mxu":
        raise ValueError(f"unknown spgemm tier {tier!r}; expected one of {TIERS}")
    if out_capacity is None:
        out_capacity = max(A.capacity, B.capacity, 64)
    out_capacity = 1 << (int(out_capacity) - 1).bit_length()
    over = 0
    for _ in range(max_retries + 1):
        C, overflow = summa_spgemm_mxu(sr, A, B, out_capacity=out_capacity, mode=mode)
        over = int(overflow)
        if over <= 0:
            return C
        out_capacity = 1 << (out_capacity + over - 1).bit_length()
    raise ValueError(
        f"spgemm_auto still overflowing by {over} after {max_retries} "
        "retries; pass an explicit out_capacity"
    )
