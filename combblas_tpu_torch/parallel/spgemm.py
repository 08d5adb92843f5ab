"""Distributed SpGEMM — counterpart of ``combblas_tpu/parallel/spgemm.py``:
SUMMA over the grid's tiles, ``C_ij = ⊕_s A_is ⊗ B_sj``, in four tiers.

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
  * windowed (``spgemm_windowed``): dense row-block accumulators, each
    stage folded in by the semiring's scatter (``backend="scatter"``) or
    by dense (row block × column window) stage products (``"dot"``:
    ``torch.matmul``, or the semiring GEMM), then one extraction a block
    or window; sized by a symbolic pass per row block
    (``summa_rowblock_flops_pair``) or window (``summa_window_flops_pair``)
    that also skips the empty ones. Forms: fused
    (``summa_spgemm_windowed``, gathered or carousel stage order), blocked
    (``summa_spgemm_windowed_blocked``) and local
    (``local_spgemm_windowed``, one tile).

The phased (``mem_efficient_spgemm``) and blocked (``block_spgemm``) forms
run the ESC tier over column or row/column pieces. ``spgemm_auto`` routes
through the tuner's chain (argument, plan store, environment, probe;
``tuner/``), then ``choose_spgemm_tier``, the reference's rule; given a layered grid
(``grid3``) a windowed product goes to the 3D tier (``windowed3d``:
``mesh3d.spgemm3d_windowed`` on the operands converted to 3D, the result
converted back).

The tiles of a grid live on one device and are walked in loops, as the
reference's all-gather (or, with ``ring=True``, its carousel of
``ppermute``s) walks its stages. Capacities are the reference's (they are
part of the output layout). The stage expansions inside a product are
internal: they are sized from exact counts read back and cut to their
valid slots before the merge, which gives the same outputs, padding slots
included, with less memory.

Telemetry (``obs``), at the reference's sites and under its gates: the
symbolic pass's ``spgemm.symbolic_fill_slots`` / ``spgemm.load_imbalance``,
the ``spgemm``, ``spgemm.scan``, ``spgemm.phase`` and ``spgemm.auto``
spans with their events, the router's ``spgemm.auto.*`` and
``tuner.store.rejected`` counts, the windowed plan's
``spgemm.windowed.*`` series, the retry counts of the scan and mxu tiers,
``spgemm.merge.tier`` (labelled by ``merge_source``), and
``spgemm.realized_nnz``, read back only under ``obs.DEVICE_SYNC`` as in the
reference, even where the port has the count on the host already. Sites
that the reference reaches while tracing a jitted program count once a
call here: ``spgemm.pipeline.stages_overlapped`` (``summa_spgemm``,
``summa_spgemm_scan``, ``summa_spgemm_windowed``) and the carousel's
``spgemm.pipeline.stage`` events. The reference's ``trace.summa_spgemm``,
``trace.summa_spgemm_scan``, ``trace.summa_spgemm_windowed`` and
``trace.summa_spgemm_mxu`` count JAX retraces; eager torch has none, so
they are left out.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import obs
from ..ops.compressed import CSR
from ..ops.semiring_matmul import semiring_matmul
from ..ops.spgemm import (
    CHUNK_W,
    coo_sort_dedup,
    densify,
    densify_combine,
    expand,
    expansion_slots,
    fold_buffer_values,
    fold_expansion_,
    mask_rows,
    merge_sorted_runs,
    new_fold_buffer,
    scatter_combine_for,
    sparsify_windowed,
    spgemm_support_bits,
    support_window_counts,
)
from ..ops.tuples import SpTuples
from ..semiring import Semiring
from ..tuner import config as tuner_config
from ..tuner import store as tuner_store
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
    p = A.grid.pr
    if obs.ENABLED and ring and p > 1:
        obs.count("spgemm.pipeline.stages_overlapped", p - 1)

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
    if obs.ENABLED:
        _record_symbolic_metrics(per_stage)
    return _caps_from_stage_flops(per_stage, A.local_rows * B.local_cols, slack)


def _record_symbolic_metrics(per_stage: np.ndarray) -> None:
    """Registry facts from one symbolic pass: total symbolic fill-in
    (expansion slots — the flops side of symbolic-vs-realized) and the
    per-tile LoadImbalance (max/mean over output tiles, the reference's
    ``LoadImbalance`` statistic)."""
    per_tile = per_stage.sum(axis=0)
    mean = float(per_tile.mean())
    obs.count("spgemm.symbolic_fill_slots", float(per_stage.sum()))
    obs.gauge("spgemm.load_imbalance", float(per_tile.max() / mean) if mean > 0 else 1.0)


def _record_realized_nnz(C: SpParMat) -> None:
    """Realized output fill-in (the other half of symbolic-vs-realized).
    Reading ``C.nnz`` is a device readback, so this records ONLY under
    the explicit ``obs.DEVICE_SYNC`` opt-in, as in the reference — also
    where the port has already read the count back — so that telemetry
    never adds a readback a caller did not ask for."""
    if obs.ENABLED and obs.DEVICE_SYNC:
        obs.count("spgemm.realized_nnz", int(host_value(C.nnz).sum()))


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
    if obs.ENABLED:
        _record_symbolic_metrics(np.asarray(per_stage, np.float64))
    dense_tile = grid.local_rows(nrows_a) * grid.local_cols(ncols_b)
    return _caps_from_stage_flops(per_stage, dense_tile, slack)


def spgemm(sr: Semiring, A: SpParMat, B: SpParMat, slack: float = 1.05, *,
           pow2_caps: bool = True, merge: str | None = None,
           merge_source: str | None = None) -> SpParMat:
    """The symbolic pass, then the ESC SUMMA at its capacities, both
    rounded up to powers of two (``pow2_caps``; ``out_capacity`` clamped to
    the dense tile). ``merge``: argument > ``COMBBLAS_SPGEMM_MERGE`` >
    ``"sort"``; ``"runs"`` merges sorted runs, and ``"hash"`` (the 3D fiber
    tier's) runs as ``"runs"`` here, as in the reference. ``merge_source``
    labels the ``spgemm.merge.tier`` count (``"arg"`` for a given
    ``merge``, ``"env"``, ``"heuristic"``; ``spgemm_auto`` passes
    ``"store"`` for a plan record's merge). ``spgemm.last_capacities``
    records the two capacities of the last call. Reference:
    ``Mult_AnXBn_Synch``."""
    if merge is not None and merge_source is None:
        merge_source = "arg"
    if merge is None:
        merge = tuner_config.env_merge()
        merge_source = "env" if merge is not None else None
    if merge == "hash":
        merge = "runs"
    if merge is None:
        merge, merge_source = "sort", "heuristic"
    with obs.span("spgemm", sr=sr.name):
        if obs.ENABLED:
            obs.count("spgemm.merge.tier", tier=merge, source=merge_source, op="spgemm")
        flop_cap, out_cap = summa_capacities(A, B, slack)
        if pow2_caps:
            flop_cap = 1 << (flop_cap - 1).bit_length()
            out_cap = min(1 << (out_cap - 1).bit_length(),
                          max(A.local_rows * B.local_cols, 1))
        if obs.ENABLED:
            obs.span_event("capacities", flop_capacity=flop_cap, out_capacity=out_cap)
        spgemm.last_capacities = (flop_cap, out_cap)
        C = summa_spgemm(sr, A, B, flop_capacity=flop_cap, out_capacity=out_cap, merge=merge)
        _record_realized_nnz(C)
        return C


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
        if obs.ENABLED:
            obs.count("spgemm.phase_adjusted")
        phases = adj
    if obs.ENABLED:
        # the phase count actually executed (the spgemm.phase spans below)
        obs.gauge("spgemm.phases", phases, scan=str(scan))

    def mult(a, b):
        return spgemm_scan(sr, a, b, slack=slack) if scan else spgemm(sr, a, b, slack)

    if phases <= 1:
        C = mult(A, B)
        return prune_fn(C) if prune_fn is not None else C
    outs = []
    for pi, Bs in enumerate(B.col_split(phases)):
        with obs.span("spgemm.phase", phase=pi):
            C = mult(A, Bs.shrink_to_fit())
            if prune_fn is not None:
                C = prune_fn(C)
        outs.append(C)
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
    if obs.ENABLED and ring and A.grid.pr > 1:
        obs.count("spgemm.pipeline.stages_overlapped", A.grid.pr - 1)
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
    with obs.span("spgemm.scan", sr=sr.name):
        flop_cap, flops_out_cap = summa_capacities(A, B, slack)
        if out_capacity is None:
            out_capacity = max(min(flops_out_cap, max(A.capacity, B.capacity)), 64)
        out_capacity = 1 << (int(out_capacity) - 1).bit_length()
        over, tried = 0, []
        for attempt in range(max_retries + 1):
            tried.append(out_capacity)
            C, overflow = summa_spgemm_scan(sr, A, B, flop_capacity=flop_cap,
                                            out_capacity=out_capacity, ring=ring)
            over = int(overflow)
            spgemm_scan.last_run = {"flop_capacity": flop_cap, "out_capacities": tried}
            if over <= 0:
                if obs.ENABLED:
                    obs.count("spgemm.scan.overflow_retries", attempt)
                    obs.span_event("sized", flop_capacity=flop_cap,
                                   out_capacity=out_capacity, retries=attempt)
                    _record_realized_nnz(C)
                return C
            if obs.ENABLED:
                obs.count("spgemm.scan.overflow_slots", over)
            out_capacity = max(1 << (out_capacity + over - 1).bit_length(),
                               out_capacity * 2)
    raise TierRefusal(f"spgemm_scan still overflowing by {over} after {max_retries} "
                     "retries; pass an explicit out_capacity")


spgemm_scan.last_run = None


# --- the windowed tier ----------------------------------------------------------

#: Dense cells aimed at per row-block accumulator, and the most row blocks
#: a tile is cut into.
WINDOWED_BLOCK_CELLS = 1 << 26
WINDOWED_MAX_BLOCKS = 32
#: The scatter backend's expansion chunk width: the scatter pays per slot,
#: so narrow chunks keep the padding near 1.1x on R-MAT degree tails.
WINDOWED_CHUNK_W = 8


def default_block_cols(local_rows_b: int, local_cols_b: int) -> int:
    """Column-window width of the 2D ``dot`` backend: the widest multiple
    of 512 whose dense B panel (padded k × window) stays within
    ``WINDOWED_MAX_PANEL_CELLS``, raised so that at most
    ``WINDOWED_MAX_COL_WINDOWS`` windows cover the tile (where the two
    conflict the window count wins; the router never sends such products
    here, ``dot_panel_feasible``)."""
    pk = _pad128(local_rows_b)
    bc = max((WINDOWED_MAX_PANEL_CELLS // pk) // 512 * 512, 512)
    floor_bc = -(-local_cols_b // WINDOWED_MAX_COL_WINDOWS)
    bc = max(bc, -(-floor_bc // 512) * 512)
    return min(bc, max(local_cols_b, 1))


def default_block_rows(local_rows: int, local_cols_b: int) -> int:
    """Row-block height: about ``WINDOWED_BLOCK_CELLS`` cells a dense
    accumulator, at most ``WINDOWED_MAX_BLOCKS`` blocks, a multiple of 8."""
    pcols = max(-(-local_cols_b // 128) * 128, 1)
    br = max(1, min(local_rows, WINDOWED_BLOCK_CELLS // pcols))
    br = max(br, -(-local_rows // WINDOWED_MAX_BLOCKS))
    return min(-(-br // 8) * 8, max(local_rows, 1))


def _segment_count(ids: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ``out[s] = Σ weights[ids == s]`` for ids in ``[0, n]``, the
    last segment cut off."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    return out.index_add_(0, ids.long(), weights.long())[:n]


def summa_rowblock_flops_pair(A: SpParMat, B: SpParMat, block_rows: int,
                              chunk_w: int) -> torch.Tensor:
    """float32 ``[2, nblocks, p, pr, pc]``: per A row block, stage and
    output tile, the expansion slots of chunk width ``chunk_w`` (index 0)
    and the true multiplies (index 1), from one symbolic pass. Sizes the
    windowed tier's scatter backend and its skip list (a block with no
    multiply has no output). Counted exactly in int64, rounded to float32
    once."""
    _check_compat(A, B)
    p = A.grid.pr
    lrA, lrB = A.local_rows, B.local_rows
    nblocks = -(-lrA // block_rows)
    out = torch.zeros((2, nblocks, p, p, p), dtype=torch.int64, device=A.grid.device)
    for s in range(p):
        padded_true = []
        for j in range(p):
            b = B.local_tile(s, j)
            blens = _segment_count(torch.clamp(b.rows, max=lrB), b.rows < lrB, lrB + 1)
            padded_true.append((-(-blens // chunk_w) * chunk_w, blens))
        for i in range(p):
            a = A.local_tile(i, s)
            valid = a.rows < lrA
            k = torch.clamp(a.cols, max=lrB).long()
            g = torch.where(valid, a.rows // block_rows, nblocks)
            for j in range(p):
                for v, bl in enumerate(padded_true[j]):
                    out[v, :, s, i, j] = _segment_count(g, torch.where(valid, bl[k], 0),
                                                        nblocks)
    return out.to(torch.float32)


def summa_rowblock_flops(A: SpParMat, B: SpParMat, block_rows: int,
                         chunk_w: int = 0) -> torch.Tensor:
    """``[nblocks, p, pr, pc]`` of ``summa_rowblock_flops_pair``: the
    expansion slots of chunk width ``chunk_w``, or with ``chunk_w == 0``
    the true multiplies."""
    pair = summa_rowblock_flops_pair(A, B, block_rows, chunk_w=max(chunk_w, 1))
    return pair[0] if chunk_w else pair[1]


def _host_counts(grid, rows_a, cols_a, rows_b, cols_b, nrows_a: int, ncols_a: int,
                 ncols_b: int, block_rows: int, block_cols: int | None, chunk_w: int):
    """The host symbolic pass's two count tables: ``countA[i, s, g, k]``
    (A's entries of row block g and column k in tile (i, s)) and
    ``countB[s, j, h, k]`` (B's entries of row k in column window h of tile
    (s, j); one window when ``block_cols`` is None), B's padded to
    ``chunk_w`` lanes when ``chunk_w``."""
    if grid.pr != grid.pc:
        raise ValueError("SUMMA requires a square grid")
    p = grid.pr
    lrA, lcA = grid.local_rows(nrows_a), grid.local_cols(ncols_a)
    lrB, lcB = grid.local_rows(ncols_a), grid.local_cols(ncols_b)
    if lcA != lrB:
        raise ValueError("A col-blocking must equal B row-blocking")
    nblocks = -(-lrA // block_rows)
    ncw = 1 if block_cols is None else -(-lcB // block_cols)
    rows_a, cols_a, rows_b, cols_b = (np.asarray(x, np.int64)
                                      for x in (rows_a, cols_a, rows_b, cols_b))
    ia, sa, ka = rows_a // lrA, cols_a // lcA, cols_a % lcA
    g = (rows_a % lrA) // block_rows
    count_a = np.bincount((((ia * p + sa) * nblocks) + g) * lcA + ka,
                          minlength=p * p * nblocks * lcA).reshape(p, p, nblocks, lcA)
    sb, jb, kb = rows_b // lrB, cols_b // lcB, rows_b % lrB
    hb = 0 if block_cols is None else (cols_b % lcB) // block_cols
    count_b = np.bincount((((sb * p + jb) * ncw) + hb) * lrB + kb,
                          minlength=p * p * ncw * lrB).reshape(p, p, ncw, lrB)
    if chunk_w:
        count_b = -(-count_b // chunk_w) * chunk_w
    return count_a, count_b


def summa_rowblock_flops_host(grid, rows_a, cols_a, rows_b, cols_b, nrows_a: int,
                              ncols_a: int, ncols_b: int, block_rows: int,
                              chunk_w: int = 0) -> np.ndarray:
    """``summa_rowblock_flops`` from global host COO arrays, with no device
    work: float64 ``[nblocks, p, pr, pc]``, summed exactly in int64."""
    count_a, count_b = _host_counts(grid, rows_a, cols_a, rows_b, cols_b, nrows_a, ncols_a,
                                    ncols_b, block_rows, None, chunk_w)
    # flops[g, s, i, j] = sum_k countA[i, s, g, k] * countB[s, j, k]
    return np.einsum("isgk,sjk->gsij", count_a, count_b[:, :, 0]).astype(np.float64)


def _window_stage_symbolic(a: SpTuples, b: SpTuples, lrA: int, lrB: int, block_rows: int,
                           block_cols: int, nblocks: int, ncw: int,
                           chunk_w: int) -> torch.Tensor:
    """One stage's int64 ``[2, nblocks, ncw]`` windowed counts (index 0
    padded to ``chunk_w`` lanes, index 1 true) of the tiles ``a`` and
    ``b``."""
    b_valid = b.rows < lrB
    # invalid entries fall in the overflow window ncw
    h = torch.where(b_valid, b.cols // block_cols, ncw).long()
    key = h * (lrB + 1) + torch.clamp(b.rows, max=lrB).long()
    blens2 = _segment_count(key, b_valid, (ncw + 1) * (lrB + 1)).view(ncw + 1, lrB + 1)
    a_valid = a.rows < lrA
    k = torch.clamp(a.cols, max=lrB).long()
    g = torch.where(a_valid, a.rows // block_rows, nblocks).long()
    both = []
    for bl in (-(-blens2 // chunk_w) * chunk_w, blens2):
        per_entry = torch.where(a_valid, bl[:ncw, k], 0)  # [ncw, capacity of a]
        seg = torch.zeros((ncw, nblocks + 1), dtype=torch.int64, device=a.rows.device)
        both.append(seg.index_add_(1, g, per_entry)[:, :nblocks].T)
    return torch.stack(both)


def summa_window_flops_pair(A: SpParMat, B: SpParMat, block_rows: int, block_cols: int,
                            chunk_w: int = 1) -> torch.Tensor:
    """float32 ``[2, nblocks, ncolwin, p, pr, pc]``: per (A row block, B
    column window), stage and output tile, the counts padded to
    ``chunk_w`` (index 0) and true (index 1). Sizes the 2D ``dot``
    backend: per-window output bounds and the 2D skip list. Exact in int64,
    rounded to float32 once."""
    _check_compat(A, B)
    p = A.grid.pr
    lrA, lrB, lcB = A.local_rows, B.local_rows, B.local_cols
    nblocks = -(-lrA // block_rows)
    ncw = -(-lcB // block_cols)
    out = torch.zeros((2, nblocks, ncw, p, p, p), dtype=torch.int64, device=A.grid.device)
    for i in range(p):
        for j in range(p):
            for s in range(p):
                out[..., s, i, j] = _window_stage_symbolic(
                    A.local_tile(i, s), B.local_tile(s, j), lrA, lrB, block_rows,
                    block_cols, nblocks, ncw, chunk_w)
    return out.to(torch.float32)


def summa_window_flops_host(grid, rows_a, cols_a, rows_b, cols_b, nrows_a: int,
                            ncols_a: int, ncols_b: int, block_rows: int, block_cols: int,
                            chunk_w: int = 0) -> np.ndarray:
    """``summa_window_flops_pair`` (one ``chunk_w`` at a time, 0 for the
    true counts) from global host COO arrays: float64 ``[nblocks, ncolwin,
    p, pr, pc]``, summed exactly in int64."""
    count_a, count_b = _host_counts(grid, rows_a, cols_a, rows_b, cols_b, nrows_a, ncols_a,
                                    ncols_b, block_rows, block_cols, chunk_w)
    # flops[g, h, s, i, j] = sum_k countA[i, s, g, k] * countB[s, j, h, k]
    return np.einsum("isgk,sjhk->ghsij", count_a, count_b).astype(np.float64)


def summa_window_bnnz(B: SpParMat, block_cols: int) -> torch.Tensor:
    """int32 ``[pr, pc, ncolwin]``: B's entries per tile and column window,
    whose maximum sizes the 2D ``dot`` backend's panel slices."""
    lrB, lcB = B.local_rows, B.local_cols
    ncw = -(-lcB // block_cols)
    out = torch.zeros((B.grid.pr, B.grid.pc, ncw), dtype=torch.int32, device=B.grid.device)
    for i in range(B.grid.pr):
        for j in range(B.grid.pc):
            t = B.local_tile(i, j)
            valid = t.rows < lrB
            h = torch.where(valid, t.cols // block_cols, ncw)
            out[i, j] = _segment_count(h, valid, ncw).to(torch.int32)
    return out


def summa_window_bnnz_host(grid, rows_b, cols_b, ncols_a: int, ncols_b: int,
                           block_cols: int) -> np.ndarray:
    """``summa_window_bnnz`` from global host COO arrays."""
    lrB, lcB = grid.local_rows(ncols_a), grid.local_cols(ncols_b)
    ncw = -(-lcB // block_cols)
    rows_b, cols_b = np.asarray(rows_b, np.int64), np.asarray(cols_b, np.int64)
    sb, jb = rows_b // lrB, cols_b // lcB
    hb = (cols_b % lcB) // block_cols
    return np.bincount(((sb * grid.pc + jb) * ncw) + hb,
                       minlength=grid.pr * grid.pc * ncw).reshape(grid.pr, grid.pc, ncw)


def windowed_plan_2d(per_window_padded, per_window_true, block_rows: int, block_cols: int,
                     local_rows: int, local_cols_b: int, slack: float = 1.02):
    """The 2D plan: per (row block, column window) ``(flop_caps, out_caps,
    skip)``, each a tuple of per-block tuples. An out cap is the window's
    true multiplies (summed over stages, the largest tile), times
    ``slack``, clamped to the window's cells; a window with none is
    skipped. ``per_window_padded`` None (the ``dot`` backend, which does
    no expansion) gives flop caps of 1."""
    pt = np.asarray(per_window_true, np.float64)
    pb = None if per_window_padded is None else np.asarray(per_window_padded, np.float64)
    nblocks, ncw = pt.shape[0], pt.shape[1]
    flop_caps, out_caps, skip = [], [], []
    for g in range(nblocks):
        rb = min(block_rows, local_rows - g * block_rows)
        fr, orow, sk = [], [], []
        for h in range(ncw):
            cells = rb * min(block_cols, local_cols_b - h * block_cols)
            tot = pt[g, h].sum(axis=0).max()
            sk.append(bool(tot <= 0))
            fr.append(1 if pb is None else max(int(pb[g, h].max() * slack) + 1, 1))
            orow.append(max(min(int(tot * slack) + 1, cells), 1))
        flop_caps.append(tuple(fr))
        out_caps.append(tuple(orow))
        skip.append(tuple(sk))
    return tuple(flop_caps), tuple(out_caps), tuple(skip)


def windowed_plan(per_block_padded, per_block_true, block_rows: int, local_rows: int,
                  local_cols_b: int, slack: float = 1.02):
    """The 1D plan from the two symbolic counts: per row block the
    expansion capacity (the largest padded count over stages and tiles),
    the output capacity (the largest tile's true multiplies clamped to the
    block's cells), each times ``slack``, and the skip list (blocks with no
    multiply)."""
    pb = np.asarray(per_block_padded, np.float64)
    pt = np.asarray(per_block_true, np.float64)
    flop_caps, out_caps, skip = [], [], []
    for g in range(pb.shape[0]):
        cells = min(block_rows, local_rows - g * block_rows) * local_cols_b
        tot = pt[g].sum(axis=0).max()
        skip.append(bool(tot <= 0))
        flop_caps.append(max(int(pb[g].max() * slack) + 1, 1))
        out_caps.append(max(min(int(tot * slack) + 1, cells), 1))
    return tuple(flop_caps), tuple(out_caps), tuple(skip)


def packed_windows(skip) -> tuple[int, ...]:
    """A 1D skip list -> the occupied row blocks in order: the launch list
    the kernels walk."""
    return tuple(g for g, s in enumerate(skip) if not s)


def packed_windows_2d(skip) -> tuple[tuple[int, int], ...]:
    """A 2D skip list -> the occupied (row block, column window) pairs,
    block-major: the order of the output chunks."""
    return tuple((g, h) for g, row in enumerate(skip) for h, s in enumerate(row) if not s)


def _live_windows_by_block(skip) -> tuple:
    """The 2D launch list grouped by row block, ``((g, (h, ...)), ...)``;
    a block with no live window is absent."""
    out = []
    for g, row in enumerate(skip):
        hs = tuple(h for h, s in enumerate(row) if not s)
        if hs:
            out.append((g, hs))
    return tuple(out)


def bucket_plan_caps(flop_caps, out_caps):
    """A plan's capacities (1D tuples or the 2D nested form) rounded up to
    powers of two. The reference does so to share compiled programs; the
    port keeps it because the capacities are part of the output layout.
    Callers clamp the out caps to the blocks' cells again."""
    def walk(t):
        return tuple(walk(x) if isinstance(x, tuple) else 1 << (max(int(x), 1) - 1).bit_length()
                     for x in t)

    return walk(flop_caps), walk(out_caps)


def panel_cap_from_bnnz(bnnz, capacity: int) -> int:
    """The panel slices' capacity: the largest per-(tile, window) B count
    rounded up to a power of two, clamped to the tile capacity."""
    m = int(np.asarray(bnnz).max())
    return max(min(1 << max(m - 1, 1).bit_length(), capacity), 1)


def _oracle_out_caps_2d(sr: Semiring, A: SpParMat, B: SpParMat, block_rows: int,
                        block_cols: int, out_caps: tuple, skip: tuple) -> tuple[tuple, tuple]:
    """Tighten a 2D plan with the support oracle (``spgemm_support_bits``
    -> ``support_window_counts``): each out cap becomes the window's exact
    output count, and a window with none is skipped. One tile, word-aligned
    windows."""
    if A.grid.size != 1 or block_cols % 32:
        raise ValueError("the oracle plan needs a 1x1 grid and block_cols a multiple of 32")
    bits, _ = spgemm_support_bits(A.local_tile(0, 0), B.local_tile(0, 0))
    cnt = host_value(support_window_counts(bits, block_rows, block_cols, A.local_rows,
                                           B.local_cols))
    new_caps, new_skip = [], []
    for g, row in enumerate(out_caps):
        new_caps.append(tuple(max(min(oc, int(cnt[g, h])), 1) for h, oc in enumerate(row)))
        new_skip.append(tuple(bool(skip[g][h] or cnt[g, h] == 0) for h in range(len(row))))
    return tuple(new_caps), tuple(new_skip)


def _extract_window_2d(acc, zero, lo: int, h: int, rb: int, block_cols: int, lrA: int,
                       lcB: int, out_cap: int):
    """One (row block, column window) extraction -> (the chunk in tile
    coordinates, its count minus ``out_cap``)."""
    wc = min(block_cols, lcB - h * block_cols)
    t, total = sparsify_windowed(acc, zero, rb, wc, out_cap)
    vm = t.valid_mask()
    chunk = SpTuples(rows=torch.where(vm, t.rows + lo, lrA),
                     cols=torch.where(vm, t.cols + h * block_cols, lcB),
                     vals=t.vals, nnz=t.nnz, nrows=lrA, ncols=lcB)
    return chunk, total - out_cap


def _extract_block_1d(acc, zero, lo: int, rb: int, lrA: int, lcB: int, out_cap: int):
    """One full-width row-block extraction -> (chunk, count minus
    ``out_cap``)."""
    t, total = sparsify_windowed(acc, zero, rb, lcB, out_cap)
    chunk = SpTuples(rows=torch.where(t.valid_mask(), t.rows + lo, lrA), cols=t.cols,
                     vals=t.vals, nnz=t.nnz, nrows=lrA, ncols=lcB)
    return chunk, total - out_cap


def _shift_rowblock(am: SpTuples, lo: int, arows: int) -> SpTuples:
    """A row-masked tile in block coordinates: valid rows move down by
    ``lo``, the others to the new padding row ``arows``."""
    valid = am.valid_mask()
    return dataclasses.replace(am, rows=torch.where(valid, am.rows - lo, arows), nrows=arows)


def _dense_col_panel(sr: Semiring, bs: SpTuples, starts: torch.Tensor, h: int,
                     block_cols: int, pk: int, pwin: int, panel_cap: int) -> torch.Tensor:
    """Dense ``[pk, pwin]`` panel of B's column window ``h`` from the
    column-sorted tile ``bs``: the window's entries are the slots
    ``[starts[h], starts[h + 1])``, read through a ``panel_cap``-slot slice
    and combined by the semiring's scatter (duplicates fold)."""
    idx = starts[h] + torch.arange(panel_cap, dtype=torch.int32, device=bs.rows.device)
    ii = torch.clamp(idx, max=bs.capacity - 1).long()
    r, c = bs.rows[ii], bs.cols[ii]
    ok = (idx < starts[h + 1]) & (r < bs.nrows)
    window = SpTuples(rows=torch.where(ok, r, pk), cols=torch.where(ok, c - h * block_cols, pwin),
                      vals=bs.vals[ii], nnz=ok.sum(), nrows=pk, ncols=pwin)
    return densify_combine(sr, window, pk, pwin)


def _window_stage_product(sr: Semiring, kind: str, da: torch.Tensor, panel: torch.Tensor,
                          mode: str) -> torch.Tensor:
    """One stage's dense window product: ``_mxu_dot`` for plus_times, the
    semiring GEMM (K1 on the card) for min_plus and max_min."""
    if kind == "plus_times":
        return _mxu_dot(da, panel, mode, da.dtype)
    return semiring_matmul(kind, da, panel)


def _windowed_dims(backend: str, block_cols, lrB: int, lcB: int):
    """The padded dims of the accumulate: ``(two_d, pcols, pk, pwin)``."""
    two_d = backend == "dot" and block_cols is not None
    if backend == "dot":
        return two_d, _pad128(lcB), _pad128(lrB), _pad128(block_cols) if two_d else None
    return two_d, -(-lcB // 128) * 128, None, None


def _colmajor_with_starts(t: SpTuples, block_cols: int):
    """The tile sorted by column, and the first slot of each column window
    (``ncolwin + 1`` int32 starts): the 2D ``dot`` backend's panel
    slicing."""
    ts = t.sort_colmajor()
    ncw = -(-t.ncols // block_cols)
    bounds = torch.clamp(torch.arange(ncw + 1, dtype=torch.int32, device=t.rows.device)
                         * block_cols, max=t.ncols)
    return ts, torch.searchsorted(ts.cols, bounds, side="left", out_int32=True)


def _windowed_stage_b_side(sr: Semiring, b: SpTuples, backend: str, two_d: bool, pk, pcols,
                           block_cols):
    """A stage's B operand: its CSR (scatter), its dense tile (1D dot), or
    (column-sorted tile, window starts) (2D dot)."""
    if backend == "scatter":
        return CSR.from_tuples(b)
    if not two_d:
        return densify_combine(sr, b, pk, pcols)
    return _colmajor_with_starts(b, block_cols)


class _Windows:
    """The static geometry of one windowed product and the per-block steps
    both compute cores share."""

    def __init__(self, sr: Semiring, *, lrA, lrB, lcB, block_rows, flop_caps, out_caps, skip,
                 backend, mode, chunk_w, block_cols, panel_cap, zero, dtype, device):
        self.sr, self.kind = sr, _PALLAS_KINDS.get(sr.name)
        self.lrA, self.lcB, self.block_rows = lrA, lcB, block_rows
        self.flop_caps, self.out_caps = flop_caps, out_caps
        self.backend, self.mode, self.chunk_w = backend, mode, chunk_w
        self.block_cols, self.panel_cap = block_cols, panel_cap
        self.zero, self.dtype, self.device = zero, dtype, device
        self.two_d, self.pcols, self.pk, self.pwin = _windowed_dims(backend, block_cols, lrB,
                                                                    lcB)
        self.live = _live_windows_by_block(skip) if self.two_d else packed_windows(skip)

    def geom(self, g: int):
        lo = g * self.block_rows
        rb = min(self.block_rows, self.lrA - lo)
        return lo, rb, _pad128(rb) if self.backend == "dot" else rb

    def b_side(self, b: SpTuples):
        return _windowed_stage_b_side(self.sr, b, self.backend, self.two_d, self.pk,
                                      self.pcols, self.block_cols)

    def new_acc(self, g: int):
        """Block g's accumulator: a fold buffer (scatter) or a dense block
        per column window (dot)."""
        _, rb, arows = self.geom(g)
        if self.backend == "scatter":
            return new_fold_buffer(self.sr, rb * self.pcols, self.dtype, self.device)
        hs = dict(self.live)[g] if self.two_d else (None,)
        width = self.pwin if self.two_d else self.pcols
        return {h: torch.full((arows, width), self.zero, dtype=self.dtype, device=self.device)
                for h in hs}

    def accumulate(self, g: int, acc, a: SpTuples, b_side) -> None:
        """Fold stage operands ``a`` (the whole tile) and ``b_side`` into
        block g's accumulator. The scatter backend expands at the plan's
        capacity cut to the exact slot count read back (the same valid
        slots in the same order)."""
        lo, rb, arows = self.geom(g)
        am = mask_rows(a, lo, lo + rb)
        if self.backend == "scatter":
            cap = max(self.flop_caps[g], self.chunk_w)
            cap = min(-(-cap // self.chunk_w) * self.chunk_w,
                      int(expansion_slots(am, b_side, self.chunk_w)))
            if cap:
                fold_expansion_(self.sr, acc, am, b_side, row_lo=lo, rb=rb,
                                pad_cols=self.pcols, flop_capacity=cap, chunk_w=self.chunk_w)
            return
        da = densify_combine(self.sr, _shift_rowblock(am, lo, arows), arows, self.pk)
        for h in acc:
            if self.two_d:
                bs, starts = b_side
                panel = _dense_col_panel(self.sr, bs, starts, h, self.block_cols, self.pk,
                                         self.pwin, self.panel_cap)
            else:
                panel = b_side
            prod = _window_stage_product(self.sr, self.kind, da, panel, self.mode)
            acc[h] = self.sr.add(acc[h], prod)

    def extract(self, g: int, acc):
        """Block g's chunks (one, or one a live window) and the largest
        count over its cap."""
        lo, rb, _ = self.geom(g)
        if self.backend == "scatter":
            dense = fold_buffer_values(self.sr, acc, rb * self.pcols, self.dtype)
            return [_extract_block_1d(dense.view(rb, self.pcols), self.zero, lo, rb, self.lrA,
                                      self.lcB, self.out_caps[g])]
        if not self.two_d:
            return [_extract_block_1d(acc[None], self.zero, lo, rb, self.lrA, self.lcB,
                                      self.out_caps[g])]
        return [_extract_window_2d(acc[h], self.zero, lo, h, rb, self.block_cols, self.lrA,
                                   self.lcB, self.out_caps[g][h]) for h in acc]

    def blocks(self):
        return [g for g, _ in self.live] if self.two_d else list(self.live)


def _collect(parts, worst):
    chunks = []
    for chunk, over in parts:
        worst = torch.maximum(worst, over)
        chunks.append(chunk)
    return chunks, worst


def _windowed_gathered_compute(win: _Windows, stages) -> tuple[list, torch.Tensor]:
    """The gathered schedule on one output tile, block-outer: each occupied
    block's accumulator lives through the stages ``stages`` ((A, B) tile
    pairs in stage order), then is extracted. Returns (chunks, worst)."""
    worst = torch.zeros((), dtype=torch.int64, device=win.device)
    b_sides = [win.b_side(b) for _, b in stages]
    chunks = []
    for g in win.blocks():
        acc = win.new_acc(g)
        for (a, _), b_side in zip(stages, b_sides):
            win.accumulate(g, acc, a, b_side)
        more, worst = _collect(win.extract(g, acc), worst)
        chunks += more
    return chunks, worst


def _record_carousel_stages(p: int, pipeline: bool) -> None:
    """One ``spgemm.pipeline.stage`` event per carousel stage, noting whether
    its successor rotation is issued early. The reference records them
    while it traces the windowed carousel (once a trace); the port records
    them once a call of a carousel product."""
    if not obs.ENABLED:
        return
    for s in range(p):
        obs.span_event("spgemm.pipeline.stage", stage=s,
                       overlapped=bool(pipeline and s != p - 1))


def _windowed_carousel_compute(win: _Windows, stages) -> tuple[list, torch.Tensor]:
    """The carousel schedule on one output tile, stage-outer: every
    occupied block's accumulator lives across the stages (the reference's
    two-slot rotation keeps O(2 tiles) of sparse operands a device), then
    all are extracted in the launch list's order. Returns (chunks,
    worst)."""
    accs = {g: win.new_acc(g) for g in win.blocks()}
    for a, b in stages:
        b_side = win.b_side(b)
        for g, acc in accs.items():
            win.accumulate(g, acc, a, b_side)
    worst = torch.zeros((), dtype=torch.int64, device=win.device)
    chunks = []
    for g, acc in accs.items():
        more, worst = _collect(win.extract(g, acc), worst)
        chunks += more
    return chunks, worst


def _check_dot_dtype(sr: Semiring, dtype: torch.dtype) -> None:
    """The ``dot`` backend's tropical stage product is the semiring GEMM,
    which takes float32 only (the reference passes any dtype to Pallas)."""
    if _PALLAS_KINDS.get(sr.name, "plus_times") != "plus_times" and dtype != torch.float32:
        raise TypeError(f"backend='dot' runs {sr.name} through the semiring GEMM kernel, "
                        f"which takes float32 only, not {dtype} (ROADMAP.md §3: the "
                        "kernel's float32-only gap); use backend='scatter'")


def _windows(sr: Semiring, A: SpParMat, B: SpParMat, *, block_rows, flop_caps, out_caps, skip,
             backend, mode, chunk_w, block_cols, panel_cap) -> _Windows:
    """Check a windowed kernel's arguments and build its geometry."""
    _check_compat(A, B)
    lrA, lrB, lcB = A.local_rows, B.local_rows, B.local_cols
    nblocks = -(-lrA // block_rows)
    two_d = backend == "dot" and block_cols is not None
    ncw = -(-lcB // block_cols) if two_d else 1
    if skip is None:
        skip = ((False,) * ncw,) * nblocks if two_d else (False,) * nblocks
    if not len(flop_caps) == len(out_caps) == len(skip) == nblocks:
        raise ValueError(f"the plan has {len(flop_caps)}, {len(out_caps)}, {len(skip)} "
                         f"blocks; the tile has {nblocks}")
    if backend not in ("dot", "scatter"):
        raise ValueError(f"backend must be 'dot' or 'scatter', got {backend!r}")
    if scatter_combine_for(sr) is None:
        raise ValueError(f"semiring {sr.name} has no scatter combiner; use the esc or scan "
                         "tier")
    if backend == "dot":
        if sr.name not in _PALLAS_KINDS:
            raise ValueError(f"backend='dot' supports semirings {sorted(_PALLAS_KINDS)}; "
                             f"got {sr.name}")
        _check_dot_dtype(sr, A.dtype)
        if two_d and (panel_cap is None or panel_cap < 1
                      or any(len(row) != ncw for row in skip)):
            raise TierRefusal(f"the 2D dot backend needs panel_cap >= 1 and {ncw} windows a "
                             "block")
    return _Windows(sr, lrA=lrA, lrB=lrB, lcB=lcB, block_rows=block_rows,
                    flop_caps=flop_caps, out_caps=out_caps, skip=skip, backend=backend,
                    mode=mode, chunk_w=chunk_w, block_cols=block_cols if two_d else None,
                    panel_cap=panel_cap, zero=float(sr.zero_fn(A.dtype)), dtype=A.dtype,
                    device=A.grid.device)


def summa_spgemm_windowed(sr: Semiring, A: SpParMat, B: SpParMat, *, block_rows: int,
                          flop_caps: tuple, out_caps: tuple, skip: tuple | None = None,
                          backend: str = "scatter", mode: str = "f32", chunk_w: int = 8,
                          block_cols: int | None = None, panel_cap: int | None = None,
                          ring: bool = False,
                          pipeline: bool = True) -> tuple[SpParMat, torch.Tensor]:
    """Sort-free SUMMA over dense row-block accumulators, the fused form of
    the windowed tier. Per output tile and occupied row block (the skip
    list drops blocks with no multiply):

      * ``backend="scatter"``: each stage's chunked expansion folded into a
        dense ``[rb, pad128(lcB)]`` block by the semiring's scatter
        (``accumulate_block_scatter``);
      * ``backend="dot"``: densified stage operands (``densify_combine``:
        duplicates fold) multiplied by ``_mxu_dot`` (plus_times) or the
        semiring GEMM (K1 on the card; min_plus, max_min), folded by
        ``sr.add``; with ``block_cols`` the output is cut into (row block ×
        column window) windows and each stage densifies only B's column
        panel (``_dense_col_panel``), without it B's whole tile;

    then extracted once (``sparsify_windowed``) at the plan's out cap. In
    2D form ``flop_caps`` / ``out_caps`` / ``skip`` are per-block tuples of
    ``windowed_plan_2d`` and ``panel_cap`` bounds a window's B entries.

    Returns ``(C, overflow)``: the largest count over its cap (0-dim; 0
    with the symbolic caps). A tile's valid slots are a compacted prefix
    per block (and per window within a block), block-major: not globally
    row-sorted. ``ring=False`` walks the stages in gathered order, block by
    block; ``ring=True`` in the carousel's order, stage by stage with every
    block's accumulator live. ``pipeline`` changes no output: eager torch
    has no rotation to overlap."""
    p = A.grid.pr
    if obs.ENABLED and ring and pipeline and p > 1:
        obs.count("spgemm.pipeline.stages_overlapped", p - 1)
    if ring:
        _record_carousel_stages(p, pipeline)
    win = _windows(sr, A, B, block_rows=block_rows, flop_caps=flop_caps, out_caps=out_caps,
                   skip=skip, backend=backend, mode=mode, chunk_w=chunk_w,
                   block_cols=block_cols, panel_cap=panel_cap)
    compute = _windowed_carousel_compute if ring else _windowed_gathered_compute
    worst = [torch.zeros((), dtype=torch.int64, device=A.grid.device)]

    def tile(i, j):
        chunks, over = compute(win, _stage_operands(A, B, i, j, ring))
        worst[0] = torch.maximum(worst[0], over)
        if not chunks:  # every block skipped
            return SpTuples.empty(win.lrA, win.lcB, 1, A.dtype, device=A.grid.device)
        return SpTuples.concat(chunks)

    C = SpParMat.assemble(A.grid, A.nrows, B.ncols, tile)
    return C, worst[0]


def local_spgemm_windowed(sr: Semiring, A: SpParMat, B: SpParMat, *, block_rows: int,
                          flop_caps: tuple, out_caps: tuple, skip: tuple, chunk_w: int = 8,
                          backend: str = "scatter", block_cols: int | None = None,
                          panel_cap: int | None = None,
                          mode: str = "f32") -> tuple[SpParMat, torch.Tensor]:
    """The windowed tier on a 1x1 grid: same plan, caps and return as
    ``summa_spgemm_windowed``. The reference dispatches a small program a
    row block here; in eager torch that is the fused form's gathered
    schedule on the one tile (one stage: occupied blocks in order, each
    block's live windows in order). ``backend="dot"`` takes the 2D plan,
    ``block_cols`` and ``panel_cap``."""
    if A.grid.size != 1 or B.grid.size != 1:
        raise ValueError("local_spgemm_windowed runs on a 1x1 grid")
    if backend == "dot" and (block_cols is None or panel_cap is None):
        raise ValueError("backend='dot' needs block_cols and panel_cap")
    return summa_spgemm_windowed(sr, A, B, block_rows=block_rows, flop_caps=flop_caps,
                                 out_caps=out_caps, skip=skip, backend=backend, mode=mode,
                                 chunk_w=chunk_w, block_cols=block_cols, panel_cap=panel_cap)


def _windowed_block_dist(win: _Windows, A: SpParMat, B: SpParMat, g: int, out: list,
                         off: int) -> torch.Tensor:
    """Row block g of the blocked form on every tile (scatter backend,
    stages in gathered order), each tile's chunk written into the slots
    ``[off, off + cap)`` of the output arrays ``out`` (rows, cols, vals,
    nnz). Returns the largest count over the cap."""
    cap = win.out_caps[g]
    worst = torch.zeros((), dtype=torch.int64, device=win.device)
    for i in range(A.grid.pr):
        for j in range(A.grid.pc):
            acc = win.new_acc(g)
            for a, b in _stage_operands(A, B, i, j, False):
                win.accumulate(g, acc, a, win.b_side(b))
            [(chunk, over)] = win.extract(g, acc)
            for dst, x in zip(out, (chunk.rows, chunk.cols, chunk.vals)):
                dst[i, j, off:off + cap] = x
            out[3][i, j] += chunk.nnz
            worst = torch.maximum(worst, over)
    return worst


def summa_spgemm_windowed_blocked(sr: Semiring, A: SpParMat, B: SpParMat, *, block_rows: int,
                                  flop_caps: tuple, out_caps: tuple, skip: tuple,
                                  chunk_w: int = 8) -> tuple[SpParMat, torch.Tensor]:
    """The blocked form of the windowed tier (scatter backend): one
    occupied row block at a time over every tile (the reference launches
    a small program a block, so that one dense block a device is live),
    each block's chunk written after the last into every tile. Same plan
    and output layout as the fused form; with no occupied block, an empty
    matrix of capacity 1, as the reference's."""
    win = _windows(sr, A, B, block_rows=block_rows, flop_caps=flop_caps, out_caps=out_caps,
                   skip=skip, backend="scatter", mode="f32", chunk_w=chunk_w, block_cols=None,
                   panel_cap=None)
    grid, dev = A.grid, A.grid.device
    live = packed_windows(skip)
    shape = (grid.pr, grid.pc, max(sum(out_caps[g] for g in live), 1))
    out = [torch.full(shape, win.lrA, dtype=torch.int32, device=dev),
           torch.full(shape, win.lcB, dtype=torch.int32, device=dev),
           torch.zeros(shape, dtype=A.dtype, device=dev),
           torch.zeros(shape[:2], dtype=torch.int32, device=dev)]
    worst = torch.zeros((), dtype=torch.int64, device=dev)
    off = 0
    for g in live:
        worst = torch.maximum(worst, _windowed_block_dist(win, A, B, g, out, off))
        off += out_caps[g]
    C = SpParMat(rows=out[0], cols=out[1], vals=out[2], nnz=out[3], nrows=A.nrows,
                 ncols=B.ncols, grid=grid)
    return C, worst


class CapacityOverflowError(RuntimeError):
    """A product's output outgrew the capacity its symbolic pass sized
    (the windowed tier's symbolic upper bound). Its own type, so the
    tuner's probe can skip such a rung without also skipping a failed
    kernel build (a plain ``RuntimeError``)."""


class TierRefusal(ValueError):
    """A tier refusing operands it cannot size or tile: capacities that
    the retries did not cover, a window geometry the tier cannot run. Its
    own type, so the tuner's probe can skip such a rung without also
    skipping a ``ValueError`` raised on a bad call (a kernel wrapper's
    precondition)."""


def _clamp_out_caps_2d(out_caps, block_rows: int, block_cols: int, lrA: int, lcB: int):
    return tuple(tuple(min(oc, max(min(block_rows, lrA - g * block_rows), 1)
                           * max(min(block_cols, lcB - h * block_cols), 1))
                       for h, oc in enumerate(row)) for g, row in enumerate(out_caps))


def spgemm_windowed(sr: Semiring, A: SpParMat, B: SpParMat, *, block_rows: int | None = None,
                    block_cols: int | None = None, backend: str | None = None,
                    mode: str = "f32", slack: float = 1.02, oracle: bool = False,
                    ring: bool = False, pipeline: bool = True, dispatch: str | None = None,
                    bucket: bool | None = None) -> SpParMat:
    """The windowed tier's entry: the symbolic pass (one readback), the
    plan (``windowed_plan`` for the scatter backend, ``windowed_plan_2d``
    for dot), then the kernel.

    ``backend``: ``resolve_spgemm_backend`` (default ``"scatter"``).
    ``block_rows`` / ``block_cols``: ``default_block_rows`` /
    ``default_block_cols``. ``bucket``: the capacities rounded up to
    powers of two and clamped to the blocks' cells again; ``None`` reads
    ``COMBBLAS_SPGEMM_BUCKET_CAPS`` (on unless ``"0"``, the reference's
    default). ``oracle`` (dot, 1x1, tiles within ``MXU_MAX_TILE_DIM``,
    ``block_cols`` a multiple of 32): the out caps become the support
    oracle's exact window counts, and empty windows are skipped; elsewhere
    it is ignored, as in the reference. ``dispatch`` (``"auto"``,
    ``"fused"``, ``"blocked"``; argument > ``COMBBLAS_SPGEMM_DISPATCH`` >
    ``"auto"``): on a grid of more than
    one tile the scatter backend runs the blocked form when more than one
    block is occupied (``"auto"``) or when asked, unless ``ring`` (a
    carousel is fused only); one tile runs ``local_spgemm_windowed``; dot
    runs fused. ``ring``: the carousel's stage order. ``pipeline``:
    accepted, no effect (eager torch has no rotation to overlap).
    ``spgemm_windowed.last_plan`` records the last call's plan."""
    backend = resolve_spgemm_backend(backend)
    dispatch = tuner_config.resolve_dispatch(dispatch)
    if bucket is None:
        bucket = tuner_config.bucket_caps_enabled()
    if backend == "dot":
        _check_dot_dtype(sr, A.dtype)
    lrA, lcB = A.local_rows, B.local_cols
    if block_rows is None:
        block_rows = default_block_rows(lrA, lcB)
    chunk_w = WINDOWED_CHUNK_W
    plan = {"backend": backend, "block_rows": block_rows}
    if backend == "dot":
        if block_cols is None:
            block_cols = default_block_cols(B.local_rows, lcB)
        pt = host_value(summa_window_flops_pair(A, B, block_rows, block_cols, chunk_w=1))[1]
        flop_caps, out_caps, skip = windowed_plan_2d(None, pt, block_rows, block_cols, lrA, lcB,
                                                     slack=slack)
        plan["packed_before_oracle"] = len(packed_windows_2d(skip))
        plan["oracle"] = bool(oracle and A.grid.size == 1 and block_cols % 32 == 0
                              and max(lrA, B.local_rows, lcB) <= MXU_MAX_TILE_DIM)
        if plan["oracle"]:
            out_caps, skip = _oracle_out_caps_2d(sr, A, B, block_rows, block_cols, out_caps,
                                                 skip)
        elif oracle and obs.ENABLED:
            # requested but inapplicable: the clamped-flops caps, observably
            obs.count("spgemm.windowed.oracle_skipped")
        if bucket:
            flop_caps, out_caps = bucket_plan_caps(flop_caps, out_caps)
            out_caps = _clamp_out_caps_2d(out_caps, block_rows, block_cols, lrA, lcB)
        panel_cap = panel_cap_from_bnnz(host_value(summa_window_bnnz(B, block_cols)),
                                        B.capacity)
        form = "local" if A.grid.size == 1 else "fused"
        if obs.ENABLED:
            _record_windowed_2d_metrics(A, B, form, skip, pt, block_rows, block_cols)
        plan.update(block_cols=block_cols, panel_cap=panel_cap, windows=len(skip[0]))
        kw = dict(block_rows=block_rows, flop_caps=flop_caps, out_caps=out_caps, skip=skip,
                  backend="dot", block_cols=block_cols, panel_cap=panel_cap, mode=mode)
        if form == "local":
            C, overflow = local_spgemm_windowed(sr, A, B, **kw)
        else:
            C, overflow = summa_spgemm_windowed(sr, A, B, chunk_w=chunk_w, ring=ring,
                                                pipeline=pipeline, **kw)
        packed = len(packed_windows_2d(skip))
    else:
        pair = host_value(summa_rowblock_flops_pair(A, B, block_rows, chunk_w=chunk_w))
        flop_caps, out_caps, skip = windowed_plan(pair[0], pair[1], block_rows, lrA, lcB,
                                                  slack=slack)
        if bucket:
            flop_caps, out_caps = bucket_plan_caps(flop_caps, out_caps)
            out_caps = tuple(min(oc, max(min(block_rows, lrA - g * block_rows), 1) * lcB)
                             for g, oc in enumerate(out_caps))
        if ring and dispatch == "blocked":
            # a carousel is fused only (the conflict is counted)
            if obs.ENABLED:
                obs.count("spgemm.windowed.dispatch_conflict")
            dispatch = "fused"
        packed = len(packed_windows(skip))
        kw = dict(block_rows=block_rows, flop_caps=flop_caps, out_caps=out_caps, skip=skip,
                  chunk_w=chunk_w)
        if A.grid.size == 1:
            form = "local"
        elif dispatch == "blocked" or (dispatch == "auto" and not ring and packed > 1):
            form = "blocked"
        else:
            form = "fused"
        if obs.ENABLED:
            obs.count("spgemm.windowed.dispatch", mode=form)
            obs.count("spgemm.windowed.windows_skipped", sum(skip))
            obs.count("spgemm.windowed.windows_packed", packed)
            obs.gauge("spgemm.windowed.pack_ratio", packed / len(skip) if skip else 0.0)
            obs.gauge("spgemm.windowed.blocks", len(skip))
            obs.gauge("spgemm.auto.mask_density",
                      float(np.asarray(pair[1]).sum(axis=1).max(axis=(-1, -2)).sum())
                      / max(lrA * lcB, 1))
        if form == "local":
            C, overflow = local_spgemm_windowed(sr, A, B, **kw)
        elif form == "blocked":
            C, overflow = summa_spgemm_windowed_blocked(sr, A, B, **kw)
        else:
            C, overflow = summa_spgemm_windowed(sr, A, B, backend="scatter", mode=mode,
                                                ring=ring, pipeline=pipeline, **kw)
    plan.update(form=form, blocks=len(skip), packed=packed, flop_caps=flop_caps,
                out_caps=out_caps, skip=skip)
    spgemm_windowed.last_plan = plan
    over = int(overflow)
    if over > 0:  # the caps are symbolic upper bounds: an overflow is a fault
        raise CapacityOverflowError(f"windowed tier overflowed its symbolic bound by {over}")
    _record_realized_nnz(C)
    return C


spgemm_windowed.last_plan = None


def _record_windowed_2d_metrics(A: SpParMat, B: SpParMat, form: str, skip, pt,
                                block_rows: int, block_cols: int) -> None:
    """The dot backend's plan series: dispatch form, skipped and packed
    (row block, column window) pairs, windows a block, the stage panel's
    cells, and the symbolic output bound over the cells of the live
    windows (``window_density``) and of the whole tile
    (``spgemm.auto.mask_density``)."""
    obs.count("spgemm.windowed.dispatch", mode=form)
    obs.count("spgemm.windowed.col_windows_skipped", sum(sum(row) for row in skip))
    npk = len(packed_windows_2d(skip))
    ntot = sum(len(row) for row in skip)
    obs.count("spgemm.windowed.windows_packed", npk)
    obs.gauge("spgemm.windowed.pack_ratio", npk / ntot if ntot else 0.0)
    obs.gauge("spgemm.windowed.col_windows", len(skip[0]) if skip else 0)
    obs.gauge("spgemm.windowed.panel_cells", _pad128(B.local_rows) * _pad128(block_cols))
    obs.gauge("spgemm.windowed.blocks", len(skip))
    live_cells = live_bound = 0.0
    per_tile = np.asarray(pt).sum(axis=2).max(axis=(-1, -2))
    for g in range(len(skip)):
        rb = min(block_rows, A.local_rows - g * block_rows)
        for h in range(len(skip[g])):
            if skip[g][h]:
                continue
            wc = min(block_cols, B.local_cols - h * block_cols)
            live_cells += rb * wc
            live_bound += min(float(per_tile[g, h]), rb * wc)
    obs.gauge("spgemm.windowed.window_density", live_bound / live_cells if live_cells else 0.0)
    obs.gauge("spgemm.auto.mask_density", live_bound / max(A.local_rows * B.local_cols, 1))


# --- the router --------------------------------------------------------------------


def resolve_spgemm_backend(backend: str | None = None) -> str:
    """The windowed tier's accumulate backend: the explicit argument >
    ``COMBBLAS_SPGEMM_BACKEND`` > ``"scatter"`` (the reference's default on
    every platform but the TPU, which has no scatter unit)."""
    if backend is None:
        backend = tuner_config.env_backend()
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
                       assume_unique: bool = False, grid3=None) -> str:
    """The tier the reference's ``spgemm_auto`` picks:

      ``"mxu"``       tiles within ``MXU_MAX_TILE_DIM``, a semiring with a
                      dense kernel, and tiles of unique entries (checked
                      with ``coo_has_duplicates`` unless ``assume_unique``);
      ``"windowed"``  the add monoid has a scatter combiner, the tile's
                      dense cells are bounded and the output dense enough
                      (the symbolic pass counts the multiplies);
      ``"scan"``      everything else.

    Given a layered grid (``grid3`` with more than one layer) whose layout
    fits the product (``mesh3d.summa3d_compatible``), ``windowed`` becomes
    ``"windowed3d"``; the other tiers stay 2D."""
    tier = _choose_spgemm_tier_2d(sr, A, B, backend=backend, assume_unique=assume_unique)
    if grid3 is not None and tier == "windowed":
        from .mesh3d import summa3d_compatible

        if grid3.layers > 1 and summa3d_compatible(grid3, A.nrows, A.ncols, B.ncols):
            return "windowed3d"
    return tier


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
        if obs.ENABLED:
            obs.count("spgemm.auto.dedup_fallback", sr=sr.name)
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
                tier: str | None = None, block_rows: int | None = None,
                block_cols: int | None = None, backend: str | None = None,
                oracle: bool = False, assume_unique: bool = False, ring: bool | None = None,
                pipeline: bool | None = None, dispatch: str | None = None,
                merge: str | None = None, grid3=None) -> SpParMat:
    """Sparse-output SpGEMM ``C = A ⊗ B`` through the tier that the routing
    below resolves:

      ``"esc"``       ``spgemm`` (``merge``: sort or runs);
      ``"scan"``      ``spgemm_scan`` (``out_capacity``, ``slack``,
                      ``max_retries``);
      ``"windowed"``  ``spgemm_windowed`` (``block_rows``, ``block_cols``,
                      ``backend``, ``mode``, ``slack``, ``oracle``,
                      ``ring``, ``pipeline``, ``dispatch``; ``ring`` None
                      means False, ``pipeline`` None True);
      ``"mxu"``       the dense tier: output capacity the next power of two
                      of ``out_capacity`` (default ``max(A.capacity,
                      B.capacity, 64)``), rerun on overflow with the power
                      of two above ``out_capacity + overflow``, at most
                      ``max_retries`` times; ``mode`` sets the plus_times
                      precision. It needs tiles of unique entries, which
                      the router checks unless ``assume_unique``.

      ``"windowed3d"`` the layered route (needs ``grid3``): A col-split and B
                      row-split onto ``grid3`` (``SpParMat3D.from_spmat``),
                      ``spgemm3d_windowed`` (``block_rows``, ``block_cols``,
                      ``backend``, ``mode``, ``slack``, ``merge``, ``ring``,
                      ``pipeline``), the result back on A's grid.

    Routing (the precedence documented in ``tuner/config.py``): the
    explicit ``tier`` > the **plan store** (a measured plan remembered for
    this (shape bucket, density band, semiring, backend, grid, grid3,
    platform) key, ``tuner.store``; vetted: a tier the router does not
    serve, ``windowed3d`` without ``grid3``, and ``mxu`` on operands with
    duplicate entries unless ``assume_unique`` are discarded) >
    ``COMBBLAS_SPGEMM_TIER`` > the **probe** (``COMBBLAS_TUNER_PROBE=1``,
    2D only: ``tuner.probe.probe_spgemm`` measures the admissible rungs on
    a bounded proxy and persists the winner) > ``choose_spgemm_tier``. The
    store is asked only when it holds entries or probing is on (the key
    costs one host nnz readback per operand). A record replays its
    ``block_rows`` / ``block_cols``, ``dispatch``, ``ring``, ``pipeline``
    and ``merge``, each only where the argument is ``None``; the
    environment's block geometry (``COMBBLAS_SPGEMM_BLOCK_ROWS`` /
    ``_BLOCK_COLS``) fills in after the record. The call that probes does
    not apply the probe's geometry; the next call, from the store, does.
    ``spgemm_auto.last_run`` records ``tier``, ``plan_source`` (``arg``,
    ``store``, ``env``, ``probe`` or ``heuristic``) and ``merge_source``."""
    plan_source = "arg" if tier is not None else None
    merge_source = "arg" if merge is not None else None
    store = key = rec = None
    if tier is None:
        store = tuner_store.get_store()
        if store is not None and (store.entries() > 0 or tuner_config.probe_enabled()):
            key = tuner_store.spgemm_plan_key(sr, A, B, resolve_spgemm_backend(backend),
                                              grid3=grid3)
            rec = store.lookup(key)
        # vet the remembered plan before trusting it; a rejected record
        # degrades down the chain
        # degrades down the chain, made visible as tuner.store.rejected
        if rec is not None and rec.tier not in TIERS:
            # e.g. a serve-lane record under a mangled key
            if obs.ENABLED:
                obs.count("tuner.store.rejected", reason="tier")
            rec = None
        if rec is not None and rec.tier == "windowed3d" and grid3 is None:
            # a 3D plan is unusable without a layered grid
            if obs.ENABLED:
                obs.count("tuner.store.rejected", reason="no_grid3")
            rec = None
        if (rec is not None and rec.tier == "mxu" and not assume_unique
                and (coo_has_duplicates(A) or (B is not A and coo_has_duplicates(B)))):
            # the record was measured on SOME input of this bucket, not
            # necessarily a duplicate-free one
            if obs.ENABLED:
                obs.count("spgemm.auto.dedup_fallback", sr=sr.name)
                obs.count("tuner.store.rejected", reason="dup")
            rec = None
        if rec is not None:
            tier, plan_source = rec.tier, "store"
            block_rows = rec.block_rows if block_rows is None else block_rows
            block_cols = rec.block_cols if block_cols is None else block_cols
            dispatch = rec.dispatch if dispatch is None else dispatch
            ring = rec.ring if ring is None else ring
            pipeline = rec.pipeline if pipeline is None else pipeline
            if merge is None and rec.merge is not None:
                merge, merge_source = rec.merge, "store"
    # the environment's geometry fills in AFTER the record
    if block_rows is None:
        block_rows = tuner_config.env_block_rows()
    if block_cols is None:
        block_cols = tuner_config.env_block_cols()
    if tier is None:
        tier = tuner_config.env_tier()
        if tier is not None:
            plan_source = "env"
    if tier is None and store is not None and grid3 is None and tuner_config.probe_enabled():
        from ..tuner.probe import probe_spgemm

        prec = probe_spgemm(sr, A, B, backend=resolve_spgemm_backend(backend), store=store,
                            key=key)
        if prec is not None:
            tier, plan_source = prec.tier, "probe"
    if tier is None:
        tier = choose_spgemm_tier(sr, A, B, backend=backend, assume_unique=assume_unique,
                                  grid3=grid3)
        plan_source = "heuristic"
    spgemm_auto.last_run = {"tier": tier, "plan_source": plan_source,
                            "merge_source": merge_source}
    ring = False if ring is None else bool(ring)
    pipeline = True if pipeline is None else bool(pipeline)
    if tier not in TIERS:
        raise ValueError(f"unknown spgemm tier {tier!r}; expected one of {TIERS}")
    if obs.ENABLED:
        obs.count("spgemm.auto.tier", tier=tier, sr=sr.name)
        obs.count("spgemm.auto.plan_source", source=plan_source, tier=tier, op="spgemm")
    with obs.span("spgemm.auto", sr=sr.name, tier=tier):
        if tier == "windowed3d":
            if grid3 is None:
                raise ValueError("tier='windowed3d' needs a grid3 (the layered mesh)")
            from .mesh3d import SpParMat3D, spgemm3d_windowed

            A3 = SpParMat3D.from_spmat(A, grid3, split="col")
            B3 = SpParMat3D.from_spmat(B, grid3, split="row")
            C3 = spgemm3d_windowed(sr, A3, B3, block_rows=block_rows, block_cols=block_cols,
                                   backend=backend, mode=mode, slack=slack, merge=merge,
                                   ring=ring, pipeline=pipeline, merge_source=merge_source)
            return C3.to_spmat(A.grid)
        if tier == "esc":
            return spgemm(sr, A, B, slack, merge=merge, merge_source=merge_source)
        if tier == "scan":
            return spgemm_scan(sr, A, B, out_capacity=out_capacity, slack=slack,
                               max_retries=max_retries)
        if tier == "windowed":
            return spgemm_windowed(sr, A, B, block_rows=block_rows, block_cols=block_cols,
                                   backend=backend, mode=mode, slack=slack, oracle=oracle,
                                   ring=ring, pipeline=pipeline, dispatch=dispatch)
        if out_capacity is None:
            out_capacity = max(A.capacity, B.capacity, 64)
        out_capacity = 1 << (int(out_capacity) - 1).bit_length()
        over = 0
        for attempt in range(max_retries + 1):
            C, overflow = summa_spgemm_mxu(sr, A, B, out_capacity=out_capacity, mode=mode)
            over = int(overflow)
            if over <= 0:
                if obs.ENABLED:
                    obs.count("spgemm.mxu.overflow_retries", attempt)
                    _record_realized_nnz(C)
                return C
            out_capacity = 1 << (out_capacity + over - 1).bit_length()
        raise ValueError(
            f"spgemm_auto still overflowing by {over} after {max_retries} "
            "retries; pass an explicit out_capacity"
        )


spgemm_auto.last_run = None
