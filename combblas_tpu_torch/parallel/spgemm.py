"""Distributed SpGEMM, dense (mxu) tier — counterpart of the parts of
``combblas_tpu/parallel/spgemm.py`` on the path
``spgemm_auto`` -> ``summa_spgemm_mxu`` -> the semiring GEMM kernel.

SUMMA over the grid's tiles: ``C_ij = ⊕_s A_is ⊗ B_sj``. Each stage
densifies its two tiles, multiplies them (``torch.matmul`` for
``plus_times``, the hand-written semiring kernel for ``min_plus`` and
``max_min``), folds the product into a dense accumulator, and one
extraction per output tile returns to sparse. The tiles of a grid live on
one device and are walked in a loop, as the reference's all-gather walks
its stages.

Only the mxu tier is ported. A call that the reference would route to
another tier (esc, scan, windowed, windowed3d) raises
``NotImplementedError``; it is never rerouted.
"""

from __future__ import annotations

import torch

from ..ops.semiring_matmul import semiring_matmul
from ..ops.spgemm import coo_sort_dedup, densify, sparsify_windowed
from ..semiring import Semiring
from .spmat import SpParMat

#: Above this local tile dimension the reference leaves the dense tier.
MXU_MAX_TILE_DIM = 8192

#: Semirings with a dense stage-product kernel, by semiring name.
_PALLAS_KINDS = {
    "plus_times": "plus_times",
    "min_plus": "min_plus",
    "max_min": "max_min",
}

_UNPORTED_TIERS = ("esc", "scan", "windowed", "windowed3d")
_UNPORTED_NOTE = "not ported yet (ROADMAP.md, queue 1: the SpGEMM tiers)"


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
    worst = torch.zeros((), dtype=torch.long, device=A.grid.device)
    tiles = []
    for i in range(p):
        row = []
        for j in range(p):
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
            worst = torch.maximum(worst, total - out_capacity)
            row.append(out)
        tiles.append(row)
    C = SpParMat.from_tiles(tiles, A.nrows, B.ncols, A.grid)
    return C, worst


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


def choose_spgemm_tier(
    sr: Semiring, A: SpParMat, B: SpParMat, *, assume_unique: bool = False
) -> str:
    """The mxu rung of the reference's router: ``"mxu"`` when every local
    tile dimension is at most ``MXU_MAX_TILE_DIM``, the semiring has a
    dense kernel and the tiles hold unique entries (checked unless
    ``assume_unique``). Where the reference would pick another tier this
    raises ``NotImplementedError``."""
    max_dim = max(A.local_rows, A.local_cols, B.local_cols)
    if max_dim > MXU_MAX_TILE_DIM:
        reason = f"local tile dim {max_dim} > MXU_MAX_TILE_DIM={MXU_MAX_TILE_DIM}"
    elif sr.name not in _PALLAS_KINDS:
        reason = f"semiring {sr.name} has no dense kernel"
    elif not assume_unique and (
        coo_has_duplicates(A) or (B is not A and coo_has_duplicates(B))
    ):
        reason = "input tiles hold duplicate entries"
    else:
        return "mxu"
    raise NotImplementedError(
        f"{reason}: the reference routes this product to windowed or scan, "
        f"which are {_UNPORTED_NOTE}"
    )


def spgemm_auto(
    sr: Semiring,
    A: SpParMat,
    B: SpParMat,
    *,
    out_capacity: int | None = None,
    max_retries: int = 3,
    mode: str = "f32",
    tier: str | None = None,
    assume_unique: bool = False,
) -> SpParMat:
    """Auto-tiered sparse-output SpGEMM ``C = A ⊗ B`` (mxu tier only).

    ``tier`` forces a tier; anything but ``"mxu"`` raises
    ``NotImplementedError`` until its port lands. Output capacity: the
    next power of two of ``out_capacity`` (default ``max(A.capacity,
    B.capacity, 64)``); on overflow the product reruns with the next
    power of two above ``out_capacity + overflow``, at most
    ``max_retries`` times. The mxu tier needs tiles of unique entries —
    the router checks unless ``assume_unique``.
    """
    if tier is None:
        tier = choose_spgemm_tier(sr, A, B, assume_unique=assume_unique)
    if tier in _UNPORTED_TIERS:
        raise NotImplementedError(f"spgemm tier {tier!r} is {_UNPORTED_NOTE}")
    if tier != "mxu":
        raise ValueError(f"unknown spgemm tier {tier!r}")
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
