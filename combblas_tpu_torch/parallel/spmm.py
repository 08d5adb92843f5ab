"""SpMM — a sparse matrix times a dense feature block, counterpart of
``combblas_tpu/parallel/spmm.py``: the graph-ML lane (k-hop feature
propagation, embedding smoothing).

  * ``dist_spmm_ell``: over the ``EllParMat`` schedule, each tile's
    gather-contract kernel (``ellmat._ell_local_spmm``) over its column
    block of the features, the tiles of a grid row combined in column
    order. Backend ``"mxu_gather"`` (plus_times only) contracts each
    bucket with a batched product, ``"scatter"`` folds with the semiring
    and combines by row id (every semiring).
  * ``summa_spmm``: SUMMA over ``SpParMat`` tiles and a ``DenseParMat``
    panel, stages in the gathered order or the carousel's (``ring``).
    ``mxu_gather`` densifies each stage tile with a combining add (so
    duplicates sum) and multiplies it by the panel (``_mxu_dot``);
    ``scatter`` gathers a panel row a slot and folds it into the
    accumulator with the semiring's scatter (sum, min or max).
  * ``spmm_khop``: k chained hops, optionally row-normalised.

The tiles of a grid live on one device and are walked in loops.
``dist_spmm`` and ``spmm_khop`` resolve the backend through the tuner's
chain (``resolve_spmm_backend``: argument, plan store, environment,
probe on the real operands, heuristic). ``pipeline`` is accepted and changes nothing: there is no
rotation to overlap on one device, and ``ring`` keeps the carousel's
stage order (it decides a float sum's order). Integer-valued and min/max
results equal the reference's bit for bit; a float plus_times sum may
differ in its last bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.segment import DROP_SPREAD, spread_drops
from ..ops.spgemm import _keyed, fold_buffer_values, fold_into_, fold_keys, new_fold_buffer
from ..semiring import PLUS_TIMES, Semiring
from .dense import DenseParMat
from .ellmat import EllParMat, _ell_local_spmm, _tile_fold
from .grid import fold_grid
from .spgemm import _carousel_stages, _mxu_dot
from .spmat import SpParMat
from .vec import DistMultiVec, DistVec

#: The SpMM backends (the reference's tuner tier names for op="spmm").
SPMM_BACKENDS = ("mxu_gather", "scatter")


def pad_feature_width(f: int) -> int:
    """The power-of-two feature width that ``pad_features`` pads to."""
    return 1 << max(int(f) - 1, 0).bit_length()


def pad_features(x, width: int | None = None) -> np.ndarray:
    """Host ``[n, F]`` → ``[n, pad_feature_width(F)]`` float32 with zero pad
    lanes. Lanes never mix, so pads cannot touch the real F lanes; the
    pads stay zero only under plus_times (under min_plus or max_min they
    carry the fold of an all-zero column), so callers slice back to F."""
    x = np.asarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"features must be [n, F], got shape {x.shape}")
    fp = pad_feature_width(x.shape[1]) if width is None else int(width)
    if fp < x.shape[1]:
        raise ValueError(f"pad width {fp} < feature dim {x.shape[1]}")
    out = np.zeros((x.shape[0], fp), np.float32)
    out[:, : x.shape[1]] = x
    return out


def spmm_backend_heuristic(sr: Semiring) -> str:
    """plus_times contracts by products (``mxu_gather``), every other
    semiring folds (``scatter``)."""
    return "mxu_gather" if sr.name == "plus_times" else "scatter"


def admissible_spmm_backends(sr: Semiring) -> tuple[str, ...]:
    """The backends exact for ``sr``."""
    if sr.name == "plus_times":
        return ("mxu_gather", "scatter")
    return ("scatter",)


# --- the distributed ELL entry ------------------------------------------------


def dist_spmm_ell(sr: Semiring, E: EllParMat, X: DistMultiVec,
                  backend: str = "scatter") -> DistMultiVec:
    """Y = E ⊗ X for a dense feature block X (an ``[n, F]`` DistMultiVec,
    either alignment); Y comes back row-aligned."""
    if backend not in SPMM_BACKENDS:
        raise ValueError(f"unknown SpMM backend {backend!r}; expected one of {SPMM_BACKENDS}")
    if X.length != E.ncols:
        raise ValueError(f"features of {X.length} rows for a matrix of {E.ncols} columns")
    lr, lc = E.local_rows, E.local_cols
    blocks = fold_grid(sr, E.grid, _tile_fold(
        E, lambda b, xb: _ell_local_spmm(sr, b, xb, lr, lc, backend), X.realign("col").blocks))
    return DistMultiVec(blocks=blocks, length=E.nrows, align="row", grid=E.grid)


def dist_spmm(sr: Semiring, E: EllParMat, X: DistMultiVec,
              backend: str | None = None) -> DistMultiVec:
    """The routed entry: ``resolve_spmm_backend``, then ``dist_spmm_ell``."""
    backend = resolve_spmm_backend(sr, E, X.width, backend=backend, X=X)
    return dist_spmm_ell(sr, E, X, backend=backend)


# --- fused k-hop propagation ----------------------------------------------------


def row_invdeg(E: EllParMat) -> DistVec:
    """Row-aligned float32 1/max(deg, 1), deg the structural row degree:
    the per-hop normalisation of ``spmm_khop(..., normalize=True)``."""
    deg = E.reduce(PLUS_TIMES, "cols",
                   map_fn=lambda v: torch.ones(v.shape, dtype=torch.float32, device=v.device))
    return dataclasses.replace(deg, blocks=1.0 / torch.clamp(deg.blocks.to(torch.float32),
                                                             min=1.0))


def _spmm_khop_impl(sr: Semiring, E: EllParMat, X: DistMultiVec, invdeg, k: int,
                    backend: str, normalize: bool) -> DistMultiVec:
    """k chained hops on the device, no host round trip between them."""
    Y = X
    for _ in range(max(int(k), 0)):
        Y = dist_spmm_ell(sr, E, Y, backend=backend)
        if normalize:
            # Y and invdeg are row-aligned: Y ← D⁻¹(E·Y)
            inv = invdeg.realign("row")
            Y = dataclasses.replace(Y, blocks=Y.blocks * inv.blocks[..., None])
    return Y


def spmm_khop(sr: Semiring, E: EllParMat, X, k: int, normalize: bool = False,
              backend: str | None = None) -> DistMultiVec:
    """k-hop feature propagation ``(D⁻¹)ᵏAᵏ·X`` (``normalize=True``,
    plus_times only) or ``Aᵏ·X`` over ``sr``. ``X``: a DistMultiVec, or a
    host ``[n, F]`` array (padded by ``pad_features`` and uploaded
    col-aligned). The backend resolves once."""
    if normalize and sr.name != "plus_times":
        raise ValueError(f"normalize=True needs plus_times, got {sr.name}")
    if not isinstance(X, DistMultiVec):
        X = DistMultiVec.from_global(E.grid, pad_features(X), align="col")
    backend = resolve_spmm_backend(sr, E, X.width, backend=backend, X=X)
    invdeg = row_invdeg(E) if normalize else None
    return _spmm_khop_impl(sr, E, X, invdeg, int(k), backend, bool(normalize))


# --- SUMMA SpMM over the 2D grid -----------------------------------------------


def _check_spmm_compat(A: SpParMat, X: DenseParMat) -> None:
    if A.grid != X.grid:
        raise ValueError("A and X must share a grid")
    if not A.grid.is_square:
        raise ValueError("SUMMA SpMM requires a square grid")
    if A.ncols != X.nrows:
        raise ValueError(f"dim mismatch {A.ncols} != {X.nrows}")
    if A.grid.local_cols(A.ncols) != A.grid.local_rows(X.nrows):
        raise ValueError("A col-blocking must equal X row-blocking")


def _stage_contract(sr: Semiring, t, xcur: torch.Tensor, acc: torch.Tensor, backend: str,
                    mode: str, lr: int, lk: int) -> torch.Tensor:
    """acc ⊕= A_stage ⊗ X_stage for one stage: the new accumulator.

    ``mxu_gather``: the stage tile densified by a combining add (repeated
    entries sum; padding slots fold into sink cells past the tile, where
    the reference clamps them onto a real cell with value 0) and one
    ``[lr, lk] × [lk, F]`` product. ``scatter``: a gathered panel row a
    slot, ``sr.mul``, and the semiring's scatter into the accumulator
    (``ops.spgemm.fold_into_``: a float min or max folds on order keys,
    as the reference's scatter does)."""
    valid = t.valid_mask()
    if backend == "mxu_gather":
        cells = lr * lk
        flat = spread_drops(t.rows.long() * lk + t.cols.long(), valid, cells)
        da = torch.zeros(cells + DROP_SPREAD, dtype=acc.dtype, device=acc.device)
        da.index_add_(0, flat, torch.where(valid, t.vals, 0).to(acc.dtype))
        da = da[:cells].view(lr, lk)
        return acc + _mxu_dot(da, xcur.to(acc.dtype), mode, acc.dtype)
    F = xcur.shape[1]
    zero = sr.zero(acc.dtype)
    xpad = torch.cat([xcur, xcur.new_full((1, F), sr.zero(xcur.dtype))])
    px = xpad.index_select(0, torch.clamp(t.cols, max=lk).long())  # [cap, F]
    prods = sr.mul(t.vals[:, None].to(acc.dtype), px.to(acc.dtype))
    prods = torch.where(valid[:, None], prods, zero)
    if sr.add_kind not in ("sum", "min", "max"):
        raise NotImplementedError(
            f"summa_spmm scatter backend needs a native add_kind, got {sr.add_kind!r} "
            f"({sr.name})")
    cells = lr * F
    lanes = torch.arange(F, device=acc.device)
    flat = (t.rows.long()[:, None] * F + lanes).reshape(-1)
    keep = valid[:, None].expand(-1, F).reshape(-1)
    buf = new_fold_buffer(sr, cells, acc.dtype, acc.device)
    init = acc.reshape(-1)
    buf[:cells] = fold_keys(init, sr.add_kind) if _keyed(sr, acc.dtype) else init.to(buf.dtype)
    fold_into_(sr, buf, spread_drops(flat, keep, cells), prods.reshape(-1))
    return fold_buffer_values(sr, buf, cells, acc.dtype).view(lr, F)


def summa_spmm(sr: Semiring, A: SpParMat, X: DenseParMat, *, backend: str = "mxu_gather",
               mode: str = "f32", ring: bool = False, pipeline: bool = True) -> DenseParMat:
    """C = A ⊗ X over the grid, X tiled like SpGEMM's B (rows over grid
    rows, the features over grid columns): stage s contracts
    ``A_{i,k(s)}`` with ``X_{k(s),j}``, k(s) = s, or with ``ring`` the
    carousel's (i + j + s) mod p. ``pipeline`` changes nothing here."""
    _check_spmm_compat(A, X)
    if backend not in SPMM_BACKENDS:
        raise ValueError(f"unknown SpMM backend {backend!r}; expected one of {SPMM_BACKENDS}")
    if backend == "mxu_gather" and sr.name != "plus_times":
        raise ValueError(f"mxu_gather is the plus_times contraction; {sr.name} needs "
                         "backend='scatter'")
    grid = A.grid
    p = grid.pr
    lr = grid.local_rows(A.nrows)
    lk = grid.local_rows(X.nrows)
    out_dtype = torch.promote_types(A.vals.dtype, X.dtype)
    if ring:
        stage_k = {(i, j): [a[i * p + j][1] for _, a, _ in _carousel_stages(p)]
                   for i in range(p) for j in range(p)}
    else:
        stage_k = {(i, j): list(range(p)) for i in range(p) for j in range(p)}
    rows = []
    for i in range(p):
        row = []
        for j in range(grid.pc):
            fc = X.blocks.shape[3]
            acc = torch.full((lr, fc), sr.zero(out_dtype), dtype=out_dtype, device=grid.device)
            for k in stage_k[i, j]:
                acc = _stage_contract(sr, A.local_tile(i, k), X.blocks[k, j], acc, backend,
                                      mode, lr, lk)
            row.append(acc)
        rows.append(torch.stack(row))
    return DenseParMat(blocks=torch.stack(rows), nrows=A.nrows, ncols=X.ncols, grid=grid)


# --- backend routing --------------------------------------------------------------


def resolve_spmm_backend(sr: Semiring, E, feat_width: int, backend: str | None = None,
                         X: DistMultiVec | None = None) -> str:
    """The SpMM backend through the tuner's chain: an explicit ``backend``
    (checked exact for ``sr``) > the plan store (``op="spmm"``, the
    feature-width bucket in the key's third shape slot) >
    ``COMBBLAS_SPMM_BACKEND`` > the probe (``COMBBLAS_TUNER_PROBE=1`` and
    ``X`` given: both admissible backends measured on the real operands,
    ``tuner.probe.probe_spmm``) > the heuristic (plus_times →
    ``mxu_gather``, else ``scatter``). A semiring with one exact backend
    short-circuits. A backend from the environment that is not admissible
    raises ``ValueError`` naming the knob."""
    from ..tuner import config as tuner_config
    from ..tuner import store as tuner_store
    from ..tuner.resolve import resolve_tier

    allowed = admissible_spmm_backends(sr)
    if backend is not None:
        if backend not in allowed:
            raise ValueError(f"backend {backend!r} is not exact for {sr.name} "
                             f"(admissible: {allowed})")
        return backend
    if len(allowed) == 1:
        return allowed[0]
    store = tuner_store.get_store()
    key = None
    if store is not None and (store.entries() > 0 or tuner_config.probe_enabled()):
        key = tuner_store.spmm_plan_key(sr, E, feat_width)
    probe = None
    if X is not None:
        def probe():
            from ..tuner.probe import probe_spmm

            return probe_spmm(sr, E, X, store=store, key=key)

    tier, source, _ = resolve_tier(key, allowed=allowed,
                                   heuristic=lambda: spmm_backend_heuristic(sr), op="spmm",
                                   store=store, probe=probe)
    if tier not in allowed:
        raise ValueError(
            f"resolved SpMM backend {tier!r} (source: {source}) is "
            f"not admissible for {sr.name} — COMBBLAS_SPMM_BACKEND "
            f"takes one of {allowed}"
        )
    return tier
