"""Sub-matrix extraction and assignment (≈ SpRef / SpAsgn) — counterpart
of ``combblas_tpu/parallel/indexing.py``.

``B = A(ri, ci)`` is two SUMMA products with selection matrices, ``P · A ·
Q``: P (len(ri) × m) holds one 1 a row at column ri[k], Q (n × len(ci)) one
1 a column at row ci[l]. Each output entry then gets exactly one
contribution, so ``plus_times`` (``or_and`` for bool) is exact. Assignment
``A(ri, ci) = B`` clears the block with a two-sided masked prune
(``SpParMat.prune_rowcol``) and adds ``Pᵀ · B · Qᵀ``. Index vectors are host
arrays; both products run the ESC ``spgemm``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..semiring import OR_AND, PLUS_TIMES, Semiring
from .grid import Grid, require_local
from .spgemm import spgemm
from .spmat import SpParMat
from .vec import DistVec


def _select_sr(mat: SpParMat) -> Semiring:
    return OR_AND if mat.dtype == torch.bool else PLUS_TIMES


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _ids(x, bound: int, what: str) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    if x.ndim != 1 or len(x) == 0:
        raise ValueError(f"{what} indices must be a non-empty 1-D array")
    if (x < 0).any() or (x >= bound).any():
        raise ValueError(f"{what} indices out of range")
    return x


def row_selector(grid: Grid, ri, ncols: int, dtype) -> SpParMat:
    """P: ``len(ri) × ncols`` with ``P[k, ri[k]] = 1``; ``P · A`` picks rows
    ri."""
    ri = _ids(ri, ncols, "row")
    return SpParMat.from_global_coo(grid, np.arange(len(ri)), ri,
                                    np.ones(len(ri), dtype=_np_dtype(dtype)), len(ri), ncols)


def col_selector(grid: Grid, ci, nrows: int, dtype) -> SpParMat:
    """Q: ``nrows × len(ci)`` with ``Q[ci[l], l] = 1``; ``A · Q`` picks
    columns ci."""
    ci = _ids(ci, nrows, "col")
    return SpParMat.from_global_coo(grid, ci, np.arange(len(ci)),
                                    np.ones(len(ci), dtype=_np_dtype(dtype)), nrows, len(ci))


def subsref(A: SpParMat, ri, ci) -> SpParMat:
    """``B = A(ri, ci)``: ``B[k, l] = A[ri[k], ci[l]]``, repeated indices
    allowed, by ``P · A`` then ``· Q``. Reference: ``SpParMat::SubsRef_SR``."""
    require_local(A.grid, "subsref", 4)
    sr = _select_sr(A)
    P = row_selector(A.grid, ri, A.nrows, A.dtype)
    Q = col_selector(A.grid, ci, A.ncols, A.dtype)
    return spgemm(sr, spgemm(sr, P, A), Q)


def spasgn(A: SpParMat, ri, ci, B: SpParMat) -> SpParMat:
    """``A(ri, ci) = B``: the (ri × ci) block of A cleared, then B added
    there (``Pᵀ · B · Qᵀ``). ri and ci must be free of repeats. Returns a new
    matrix. Reference: ``SpParMat::SpAsgn``."""
    require_local(A.grid, "spasgn", 4)
    ri = _ids(ri, A.nrows, "row")
    ci = _ids(ci, A.ncols, "col")
    if len(np.unique(ri)) != len(ri):
        raise ValueError("SpAsgn requires distinct row ids")
    if len(np.unique(ci)) != len(ci):
        raise ValueError("SpAsgn requires distinct col ids")
    if (B.nrows, B.ncols) != (len(ri), len(ci)):
        raise ValueError("B shape mismatch")
    sr = _select_sr(A)
    ones = np.dtype(_np_dtype(A.dtype))
    mrow = np.zeros(A.nrows, dtype=bool)
    mrow[ri] = True
    mcol = np.zeros(A.ncols, dtype=bool)
    mcol[ci] = True
    rvec = DistVec.from_global(A.grid, mrow, align="row", fill=False)
    cvec = DistVec.from_global(A.grid, mcol, align="col", fill=False)
    cleared = A.prune_rowcol(rvec, cvec, _keep_outside_block)
    Pt = SpParMat.from_global_coo(A.grid, ri, np.arange(len(ri)), np.ones(len(ri), ones),
                                  A.nrows, len(ri))
    Qt = SpParMat.from_global_coo(A.grid, np.arange(len(ci)), ci, np.ones(len(ci), ones),
                                  len(ci), A.ncols)
    return cleared.ewise_add(spgemm(sr, spgemm(sr, Pt, B), Qt), sr)


def _keep_outside_block(v, inrow, incol):
    return ~(inrow & incol)
