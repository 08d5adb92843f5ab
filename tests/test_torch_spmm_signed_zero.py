"""Signed zeros of plus_times sums against ``combblas_tpu``, bit for bit.

A plus_times cell whose products are all zeros is +0.0 or -0.0 depending on
which terms the fold adds. The reference's ELL kernel (``_ell_local_spmm``)
keeps the lone product of a first bucket that holds one row of one slot
(XLA folds its ``+ 0.0`` start and its one-row scatter away), so such a row
can be -0.0; every other row sums onto +0.0. The matrix values and the
features are both drawn from NaN, ±0.0, ±inf and small integers, so that
zero products of either sign occur. Seeds 2, 7 and 11 of ``draw`` have such
a first bucket, with -0.0 products in it.
"""

import numpy as np
import pytest

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import spmm as jspmm
from combblas_tpu.parallel import spmv as jspmv
from combblas_tpu.parallel.dense import DenseParMat as JaxDense
from combblas_tpu.parallel.ellmat import EllParMat as JaxEll
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistMultiVec as JaxDMV
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    PLUS_TIMES,
    DenseParMat,
    DistMultiVec,
    DistVec,
    EllParMat,
    Grid,
    SpParMat,
)
from combblas_tpu_torch.parallel import spmm as tspmm
from combblas_tpu_torch.parallel import spmv as tspmv

SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3], np.float32)
GRIDS = [(1, 1), (2, 2), (2, 4)]
SEEDS = [0, 1, 2, 7, 11]


def same(got, want):
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.int32), want[keep].view(np.int32))


def draw(seed, n=19, m=60, F=8, dup=30):
    """The pattern of ``test_torch_spmm.coo(seed, n, m)``; values, then
    features, from ``SPECIALS``."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    r, c = np.concatenate([r, r[:dup]]), np.concatenate([c, c[:dup]])
    rng = np.random.default_rng(seed)
    v = rng.choice(SPECIALS, size=len(r)).astype(np.float32)
    X = rng.choice(SPECIALS, size=(n, F)).astype(np.float32)
    return r, c, v, X


@pytest.mark.parametrize("shape", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
@pytest.mark.parametrize("seed", SEEDS)
def test_dist_spmm_ell_plus_times_signed_zeros(shape, seed):
    n = 19
    r, c, v, X = draw(seed, n)
    JE = JaxEll.from_host_coo(JaxGrid.make(*shape), r, c, v, n, n)
    TE = EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, v, n, n)
    JX = JaxDMV.from_global(JaxGrid.make(*shape), X, align="col")
    TX = DistMultiVec.from_global(Grid.make(*shape, device="cpu"), X, align="col")
    for backend in ("mxu_gather", "scatter"):
        same(tspmm.dist_spmm_ell(PLUS_TIMES, TE, TX, backend=backend).blocks,
             jspmm.dist_spmm_ell(jsr.PLUS_TIMES, JE, JX, backend=backend).blocks)
    # the ELL SpMV shares the local kernel: one feature lane at a time
    for lane in (0, 3):
        jx = JaxDistVec.from_global(JaxGrid.make(*shape), X[:, lane], align="col")
        tx = DistVec.from_global(Grid.make(*shape, device="cpu"), X[:, lane], align="col")
        same(tspmv.dist_spmv(PLUS_TIMES, TE, tx).blocks,
             jspmv.dist_spmv(jsr.PLUS_TIMES, JE, jx).blocks)


def test_first_bucket_of_one_slot_keeps_its_negative_zero():
    """Seed 2, row 0: its one product, 0 × -3, is -0.0 in both packages."""
    n = 19
    r, c, v, X = draw(2, n)
    TE = EllParMat.from_host_coo(Grid.make(1, 1, device="cpu"), r, c, v, n, n)
    assert tuple(TE.buckets[0][0].shape[2:]) == (1, 1)
    TX = DistMultiVec.from_global(Grid.make(1, 1, device="cpu"), X, align="col")
    JE = JaxEll.from_host_coo(JaxGrid.make(1, 1), r, c, v, n, n)
    JX = JaxDMV.from_global(JaxGrid.make(1, 1), X, align="col")
    want = np.asarray(jspmm.dist_spmm_ell(jsr.PLUS_TIMES, JE, JX).blocks).reshape(-1, 8)
    assert np.signbit(want[0, 3]) and want[0, 3] == 0
    for backend in ("mxu_gather", "scatter"):
        got = tspmm.dist_spmm_ell(PLUS_TIMES, TE, TX, backend=backend).blocks.reshape(-1, 8)
        same(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("seed", [2, 7])
def test_summa_spmm_and_dist_spmv_plus_times_signed_zeros(shape, seed):
    n = 20
    r, c, v, X = draw(seed, n)
    JA = JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, n, n)
    TA = SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, n, n)
    JX = JaxDense.from_global(JaxGrid.make(*shape), X)
    TX = DenseParMat.from_global(Grid.make(*shape, device="cpu"), X)
    for backend in ("mxu_gather", "scatter"):
        for ring in (False, True):
            same(tspmm.summa_spmm(PLUS_TIMES, TA, TX, backend=backend, ring=ring).blocks,
                 jspmm.summa_spmm(jsr.PLUS_TIMES, JA, JX, backend=backend, ring=ring).blocks)
    for lane in (0, 5):
        jx = JaxDistVec.from_global(JaxGrid.make(*shape), X[:, lane], align="col")
        tx = DistVec.from_global(Grid.make(*shape, device="cpu"), X[:, lane], align="col")
        same(tspmv.dist_spmv(PLUS_TIMES, TA, tx).blocks,
             jspmv.dist_spmv(jsr.PLUS_TIMES, JA, jx).blocks)
