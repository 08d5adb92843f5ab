"""Parity of the port's SpMM lane and k-hop feature propagation with
``combblas_tpu`` on the CPU.

Exact (bit for bit): ``pad_feature_width`` / ``pad_features``, the backend
helpers, ``dist_spmm_ell`` for min_plus and max_min (scatter, with NaN,
±0.0 and ±inf in the features) and plus_times on integer-valued float32
(both backends; every sum below 2**24) on 1x1, 2x2 and 2x4 grids with a
duplicated-entry COO, ``summa_spmm`` on 1x1 and 2x2 in both stage orders
(plus_times by both backends, min_plus and max_min by scatter with the
specials), ``spmm_khop`` unnormalised, and the pad lanes of
``_propagate_batch_impl``, which are exactly zero.

Within a stated tolerance (a float32 sum folds in another order):
plus_times on random float32 features (rtol 1e-5, atol 1e-6 of the
largest magnitude), ``spmm_khop(normalize=True)``, ``propagate_features``
and ``_propagate_batch_impl`` (rtol 1e-5, atol 1e-6), and the batch's
lanes against the rows of the whole-graph propagation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.models import propagate as jprop
from combblas_tpu.parallel import spmm as jspmm
from combblas_tpu.parallel.dense import DenseParMat as JaxDense
from combblas_tpu.parallel.ellmat import EllParMat as JaxEll
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistMultiVec as JaxDMV
from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PAD_ROOT,
    PLUS_TIMES,
    DenseParMat,
    DistMultiVec,
    EllParMat,
    Grid,
    SpParMat,
)
from combblas_tpu_torch.models import propagate as tprop
from combblas_tpu_torch.parallel import spmm as tspmm

SRS = {"plus_times": (PLUS_TIMES, jsr.PLUS_TIMES), "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
       "max_min": (MAX_MIN, jsr.MAX_MIN)}
GRIDS = [(1, 1), (2, 2), (2, 4)]
SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3], np.float32)


def ids(shapes):
    return [f"{a}x{b}" for a, b in shapes]


def same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32), want[keep].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


def close(got, want, rtol=1e-5):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * max(np.abs(want).max(), 1.0))


def coo(seed, n, m, dup=30):
    """A random COO with ``dup`` repeated entries, integer values 1..4."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    r, c = np.concatenate([r, r[:dup]]), np.concatenate([c, c[:dup]])
    return r, c, rng.integers(1, 5, len(r)).astype(np.float32)


def sym(seed, n, m):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = r != c
    r, c = np.concatenate([r[keep], c[keep]]), np.concatenate([c[keep], r[keep]])
    key = np.unique(r * n + c)
    return key // n, key % n, np.ones(len(key), np.float32)


def features(kind, n, F, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 4, (n, F)).astype(np.float32)
    if kind == "special":
        return rng.choice(SPECIALS, size=(n, F)).astype(np.float32)
    return rng.standard_normal((n, F)).astype(np.float32)


def ells(shape, r, c, v, n):
    return (JaxEll.from_host_coo(JaxGrid.make(*shape), r, c, v, n, n),
            EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, v, n, n))


def dmvs(shape, X, align="col"):
    return (JaxDMV.from_global(JaxGrid.make(*shape), X, align=align),
            DistMultiVec.from_global(Grid.make(*shape, device="cpu"), X, align=align))


# --- helpers ----------------------------------------------------------------------


def test_padding_and_backend_helpers_match_reference():
    for f in (1, 2, 3, 5, 8, 9, 64, 100):
        assert tspmm.pad_feature_width(f) == jspmm.pad_feature_width(f)
    X = features("float", 7, 5)
    same(tspmm.pad_features(X), jspmm.pad_features(X))
    same(tspmm.pad_features(X, width=16), jspmm.pad_features(X, width=16))
    for bad in (dict(x=X, width=4), dict(x=X[0])):
        with pytest.raises(ValueError):
            tspmm.pad_features(**bad)
    assert tspmm.SPMM_BACKENDS == jspmm.SPMM_BACKENDS
    for name, (tsr, jsr_) in SRS.items():
        assert tspmm.spmm_backend_heuristic(tsr) == jspmm.spmm_backend_heuristic(jsr_)
        assert tspmm.admissible_spmm_backends(tsr) == jspmm.admissible_spmm_backends(jsr_)
        for b in tspmm.admissible_spmm_backends(tsr):
            assert tspmm.resolve_spmm_backend(tsr, None, 8, backend=b) == b
        assert tspmm.resolve_spmm_backend(tsr, None, 8) == jspmm.spmm_backend_heuristic(jsr_)
    with pytest.raises(ValueError, match="not exact"):
        tspmm.resolve_spmm_backend(MIN_PLUS, None, 8, backend="mxu_gather")


# --- dist_spmm_ell ----------------------------------------------------------------


@pytest.mark.parametrize("shape", GRIDS, ids=ids(GRIDS))
@pytest.mark.parametrize("sr_name,kind", [("plus_times", "int"), ("min_plus", "special"),
                                          ("max_min", "special"), ("min_plus", "int")])
def test_dist_spmm_ell_matches_reference(shape, sr_name, kind):
    n, F = 72, 8
    r, c, v = coo(1, n, 420)
    X = features(kind, n, F)
    JE, TE = ells(shape, r, c, v, n)
    JX, TX = dmvs(shape, X)
    tsr, jsr_ = SRS[sr_name]
    for backend in tspmm.admissible_spmm_backends(tsr):
        got = tspmm.dist_spmm_ell(tsr, TE, TX, backend=backend)
        want = jspmm.dist_spmm_ell(jsr_, JE, JX, backend=backend)
        assert (got.length, got.align) == (want.length, want.align)
        same(got.blocks, want.blocks)
    same(tspmm.dist_spmm(tsr, TE, TX).blocks, jspmm.dist_spmm_ell(
        jsr_, JE, JX, backend=jspmm.spmm_backend_heuristic(jsr_)).blocks)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=ids([(1, 1), (2, 2)]))
def test_plus_times_float_within_rounding(shape):
    n, F = 80, 16
    r, c, _ = coo(2, n, 500)
    v = np.random.default_rng(3).random(len(r)).astype(np.float32)
    X = features("float", n, F)
    JE, TE = ells(shape, r, c, v, n)
    JX, TX = dmvs(shape, X, align="row")
    for backend in ("mxu_gather", "scatter"):
        close(tspmm.dist_spmm_ell(PLUS_TIMES, TE, TX, backend=backend).blocks,
              jspmm.dist_spmm_ell(jsr.PLUS_TIMES, JE, JX, backend=backend).blocks)


# --- k hops and propagation ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=ids([(1, 1), (2, 2)]))
def test_spmm_khop_and_propagate_match_reference(shape):
    n, F, k = 60, 6, 3
    r, c, v = coo(4, n, 300, dup=0)
    X = features("int", n, F)
    JE, TE = ells(shape, r, c, v, n)
    same(tspmm.spmm_khop(PLUS_TIMES, TE, X, k).blocks,
         jspmm.spmm_khop(jsr.PLUS_TIMES, JE, X, k).blocks)
    same(tspmm.spmm_khop(MIN_PLUS, TE, X, 2, backend="scatter").blocks,
         jspmm.spmm_khop(jsr.MIN_PLUS, JE, X, 2, backend="scatter").blocks)
    close(tspmm.spmm_khop(PLUS_TIMES, TE, X, k, normalize=True).blocks,
          jspmm.spmm_khop(jsr.PLUS_TIMES, JE, X, k, normalize=True).blocks)
    close(tspmm.row_invdeg(TE).blocks, jspmm.row_invdeg(JE).blocks, rtol=0)
    got = tprop.propagate_features(TE, X, 2, normalize=True)
    want = jprop.propagate_features(JE, X, 2, normalize=True)
    assert got.shape == (n, F)
    close(got, want)
    with pytest.raises(ValueError, match="plus_times"):
        tspmm.spmm_khop(MIN_PLUS, TE, X, 2, normalize=True)
    with pytest.raises(ValueError, match="backend"):
        tspmm.dist_spmm_ell(PLUS_TIMES, TE, DistMultiVec.from_global(TE.grid, X), backend="x")


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=ids([(1, 1), (2, 2)]))
@pytest.mark.parametrize("normalize", [False, True])
def test_propagate_batch_matches_reference(shape, normalize):
    """W = 16 roots, four of them PAD_ROOT: the lanes within tolerance of
    the reference and of the whole-graph propagation's rows, the pad lanes
    exactly zero."""
    n, F, hops = 96, 10, 2
    r, c, v = sym(6, n, 380)
    X = features("int", n, F)
    Xp = tspmm.pad_features(X)
    JE, TE = ells(shape, r, c, v, n)
    JX, TX = dmvs(shape, Xp, align="row")
    roots = np.random.default_rng(7).integers(0, n, 16).astype(np.int32)
    roots[[2, 5, 11, 15]] = PAD_ROOT
    jinv = jspmm.row_invdeg(JE).realign("col") if normalize else None
    tinv = tspmm.row_invdeg(TE).realign("col") if normalize else None
    kw = dict(hops=hops, normalize=normalize, backend="mxu_gather")
    want = np.asarray(jprop._propagate_batch_impl(JE, JX, jinv, jnp.asarray(roots), **kw))
    got = tprop._propagate_batch_impl(TE, TX, tinv, torch.from_numpy(roots), **kw)
    close(got, want)
    pads = roots == PAD_ROOT
    assert (got[:, torch.from_numpy(pads)] == 0).all()
    same(got[:, torch.from_numpy(pads)], want[:, pads])
    whole = tprop.propagate_features(TE, X, hops, normalize=normalize)
    close(got[:F, torch.from_numpy(~pads)].T, whole[roots[~pads]])


# --- summa_spmm ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=ids([(1, 1), (2, 2)]))
@pytest.mark.parametrize("ring", [False, True])
def test_summa_spmm_matches_reference(shape, ring):
    n, F = 64, 8
    r, c, v = coo(8, n, 380)
    JA = JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, n, n)
    TA = SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, n, n)
    cases = [("plus_times", "mxu_gather", "int"), ("plus_times", "scatter", "int"),
             ("min_plus", "scatter", "special"), ("max_min", "scatter", "special")]
    for sr_name, backend, kind in cases:
        X = features(kind, n, F, seed=9)
        JX = JaxDense.from_global(JaxGrid.make(*shape), X)
        TX = DenseParMat.from_global(Grid.make(*shape, device="cpu"), X)
        tsr, jsr_ = SRS[sr_name]
        got = tspmm.summa_spmm(tsr, TA, TX, backend=backend, ring=ring)
        want = jspmm.summa_spmm(jsr_, JA, JX, backend=backend, ring=ring)
        assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
        same(got.blocks, want.blocks)
        same(tspmm.summa_spmm(tsr, TA, TX, backend=backend, ring=ring, pipeline=False).blocks,
             want.blocks)
    with pytest.raises(ValueError, match="plus_times"):
        tspmm.summa_spmm(MIN_PLUS, TA, TX, backend="mxu_gather")


def test_summa_spmm_plus_times_float_and_rectangular_grid():
    n, F = 64, 8
    r, c, _ = coo(10, n, 380)
    v = np.random.default_rng(10).random(len(r)).astype(np.float32)
    X = features("float", n, F)
    JA = JaxSpParMat.from_global_coo(JaxGrid.make(2, 2), r, c, v, n, n)
    TA = SpParMat.from_global_coo(Grid.make(2, 2, device="cpu"), r, c, v, n, n)
    for backend in ("mxu_gather", "scatter"):
        close(tspmm.summa_spmm(PLUS_TIMES, TA, DenseParMat.from_global(TA.grid, X),
                               backend=backend).blocks,
              jspmm.summa_spmm(jsr.PLUS_TIMES, JA, JaxDense.from_global(JA.grid, X),
                               backend=backend).blocks)
    rect = Grid.make(2, 4, device="cpu")
    with pytest.raises(ValueError, match="square"):
        tspmm.summa_spmm(PLUS_TIMES, SpParMat.from_global_coo(rect, r, c, v, n, n),
                         DenseParMat.from_global(rect, X))
