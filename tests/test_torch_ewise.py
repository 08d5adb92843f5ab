"""Parity of the port's sparse elementwise layer with ``combblas_tpu`` on
the CPU: ``ops/ewise.py`` (``intersect_lookup``, ``ewise_apply``,
``ewise_mult``) and the elementwise, select and split family of
``SpParMat`` (``ewise_mult``, ``ewise_apply``, ``ewise_add``,
``add_loops``, ``nnz_per_column``, ``kselect``, ``kselect2``,
``prune_column``, ``prune_rowcol``, ``with_capacity``, ``shrink_to_fit``,
``col_split``, ``row_split``, ``block_split``, ``col_concatenate``) on 1x1,
2x2 and 2x4 grids.

Every comparison is exact, array by array (padding slots included; floats
by their bits, NaN cells by position): these ops select, move and combine
single values, and ``ewise_add``'s sums are of integer-valued float32.
``kselect`` runs on the reference's key order: -0.0 below +0.0, NaN above
+inf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.ops import ewise as jew
from combblas_tpu.ops.tuples import SpTuples as JaxSpTuples
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    MIN_PLUS,
    PLUS_TIMES,
    DistVec,
    Grid,
    SpParMat,
    SpTuples,
)
from combblas_tpu_torch.ops import ewise as tew
from combblas_tpu_torch.parallel.spmat import key_u32_to_val, monotone_key_u32

M, N = 24, 16  # divisible by every grid below: the splits need even blocking
GRIDS = [(1, 1), (2, 2), (2, 4)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]
SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3, 2.5], np.float32)


# module-level callbacks: the reference compiles one program per callback
def f_sub(a, b):
    return a - b


def f_add2(a, b):
    return a + 2 * b


def keep_ge(v, t):
    return v >= t


def keep_row_col(v, r, c):
    return (v > r) | (c > 3)


def assert_same(got, want):
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


def assert_same_mat(got, want):
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "vals", "nnz"):
        assert_same(getattr(got, f), getattr(want, f))


def pattern(seed, m=M, n=N, density=0.3):
    rng = np.random.default_rng(seed)
    d = rng.random((m, n)) < density
    d[2] = False  # an empty row
    d[:, 5] = True  # a full column
    return np.nonzero(d)


def values(seed, nnz, case="ints"):
    rng = np.random.default_rng(seed + 50)
    if case == "specials":
        return rng.choice(SPECIALS, nnz)
    if case == "int32":
        return rng.integers(-2**31, 2**31, nnz, dtype=np.int64).astype(np.int32)
    return rng.integers(-9, 10, nnz).astype(np.float32)


def build(shape, seed, case="ints", m=M, n=N, capacity=None):
    r, c = pattern(seed, m, n)
    v = values(seed, len(r), case)
    return (JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, m, n, capacity=capacity),
            SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, m, n,
                                     capacity=capacity))


# --- ops/ewise.py ------------------------------------------------------------------


def _tile_pair(seed=0):
    ra, ca = pattern(seed)
    rb, cb = pattern(seed + 1)
    perm = np.random.default_rng(seed).permutation(len(ra))  # a unsorted
    ra, ca = ra[perm], ca[perm]
    va, vb = values(seed, len(ra)), values(seed + 1, len(rb))
    ja = JaxSpTuples.from_coo(ra, ca, va, M, N, len(ra) + 7)
    jb = JaxSpTuples.from_coo(rb, cb, vb, M, N, len(rb) + 3)
    ta = SpTuples.from_coo(ra, ca, va, M, N, len(ra) + 7, device="cpu")
    tb = SpTuples.from_coo(rb, cb, vb, M, N, len(rb) + 3, device="cpu")
    return ja, jb, ta, tb


def test_intersect_lookup_matches_reference():
    """Hits and b's values on every valid slot of a (padding slots mean
    nothing and are masked), b-zero -5 on misses."""
    ja, jb, ta, tb = _tile_pair()
    jh, jv = jew.intersect_lookup(ja, jb, b_zero=jnp.float32(-5))
    th, tv = tew.intersect_lookup(ta, tb, b_zero=-5.0)
    valid = ta.valid_mask().numpy()
    assert_same(th[valid], np.asarray(jh)[valid])
    assert_same(tv[valid], np.asarray(jv)[valid])
    assert 0 < int(th[valid].sum()) < int(valid.sum())


@pytest.mark.parametrize("a_nulls,b_nulls", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_ewise_apply_tiles_match_reference(a_nulls, b_nulls):
    ja, jb, ta, tb = _tile_pair(2)
    got = tew.ewise_apply(ta, tb, f_sub, allow_a_nulls=a_nulls, allow_b_nulls=b_nulls,
                          a_null=100.0, b_null=-7.0)
    want = jew.ewise_apply(ja, jb, f_sub, allow_a_nulls=a_nulls, allow_b_nulls=b_nulls,
                           a_null=100.0, b_null=-7.0)
    assert_same_mat(got, want)


@pytest.mark.parametrize("negate,combine", [(False, None), (True, None), (False, f_sub),
                                            (True, f_sub)])
def test_ewise_mult_tiles_match_reference(negate, combine):
    ja, jb, ta, tb = _tile_pair(4)
    assert_same_mat(tew.ewise_mult(ta, tb, negate, combine),
                    jew.ewise_mult(ja, jb, negate, combine))


# --- SpParMat: elementwise -----------------------------------------------------------


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_spparmat_ewise_family(shape):
    """``ewise_mult`` (plain, negated, combined), ``ewise_apply`` with both
    nulls, ``ewise_add`` with min_plus and plus_times, ``add_loops``."""
    jA, tA = build(shape, 1)
    jB, tB = build(shape, 2, capacity=160)
    assert_same_mat(tA.ewise_mult(tB), jA.ewise_mult(jB))
    assert_same_mat(tA.ewise_mult(tB, negate=True), jA.ewise_mult(jB, negate=True))
    assert_same_mat(tA.ewise_mult(tB, combine=f_sub), jA.ewise_mult(jB, combine=f_sub))
    assert_same_mat(tA.ewise_apply(tB, f_add2, allow_a_nulls=True, allow_b_nulls=True,
                                   a_null=3, b_null=-1),
                    jA.ewise_apply(jB, f_add2, allow_a_nulls=True, allow_b_nulls=True,
                                   a_null=3, b_null=-1))
    assert_same_mat(tA.ewise_add(tB, PLUS_TIMES), jA.ewise_add(jB, jsr.PLUS_TIMES))
    assert_same_mat(tA.ewise_add(tB, MIN_PLUS, capacity=400),
                    jA.ewise_add(jB, jsr.MIN_PLUS, capacity=400))
    if shape[0] == shape[1]:
        jS, tS = build(shape, 3, m=M, n=M)
        assert_same_mat(tS.add_loops(4.0), jS.add_loops(4.0))
    else:
        with pytest.raises(ValueError, match="square blocking"):
            tA.add_loops(1.0)
    _, tC = build(shape, 1, m=M, n=M)
    with pytest.raises(ValueError, match="shapes differ"):
        tA.ewise_mult(tC)


# --- SpParMat: select and prune ------------------------------------------------------


def test_monotone_keys_order_as_the_reference():
    """Keys of the specials (NaN of both signs, ±0, ±inf) and of int32
    extremes sort as the values do and invert."""
    v = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 1e-45],
                 np.float32)
    k = monotone_key_u32(torch.from_numpy(v))
    from combblas_tpu.parallel.spmat import _monotone_key_u32

    np.testing.assert_array_equal(k.numpy(), np.asarray(_monotone_key_u32(jnp.asarray(v)))
                                  .astype(np.int64))
    assert k[3] < k[2] and k[0] > k[4] and k[1] < k[5]  # -0 < +0, NaN > inf, -NaN < -inf
    assert_same(key_u32_to_val(k, torch.float32), v)
    iv = np.array([-2**31, -1, 0, 1, 2**31 - 1], np.int32)
    ik = monotone_key_u32(torch.from_numpy(iv))
    assert (ik.diff() > 0).all() and int(ik.min()) == 0 and int(ik.max()) == 2**32 - 1
    assert_same(key_u32_to_val(ik, torch.int32), iv)
    with pytest.raises(TypeError, match="kselect keys"):
        monotone_key_u32(torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("case", ["ints", "specials", "int32"])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_kselect_matches_reference(shape, case):
    """Per-column k-th largest (k = 3 and per-column k's), columns with
    fewer entries at the dtype's least value; ``kselect2``;
    ``nnz_per_column``."""
    jA, tA = build(shape, 5, case)
    assert_same(tA.nnz_per_column().blocks, jA.nnz_per_column().blocks)
    assert_same(tA.kselect(3).blocks, jA.kselect(3).blocks)
    kv = np.random.default_rng(1).integers(1, 9, N).astype(np.int32)
    assert_same(tA.kselect(DistVec.from_global(tA.grid, kv, align="col")).blocks,
                jA.kselect(JaxDistVec.from_global(jA.grid, kv, align="col")).blocks)
    tth, tany = tA.kselect2(30)
    jth, jany = jA.kselect2(30)
    assert_same(tth.blocks, jth.blocks)
    assert bool(tany) == bool(jany)


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_prune_column_and_rowcol_match_reference(shape):
    """``prune_column`` against the k-th largest (MCL's select), and
    ``prune_rowcol`` with row and column vectors."""
    jA, tA = build(shape, 6)
    assert_same_mat(tA.prune_column(tA.kselect(2), keep_ge),
                    jA.prune_column(jA.kselect(2), keep_ge))
    rv = np.random.default_rng(2).integers(-5, 5, M).astype(np.float32)
    cv = np.arange(N, dtype=np.float32)
    assert_same_mat(
        tA.prune_rowcol(DistVec.from_global(tA.grid, rv, align="row"),
                        DistVec.from_global(tA.grid, cv, align="col"), keep_row_col),
        jA.prune_rowcol(JaxDistVec.from_global(jA.grid, rv, align="row"),
                        JaxDistVec.from_global(jA.grid, cv, align="col"), keep_row_col))


# --- SpParMat: capacities and splits --------------------------------------------------


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_capacities_and_splits_match_reference(shape):
    """``with_capacity`` up and down, ``shrink_to_fit`` both ways,
    ``col_split`` / ``row_split`` / ``block_split`` and
    ``col_concatenate`` of the pieces (which puts the columns back)."""
    jA, tA = build(shape, 7, capacity=170)
    assert_same_mat(tA.with_capacity(200), jA.with_capacity(200))
    assert_same_mat(tA.shrink_to_fit(), jA.shrink_to_fit())
    assert_same_mat(tA.shrink_to_fit(pow2=False), jA.shrink_to_fit(pow2=False))
    tcs, jcs = tA.col_split(2), jA.col_split(2)
    for g, w in zip(tcs, jcs):
        assert_same_mat(g, w)
    back = SpParMat.col_concatenate(tcs)
    assert_same_mat(back, JaxSpParMat.col_concatenate(jcs))
    np.testing.assert_array_equal(back.to_dense(), tA.to_dense())
    for g, w in zip(tA.row_split(2), jA.row_split(2)):
        assert_same_mat(g, w)
    for grow, wrow in zip(tA.block_split(2, 2), jA.block_split(2, 2)):
        for g, w in zip(grow, wrow):
            assert_same_mat(g, w)
    with pytest.raises(ValueError, match="not divisible"):
        tA.col_split(5)
    _, odd = build(shape, 7, m=M + 1)
    with pytest.raises(ValueError, match="divide evenly|not divisible"):
        odd.row_split(2)
