"""Parity of the port's SpMV layer on ``SpParMat`` with ``combblas_tpu`` on
the CPU: the ``SpTuples`` constructors and transforms, ``CSR`` / ``CSC``,
the local ``spmv`` / ``spmv_masked`` / ``spmspv_dense_out`` / ``spmspv``
and the four distributed forms (``dist_spmv``, ``dist_spmv_masked``,
``dist_spmspv``, ``dist_spmspv_masked``) on 1x1, 2x2 and 2x4 grids.

Exact (equal bits, NaN cells by position) for integer data, min/max
semirings and ``plus_times`` on integer-valued float32 (every sum below
2**24); ``plus_times`` on random float32 within ``rtol=1e-5, atol=1e-6``
(the order of a float sum differs). The reference's functions are
compiled once per semiring and shape (``jax.jit``) and reused.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.ops.compressed import CSC as JaxCSC
from combblas_tpu.ops.compressed import CSR as JaxCSR
from combblas_tpu.ops.tuples import SpTuples as JaxSpTuples
from combblas_tpu.parallel import spmv as jax_pspmv
from combblas_tpu.parallel.ellmat import EllParMat as JaxEllParMat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    CSC,
    CSR,
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    SELECT2ND_MIN,
    DistVec,
    EllParMat,
    Grid,
    SpParMat,
    SpTuples,
    dist_spmspv,
    dist_spmspv_masked,
    dist_spmv,
    dist_spmv_masked,
)
from combblas_tpu_torch.ops import spmv as torch_spmv
from combblas_tpu_torch.ops.segment import DROP_SPREAD

# the module: the package's ``ops`` exports a function of the same name
jax_spmv = importlib.import_module("combblas_tpu.ops.spmv")

M, N = 37, 29  # rectangular, so padding rows and columns differ
SEMIRINGS = {
    "plus_times": (PLUS_TIMES, jsr.PLUS_TIMES),
    "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
    "max_min": (MAX_MIN, jsr.MAX_MIN),
    "select2nd_max": (SELECT2ND_MAX, jsr.SELECT2ND_MAX),
    "select2nd_min": (SELECT2ND_MIN, jsr.SELECT2ND_MIN),
}
# (semiring, data case): integer-valued plus_times is exact, "float" is not
CASES = [("plus_times", "ints"), ("plus_times", "float"), ("min_plus", "float"),
         ("max_min", "float"), ("select2nd_max", "ids"), ("select2nd_min", "ids")]
CASE_IDS = [f"{a}-{b}" for a, b in CASES]
GRIDS = [(1, 1), (2, 2), (2, 4)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]
SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3], np.float32)

jit_spmv = jax.jit(jax_spmv.spmv, static_argnums=0)
jit_spmv_masked = jax.jit(jax_spmv.spmv_masked, static_argnums=0)
jit_dense_out = jax.jit(jax_spmv.spmspv_dense_out, static_argnums=0,
                        static_argnames="exp_capacity")
jit_spmspv = jax.jit(jax_spmv.spmspv, static_argnums=0, static_argnames="out_capacity")
jit_dist_spmv = jax.jit(jax_pspmv.dist_spmv, static_argnums=0)
jit_dist_masked = jax.jit(jax_pspmv.dist_spmv_masked, static_argnums=0)


def assert_same(got, want, tol=False):
    """Equal bits (NaN cells by position), or within tolerance."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if tol:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    elif got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32), want[keep].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


def pattern(seed, m=M, n=N, density=0.12):
    """A random (row, col) pattern without duplicates, with an empty row
    and an empty column, and one dense column (a hub)."""
    rng = np.random.default_rng(seed)
    d = rng.random((m, n)) < density
    d[:, 5] |= rng.random(m) < 0.6
    d[3] = False
    d[:, 7] = False
    r, c = np.nonzero(d)
    return r, c


def values(case, seed, nnz, nx):
    """Matrix values [nnz] and a vector [nx] for a data case."""
    rng = np.random.default_rng(seed)
    if case == "float":
        return (rng.uniform(-1, 1, nnz).astype(np.float32),
                rng.uniform(-1, 1, nx).astype(np.float32))
    if case == "ids":  # candidates: vertex ids or -1, and a large "none"
        return (np.ones(nnz, np.float32),
                rng.choice([-1, 2**31 - 1, *range(50)], nx).astype(np.int32))
    if case == "specials":
        return rng.choice(SPECIALS, nnz), rng.choice(SPECIALS, nx)
    return (rng.integers(-8, 9, nnz).astype(np.float32),
            rng.integers(-8, 9, nx).astype(np.float32))


def both_tuples(r, c, v, m=M, n=N, capacity=None):
    return (JaxSpTuples.from_coo(r, c, v, m, n, capacity),
            SpTuples.from_coo(r, c, v, m, n, capacity, device="cpu"))


def assert_same_tuples(got, want):
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "vals", "nnz"):
        assert_same(getattr(got, f), getattr(want, f))


# --- SpTuples ----------------------------------------------------------------


def test_from_coo_from_dense_and_empty():
    r, c = pattern(1)
    v = np.arange(len(r), dtype=np.float32) + 1
    ref, mine = both_tuples(r, c, v, capacity=len(r) + 9)
    assert_same_tuples(mine, ref)
    dense = np.zeros((M, N), np.float32)
    dense[r, c] = v
    assert_same_tuples(SpTuples.from_dense(dense, capacity=300, device="cpu"),
                       JaxSpTuples.from_dense(dense, capacity=300))
    assert_same_tuples(SpTuples.empty(M, N, 11, torch.int32, device="cpu"),
                       JaxSpTuples.empty(M, N, 11, jnp.int32))
    with pytest.raises(ValueError, match="exceeds capacity"):
        SpTuples.from_coo(r, c, v, M, N, capacity=3, device="cpu")


@pytest.mark.parametrize("sr", [None, "min_plus", "max_min", "select2nd_max"])
def test_to_dense_combines_duplicates(sr):
    """Duplicate cells fold with ``sr.add`` (sum by default); special
    values keep the reference's NaN and signed zeros."""
    rng = np.random.default_rng(2)
    r, c = rng.integers(0, M, 300), rng.integers(0, N, 300)  # many duplicates
    if sr == "select2nd_max":
        v = rng.integers(-5, 5, 300).astype(np.int32)
    else:
        v = rng.choice(SPECIALS, 300) if sr else rng.integers(-4, 5, 300).astype(np.float32)
    ref, mine = both_tuples(r, c, v, capacity=320)
    tsr, jsr_ = SEMIRINGS[sr] if sr else (None, None)
    assert_same(mine.to_dense(tsr), jax.jit(JaxSpTuples.to_dense, static_argnums=1)(ref, jsr_))


def test_sort_colmajor_transpose_and_concat():
    r, c = pattern(3)
    rng = np.random.default_rng(3)
    perm = rng.permutation(len(r))
    v = np.arange(len(r), dtype=np.int32)
    ref, mine = both_tuples(r[perm], c[perm], v, capacity=len(r) + 5)
    assert_same_tuples(mine.sort_colmajor(), ref.sort_colmajor())
    assert_same_tuples(mine.sort_rowmajor(), ref.sort_rowmajor())
    assert_same_tuples(mine.transpose(), ref.transpose())
    assert_same_tuples(SpTuples.concat([mine, mine.transpose().transpose()]),
                       JaxSpTuples.concat([ref, ref.transpose().transpose()]))


def test_prune_select_ij_and_apply():
    r, c = pattern(4)
    v = np.random.default_rng(4).integers(-5, 6, len(r)).astype(np.float32)
    ref, mine = both_tuples(r, c, v, capacity=len(r) + 7)
    assert_same_tuples(mine.prune(lambda x: x < 0), ref.prune(lambda x: x < 0))
    assert_same_tuples(mine.select_ij(lambda i, j: i > j), ref.select_ij(lambda i, j: i > j))
    assert_same_tuples(mine.apply(lambda x: x * 3 + 1), ref.apply(lambda x: x * 3 + 1))
    assert_same_tuples(mine.apply(lambda x: torch.ones(x.shape, dtype=torch.int32)),
                       ref.apply(lambda x: jnp.ones(x.shape, jnp.int32)))


# --- CSR / CSC ---------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_compressed_from_and_to_tuples(fmt):
    r, c = pattern(5)
    perm = np.random.default_rng(5).permutation(len(r))
    v = np.arange(len(r), dtype=np.float32)
    ref, mine = both_tuples(r[perm], c[perm], v, capacity=len(r) + 6)
    jcls, tcls = (JaxCSR, CSR) if fmt == "csr" else (JaxCSC, CSC)
    jc, tc = jcls.from_tuples(ref), tcls.from_tuples(mine)
    for f in ("indptr", "indices", "vals", "nnz"):
        assert_same(getattr(tc, f), getattr(jc, f))
    assert tc.indptr.dtype == torch.int32 and tc.indptr.shape == ((M if fmt == "csr" else N) + 1,)
    lens = tc.row_lens() if fmt == "csr" else tc.col_lens()
    assert_same(lens, jc.row_lens() if fmt == "csr" else jc.col_lens())
    assert_same_tuples(tc.to_tuples(), jc.to_tuples())
    # the support words: the reference's uint32 bits as int32
    np.testing.assert_array_equal(tc.to_bitmask().numpy(),
                                  np.asarray(jc.to_bitmask()).view(np.int32))


# --- local kernels -----------------------------------------------------------


@pytest.mark.parametrize("sr,case", CASES + [("min_plus", "specials"),
                                             ("max_min", "specials")],
                         ids=CASE_IDS + ["min_plus-specials", "max_min-specials"])
def test_local_spmv_and_masked(sr, case):
    tsr, jsr_ = SEMIRINGS[sr]
    r, c = pattern(6)
    v, x = values(case, 6, len(r), N)
    ref, mine = both_tuples(r, c, v, capacity=len(r) + 4)
    tol = case == "float" and sr == "plus_times"
    assert_same(torch_spmv.spmv(tsr, mine, torch.from_numpy(x)), jit_spmv(jsr_, ref, x), tol)
    active = np.random.default_rng(7).random(M) < 0.5
    assert_same(torch_spmv.spmv_masked(tsr, mine, torch.from_numpy(x), torch.from_numpy(active)),
                jit_spmv_masked(jsr_, ref, x, active), tol)


def sparse_x(seed, nactive, xcap, vals):
    """Distinct active column ids in the first slots (padding id N), with
    the vector's values at them."""
    rng = np.random.default_rng(seed)
    ind = np.full(xcap, N, np.int32)
    ind[:nactive] = rng.choice(N, nactive, replace=False)
    val = np.zeros(xcap, vals.dtype)
    val[:nactive] = vals[ind[:nactive]]
    return ind, val


@pytest.mark.parametrize("sr,case", CASES + [("min_plus", "specials")],
                         ids=CASE_IDS + ["min_plus-specials"])
def test_local_spmspv_dense_out_and_sparse_out(sr, case):
    tsr, jsr_ = SEMIRINGS[sr]
    r, c = pattern(8)
    v, x = values(case, 8, len(r), N)
    ref, mine = both_tuples(r, c, v, capacity=len(r) + 4)
    jc, tc = JaxCSC.from_tuples(ref), CSC.from_tuples(mine)
    ind, val = sparse_x(9, 6, 10, x)
    tind, tval = torch.from_numpy(ind), torch.from_numpy(val)
    tol = case == "float" and sr == "plus_times"
    assert_same(torch_spmv.spmspv_dense_out(tsr, tc, tind, tval, exp_capacity=len(r)),
                jit_dense_out(jsr_, jc, ind, val, exp_capacity=len(r)), tol)
    want = jit_spmspv(jsr_, jc, ind, val, np.int32(6), out_capacity=M)
    got = torch_spmv.spmspv(tsr, tc, tind, tval, torch.tensor(6), out_capacity=M)
    for g, w in zip(got, want):
        assert_same(g, w, tol)


def test_local_spmspv_budget_overflow():
    """Past ``exp_capacity`` walked entries (and past ``out_capacity``
    touched rows) the same pairs and rows drop as in the reference."""
    tsr, jsr_ = SEMIRINGS["plus_times"]
    r, c = pattern(10, density=0.3)
    v, x = values("ints", 10, len(r), N)
    ref, mine = both_tuples(r, c, v)
    jc, tc = JaxCSC.from_tuples(ref), CSC.from_tuples(mine)
    ind, val = sparse_x(11, 12, 12, x)
    walked = int(np.asarray(jc.col_lens())[ind].sum())
    tind, tval = torch.from_numpy(ind), torch.from_numpy(val)
    for cap in (1, walked // 3, walked - 1, walked):
        assert_same(torch_spmv.spmspv_dense_out(tsr, tc, tind, tval, exp_capacity=cap),
                    jit_dense_out(jsr_, jc, ind, val, exp_capacity=cap))
    want = jit_spmspv(jsr_, jc, ind, val, np.int32(12), out_capacity=5)
    got = torch_spmv.spmspv(tsr, tc, tind, tval, torch.tensor(12), out_capacity=5)
    for g, w in zip(got, want):
        assert_same(g, w)


# --- distributed forms -------------------------------------------------------


def both_mats(shape, r, c, v, m=M, n=N):
    return (JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, m, n),
            SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, m, n))


def both_vecs(ref, mine, x, align):
    return (JaxDistVec.from_global(ref.grid, x, align=align),
            DistVec.from_global(mine.grid, x, align=align))


def assert_same_vec(got, want, tol=False):
    assert (got.length, got.align) == (want.length, want.align)
    assert_same(got.blocks, want.blocks, tol)


def test_fold_rows_spread_the_padding_and_are_kept():
    """``SpParMat.fold_rows``, what the local ``spmv`` scatters into: each
    valid slot's row, each padding slot one of the sink rows past
    ``local_rows`` in turn (slot number modulo ``DROP_SPREAD``); made once
    a matrix."""
    r, c = pattern(6)
    _, mine = both_mats((2, 2), r, c, np.ones(len(r), np.float32))
    lr, fr = mine.local_rows, mine.fold_rows
    assert fr is mine.fold_rows
    valid = mine.rows < lr
    assert (~valid).any()
    assert torch.equal(fr[valid], mine.rows[valid])
    slot = torch.arange(mine.capacity, dtype=fr.dtype).expand_as(fr)
    assert torch.equal(fr[~valid], (lr + slot % DROP_SPREAD)[~valid])


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("sr,case", CASES, ids=CASE_IDS)
def test_dist_spmv_and_masked(shape, sr, case):
    """x in either alignment; the mask applies before the combine."""
    tsr, jsr_ = SEMIRINGS[sr]
    r, c = pattern(12)
    v, x = values(case, 12, len(r), N)
    ref, mine = both_mats(shape, r, c, v)
    tol = case == "float" and sr == "plus_times"
    align = "row" if shape == (2, 4) else "col"
    jx, tx = both_vecs(ref, mine, x, align)
    assert_same_vec(dist_spmv(tsr, mine, tx), jit_dist_spmv(jsr_, ref, jx), tol)
    active = np.random.default_rng(13).random(M) < 0.6
    ja, ta = both_vecs(ref, mine, active, "row")
    assert_same_vec(dist_spmv_masked(tsr, mine, tx, ta), jit_dist_masked(jsr_, ref, jx, ja), tol)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("sr", ["min_plus", "max_min"])
def test_dist_spmv_special_values(shape, sr):
    """±0, NaN and ±inf through the products, the folds and the combine
    over grid columns (which drops a NaN and keeps the first of two equal
    zeros, as the reference's does on the CPU)."""
    tsr, jsr_ = SEMIRINGS[sr]
    r, c = pattern(14, density=0.3)
    v, x = values("specials", 14, len(r), N)
    ref, mine = both_mats(shape, r, c, v)
    jx, tx = both_vecs(ref, mine, x, "col")
    assert_same_vec(dist_spmv(tsr, mine, tx), jit_dist_spmv(jsr_, ref, jx))


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("sr,case", [("plus_times", "ints"), ("select2nd_max", "ids"),
                                     ("min_plus", "float")],
                         ids=["plus_times-ints", "select2nd_max-ids", "min_plus-float"])
def test_dist_spmspv(shape, sr, case):
    tsr, jsr_ = SEMIRINGS[sr]
    r, c = pattern(15)
    v, x = values(case, 15, len(r), N)
    ref, mine = both_mats(shape, r, c, v)
    jx, tx = both_vecs(ref, mine, x, "col")
    act = np.random.default_rng(16).random(N) < 0.3
    ja, ta = both_vecs(ref, mine, act, "col")
    got = dist_spmspv(tsr, mine, tx, ta)
    want = jax_pspmv.dist_spmspv(jsr_, ref, jx, ja)
    assert_same_vec(got[0], want[0])
    assert_same_vec(got[1], want[1])
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("budgets", [(64, 4096), (3, 4096), (64, 7)],
                         ids=["ample", "few-columns", "few-entries"])
def test_dist_spmspv_masked(shape, budgets):
    """The walk over the active columns, ample budgets and budgets that
    cut it (the first columns, then the first walked entries, per tile)."""
    tsr, jsr_ = SEMIRINGS["select2nd_max"]
    fc, ec = budgets
    r, c = pattern(17, m=40, n=40)
    ref, mine = both_mats(shape, r, c, np.ones(len(r), np.float32), 40, 40)
    rng = np.random.default_rng(18)
    x = np.where(rng.random(40) < 0.4, np.arange(40), -1).astype(np.int32)
    jx, tx = both_vecs(ref, mine, x, "col")
    ja, ta = both_vecs(ref, mine, x >= 0, "col")
    unv = rng.random(40) < 0.7
    ju, tu = both_vecs(ref, mine, unv, "row")
    want = jax_pspmv.dist_spmspv_masked(jsr_, ref, jx, ja, ju, frontier_capacity=fc,
                                        exp_capacity=ec)
    got = dist_spmspv_masked(tsr, mine, tx, ta, tu, frontier_capacity=fc, exp_capacity=ec)
    assert_same_vec(got, want)


def test_dist_spmv_dispatches_an_ellparmat():
    """``dist_spmv`` / ``dist_spmv_masked`` of an EllParMat run the ELL
    family, as in the reference."""
    tsr, jsr_ = SEMIRINGS["select2nd_max"]
    r, c = pattern(19, m=40, n=40)
    v = np.ones(len(r), np.float32)
    ref = JaxEllParMat.from_host_coo(JaxGrid.make(2, 2), r, c, v, 40, 40)
    mine = EllParMat.from_host_coo(Grid.make(2, 2, device="cpu"), r, c, v, 40, 40)
    x = np.where(np.random.default_rng(20).random(40) < 0.5, np.arange(40), -1).astype(np.int32)
    jx, tx = both_vecs(ref, mine, x, "col")
    assert_same_vec(dist_spmv(tsr, mine, tx), jax_pspmv.dist_spmv(jsr_, ref, jx))
    act = np.arange(40) % 3 != 0
    ja, ta = both_vecs(ref, mine, act, "row")
    assert_same_vec(dist_spmv_masked(tsr, mine, tx, ta),
                    jax_pspmv.dist_spmv_masked(jsr_, ref, jx, ja))


def test_dist_spmv_checks_the_length():
    _, mine = both_mats((1, 1), *pattern(21), np.ones(len(pattern(21)[0]), np.float32))
    with pytest.raises(ValueError, match="length"):
        dist_spmv(PLUS_TIMES, mine, DistVec.from_global(mine.grid, np.ones(N + 1, np.float32)))
