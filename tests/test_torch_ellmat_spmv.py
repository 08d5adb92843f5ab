"""Parity of the port's ELL SpMV family (``dist_spmv_ell``,
``dist_spmv_ell_masked``, their ``_multi`` forms, ``EllParMat.reduce``,
``from_spmat``, ``_ell_local_spmm``) and of the generic-monoid
``segment_reduce`` with ``combblas_tpu`` on the CPU.

Exact (``array_equal``) for integer data and min/max semirings, and for
``plus_times`` on integer-valued float32 (every sum stays below 2**24);
``plus_times`` on random float32 within ``rtol=1e-5, atol=1e-6`` (the
order of a float sum differs). The special-value case (±0, NaN) of the
min/max semirings compares bits, NaN cells by position.

A generic monoid (int32 bitwise or, defined below identically for both
packages) runs in the reference's local kernel and ``segment_reduce``
only: the reference's ``dist_spmv_ell*`` raise for it (its shard_map
cannot infer the replication of an ``all_gather`` fold), and its generic
``segment_reduce`` takes 1-D values only (``lax.sort`` of ids ``[n]``
with values ``[n, F]``). Those cases are held against the reference's
local kernel tile by tile, combined over grid columns in column order as
the reference's ``axis_reduce`` does, and the port's ``[n, F]`` forms
against its 1-D form lane by lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jax_semiring
from combblas_tpu.ops import segment as jax_segment
from combblas_tpu.parallel import ellmat as jax_ellmat
from combblas_tpu.parallel import spmat as jax_spmat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistMultiVec as JaxDistMultiVec
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    DistMultiVec,
    DistVec,
    EllParMat,
    Grid,
    Semiring,
    SpParMat,
    dist_spmv_ell,
    dist_spmv_ell_masked,
    dist_spmv_ell_masked_multi,
    dist_spmv_ell_multi,
    ones_f32,
    ones_i32,
    segment_reduce,
)
from combblas_tpu_torch.parallel import ellmat as torch_ellmat

N = 96
W = 3
# (grid, max_k): split rows on the widest grid. The parity matrix runs 1x1
# and 2x4; the square 2x2 grid (its own realign) runs the special values
# and the reduce.
GRIDS = [((1, 1), None), ((2, 2), None), ((2, 4), 5)]
GRID_IDS = ["1x1", "2x2", "2x4-split-rows"]

BOR = Semiring(name="bitor_and", add=torch.bitwise_or, mul=torch.bitwise_and,
               zero_fn=lambda dt: 0, add_kind="generic")
JAX_BOR = jax_semiring.Semiring(name="bitor_and", add=jnp.bitwise_or, mul=jnp.bitwise_and,
                                zero_fn=lambda dt: 0, add_kind="generic")
SEMIRINGS = {
    "plus_times": (PLUS_TIMES, jax_semiring.PLUS_TIMES),
    "min_plus": (MIN_PLUS, jax_semiring.MIN_PLUS),
    "max_min": (MAX_MIN, jax_semiring.MAX_MIN),
    "select2nd_max": (SELECT2ND_MAX, jax_semiring.SELECT2ND_MAX),
}
FORMS = ["spmv", "masked", "multi", "masked_multi"]

# the reference's building blocks, compiled once per shape (op-by-op
# dispatch of their scans would cost seconds a call)
ref_local_spmv = jax.jit(jax_ellmat._ell_local_spmv, static_argnums=(0, 3, 4))
ref_local_spmm = jax.jit(jax_ellmat._ell_local_spmm, static_argnums=(0, 3, 4, 5))
ref_segment_reduce = jax.jit(jax_segment.segment_reduce, static_argnums=(0, 3))


def pattern(seed: int, n: int = N):
    """Random COO with a few dense rows and columns (hubs, so that
    ``max_k=5`` splits rows) and some empty ones, sorted by (row, col)."""
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)) < 0.06
    d[rng.choice(n, 3, replace=False)] |= rng.random(n) < 0.5
    d[:, rng.choice(n, 2, replace=False)] |= (rng.random(n) < 0.4)[:, None]
    d[rng.choice(n, 5, replace=False)] = False
    r, c = np.nonzero(d)
    return r.astype(np.int64), c.astype(np.int64)


def data(case: str, seed: int, nnz: int):
    """Matrix values [nnz], vector [N] and multivector [N, W] for a case."""
    rng = np.random.default_rng(seed)
    if case == "float":
        return (rng.uniform(-1, 1, nnz).astype(np.float32),
                rng.uniform(-1, 1, N).astype(np.float32),
                rng.uniform(-1, 1, (N, W)).astype(np.float32))
    if case == "select":  # int32 candidates, -1 = none
        return (np.ones(nnz, np.float32), rng.integers(-1, N, N).astype(np.int32),
                rng.integers(-1, N, (N, W)).astype(np.int32))
    if case == "bits":
        return tuple(rng.integers(0, 2**31 - 1, s).astype(np.int32)
                     for s in (nnz, N, (N, W)))
    if case == "specials":  # ±0, NaN, ±inf among small integers
        pick = lambda size: rng.choice(
            np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3], np.float32), size=size,
            p=[0.2, 0.2, 0.05, 0.05, 0.05, 0.15, 0.15, 0.15])
        return pick(nnz), pick(N), pick((N, W))
    return tuple(rng.integers(-8, 9, s).astype(np.float32) for s in (nnz, N, (N, W)))


def build(shape, max_k, vals, seed=3):
    r, c = pattern(seed)
    ref = jax_ellmat.EllParMat.from_host_coo(JaxGrid.make(*shape), r, c, vals, N, N, max_k=max_k)
    mine = EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, vals, N, N,
                                   max_k=max_k)
    return ref, mine


def run_form(form, jsr, tsr, ref, mine, x, X, active, active2):
    """The form on both packages: (reference blocks, port blocks)."""
    jg, tg = ref.grid, mine.grid
    if form in ("spmv", "masked"):
        jx, tx = JaxDistVec.from_global(jg, x, align="col"), DistVec.from_global(tg, x, align="col")
        if form == "spmv":
            return (jax_ellmat.dist_spmv_ell(jsr, ref, jx),
                    dist_spmv_ell(tsr, mine, tx))
        ja = JaxDistVec.from_global(jg, active, align="row")
        ta = DistVec.from_global(tg, active, align="row")
        return (jax_ellmat.dist_spmv_ell_masked(jsr, ref, jx, ja),
                dist_spmv_ell_masked(tsr, mine, tx, ta))
    jX = JaxDistMultiVec.from_global(jg, X, align="col")
    tX = DistMultiVec.from_global(tg, X, align="col")
    if form == "multi":
        return (jax_ellmat.dist_spmv_ell_multi(jsr, ref, jX),
                dist_spmv_ell_multi(tsr, mine, tX))
    ja = JaxDistMultiVec.from_global(jg, active2, align="row")
    ta = DistMultiVec.from_global(tg, active2, align="row")
    return (jax_ellmat.dist_spmv_ell_masked_multi(jsr, ref, jX, ja),
            dist_spmv_ell_masked_multi(tsr, mine, tX, ta))


def masks(seed):
    rng = np.random.default_rng(seed)
    return rng.random(N) < 0.7, rng.random((N, W)) < 0.7


def assert_same_bits(got: np.ndarray, want: np.ndarray):
    """Equal values, -0.0 and +0.0 told apart, NaN cells by position."""
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_array_equal(np.signbit(got[ok]), np.signbit(want[ok]))


CASES = [("plus_times", "int"), ("plus_times", "float"), ("min_plus", "int"),
         ("max_min", "int"), ("select2nd_max", "select")]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("sr_name, case", CASES, ids=[f"{a}-{b}" for a, b in CASES])
@pytest.mark.parametrize("shape, max_k", [GRIDS[0], GRIDS[2]], ids=[GRID_IDS[0], GRID_IDS[2]])
def test_dist_spmv_ell_matches_reference(shape, max_k, sr_name, case, form):
    tsr, jsr = SEMIRINGS[sr_name]
    r, _ = pattern(3)
    vals, x, X = data(case, 11, len(r))
    ref, mine = build(shape, max_k, vals)
    active, active2 = masks(5)
    want, got = run_form(form, jsr, tsr, ref, mine, x, X, active, active2)
    assert (got.align, got.length) == ("row", N) and got.blocks.shape == tuple(want.blocks.shape)
    g, w = got.to_global(), np.asarray(want.to_global())
    assert g.dtype == w.dtype
    if case == "float":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", ["masked", "multi"])
@pytest.mark.parametrize("sr_name", ["min_plus", "max_min"])
def test_dist_spmv_ell_specials_match_reference(sr_name, form):
    """±0, NaN and ±inf in the matrix and the vectors, on a 2×2 grid with
    split rows (the square grid of the parity matrix): the folds, the row
    scatter and the combine over grid columns give the reference's bits."""
    tsr, jsr = SEMIRINGS[sr_name]
    r, _ = pattern(3)
    vals, x, X = data("specials", 17, len(r))
    ref, mine = build((2, 2), 5, vals)
    active, active2 = masks(6)
    want, got = run_form(form, jsr, tsr, ref, mine, x, X, active, active2)
    assert_same_bits(got.to_global(), np.asarray(want.to_global()))


def reference_generic(ref, x_blocks, active=None):
    """The reference's local kernel on each tile (its dist forms raise for
    a generic monoid), masked, then combined over grid columns with the
    monoid in column order, as its ``axis_reduce`` does."""
    pr, pc = ref.grid.pr, ref.grid.pc
    lr, lc = ref.local_rows, ref.local_cols
    out = []
    for i in range(pr):
        acc = None
        for j in range(pc):
            b = [tuple(a[i, j] for a in bk) for bk in ref.buckets]
            y = ref_local_spmv(JAX_BOR, b, jnp.asarray(x_blocks[j]), lr, lc)
            if active is not None:
                y = jnp.where(active[i], y, 0)
            acc = y if acc is None else jnp.bitwise_or(acc, y)
        out.append(np.asarray(acc))
    return np.stack(out)


@pytest.mark.parametrize("shape, max_k", [GRIDS[0], GRIDS[2]], ids=[GRID_IDS[0], GRID_IDS[2]])
def test_generic_monoid_spmv_matches_reference_local_kernel(shape, max_k):
    r, _ = pattern(3)
    vals, x, X = data("bits", 19, len(r))
    ref, mine = build(shape, max_k, vals)
    active, active2 = masks(7)
    tx = DistVec.from_global(mine.grid, x, align="col")
    ta = DistVec.from_global(mine.grid, active, align="row")
    np.testing.assert_array_equal(dist_spmv_ell(BOR, mine, tx).blocks.numpy(),
                                  reference_generic(ref, tx.blocks.numpy()))
    np.testing.assert_array_equal(dist_spmv_ell_masked(BOR, mine, tx, ta).blocks.numpy(),
                                  reference_generic(ref, tx.blocks.numpy(), ta.blocks.numpy()))
    # the [n, W] forms, lane by lane against the 1-D form
    tX = DistMultiVec.from_global(mine.grid, X, align="col")
    tA = DistMultiVec.from_global(mine.grid, active2, align="row")
    Y = dist_spmv_ell_multi(BOR, mine, tX).to_global()
    YM = dist_spmv_ell_masked_multi(BOR, mine, tX, tA).to_global()
    for k in range(W):
        xk = DistVec.from_global(mine.grid, X[:, k], align="col")
        np.testing.assert_array_equal(Y[:, k], dist_spmv_ell(BOR, mine, xk).to_global())
        ak = DistVec.from_global(mine.grid, active2[:, k], align="row")
        np.testing.assert_array_equal(YM[:, k],
                                      dist_spmv_ell_masked(BOR, mine, xk, ak).to_global())


def test_reference_dist_forms_refuse_a_generic_monoid():
    """The deviation the test above works around: the reference's
    distributed SpMV does not run a generic monoid."""
    r, _ = pattern(3)
    vals, x, _ = data("bits", 19, len(r))
    ref, _ = build((1, 1), None, vals)
    with pytest.raises(Exception, match="replicat"):
        jax_ellmat.dist_spmv_ell(JAX_BOR, ref, JaxDistVec.from_global(ref.grid, x, align="col"))


def test_vector_length_must_match_the_columns():
    r, _ = pattern(3)
    _, mine = build((1, 1), None, np.ones(len(r), np.float32))
    with pytest.raises(ValueError, match="length"):
        dist_spmv_ell(PLUS_TIMES, mine, DistVec.from_global(mine.grid, np.ones(N + 1, np.float32)))


REDUCE_CASES = [("plus_times-ones_i32", "int", "ones_i32"), ("max_min", "int", None),
                ("min_plus-ones_f32", "float", "ones_f32")]


@pytest.mark.parametrize("sr_name, case, fn", REDUCE_CASES, ids=[c[0] for c in REDUCE_CASES])
@pytest.mark.parametrize("shape, max_k", GRIDS, ids=GRID_IDS)
def test_reduce_matches_reference(shape, max_k, sr_name, case, fn):
    tsr, jsr = SEMIRINGS[sr_name.split("-")[0]]
    r, _ = pattern(3)
    vals, _, _ = data(case, 23, len(r))
    ref, mine = build(shape, max_k, vals)
    tfn = {"ones_i32": ones_i32, "ones_f32": ones_f32, None: None}[fn]
    jfn = {"ones_i32": jax_spmat.ones_i32, "ones_f32": jax_spmat.ones_f32, None: None}[fn]
    got = mine.reduce(tsr, "cols", map_fn=tfn)
    want = ref.reduce(jsr, "cols", map_fn=jfn)
    assert (got.align, got.length) == ("row", N)
    g, w = got.blocks.numpy(), np.asarray(want.blocks)
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)
    if fn == "ones_i32":  # the structural degree of every row
        np.testing.assert_array_equal(got.to_global(), np.bincount(r, minlength=N))


def test_reduce_of_an_empty_matrix_takes_map_fn_dtype():
    e = np.empty(0, np.int64)
    ref = jax_ellmat.EllParMat.from_host_coo(JaxGrid.make(2, 2), e, e, np.empty(0, np.float32),
                                             N, N)
    mine = EllParMat.from_host_coo(Grid.make(2, 2, device="cpu"), e, e,
                                   np.empty(0, np.float32), N, N)
    assert mine.buckets == () and ref.buckets == ()
    got = mine.reduce(PLUS_TIMES, "cols", map_fn=ones_i32)
    want = ref.reduce(jax_semiring.PLUS_TIMES, "cols", map_fn=jax_spmat.ones_i32)
    assert got.blocks.dtype == torch.int32
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    assert mine.reduce(MIN_PLUS, "cols").blocks.dtype == torch.float32


def test_reduce_over_rows_raises():
    r, _ = pattern(3)
    ref, mine = build((1, 1), None, np.ones(len(r), np.float32))
    with pytest.raises(AssertionError):
        ref.reduce(jax_semiring.PLUS_TIMES, "rows")
    with pytest.raises(ValueError, match="cols"):
        mine.reduce(PLUS_TIMES, "rows")


@pytest.mark.parametrize("shape, max_k", [GRIDS[0], GRIDS[2]], ids=[GRID_IDS[0], GRID_IDS[2]])
def test_from_spmat_matches_reference(shape, max_k):
    r, c = pattern(4)
    v = np.random.default_rng(4).integers(1, 50, len(r)).astype(np.float32)
    A = SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, N, N)
    jA = JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, N, N)
    got = EllParMat.from_spmat(A, max_k=max_k)
    want = jax_ellmat.EllParMat.from_spmat(jA, max_k=max_k)
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        for ga, wa in zip(gb, wb):
            np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert (got.nrows, got.ncols) == (N, N)


@pytest.mark.parametrize("case", ["int", "float"])
@pytest.mark.parametrize("max_k", [None, 5])
def test_local_spmm_backends_match_reference(max_k, case):
    """``_ell_local_spmm`` on one tile: ``mxu_gather`` (a batched
    contraction) and ``scatter`` against the reference's, and against
    each other; the row slices of a tiny envelope change nothing."""
    r, _ = pattern(8)
    vals, _, X = data(case, 29, len(r))
    ref, mine = build((1, 1), max_k, vals, seed=8)
    tb = torch_ellmat._tile_buckets(mine, 0, 0)
    jb = [tuple(a[0, 0] for a in bk) for bk in ref.buckets]
    out = {}
    for backend in ("mxu_gather", "scatter"):
        got = torch_ellmat._ell_local_spmm(PLUS_TIMES, tb, torch.from_numpy(X), N, N, backend)
        want = ref_local_spmm(jax_semiring.PLUS_TIMES, jb, jnp.asarray(X), N, N, backend)
        out[backend] = got.numpy()
        if case == "int":
            np.testing.assert_array_equal(out[backend], np.asarray(want))
        else:
            np.testing.assert_allclose(out[backend], np.asarray(want), rtol=1e-5, atol=1e-6)
    if case == "int":
        np.testing.assert_array_equal(out["mxu_gather"], out["scatter"])
    keep = torch_ellmat.SPMV_BUDGET_BYTES
    try:
        torch_ellmat.SPMV_BUDGET_BYTES = 64  # a few rows a slice
        sliced = torch_ellmat._ell_local_spmm(PLUS_TIMES, tb, torch.from_numpy(X), N, N,
                                              "scatter")
    finally:
        torch_ellmat.SPMV_BUDGET_BYTES = keep
    np.testing.assert_allclose(sliced.numpy(), out["scatter"], rtol=1e-6, atol=1e-6)


SEGMENT_CASES = {
    "unsorted-with-empties": (np.array([5, 1, 5, 0, 1, 5, 3, 0, 1]), 8),
    "dropped-ids": (np.array([2, 9, 2, 7, 8, 0, 11, 7]), 8),
    "one": (np.array([4]), 6),
    "empty": (np.array([], np.int64), 4),
    "random": (np.random.default_rng(0).integers(0, 40, 500), 37),
}


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_generic_segment_reduce_matches_reference(name):
    ids, nseg = SEGMENT_CASES[name]
    ids = ids.astype(np.int32)
    vals = np.random.default_rng(len(ids)).integers(0, 2**31 - 1, len(ids)).astype(np.int32)
    got = segment_reduce(BOR, torch.from_numpy(vals), torch.from_numpy(ids), nseg)
    want = ref_segment_reduce(JAX_BOR, jnp.asarray(vals), jnp.asarray(ids), nseg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # [n, F] values: lane by lane the 1-D result
    vals2 = np.stack([vals, vals ^ 0x5555, vals >> 3], axis=1)
    got2 = segment_reduce(BOR, torch.from_numpy(vals2), torch.from_numpy(ids), nseg)
    for k in range(3):
        lane = segment_reduce(BOR, torch.from_numpy(vals2[:, k].copy()), torch.from_numpy(ids),
                              nseg)
        np.testing.assert_array_equal(got2[:, k].numpy(), lane.numpy())


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "select2nd_max"])
def test_native_segment_reduce_takes_lanes(sr_name):
    """The native monoids on [n, F] values: lane by lane the reference."""
    tsr, jsr = SEMIRINGS[sr_name]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 12, 60).astype(np.int32)
    vals = rng.integers(-50, 50, (60, 2)).astype(np.int32)
    got = segment_reduce(tsr, torch.from_numpy(vals), torch.from_numpy(ids), 10)
    for k in range(2):
        want = ref_segment_reduce(jsr, jnp.asarray(vals[:, k]), jnp.asarray(ids), 10)
        np.testing.assert_array_equal(got[:, k].numpy(), np.asarray(want))
