"""Parity of the port's ``SpParMat`` operations with
``combblas_tpu.parallel.spmat`` on the CPU: ``apply``, ``prune``,
``keep_ij`` / ``tril`` / ``triu`` / ``remove_loops``, ``reduce`` on both
axes, ``transpose`` (square grids) and ``dim_apply`` on both axes, on 1x1,
2x2 and 2x4 grids. Tiles are compared array for array (padding slots
included), floats by their bits (NaN cells by position); ``reduce`` with
``plus_times`` on random float32 within ``rtol=1e-5, atol=1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import spmat as jax_spmat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    DistVec,
    Grid,
    SpParMat,
    ones_f32,
    ones_i32,
)

M, N = 23, 19
GRIDS = [(1, 1), (2, 2), (2, 4)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]
SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3], np.float32)


# module-level callbacks: the reference compiles one program per callback
def j_affine(v):
    return v * 2 - 1


def t_affine(v):
    return v * 2 - 1


def j_negative(v):
    return v < 0


def t_negative(v):
    return v < 0


def j_mul(a, s):
    return a * s


def j_sub(a, s):
    return a - s


def t_mul(a, s):
    return a * s


def t_sub(a, s):
    return a - s


def j_band(r, c):
    return (r - c) % 3 == 0


def t_band(r, c):
    return (r - c) % 3 == 0


def build(shape, seed=0, m=M, n=N, vals="ints"):
    rng = np.random.default_rng(seed)
    d = rng.random((m, n)) < 0.25
    np.fill_diagonal(d[: min(m, n), : min(m, n)], True)  # a full diagonal
    d[4] = False
    r, c = np.nonzero(d)
    if vals == "specials":
        v = rng.choice(SPECIALS, len(r))
    elif vals == "float":
        v = rng.uniform(-1, 1, len(r)).astype(np.float32)
    else:
        v = rng.integers(-5, 6, len(r)).astype(np.float32)
    return (JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, m, n),
            SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, m, n))


def assert_same(got, want, tol=False):
    g = got.cpu().numpy()
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    if tol:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    elif g.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g[~np.isnan(w)].view(np.int32),
                                      w[~np.isnan(w)].view(np.int32))
    else:
        np.testing.assert_array_equal(g, w)


def assert_same_mat(got, want):
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    for f in ("rows", "cols", "vals", "nnz"):
        assert_same(getattr(got, f), getattr(want, f))


def assert_same_vec(got, want, tol=False):
    assert (got.length, got.align) == (want.length, want.align)
    assert_same(got.blocks, want.blocks, tol)


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_apply_and_prune(shape):
    ref, mine = build(shape, 1)
    assert_same_mat(mine.apply(t_affine), ref.apply(j_affine))
    assert_same_mat(mine.apply(ones_i32), ref.apply(jax_spmat.ones_i32))
    assert_same_mat(mine.prune(t_negative), ref.prune(j_negative))


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_keep_ij_and_triangles(shape):
    """Predicates see global ids: the tiles' offsets are added in."""
    ref, mine = build(shape, 2)
    assert_same_mat(mine.keep_ij(t_band), ref.keep_ij(j_band))
    for strict in (True, False):
        assert_same_mat(mine.tril(strict), ref.tril(strict))
        assert_same_mat(mine.triu(strict), ref.triu(strict))
    assert_same_mat(mine.remove_loops(), ref.remove_loops())
    dense = mine.to_dense()
    np.testing.assert_array_equal(mine.tril().to_dense(), np.tril(dense, -1))
    off_diag = dense.copy()
    np.fill_diagonal(off_diag, 0)
    np.testing.assert_array_equal(mine.remove_loops().to_dense(), off_diag)


REDUCE_CASES = [("plus_times", "ints", None), ("plus_times", "ints", "ones_i32"),
                ("plus_times", "ints", "ones_f32"), ("plus_times", "float", None),
                ("min_plus", "specials", None), ("max_min", "specials", None),
                ("select2nd_max", "ints", "ones_i32")]


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("case", REDUCE_CASES, ids=["-".join(map(str, c)) for c in REDUCE_CASES])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_reduce(shape, case, axis):
    """Folds per tile, then over the grid axis (``axis="rows"`` combines
    down each grid column, ``"cols"`` along each grid row)."""
    srs = {"plus_times": (PLUS_TIMES, jsr.PLUS_TIMES), "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
           "max_min": (MAX_MIN, jsr.MAX_MIN),
           "select2nd_max": (SELECT2ND_MAX, jsr.SELECT2ND_MAX)}
    maps = {None: (None, None), "ones_i32": (ones_i32, jax_spmat.ones_i32),
            "ones_f32": (ones_f32, jax_spmat.ones_f32)}
    name, vals, fn = case
    tsr, jsr_ = srs[name]
    tmap, jmap = maps[fn]
    ref, mine = build(shape, 3, vals=vals)
    assert_same_vec(mine.reduce(tsr, axis, map_fn=tmap), ref.reduce(jsr_, axis, map_fn=jmap),
                    tol=vals == "float")


def test_reduce_rejects_an_unknown_axis():
    _, mine = build((1, 1))
    with pytest.raises(ValueError, match="axis"):
        mine.reduce(PLUS_TIMES, "diag")


@pytest.mark.parametrize("dims", [(M, M), (M, N)], ids=["square", "rectangular"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_transpose(shape, dims):
    ref, mine = build(shape, 4, *dims)
    got, want = mine.transpose(), ref.transpose()
    assert_same_mat(got, want)
    np.testing.assert_array_equal(got.to_dense(), mine.to_dense().T)


def test_transpose_needs_a_square_grid():
    _, mine = build((2, 4))
    with pytest.raises(ValueError, match="square grid"):
        mine.transpose()


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_dim_apply(shape, axis):
    """``fn(val, vec[j])`` (``"cols"``) or ``fn(val, vec[i])`` (``"rows"``),
    the vector taken in the other alignment first."""
    ref, mine = build(shape, 5)
    length = N if axis == "cols" else M
    x = np.random.default_rng(6).integers(-3, 4, length).astype(np.float32)
    align = "row" if axis == "cols" else "col"  # realigned inside
    jv = JaxDistVec.from_global(ref.grid, x, align=align)
    tv = DistVec.from_global(mine.grid, x, align=align)
    assert_same_mat(mine.dim_apply(tv, t_mul, axis), ref.dim_apply(jv, j_mul, axis))
    assert_same_mat(mine.dim_apply(tv, t_sub, axis), ref.dim_apply(jv, j_sub, axis))


def test_ones_maps_keep_the_shape_and_dtype():
    v = torch.arange(5, dtype=torch.float32)
    assert ones_i32(v).dtype == torch.int32 and ones_f32(v).dtype == torch.float32
    np.testing.assert_array_equal(ones_i32(v).numpy(), np.asarray(jax_spmat.ones_i32(jnp.zeros(5))))
