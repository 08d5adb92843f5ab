"""Parity of the port's 3D conversions and column ops with ``combblas_tpu``
on the CPU, the cases of the reference's ``tests/test_mesh3d.py`` that
move tuples between layouts: 3D round trips on both splits, the 2D ↔ 3D
conversions on 2x4 and 4x2, a product on converted operands, the column
ops, and ``resplit3d``. The conversions' retries under starved sizing
are in ``test_torch_mesh3d_route.py``.
The products are in ``test_torch_mesh3d.py``, whose helpers this file
shares; the same comparison rules hold (whole arrays, bit for bit but
plus_times values, within rtol 1e-5 and atol 1e-6).
"""

import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu_torch import MAX_MIN, PLUS_TIMES
from combblas_tpu_torch.parallel import mesh3d as tm
from test_torch_mesh3d import (ATOL, RTOL, SEMIRINGS, arr, both2, both3, grids, random_dense,
                               same_arrays, same_mat2, same_mat3)


@pytest.mark.parametrize("split", ["col", "row"])
def test_3d_roundtrip(split):
    d = random_dense(np.random.default_rng(2), 16, 16, 0.3)
    jA, tA = both3(d, split)
    same_mat3(tA, jA)
    for g, w in zip(tA.to_global_coo(), jA.to_global_coo()):
        same_arrays(g, w)
    np.testing.assert_array_equal(tA.to_dense(), d)
    assert int(tA.getnnz()) == int(jA.getnnz()) == int((d != 0).sum())


@pytest.mark.parametrize("split", ["col", "row"])
@pytest.mark.parametrize("shape2", [(2, 4), (4, 2)])
def test_2d_3d_conversion_roundtrip(split, shape2):
    """2D → 3D → 2D on the device gives the reference's tiles both ways,
    padding and capacities included."""
    d = random_dense(np.random.default_rng(4), 48, 48, 0.15)
    jA, tA = both2(shape2, d)
    jg, tg = grids()
    jA3, tA3 = jm.SpParMat3D.from_spmat(jA, jg, split=split), tm.SpParMat3D.from_spmat(
        tA, tg, split=split)
    same_mat3(tA3, jA3)
    np.testing.assert_array_equal(tA3.to_dense(), d)
    back = tA3.to_spmat(tA.grid)
    same_mat2(back, jA3.to_spmat(jA.grid))
    np.testing.assert_array_equal(back.to_dense(), d)
    assert int(back.getnnz()) == int((d != 0).sum())


def test_3d_conversion_then_spgemm():
    d = random_dense(np.random.default_rng(5), 32, 32, 0.2)
    jA, tA = both2((2, 4), d)
    jg, tg = grids()
    jA3, tA3 = jm.SpParMat3D.from_spmat(jA, jg, "col"), tm.SpParMat3D.from_spmat(tA, tg, "col")
    jB3, tB3 = jm.SpParMat3D.from_spmat(jA, jg, "row"), tm.SpParMat3D.from_spmat(tA, tg, "row")
    same_mat3(tB3, jB3)
    for name in ("plus_times", "max_min"):
        sr, jr = SEMIRINGS[name]
        same_mat3(tm.spgemm3d(sr, tA3, tB3), jm.spgemm3d(jr, jA3, jB3),
                  close=name == "plus_times")
    np.testing.assert_allclose(tm.spgemm3d(PLUS_TIMES, tA3, tB3).to_dense(), d @ d,
                               rtol=RTOL, atol=ATOL)


def test_3d_column_ops_match_reference():
    """``reduce3d_cols``, ``nnz_per_column3d``, ``kselect3d`` (also with a
    per-column k), ``prune_column3d``, ``prune3d``, ``apply3d`` and
    ``dim_apply3d_cols`` against the reference on a converted matrix."""
    import jax.numpy as jnp

    d = random_dense(np.random.default_rng(6), 48, 48, 0.25)
    jA, tA = both2((2, 4), d)
    jg, tg = grids()
    jA3, tA3 = jm.SpParMat3D.from_spmat(jA, jg, "col"), tm.SpParMat3D.from_spmat(tA, tg, "col")
    sums = tm.reduce3d_cols(PLUS_TIMES, tA3)
    np.testing.assert_allclose(arr(sums), arr(jm.reduce3d_cols(jsr.PLUS_TIMES, jA3)),
                               rtol=RTOL, atol=0)
    same_arrays(tm.reduce3d_cols(MAX_MIN, tA3), jm.reduce3d_cols(jsr.MAX_MIN, jA3))
    same_arrays(tm.reduce3d_cols(PLUS_TIMES, tA3, map_fn=lambda v: v * 0 + 1),
                jm.reduce3d_cols(jsr.PLUS_TIMES, jA3, map_fn=lambda v: v * 0 + 1))
    same_arrays(tm.nnz_per_column3d(tA3), jm.nnz_per_column3d(jA3))
    for k in (1, 3):
        same_arrays(tm.kselect3d(tA3, k), jm.kselect3d(jA3, k))
    kvec = np.random.default_rng(7).integers(1, 5, (2, 2, 12)).astype(np.int32)
    th = tm.kselect3d(tA3, 0, kvec=torch.from_numpy(kvec))
    same_arrays(th, jm.kselect3d(jA3, 0, kvec=jnp.asarray(kvec)))
    same_mat3(tm.prune_column3d(tA3, th, keep=lambda v, t: v >= t),
              jm.prune_column3d(jA3, jnp.asarray(arr(th)), keep=lambda v, t: v >= t))
    same_mat3(tm.prune3d(tA3, lambda v: v < 0.5), jm.prune3d(jA3, lambda v: v < 0.5))
    same_mat3(tm.apply3d(tA3, lambda v: v * 3), jm.apply3d(jA3, lambda v: v * 3))
    scaled = tm.dim_apply3d_cols(tA3, sums, lambda v, s: v / torch.where(s != 0, s, 1))
    want = jm.dim_apply3d_cols(jA3, jnp.asarray(arr(sums)),
                               lambda v, s: v / jnp.where(s != 0, s, 1))
    same_mat3(scaled, want)
    cs = scaled.to_dense().sum(axis=0)
    np.testing.assert_allclose(cs[(d != 0).any(axis=0)], 1.0, rtol=RTOL)
    with pytest.raises(ValueError, match="col-split"):
        tm.reduce3d_cols(PLUS_TIMES, tm.resplit3d(tA3, "row"))


def test_resplit3d_roundtrip():
    """``resplit3d`` both ways and ``resplit3d_fixed`` at starved capacities
    (the dropped count) give the reference's tiles."""
    d = random_dense(np.random.default_rng(10), 32, 32, 0.2)
    jA, tA = both2((2, 4), d)
    jg, tg = grids()
    jA3, tA3 = jm.SpParMat3D.from_spmat(jA, jg, "col"), tm.SpParMat3D.from_spmat(tA, tg, "col")
    jR, tR = jm.resplit3d(jA3, "row"), tm.resplit3d(tA3, "row")
    assert tR.split == "row"
    same_mat3(tR, jR)
    np.testing.assert_array_equal(tR.to_dense(), d)
    same_mat3(tm.resplit3d(tR, "col"), jm.resplit3d(jR, "col"))
    assert tm.resplit3d(tR, "row") is tR
    for caps in ((4, 16), (64, 8)):
        got, gd = tm.resplit3d_fixed(tA3, "row", stage_capacity=caps[0], tile_capacity=caps[1])
        want, wd = jm.resplit3d_fixed(jA3, "row", stage_capacity=caps[0],
                                      tile_capacity=caps[1])
        assert int(gd) == int(wd) > 0
        same_mat3(got, want)
