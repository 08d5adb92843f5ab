"""Parity of the port's layered route with ``combblas_tpu`` on the CPU: the
router cases of the reference's ``tests/test_spgemm_auto.py``
(``choose_spgemm_tier(grid3=)`` answers ``windowed3d`` only for a
compatible layered grid; ``spgemm_auto(tier="windowed3d", grid3=)`` equals
the reference and the 2D windowed tier, and fails without ``grid3`` as the
reference does), and the conversions it rides under starved sizing: the
retries double the capacities to the reference's, and with no retry left
both packages raise with the last attempt's drop count.

Comparisons are bit for bit (integer values): tiles with their padding,
``nnz``, capacities and raises.
"""

import numpy as np
import pytest

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu_torch import PLUS_TIMES, Grid, SpParMat
from combblas_tpu_torch.parallel import mesh3d as tm
from combblas_tpu_torch.parallel import spgemm as tpar
from test_torch_mesh3d import both2, grids, random_dense, same_mat2, same_mat3
from test_torch_mesh3d_merge import SEMIRINGS, SLOW, canon, same_canon, same_tiles


def coo(rng, m, k, nnz, dup_frac=0.0):
    r = rng.integers(0, m, nnz).astype(np.int64)
    c = rng.integers(0, k, nnz).astype(np.int64)
    v = rng.integers(1, 4, nnz).astype(np.float32)
    ndup = int(nnz * dup_frac)
    return tuple(np.concatenate([x, x[:ndup]]) for x in (r, c, v))


def test_router_upgrades_windowed_to_3d(monkeypatch):
    """``choose_spgemm_tier(grid3=)`` answers ``windowed3d`` where the 2D
    rule says windowed and the layered grid fits the product, and keeps the
    2D tier where the layout does not divide over the layers, as the
    reference does (``MXU_MAX_TILE_DIM`` patched to 32 in both)."""
    monkeypatch.setattr(tpar, "MXU_MAX_TILE_DIM", 32)
    monkeypatch.setattr(jpar, "MXU_MAX_TILE_DIM", 32)
    rng = np.random.default_rng(0)
    m = 96
    r, c, v = coo(rng, m, m, 2000)
    jg3, tg3 = jm.Grid3D.make(2, 2, 2), tm.Grid3D.make(2, 2, 2, device="cpu")
    for n, rr, cc in ((96, r, c), (98, np.minimum(r, 97), np.minimum(c, 97))):
        jA = JaxSpParMat.from_global_coo(JaxGrid.make(1, 1), rr, cc, v, n, n)
        tA = SpParMat.from_global_coo(Grid.make(1, 1, device="cpu"), rr, cc, v, n, n)
        for g3 in ((None, None), (jg3, tg3), (jm.Grid3D.make(1, 2, 2),
                                              tm.Grid3D.make(1, 2, 2, device="cpu"))):
            want = jpar.choose_spgemm_tier(jsr.PLUS_TIMES, jA, jA, backend="scatter",
                                           grid3=g3[0])
            assert tpar.choose_spgemm_tier(PLUS_TIMES, tA, tA, backend="scatter",
                                           grid3=g3[1]) == want
        assert tpar.choose_spgemm_tier(PLUS_TIMES, tA, tA, backend="scatter",
                                       grid3=tg3) == ("windowed3d" if n == 96 else "windowed")
    assert not tm.summa3d_compatible(tg3, 98, 98, 98)
    assert not tm.summa3d_compatible(tm.Grid3D.make(2, 2, 1, device="cpu"), 96, 96, 96)


@pytest.mark.parametrize("backend,srname", [("dot", "plus_times"), ("scatter", "min_plus"),
                                            pytest.param("dot", "min_plus", marks=SLOW)])
def test_spgemm_auto_3d_matches_reference(backend, srname):
    """The layered route (2D → 3D → per-layer windowed SUMMA → fiber merge
    → 2D) gives the reference's 2D tiles and the 2D windowed tier's
    entries; forced without ``grid3`` it fails in both packages."""
    sr, jr = SEMIRINGS[srname]
    rng = np.random.default_rng(5)
    m = 64
    r, c, v = coo(rng, m, m, 900, dup_frac=0.1)
    jA = JaxSpParMat.from_global_coo(JaxGrid.make(2, 2), r, c, v, m, m)
    tA = SpParMat.from_global_coo(Grid.make(2, 2, device="cpu"), r, c, v, m, m)
    jg3, tg3 = jm.Grid3D.make(2, 2, 2), tm.Grid3D.make(2, 2, 2, device="cpu")
    kw = dict(tier="windowed3d", backend=backend, block_rows=16, block_cols=16)
    got = tpar.spgemm_auto(sr, tA, tA, grid3=tg3, **kw)
    want = jpar.spgemm_auto(jr, jA, jA, grid3=jg3, interpret=True, **kw)
    assert got.capacity == want.capacity
    same_tiles(got, want)
    ref = tpar.spgemm_auto(sr, tA, tA, tier="windowed", block_rows=16)
    same_canon(canon(got), canon(ref))
    with pytest.raises(AssertionError, match="grid3"):
        jpar.spgemm_auto(jr, jA, jA, tier="windowed3d")
    with pytest.raises(ValueError, match="needs a grid3"):
        tpar.spgemm_auto(sr, tA, tA, tier="windowed3d")


def test_conversion_retries_match_reference():
    """Starved sizing (slack 0.3): the first attempts drop and the retries
    reach the reference's capacities and tiles; with no retry left both
    packages raise with the same drop count."""
    d = random_dense(np.random.default_rng(10), 32, 32, 0.2)
    jA, tA = both2((2, 4), d)
    jg, tg = grids()
    jA3, tA3 = jm.SpParMat3D.from_spmat(jA, jg, "col"), tm.SpParMat3D.from_spmat(tA, tg, "col")
    same_mat3(tm.resplit3d(tA3, "row", slack=0.3), jm.resplit3d(jA3, "row", slack=0.3))
    same_mat3(tm.SpParMat3D.from_spmat(tA, tg, "row", slack=0.3),
              jm.SpParMat3D.from_spmat(jA, jg, "row", slack=0.3))
    same_mat2(tA3.to_spmat(tA.grid, slack=0.3), jA3.to_spmat(jA.grid, slack=0.3))
    for want_fn, got_fn in (
            (lambda: jm.SpParMat3D.from_spmat(jA, jg, "row", slack=0.3, max_retries=0),
             lambda: tm.SpParMat3D.from_spmat(tA, tg, "row", slack=0.3, max_retries=0)),
            (lambda: jm.resplit3d(jA3, "row", slack=0.3, max_retries=0),
             lambda: tm.resplit3d(tA3, "row", slack=0.3, max_retries=0)),
            (lambda: jA3.to_spmat(jA.grid, slack=0.3, max_retries=0),
             lambda: tA3.to_spmat(tA.grid, slack=0.3, max_retries=0))):
        with pytest.raises(ValueError) as want:
            want_fn()
        with pytest.raises(ValueError, match=str(want.value)):
            got_fn()
