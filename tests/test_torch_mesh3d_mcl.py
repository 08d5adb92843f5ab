"""Parity of the port's 3D Markov clustering (``mcl(layers > 1)``) with
``combblas_tpu`` on the CPU: the 3D column helpers (``make_col_stochastic3d``,
``chaos3d``, ``inflate3d``, ``mcl_prune_recovery_select3d``, the block
capacities) on one 3D matrix, and ``mcl(layers=2, grid3=Grid3D.make(2, 2,
2))``: labels and iteration count equal to the reference's and to the 2D
loop's labels. The plain 3D loop is tier 1; the block loop
(``chaos_every``) and the default layered grid of a 2x2 matrix run under
``-m slow``, as the reference's own 3D MCL tests do (their compiles take
20-40 s).

Values are held within rtol 1e-6 (column sums fold in another order), the
chaos within rtol 1e-5 and atol 1e-7; layouts, thresholds, capacities,
labels and iteration counts exactly.
"""

import numpy as np
import pytest

from combblas_tpu.models import mcl as jmcl
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu_torch import Grid, SpParMat
from combblas_tpu_torch.models import mcl as tmcl
from combblas_tpu_torch.parallel import mesh3d as tm


def bridged_cliques():
    """Two 8-cliques joined by one 0.1 edge (the reference's 3D test graph)."""
    d = np.zeros((16, 16), np.float32)
    d[:8, :8] = d[8:, 8:] = 1.0
    d[7, 8] = d[8, 7] = 0.1
    np.fill_diagonal(d, 0)
    return d


def both2(shape, d):
    return (JaxSpParMat.from_dense(JaxGrid.make(*shape), d),
            SpParMat.from_dense(Grid.make(*shape, device="cpu"), d))


def grids():
    return jm.Grid3D.make(2, 2, 2), tm.Grid3D.make(2, 2, 2, device="cpu")


def arr(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def same_layout(got, want):
    assert got.capacity == want.rows.shape[3]
    for f in ("rows", "cols", "nnz"):
        np.testing.assert_array_equal(arr(getattr(got, f)), arr(getattr(want, f)))


def test_3d_helpers_match_reference():
    rng = np.random.default_rng(0)
    d = (rng.random((32, 32)) * (rng.random((32, 32)) < 0.4)).astype(np.float32)
    jA, tA = both2((2, 4), d)
    jg, tg = grids()
    jA3, tA3 = jm.SpParMat3D.from_spmat(jA, jg, "col"), tm.SpParMat3D.from_spmat(tA, tg, "col")
    jS, tS = jmcl.make_col_stochastic3d(jA3), tmcl.make_col_stochastic3d(tA3)
    same_layout(tS, jS)
    np.testing.assert_allclose(arr(tS.vals), arr(jS.vals), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(tmcl.chaos3d(tS)), float(jmcl.chaos3d(jS)), rtol=1e-5,
                               atol=1e-7)
    jI, tI = jmcl.inflate3d(jS, 2.0), tmcl.inflate3d(tS, 2.0)
    same_layout(tI, jI)
    np.testing.assert_allclose(arr(tI.vals), arr(jI.vals), rtol=1e-6, atol=0)
    # the sparsifier fed the same arrays: thresholds and layouts exact
    tS = tm.SpParMat3D(rows=tS.rows, cols=tS.cols, vals=tS.vals.new_tensor(arr(jS.vals)),
                       nnz=tS.nnz, nrows=tS.nrows, ncols=tS.ncols, split="col", grid=tg)
    for kw in (dict(hard_threshold=0.0, select_num=3, recover_num=5, recover_pct=0.0),
               dict(hard_threshold=0.03, select_num=2, recover_num=4, recover_pct=0.9)):
        for gate in (False, True):
            got = tmcl.mcl_prune_recovery_select3d(tS, device_gate=gate, **kw)
            want = jmcl.mcl_prune_recovery_select3d(jS, device_gate=gate, **kw)
            same_layout(got, want)
            np.testing.assert_array_equal(arr(got.vals), arr(want.vals))
    jB, tB = jm.resplit3d(jS, "row"), tm.resplit3d(tS, "row")
    assert tmcl._mcl3d_block_caps(tS, tB) == jmcl._mcl3d_block_caps(jS, jB)


def check_mcl3d(shape, explicit_grid: bool, layers: int = 2, **kw):
    """``mcl(layers=...)`` in both packages (on ``grids()`` when
    ``explicit_grid``): the same labels and iterations, converged, and the
    2D loop's labels. Returns the port's ``mcl.last_run``."""
    jA, tA = both2(shape, bridged_cliques())
    jg, tg = grids() if explicit_grid else (None, None)
    jl, jit, _ = jmcl.mcl(jA, inflation=2.0, layers=layers, grid3=jg, **kw)
    tl, tit, tch = tmcl.mcl(tA, inflation=2.0, layers=layers, grid3=tg, **kw)
    run = tmcl.mcl.last_run
    np.testing.assert_array_equal(arr(tl.blocks), arr(jl.blocks))
    assert tit == int(jit) and tch < 1e-3
    l2, _, _ = tmcl.mcl(tA, inflation=2.0)
    np.testing.assert_array_equal(tl.to_global(), l2.to_global())
    assert len(np.unique(tl.to_global())) == 2
    return run


def test_mcl_3d_matches_reference():
    run = check_mcl3d((2, 2), True)
    assert run["loop"] == "3d"


@pytest.mark.slow
def test_mcl_3d_chaos_every_matches_reference():
    run = check_mcl3d((2, 2), True, chaos_every=3)
    assert run["loop"] == "3d_block"


@pytest.mark.slow
def test_mcl_3d_default_grid_matches_reference():
    """A 2x2 matrix with ``layers=4`` and no ``grid3`` runs on 4x1x1."""
    assert check_mcl3d((2, 2), False, layers=4)["loop"] == "3d"
