"""Parity of the port's application and layer sites with
``combblas_tpu``'s on the CPU: Graph500 kernel 1 and ``redistribute``, the
SpMV dispatch counts, ``summa_spmm``, the triangle count's edge harvest
and MCL's loops, compared as in ``test_torch_obs_spgemm.py``. MCL's chaos
events fold float sums in another order and are compared within float32
rounding; ``connected_components`` (under MCL) counts ``spmv.dispatch``
once a trace in the reference and once a call here, so that series is left
out of MCL's comparison.
"""

import jax
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.models import graph500 as jg500
from combblas_tpu.models import mcl as jmcl
from combblas_tpu.models import tc as jtc
from combblas_tpu.parallel import redistribute as jred
from combblas_tpu.parallel import spmm as jspmm
from combblas_tpu.parallel import spmv as jspmv
from combblas_tpu.parallel.dense import DenseParMat as JaxDense
from combblas_tpu.parallel.ellmat import EllParMat as JaxEll
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import PLUS_TIMES, DenseParMat, DistVec, EllParMat, Grid, key_from_jax
from combblas_tpu_torch.models import graph500 as tg500
from combblas_tpu_torch.models import mcl as tmcl
from combblas_tpu_torch.models import tc as ttc
from combblas_tpu_torch.parallel import redistribute as tred
from combblas_tpu_torch.parallel import spmm as tspmm
from combblas_tpu_torch.parallel import spmv as tspmv
from torch_obs_parity import SR, clean, graph, mats, run_both, tobs


@pytest.fixture(autouse=True)
def _clean():
    with clean():
        yield


# --- the apps and the layers under them -------------------------------------------------


def test_redistribute_and_kernel1_sites():
    jg, tg = JaxGrid.make(2, 2), Grid.make(2, 2, device="cpu")
    k = jax.random.key(3)
    tk = key_from_jax(np.asarray(jax.random.key_data(k)))
    run_both(lambda: jg500.kernel1_device(jg, 6, 4, k),
             lambda: tg500.kernel1_device(tg, 6, 4, tk))
    assert tobs.registry.get_histogram("k1.generate_s")["count"] == 1
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 40, (2, 2, 30)).astype(np.int32)
    cols = rng.integers(0, 40, (2, 2, 30)).astype(np.int32)
    vals = np.ones((2, 2, 30), np.float32)
    for slack in (2.0, 0.3):  # the second one drops and retries
        run_both(lambda: jred.from_device_coo(jg, rows, cols, vals, 40, 40, slack=slack),
                 lambda: tred.from_device_coo(tg, torch.from_numpy(rows),
                                              torch.from_numpy(cols), torch.from_numpy(vals),
                                              40, 40, slack=slack))
    assert tobs.registry.get_counter("redistribute.retries") >= 1


def test_spmv_spmm_and_tc_sites():
    d = graph(7, n=40, density=0.12, weights=False)
    d = np.maximum(d, d.T)
    np.fill_diagonal(d, 0)
    jA, tA = mats((2, 2), d)
    sr, jsr_ = SR["select2nd_max"]
    x = np.arange(40, dtype=np.int32)
    act = (np.arange(40) % 3 == 0)
    jx = JaxDistVec.from_global(jA.grid, x, align="col")
    tx = DistVec.from_global(tA.grid, x, align="col")
    ja = JaxDistVec.from_global(jA.grid, act, align="col")
    ta = DistVec.from_global(tA.grid, act, align="col")
    ju = JaxDistVec.from_global(jA.grid, ~act, align="row")
    tu = DistVec.from_global(tA.grid, ~act, align="row")
    jE = JaxEll.from_host_coo(jA.grid, *np.nonzero(d), d[np.nonzero(d)], 40, 40)
    tE = EllParMat.from_host_coo(tA.grid, *np.nonzero(d), d[np.nonzero(d)], 40, 40)
    run_both(lambda: (jspmv.dist_spmv(jsr_, jA, jx), jspmv.dist_spmv_masked(jsr_, jA, jx, ju),
                      jspmv.dist_spmv(jsr_, jE, jx), jspmv.dist_spmspv(jsr_, jA, jx, ja),
                      jspmv.dist_spmspv_masked(jsr_, jA, jx, ja, ju, frontier_capacity=40,
                                               exp_capacity=400)),
             lambda: (tspmv.dist_spmv(sr, tA, tx), tspmv.dist_spmv_masked(sr, tA, tx, tu),
                      tspmv.dist_spmv(sr, tE, tx), tspmv.dist_spmspv(sr, tA, tx, ta),
                      tspmv.dist_spmspv_masked(sr, tA, tx, ta, tu, frontier_capacity=40,
                                               exp_capacity=400)))
    assert tobs.registry.get_counter("spmv.dispatch", kernel="dist_spmspv") == 1
    X = np.random.default_rng(8).integers(0, 4, (40, 8)).astype(np.float32)
    jX, tX = JaxDense.from_global(jA.grid, X), DenseParMat.from_global(tA.grid, X)
    for ring in (False, True):
        run_both(lambda: jspmm.summa_spmm(jsr.PLUS_TIMES, jA, jX, ring=ring),
                 lambda: tspmm.summa_spmm(PLUS_TIMES, tA, tX, ring=ring))
    jT, tT = mats((1, 1), d)
    run_both(lambda: jtc.triangle_count(jT, "edgeharvest"),
             lambda: ttc.triangle_count(tT, "edgeharvest"))
    assert tobs.registry.get_counter("spgemm.auto.tier", tier="edgeharvest",
                                     sr="plus_times") == 1


def _cliques(k=3, size=6, w=0.1):
    n = k * size
    d = np.zeros((n, n), np.float32)
    for b in range(k):
        d[b * size:(b + 1) * size, b * size:(b + 1) * size] = 1
    np.fill_diagonal(d, 0)
    for b in range(k):
        i, j = b * size + size - 1, ((b + 1) % k) * size
        d[i, j] = d[j, i] = w
    return d


@pytest.mark.parametrize("loop", [dict(max_iters=3), dict(chaos_every=2, max_iters=4),
                                  dict(expansion="dense", dense_mode="f32")],
                         ids=["sparse", "block", "dense"])
def test_mcl_sites(loop):
    d = _cliques()
    shape = (2, 2) if loop.get("chaos_every") else (1, 1)
    jA, tA = mats(shape, d)
    # connected_components counts spmv.dispatch once a trace in the
    # reference, once a call here: not an mcl site
    run_both(lambda: jmcl.mcl(jA, inflation=2.0, **loop),
             lambda: tmcl.mcl(tA, inflation=2.0, **loop), approx=True,
             drop=("spmv.dispatch",))
