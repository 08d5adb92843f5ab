"""Parity of the port's triangle counting, betweenness centrality and
``DenseParMat`` with ``combblas_tpu`` on the CPU.

TC: every kernel (``_tc_dense``, ``_tc_edge_harvest``,
``_tc_edge_harvest_bits``, ``_tc_edge_harvest_dist`` on 2x2, ``sparse`` on
1x1 and 2x2) and ``triangle_count``'s routing, on an R-MAT graph whose COO
repeats entries, and on a graph holding a 300-vertex clique (edge counts
of 298: a bf16 sum would round them). Counts and the kernels' (hi, lo)
splits are exact.

BC: ``bc_batch`` (the SpGEMM form) and ``betweenness_centrality`` on 1x1
and 2x2, ``bc_batch_dense`` and ``bc_batch_dense_lanes`` on the ELL form
(directed, with ``PAD_ROOT`` lanes and a depth bound), against the
reference within ``rtol=1e-5`` and ``atol = 1e-6 · max |score|`` (float
sums fold in another order), and against a float64 Brandes.

``DenseParMat``: construction, the elementwise and sparse-interplay ops
and ``reduce`` on 1x1, 2x2 and 2x4, exact (integer-valued float32, min and
max on specials).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.models import bc as jbc
from combblas_tpu.models import tc as jtc
from combblas_tpu.parallel.dense import DenseParMat as JaxDense
from combblas_tpu.parallel.ellmat import EllParMat as JaxEll
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.utils.rmat import rmat_symmetric_coo_host as jax_rmat
from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PAD_ROOT,
    PLUS_TIMES,
    DenseParMat,
    EllParMat,
    Grid,
    SpParMat,
    bc_batch,
    bc_batch_dense,
    bc_batch_dense_lanes,
    betweenness_centrality,
    denseparmat_from_arrays,
    triangle_count,
)
from combblas_tpu_torch.models import tc as ttc

GRIDS = [(1, 1), (2, 2), (2, 4)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]
SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3], np.float32)


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


def assert_close_scores(got, want):
    """The BC tolerance: rtol 1e-5, atol 1e-6 of the largest score."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(np.abs(want).max(), 1.0))


def both(shape, r, c, v, n):
    return (JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, n, n),
            SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, n, n))


def rmat_graph(scale=7, seed=3):
    """A symmetric R-MAT graph; its COO repeats entries and holds loops."""
    r, c = jax_rmat(seed, scale, 8)
    return r, c, np.ones(len(r), np.float32), 1 << scale


def clique_graph(k=300, n=320, seed=0):
    """A k-clique on the first k vertices and a few random edges: C(k, 3)
    triangles and more; unique entries, no loops."""
    d = np.zeros((n, n), bool)
    d[:k, :k] = True
    rng = np.random.default_rng(seed)
    extra = rng.random((n, n)) < 0.02
    d |= extra | extra.T
    np.fill_diagonal(d, False)
    r, c = np.nonzero(d)
    return r, c, np.ones(len(r), np.float32), n


def host_triangles(r, c, n):
    d = np.zeros((n, n), np.int64)
    d[r, c] = 1
    np.fill_diagonal(d, 0)
    low = np.tril(d, -1)
    return int(((low @ low) * low).sum())


# --- triangle counting ---------------------------------------------------------


@pytest.mark.parametrize("case", ["rmat", "clique"])
def test_tc_local_kernels_match_reference(case):
    """The three one-tile kernels' (hi, lo) splits equal the reference's,
    and every kernel counts the host's triangles."""
    r, c, v, n = rmat_graph() if case == "rmat" else clique_graph()
    jA, tA = both((1, 1), r, c, v, n)
    want = host_triangles(r, c, n)
    if case == "clique":
        assert want >= 300 * 299 * 298 // 6
    tt = tA.local_tile(0, 0)
    jr, jc = jnp.asarray(np.asarray(jA.rows)[0, 0]), jnp.asarray(np.asarray(jA.cols)[0, 0])
    for tfn, jfn in ((ttc._tc_dense, jtc._tc_dense),
                     (ttc._tc_edge_harvest, jtc._tc_edge_harvest),
                     (ttc._tc_edge_harvest_bits, jtc._tc_edge_harvest_bits)):
        got = tfn(tt.rows, tt.cols, n)
        assert_same(got, jfn(jr, jc, n))
        total = ttc.combine_hilo(got)
        assert (total if tfn is ttc._tc_dense else total // 3) == want
    for kernel in ("auto", "dense", "edgeharvest", "edgeharvest_bf16"):
        assert triangle_count(tA, kernel) == want


def test_tc_sparse_and_distributed_match_reference():
    """``sparse`` (masked SpGEMM) on 1x1 and 2x2 and the distributed edge
    harvest on 2x2 (``auto`` picks it: 64 local columns, word-aligned)."""
    r, c, v, n = rmat_graph()
    uniq = np.unique(r.astype(np.int64) * n + c)  # sparse needs unique entries
    ru, cu = uniq // n, uniq % n
    want = host_triangles(r, c, n)
    for shape in ((1, 1), (2, 2)):
        jA, tA = both(shape, ru, cu, np.ones(len(ru), np.float32), n)
        assert triangle_count(tA, "sparse") == jtc.triangle_count(jA, "sparse") == want
    jD, tD = both((2, 2), r, c, v, n)  # the repeated COO: harvested once
    assert_same(ttc._tc_edge_harvest_dist(tD), jtc._tc_edge_harvest_dist(jD))
    assert triangle_count(tD) == jtc.triangle_count(jD) == want
    with pytest.raises(ValueError, match="edgeharvest' only"):
        triangle_count(tD, "edgeharvest_bf16")
    _, t24 = both((2, 4), ru, cu, np.ones(len(ru), np.float32), n)
    with pytest.raises(ValueError, match="square grid"):  # routed to sparse: SUMMA
        triangle_count(t24)


# --- betweenness centrality ---------------------------------------------------------


def _bc_graph(n=40, seed=5, directed=False):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)) < 0.1
    if not directed:
        d |= d.T
    np.fill_diagonal(d, False)
    return np.nonzero(d)


def brandes64(r, c, n, sources):
    """Float64 Brandes, level by level (entry (i, j) = edge j -> i):
    per-source dependency vectors [n, W], sources' own entries zero."""
    adj = np.zeros((n, n))
    adj[r, c] = 1.0
    out = np.zeros((n, len(sources)))
    for k, s in enumerate(sources):
        lvl = np.full(n, -1)
        sig = np.zeros(n)
        lvl[s], sig[s] = 0, 1.0
        d = 0
        while True:
            arriving = adj @ np.where(lvl == d, sig, 0)
            new = (arriving > 0) & (lvl < 0)
            if not new.any():
                break
            lvl[new], sig[new] = d + 1, arriving[new]
            d += 1
        delta = np.zeros(n)
        for dd in range(d, 0, -1):
            w = np.where(lvl == dd, (1 + delta) / np.maximum(sig, 1e-300), 0)
            delta += np.where(lvl == dd - 1, (adj.T @ w) * sig, 0)
        delta[s] = 0
        out[:, k] = delta
    return out


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_bc_batch_matches_reference(shape):
    r, c = _bc_graph()
    n = 40
    jA, tA = both(shape, r, c, np.ones(len(r), np.float32), n)
    srcs = np.array([0, 7, 19, 33])
    got = bc_batch(tA, srcs)
    assert_close_scores(got.to_global(), jbc.bc_batch(jA, srcs).to_global())
    assert_close_scores(got.to_global(), brandes64(r, c, n, srcs).sum(1))
    run = bc_batch.last_run
    assert run["readbacks"] == run["levels"] and len(run["forward_capacities"]) == run["levels"]
    two = betweenness_centrality(tA, batch_size=2, sources=srcs, normalize=True).to_global()
    assert_close_scores(two, jbc.betweenness_centrality(jA, batch_size=2, sources=srcs,
                                                       normalize=True).to_global())
    if shape == (1, 1):  # every source, in batches: a float64 Brandes
        full = betweenness_centrality(tA, batch_size=16).to_global()
        assert_close_scores(full, brandes64(r, c, n, np.arange(n)).sum(1))


def test_bc_batch_dense_matches_reference():
    """The dense-lane form on a directed ELL pair (E, Eᵀ) on 2x2, with a
    PAD_ROOT lane (all zero) and a depth bound that cuts the sweep; the
    lanes against a float64 Brandes."""
    n = 40
    r, c = _bc_graph(n, seed=6, directed=True)
    v = np.ones(len(r), np.float32)
    grid, jgrid = Grid.make(2, 2, device="cpu"), JaxGrid.make(2, 2)
    E = EllParMat.from_host_coo(grid, r, c, v, n, n)
    ET = EllParMat.from_host_coo(grid, c, r, v, n, n)
    jE = JaxEll.from_host_coo(jgrid, r.astype(np.int64), c.astype(np.int64), v, n, n)
    jET = JaxEll.from_host_coo(jgrid, c.astype(np.int64), r.astype(np.int64), v, n, n)
    srcs = np.array([0, 3, PAD_ROOT, 17], np.int32)
    lanes = bc_batch_dense_lanes(E, ET, srcs)
    want = np.asarray(jbc.bc_batch_dense_lanes(jE, jET, jnp.asarray(srcs)).to_global())
    assert_close_scores(lanes.to_global(), want)
    assert not lanes.to_global()[:, 2].any()
    live = [0, 1, 3]
    assert_close_scores(lanes.to_global()[:, live], brandes64(r, c, n, srcs[live]))
    assert bc_batch_dense_lanes.last_run["readbacks"] >= 1
    for depth in (None, 2):
        got = bc_batch_dense(E, ET, srcs, max_depth=depth).to_global()
        assert_close_scores(got, jbc.bc_batch_dense(jE, jET, jnp.asarray(srcs),
                                                    max_depth=depth).to_global())
    # the SpGEMM form agrees on the same directed graph
    _, tA = both((2, 2), r, c, v, n)
    keep = srcs != PAD_ROOT
    assert_close_scores(bc_batch(tA, srcs[keep]).to_global(),
                        bc_batch_dense(E, ET, srcs).to_global())


# --- DenseParMat ---------------------------------------------------------------------


def keep_zero(s, d):
    return d == 0


def scale_by(s, d):
    return s * d


def comb_max(cur, s):
    return torch.maximum(cur, s)


def jcomb_max(cur, s):
    return jnp.maximum(cur, s)


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_denseparmat_matches_reference(shape):
    m, n = 13, 11
    rng = np.random.default_rng(4)
    dense = rng.integers(-3, 4, (m, n)).astype(np.float32)
    jD = JaxDense.from_global(JaxGrid.make(*shape), dense)
    tD = DenseParMat.from_global(Grid.make(*shape, device="cpu"), dense)
    assert_same(tD.blocks, jD.blocks)
    np.testing.assert_array_equal(tD.to_global(), dense)
    assert_same(denseparmat_from_arrays(tD.grid, np.asarray(jD.blocks), m, n).blocks, jD.blocks)
    z = DenseParMat.zeros(tD.grid, m, n)
    assert_same(z.blocks, JaxDense.zeros(jD.grid, m, n).blocks)
    d = rng.random((m, n)) < 0.4
    r, c = np.nonzero(d)
    v = rng.integers(1, 5, len(r)).astype(np.float32)
    jS = JaxSpParMat.from_global_coo(jD.grid, r, c, v, m, n, capacity=80)
    tS = SpParMat.from_global_coo(tD.grid, r, c, v, m, n, capacity=80)
    assert_same(tD.add_spmat(tS).blocks, jD.add_spmat(jS).blocks)
    assert_same(tD.add_spmat(tS, comb_max).blocks, jD.add_spmat(jS, jcomb_max).blocks)
    assert_same_mat(tD.filter_spmat(tS, keep_zero), jD.filter_spmat(jS, keep_zero))
    assert_same_mat(tD.scale_spmat(tS, scale_by), jD.scale_spmat(jS, scale_by))
    assert_same(tD.ewise(tD, torch.mul).blocks, jD.ewise(jD, jnp.multiply).blocks)
    assert_same(tD.apply(torch.neg).blocks, jD.apply(jnp.negative).blocks)
    for axis in ("rows", "cols"):
        assert_same(tD.reduce(PLUS_TIMES, axis).blocks, jD.reduce(jsr.PLUS_TIMES, axis).blocks)
    sp = rng.choice(SPECIALS, (m, n)).astype(np.float32)
    jX = JaxDense.from_global(jD.grid, sp)
    tX = DenseParMat.from_global(tD.grid, sp)
    for sr, jr in ((MIN_PLUS, jsr.MIN_PLUS), (MAX_MIN, jsr.MAX_MIN)):
        for axis in ("rows", "cols"):
            assert_same(tX.reduce(sr, axis).blocks, jX.reduce(jr, axis).blocks)
    with pytest.raises(ValueError, match="axis"):
        tD.reduce(PLUS_TIMES, "diag")
