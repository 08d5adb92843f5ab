"""Parity of the port's searches on ``SpParMat`` with ``combblas_tpu`` on
the CPU: ``bfs`` (also on an ``EllParMat`` through ``dist_spmv_masked``'s
dispatch), ``bfs_diropt`` (top-down only, bottom-up only, and mixed),
``bfs_diropt_auto``, ``traversed_edges`` and the single-source ``sssp``,
on 1x1, 2x2 and 2x4 grids. Parents, levels, distances and iteration
counts are compared bit for bit; the trees are also checked with
``validate_bfs_tree``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from combblas_tpu.models import bfs as jax_bfs
from combblas_tpu.models import sssp as jax_sssp
from combblas_tpu.parallel.ellmat import EllParMat as JaxEllParMat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu_torch import (
    EllParMat,
    Grid,
    SpParMat,
    bfs,
    bfs_diropt,
    bfs_diropt_auto,
    sssp,
    traversed_edges,
    validate_bfs_tree,
)

GRIDS = [(1, 1), (2, 2), (2, 4)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]
N = 70


def graph(seed=0, n=N, density=0.05, weighted=False):
    """A random symmetric loop-free graph with a few isolated vertices and
    a tail (a path hanging off vertex 0), so that searches run several
    levels: (dense, rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)) < density
    d = np.triu(d, 1)
    d[:, n - 4:] = False  # isolated: the last four
    for k in range(n - 12, n - 5):  # the tail
        d[k, k + 1] = True
    d[0, n - 12] = True
    d = d | d.T
    r, c = np.nonzero(d)
    w = np.triu(rng.integers(1, 10, (n, n)).astype(np.float32))
    w = w + w.T
    v = w[r, c] if weighted else np.ones(len(r), np.float32)
    return d, r, c, v


def both(shape, r, c, v, n=N):
    return (JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, n, n),
            SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, n, n))


def assert_same_run(got, want):
    (gp, gl, gi), (wp, wl, wi) = got, want
    np.testing.assert_array_equal(gp.blocks.numpy(), np.asarray(wp.blocks))
    np.testing.assert_array_equal(gl.blocks.numpy(), np.asarray(wl.blocks))
    assert gp.blocks.numpy().dtype == gl.blocks.numpy().dtype == np.asarray(wp.blocks).dtype
    assert isinstance(gi, int) and gi == int(wi)


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_bfs_and_traversed_edges(shape):
    d, r, c, v = graph(1)
    ref, mine = both(shape, r, c, v)
    for src in (0, 5):
        got, want = bfs(mine, src), jax_bfs.bfs(ref, src)
        assert_same_run(got, want)
        assert bfs.last_run["readbacks"] == got[2]
        assert validate_bfs_tree(d, src, got[0].to_global(), got[1].to_global()) == []
        te = traversed_edges(mine, got[0])
        assert int(te) == int(jax_bfs.traversed_edges(ref, want[0])) > 0
    # an isolated root: one level that finds nothing
    got = bfs(mine, N - 1)
    assert_same_run(got, jax_bfs.bfs(ref, N - 1))
    assert got[2] == 1 and int(traversed_edges(mine, got[0])) == 0


def test_bfs_max_iters():
    _, r, c, v = graph(2)
    ref, mine = both((2, 2), r, c, v)
    assert_same_run(bfs(mine, 0, max_iters=2), jax_bfs.bfs(ref, 0, max_iters=2))


def test_bfs_on_an_ellparmat():
    """``bfs`` over an EllParMat runs the ELL SpMV through the dispatch and
    gives the reference's (and the SpParMat's) tree."""
    _, r, c, v = graph(3)
    ref = JaxEllParMat.from_host_coo(JaxGrid.make(2, 2), r, c, v, N, N)
    mine = EllParMat.from_host_coo(Grid.make(2, 2, device="cpu"), r, c, v, N, N)
    got = bfs(mine, 0)
    assert_same_run(got, jax_bfs.bfs(ref, 0))
    assert_same_run(got, bfs(both((2, 2), r, c, v)[1], 0))


DIROPT = {"topdown": (N, 10_000), "bottomup": (1, 1), "mixed": (4, 12)}


@pytest.mark.parametrize("budgets", list(DIROPT), ids=list(DIROPT))
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_bfs_diropt(shape, budgets):
    """Budgets that admit every level top-down, none, and some: the same
    tree as the reference's, and as ``bfs``'s."""
    fc, ec = DIROPT[budgets]
    d, r, c, v = graph(4)
    ref, mine = both(shape, r, c, v)
    got = bfs_diropt(mine, 2, frontier_capacity=fc, exp_capacity=ec)
    assert_same_run(got, jax_bfs.bfs_diropt(ref, 2, frontier_capacity=fc, exp_capacity=ec))
    assert_same_run(got, jax_bfs.bfs(ref, 2))
    run = bfs_diropt.last_run
    assert len(run["steps"]) == got[2] and run["readbacks"] == got[2] + 1
    want_steps = {"topdown": {"td"}, "bottomup": {"bu"}, "mixed": {"td", "bu"}}[budgets]
    assert set(run["steps"]) == want_steps, run["steps"]


def test_bfs_diropt_path_graph():
    """A path: a one-vertex frontier at every level, all top-down."""
    n = 16
    r = np.concatenate([np.arange(n - 1), np.arange(1, n)])
    c = np.concatenate([np.arange(1, n), np.arange(n - 1)])
    ref, mine = both((2, 2), r, c, np.ones(len(r), np.float32), n)
    got = bfs_diropt(mine, 0, frontier_capacity=4, exp_capacity=16)
    assert_same_run(got, jax_bfs.bfs_diropt(ref, 0, frontier_capacity=4, exp_capacity=16))
    np.testing.assert_array_equal(got[1].to_global(), np.arange(n))
    assert got[2] == n and set(bfs_diropt.last_run["steps"]) == {"td"}


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
def test_bfs_diropt_auto(shape):
    d, r, c, v = graph(5, density=0.12)
    ref, mine = both(shape, r, c, v)
    got = bfs_diropt_auto(mine, 1)
    assert_same_run(got, jax_bfs.bfs_diropt_auto(ref, 1))
    assert validate_bfs_tree(d, 1, got[0].to_global(), got[1].to_global()) == []


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_sssp(shape):
    """Integer weights: float32 sums are exact, so distances are bit for
    bit; unreachable vertices are +inf."""
    _, r, c, v = graph(6, density=0.1, weighted=True)
    ref, mine = both(shape, r, c, v)
    (gd, gi), (wd, wi) = sssp(mine, 3), jax_sssp.sssp(ref, 3)
    np.testing.assert_array_equal(gd.blocks.numpy(), np.asarray(wd.blocks))
    assert gd.blocks.numpy().dtype == np.asarray(wd.blocks).dtype
    assert isinstance(gi, int) and gi == int(wi) == sssp.last_run["readbacks"]
    want = csgraph.dijkstra(sp.csr_matrix((v, (r, c)), shape=(N, N)), indices=3)
    np.testing.assert_array_equal(gd.to_global(), want.astype(np.float32))
    assert np.isinf(want[N - 4:]).all() and np.isfinite(want).sum() > 10


def test_sssp_directed_line_and_float_weights():
    """A directed path (w(j -> i) at entry (i, j)) and random float
    weights on a 2x2 grid."""
    n = 8
    r, c = np.array([1, 2, 3]), np.array([0, 1, 2])
    v = np.array([1.0, 2.0, 3.0], np.float32)
    ref, mine = both((2, 2), r, c, v, n)
    dist, _ = sssp(mine, 0)
    np.testing.assert_array_equal(dist.to_global()[:4], [0, 1, 3, 6])
    assert np.isinf(dist.to_global()[4:]).all()
    _, r, c, _ = graph(7)
    v = np.random.default_rng(7).uniform(0.5, 2.0, len(r)).astype(np.float32)
    ref, mine = both((2, 4), r, c, v)
    (gd, gi), (wd, wi) = sssp(mine, 0), jax_sssp.sssp(ref, 0)
    np.testing.assert_array_equal(gd.blocks.numpy(), np.asarray(wd.blocks))
    assert gi == int(wi)
