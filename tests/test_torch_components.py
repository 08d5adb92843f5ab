"""Parity of the port's ``connected_components`` (FastSV), ``lacc``,
``num_components``, ``mis``, ``pagerank`` and ``pagerank_batch`` with
``combblas_tpu`` on the CPU, on 1x1, 2x2 and 2x4 grids.

Labels, statuses and iteration counts are int32 and compared bit for bit;
``mis``'s rounds are held bit for bit when fed the reference's
priorities (``jax.random.permutation`` of the padded ids), and the public
``mis`` (priorities from a torch.Generator) for independence and
maximality. Ranks are float32 sums taken in another order than the
reference's: within ``atol=1e-6`` of it (ranks are about 1/n), with equal
iteration counts, and within ``atol=1e-5`` of a float64 power iteration.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from combblas_tpu.models import cc as jax_cc
from combblas_tpu.models import mis as jax_mis
from combblas_tpu.models import pagerank as jax_pr
from combblas_tpu.parallel.ellmat import EllParMat as JaxEllParMat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    PAD_ROOT,
    DistVec,
    EllParMat,
    Grid,
    SpParMat,
    connected_components,
    lacc,
    mis,
    num_components,
    pagerank,
    pagerank_batch,
)
from combblas_tpu_torch.models import mis as torch_mis

GRIDS = [(1, 1), (2, 2), (2, 4)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]
N = 60


def sym_graph(seed, n=N, density=0.03):
    """A random symmetric loop-free graph (several components)."""
    rng = np.random.default_rng(seed)
    d = np.triu(rng.random((n, n)) < density, 1)
    d = d | d.T
    r, c = np.nonzero(d)
    return d, r, c


def both(shape, r, c, n=N, v=None):
    v = np.ones(len(r), np.float32) if v is None else v
    return (JaxSpParMat.from_global_coo(JaxGrid.make(*shape), r, c, v, n, n),
            SpParMat.from_global_coo(Grid.make(*shape, device="cpu"), r, c, v, n, n))


def assert_same_int(got, want):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(gv.blocks.numpy(), np.asarray(wv.blocks))
    assert gv.blocks.numpy().dtype == np.asarray(wv.blocks).dtype
    assert isinstance(gi, int) and gi == int(wi)


def min_id_labels(d):
    """The minimum vertex id of each vertex's component (scipy)."""
    ncomp, lab = csgraph.connected_components(sp.csr_matrix(d), directed=False)
    first = np.full(ncomp, d.shape[0])
    np.minimum.at(first, lab, np.arange(d.shape[0]))
    return ncomp, first[lab]


@pytest.mark.parametrize("density", [0.03, 0.08], ids=["sparse", "denser"])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_fastsv_and_lacc(shape, density):
    d, r, c = sym_graph(1, density=density)
    ref, mine = both(shape, r, c)
    ncomp, want = min_id_labels(d)
    for port_fn, ref_fn in ((connected_components, jax_cc.connected_components),
                            (lacc, jax_cc.lacc)):
        got = port_fn(mine)
        assert_same_int(got, ref_fn(ref))
        np.testing.assert_array_equal(got[0].to_global(), want)
        assert num_components(got[0]) == ncomp == jax_cc.num_components(ref_fn(ref)[0])


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_components_all_isolated_and_one_edge(shape):
    n = 16
    ref, mine = both(shape, np.array([0, 1]), np.array([1, 0]), n)
    for port_fn, ref_fn in ((connected_components, jax_cc.connected_components),
                            (lacc, jax_cc.lacc)):
        got = port_fn(mine)
        assert_same_int(got, ref_fn(ref))
        np.testing.assert_array_equal(got[0].to_global(), [0, 0, *range(2, n)])
    ref, mine = both(shape, np.array([], np.int64), np.array([], np.int64), n)
    got = lacc(mine)
    assert_same_int(got, jax_cc.lacc(ref))
    np.testing.assert_array_equal(got[0].to_global(), np.arange(n))


def test_components_path_and_cliques():
    """A path of ten, a clique of six and isolated vertices: the path
    needs several hooking rounds and a pointer-jumping pass."""
    n = 24
    d = np.zeros((n, n), bool)
    for i in range(9):
        d[i, i + 1] = d[i + 1, i] = True
    d[10:16, 10:16] = True
    np.fill_diagonal(d, False)
    r, c = np.nonzero(d)
    ref, mine = both((2, 2), r, c, n)
    for port_fn, ref_fn in ((connected_components, jax_cc.connected_components),
                            (lacc, jax_cc.lacc)):
        got = port_fn(mine)
        assert_same_int(got, ref_fn(ref))
        assert num_components(got[0]) == 2 + (n - 16)
        assert port_fn.last_run["readbacks"] >= got[1] + 1


def reference_priorities(shape, n, seed):
    pa = shape[0]
    L = -(-n // pa)
    prio = jax.random.permutation(jax.random.key(seed), pa * L)
    return np.asarray(prio).reshape(pa, L).astype(np.int32)


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_mis_rounds_with_the_reference_priorities(shape):
    d, r, c = sym_graph(2, density=0.08)
    ref, mine = both(shape, r, c)
    for seed in (3, 4):
        want = jax_mis.mis(ref, jax.random.key(seed))
        prio = torch.from_numpy(reference_priorities(shape, N, seed))
        assert_same_int(torch_mis._mis_rounds(mine, prio), want)
        assert mis.last_run["readbacks"] == int(want[1]) + 1


@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_mis_is_independent_and_maximal(shape):
    d, r, c = sym_graph(3, density=0.1)
    _, mine = both(shape, r, c)
    status, rounds = mis(mine, torch.Generator().manual_seed(5))
    s = status.to_global()
    assert set(np.unique(s)) <= {1, -1} and rounds >= 1
    members = np.flatnonzero(s == 1)
    assert members.size and not d[np.ix_(members, members)].any()  # independent
    assert d[np.flatnonzero(s == -1)][:, members].any(axis=1).all()  # maximal
    again, _ = mis(mine, torch.Generator().manual_seed(5))
    assert torch.equal(again.blocks, status.blocks)
    default, _ = mis(mine)  # the grid device's default generator
    dm = np.flatnonzero(default.to_global() == 1)
    assert default.blocks.device == mine.grid.device
    assert dm.size and not d[np.ix_(dm, dm)].any()


def dense_pagerank(d, iters, alpha=0.85):
    """float64 power iteration of the same formula, ``iters`` rounds."""
    n = d.shape[0]
    outdeg = d.sum(axis=0)
    P = np.divide(d, outdeg, where=outdeg > 0, out=np.zeros_like(d))
    x = np.full(n, 1.0 / n)
    for _ in range(iters):
        x = alpha * (P @ x) + ((1 - alpha) + alpha * x[outdeg == 0].sum()) / n
    return x


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2)], ids=["1x1", "2x2", "4x2"])
def test_pagerank(shape):
    rng = np.random.default_rng(6)
    d = (rng.random((N, N)) < 0.06).astype(np.float64)
    np.fill_diagonal(d, 0)
    d[:, -3:] = 0  # dangling columns
    r, c = np.nonzero(d)
    ref, mine = both(shape, r, c)
    (gx, gi), (wx, wi) = pagerank(mine, tol=1e-6, max_iters=200), \
        jax_pr.pagerank(ref, tol=1e-6, max_iters=200)
    assert isinstance(gi, int) and gi == int(wi) > 1
    assert gx.blocks.dtype == torch.float32
    np.testing.assert_allclose(gx.blocks.numpy(), np.asarray(wx.blocks), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gx.to_global(), dense_pagerank(d, gi), rtol=0, atol=1e-5)
    assert abs(gx.to_global().sum() - 1) < 1e-5


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_pagerank_batch_with_padding_lanes(shape):
    """W personalised chains over the column-normalised ELL; PAD_ROOT lanes
    stay all zero."""
    rng = np.random.default_rng(7)
    d = (rng.random((N, N)) < 0.08).astype(np.float32)
    np.fill_diagonal(d, 0)
    d[:, -3:] = 0
    r, c = np.nonzero(d)
    outdeg = d.sum(axis=0)
    vals = (1.0 / outdeg[c]).astype(np.float32)
    ref = JaxEllParMat.from_host_coo(JaxGrid.make(*shape), r, c, vals, N, N)
    mine = EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, vals, N, N)
    dang = (outdeg == 0).astype(np.float32)
    sources = np.array([0, PAD_ROOT, 19, 33, PAD_ROOT], np.int32)
    got, gi = pagerank_batch(mine, torch.from_numpy(sources),
                             DistVec.from_global(mine.grid, dang, align="col"),
                             tol=1e-7, max_iters=300)
    want, wi = jax_pr.pagerank_batch(ref, jax.numpy.asarray(sources),
                                     JaxDistVec.from_global(ref.grid, dang, align="col"),
                                     tol=1e-7, max_iters=300)
    assert isinstance(gi, int) and gi == int(wi) > 1
    np.testing.assert_allclose(got.blocks.numpy(), np.asarray(want.blocks), rtol=0, atol=1e-6)
    ranks = got.to_global()
    assert not ranks[:, [1, 4]].any()
    np.testing.assert_allclose(ranks[:, [0, 2, 3]].sum(axis=0), 1.0, atol=1e-5)
