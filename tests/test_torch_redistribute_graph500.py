"""Parity of the port's tuple routing (``parallel/redistribute.py``),
Graph500 kernel 1 on the device (``models/graph500.py``) and the ring
fold (``parallel/collectives.py``; ``bfs_batch_compact(ring=True)`` is held
in ``test_torch_bfs.py``) with ``combblas_tpu`` on the CPU. The JAX side runs on the 8-device virtual CPU mesh; both sides get the same
numpy inputs, and JAX keys are carried across with ``key_from_jax``. Every
comparison is bit for bit: tile arrays whole (padding slots included),
drop counts, permutations and degrees.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from combblas_tpu import semiring as jax_semiring
from combblas_tpu.models import graph500 as jax_graph500
from combblas_tpu.parallel import redistribute as jax_redistribute
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    DistVec,
    Grid,
    SpParMat,
    axis_ring_reduce,
    from_device_coo,
    isolated_compression_perm,
    kernel1_device,
    key_from_jax,
    permute_vertices,
    redistribute_coo,
    semiring,
)
from combblas_tpu_torch.parallel.collectives import ring_order

SEMIRINGS = {None: (None, None), "select2nd_max": (jax_semiring.SELECT2ND_MAX, SELECT2ND_MAX),
             "plus_times": (jax_semiring.PLUS_TIMES, PLUS_TIMES),
             "min_plus": (jax_semiring.MIN_PLUS, MIN_PLUS)}
SHAPES = [(2, 2), (2, 4)]
SHAPE_IDS = ["2x2", "2x4"]


def carried(k):
    return key_from_jax(np.asarray(jax.random.key_data(k)))


def grids(shape):
    return JaxGrid.make(*shape), Grid.make(*shape, device="cpu")


def assert_same_mat(got: SpParMat, want) -> None:
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    for f in ("rows", "cols", "vals", "nnz"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (f, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=f)


def chunks(shape, n, m, seed, invalid=0.1):
    """``m`` random global tuples of an n×n matrix, some invalid (row past
    n), packed into ``[pr, pc, chunk]`` in tile order; integer values."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, m).astype(np.int32)
    c = rng.integers(0, n, m).astype(np.int32)
    r[rng.random(m) < invalid] = n + 3
    v = rng.integers(1, 9, m).astype(np.float32)
    ntiles = shape[0] * shape[1]
    chunk = -(-m // ntiles)
    R = np.full(ntiles * chunk, n, np.int32)
    C = R.copy()
    V = np.zeros(ntiles * chunk, np.float32)
    R[:m], C[:m], V[:m] = r, c, v
    return tuple(x.reshape(*shape, chunk) for x in (R, C, V))


# --- routing ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("stage, tile, dedup", [
    (4, 16, None), (4, 8, "select2nd_max"), (8, 16, "plus_times"), (16, 4, "min_plus"),
])
def test_redistribute_coo_matches_reference(shape, stage, tile, dedup):
    """The same tiles, nnz and drop count, also where small capacities drop
    tuples at a hop or at a tile."""
    jg, tg = grids(shape)
    n = 37
    R, C, V = chunks(shape, n, 300, seed=stage * 7 + tile)
    jsr, tsr = SEMIRINGS[dedup]
    want, wd = jax_redistribute.redistribute_coo(
        jg, jnp.asarray(R), jnp.asarray(C), jnp.asarray(V), n, n,
        stage_capacity=stage, tile_capacity=tile, dedup_sr=jsr)
    got, gd = redistribute_coo(tg, *(torch.from_numpy(x) for x in (R, C, V)), n, n,
                               stage_capacity=stage, tile_capacity=tile, dedup_sr=tsr)
    assert gd.dtype == torch.int32 and gd.dim() == 0
    assert int(gd) == int(wd)
    assert_same_mat(got, want)


def test_redistribute_coo_drops_when_starved():
    _, tg = grids((2, 2))
    R, C, V = chunks((2, 2), 12, 90, seed=1, invalid=0.0)
    _, dropped = redistribute_coo(tg, *(torch.from_numpy(x) for x in (R, C, V)), 12, 12,
                                  stage_capacity=2, tile_capacity=4)
    assert int(dropped) > 0


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_from_device_coo_retries_as_reference(shape):
    """Skewed tuples (a hub column) overflow the first capacities at slack
    1; both packages double them and end with the same matrix."""
    jg, tg = grids(shape)
    n = 40
    rng = np.random.default_rng(4)
    m = 160
    r = rng.integers(0, n, m).astype(np.int32)
    c = np.where(rng.random(m) < 0.7, 3, rng.integers(0, n, m)).astype(np.int32)
    v = np.ones(m, np.float32)
    sh = (*shape, m // (shape[0] * shape[1]))
    R, C, V = r.reshape(sh), c.reshape(sh), v.reshape(sh)
    with pytest.raises(ValueError, match="capacity doublings"):
        from_device_coo(tg, *(torch.from_numpy(x) for x in (R, C, V)), n, n, slack=0.05,
                        max_retries=0)
    want = jax_redistribute.from_device_coo(jg, jnp.asarray(R), jnp.asarray(C), jnp.asarray(V),
                                            n, n, slack=1.0, dedup_sr=jax_semiring.PLUS_TIMES)
    got = from_device_coo(tg, *(torch.from_numpy(x) for x in (R, C, V)), n, n, slack=1.0,
                          dedup_sr=PLUS_TIMES)
    assert_same_mat(got, want)
    wm, wd = jax_redistribute.from_device_coo(jg, jnp.asarray(R), jnp.asarray(C),
                                              jnp.asarray(V), n, n, slack=1.0,
                                              defer_drop_check=True)
    gm, gd = from_device_coo(tg, *(torch.from_numpy(x) for x in (R, C, V)), n, n, slack=1.0,
                             defer_drop_check=True)
    assert int(gd) == int(wd) > 0
    assert_same_mat(gm, wm)


# --- kernel 1 ----------------------------------------------------------------------


def dense_graph(n, seed, live=None):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < 0.2).astype(np.float32)
    d = np.maximum(d, d.T)
    np.fill_diagonal(d, 0)
    if live is not None:
        dead = np.setdiff1d(np.arange(n), live)
        d[dead, :] = 0
        d[:, dead] = 0
    return d


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_permute_vertices_matches_reference(shape):
    """Equal to the reference on both grids. On the square grid the result
    is ``A[p[i], p[j]] = A[i, j]``; on 2x4 with n = 26 it is not, in either
    package: the col→row realign of ``p`` cuts blocks of 14 where the
    matrix's row blocks hold 13 (``DistVec.realign`` on rectangular grids,
    a reference behaviour the port keeps)."""
    jg, tg = grids(shape)
    n = 26
    d = dense_graph(n, 3)
    k = jax.random.key(3)
    want = jax_graph500.permute_vertices(JaxSpParMat.from_dense(jg, d),
                                         JaxDistVec.randperm(jg, n, k))
    p = DistVec.randperm(tg, n, carried(k))
    got = permute_vertices(SpParMat.from_dense(tg, d), p)
    assert_same_mat(got, want)
    pg = p.to_global()
    expect = np.zeros_like(d)
    expect[np.ix_(pg, pg)] = d
    assert np.array_equal(got.to_dense(), expect) == tg.is_square


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_isolated_compression_perm_matches_reference(shape):
    jg, tg = grids(shape)
    n = 23
    d = dense_graph(n, 5, live=[1, 4, 9, 10, 17, 22])
    wp, wn = jax_graph500.isolated_compression_perm(JaxSpParMat.from_dense(jg, d))
    gp, gn = isolated_compression_perm(SpParMat.from_dense(tg, d))
    assert gn.dtype == torch.int32
    assert int(gn) == int(wn) == int((d.sum(0) > 0).sum())
    assert (gp.length, gp.align) == (wp.length, wp.align)
    np.testing.assert_array_equal(gp.blocks.numpy(), np.asarray(wp.blocks))


@pytest.mark.parametrize("shape, extra_relabel, compress", [
    ((2, 2), False, True), ((2, 2), True, True),
], ids=["2x2", "2x2-extra-relabel"])
def test_kernel1_device_matches_reference(shape, extra_relabel, compress):
    """Graph500 kernel 1 at scale 7, edgefactor 8: the same matrix tile for
    tile, the same degrees, nkeep and drop count (0)."""
    jg, tg = grids(shape)
    k = jax.random.key(11)
    wA, wdeg, wn, wt = jax_graph500.kernel1_device(jg, 7, 8, k, extra_relabel=extra_relabel,
                                                   compress_isolated=compress)
    gA, gdeg, gn, gt = kernel1_device(tg, 7, 8, carried(k), extra_relabel=extra_relabel,
                                      compress_isolated=compress)
    assert_same_mat(gA, wA)
    assert gdeg.blocks.dtype == torch.float32 and gdeg.align == wdeg.align == "row"
    np.testing.assert_array_equal(gdeg.blocks.numpy(), np.asarray(wdeg.blocks))
    assert int(gn) == int(wn)
    assert int(gt["dropped_dev"]) == int(wt["dropped_dev"]) == 0
    assert set(gt) == set(wt)


# --- the ring fold -------------------------------------------------------------------


def test_ring_order_and_generic_monoids():
    assert ring_order(4, 0) == [0, 3, 2, 1] and ring_order(4, 2) == [2, 1, 0, 3]
    ys = [torch.tensor([3, 1]), torch.tensor([2, 5]), torch.tensor([0, 4])]
    assert axis_ring_reduce(SELECT2ND_MAX, ys).tolist() == [3, 5]
    assert axis_ring_reduce(PLUS_TIMES, ys, pos=1).tolist() == [5, 10]
    generic = semiring.Semiring(name="gen", add=torch.maximum, mul=torch.mul,
                                zero_fn=lambda dt: 0, add_kind="generic")
    with pytest.raises(ValueError, match="commutative"):
        axis_ring_reduce(generic, ys)
