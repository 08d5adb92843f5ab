"""Parity of the port's Graph500 batched BFS (``bfs_batch_compact``,
``batch_traversed_edges``, ``validate_bfs_device``, the graph recipe) with
``combblas_tpu`` on the CPU: the slice as a whole. Parents, levels and
counts are integers, so every comparison is exact (``array_equal``, no
tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.models import bfs as jax_bfs
from combblas_tpu.parallel import ellmat as jax_ellmat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.grid import HostGrid as JaxHostGrid
from combblas_tpu.parallel.vec import DistMultiVec as JaxDistMultiVec
from combblas_tpu.utils.rmat import rmat_symmetric_coo_host as jax_rmat_host
from combblas_tpu_torch import (
    PAD_ROOT,
    DistMultiVec,
    DistVec,
    EllParMat,
    Grid,
    batch_traversed_edges,
    bfs_batch_compact,
    build_csc_companion,
    build_graph,
    build_structures,
    distmultivec_from_arrays,
    rmat_symmetric_coo_host,
    validate_bfs_device,
    validate_bfs_tree,
)


def graph(scale: int, seed: int, edgefactor: int = 6):
    n = 1 << scale
    r, c = rmat_symmetric_coo_host(seed, scale, edgefactor)
    key = np.unique(r * n + c)
    return key // n, key % n, n


def both(shape, r, c, n, max_k=None):
    ones = np.ones(len(r), np.float32)
    ref = jax_ellmat.EllParMat.from_host_coo(JaxGrid.make(*shape), r, c, ones, n, n, max_k=max_k)
    mine = EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, ones, n, n, max_k=max_k)
    return ref, mine


def assert_same_search(got, want):
    (gp, gl, git), (wp, wl, wit) = got, want
    assert gp.blocks.dtype == torch.int32 and gl.blocks.dtype == torch.int8
    assert (gp.align, gl.align, gp.length) == ("row", "row", wp.length)
    np.testing.assert_array_equal(gl.blocks.numpy(), np.asarray(wl.blocks), err_msg="levels")
    np.testing.assert_array_equal(gp.blocks.numpy(), np.asarray(wp.blocks), err_msg="parents")
    assert git == int(wit)


@pytest.mark.parametrize("shape, max_k", [((1, 1), None), ((1, 1), 5), ((2, 2), None),
                                          ((2, 4), 5)],
                         ids=["1x1", "1x1-split-rows", "2x2", "2x4-split-rows"])
def test_bfs_batch_compact_matches_reference(shape, max_k):
    r, c, n = graph(8, 13)
    ref, mine = both(shape, r, c, n, max_k)
    deg = np.bincount(r, minlength=n)
    srcs = np.flatnonzero(deg > 0)[[0, 5, 23]].astype(np.int32)
    want = jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs))
    got = bfs_batch_compact(mine, torch.from_numpy(srcs))
    assert_same_search(got, want)
    assert bfs_batch_compact.last_run == {"readbacks": got[2], "steps": ["dense"] * got[2]}
    # each lane is a valid tree by the host checker
    d = np.zeros((n, n), bool)
    d[r, c] = True
    P, L = got[0].to_global(), got[1].to_global().astype(np.int32)
    for k, s in enumerate(srcs):
        assert not validate_bfs_tree(d, int(s), P[:, k], L[:, k]), k


@pytest.mark.parametrize("fcap, ecap", [(16, 256), (None, None)], ids=["small", "generous"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_bfs_batch_compact_with_csc_budgets_matches_reference(shape, fcap, ecap):
    """Small budgets: some levels sparse, some dense. Generous budgets:
    every level through the sparse step. Same result as the dense search."""
    r, c, n = graph(8, 21)
    ref, mine = both(shape, r, c, n)
    fcap, ecap = fcap or n, ecap or 4 * len(r)
    deg = np.bincount(r, minlength=n)
    srcs = np.flatnonzero(deg > 0)[[0, 3]].astype(np.int32)
    ref_csc = jax_ellmat.build_csc_companion(ref.grid, r, c, n, n)
    want = jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs), csc=ref_csc,
                                     frontier_capacity=fcap, edge_capacity=ecap)
    csc = build_csc_companion(mine.grid, r, c, n, n)
    got = bfs_batch_compact(mine, srcs, csc=csc, frontier_capacity=fcap, edge_capacity=ecap)
    assert_same_search(got, want)
    dense = bfs_batch_compact(mine, srcs)
    assert torch.equal(got[0].blocks, dense[0].blocks)
    assert torch.equal(got[1].blocks, dense[1].blocks)
    assert bfs_batch_compact.last_run["steps"] == ["dense"] * dense[2]
    bfs_batch_compact(mine, srcs, csc=csc, frontier_capacity=fcap, edge_capacity=ecap)
    run = bfs_batch_compact.last_run
    assert run["readbacks"] == 2 * got[2] and len(run["steps"]) == got[2]
    if fcap == n:
        assert set(run["steps"]) == {"sparse"}
    else:
        assert set(run["steps"]) == {"sparse", "dense"}


def test_pad_root_lane_and_disconnected_root():
    """A PAD_ROOT lane discovers nothing; a root without edges discovers
    itself alone. Vertex ids past the edges' range stay isolated."""
    r, c, n0 = graph(7, 4)
    n = n0 + 8  # eight isolated vertices
    ref, mine = both((2, 2), r, c, n)
    deg = np.bincount(r, minlength=n)
    srcs = np.array([np.flatnonzero(deg > 0)[2], PAD_ROOT, n - 3, PAD_ROOT], np.int32)
    want = jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs))
    got = bfs_batch_compact(mine, srcs)
    assert_same_search(got, want)
    P, L = got[0].to_global(), got[1].to_global()
    assert (P[:, [1, 3]] == -1).all() and (L[:, [1, 3]] == -1).all()
    assert np.flatnonzero(P[:, 2] >= 0).tolist() == [n - 3] and P[n - 3, 2] == n - 3
    assert L[n - 3, 2] == 0 and (L[:, 0] >= 0).sum() > 1


@pytest.mark.parametrize("max_iters", [2, 126])
def test_max_iters_cuts_the_search(max_iters):
    r, c, n = graph(8, 13)
    ref, mine = both((1, 1), r, c, n)
    srcs = np.flatnonzero(np.bincount(r, minlength=n) > 0)[[1, 7]].astype(np.int32)
    want = jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs), max_iters=max_iters)
    got = bfs_batch_compact(mine, srcs, max_iters=max_iters)
    assert_same_search(got, want)
    if max_iters == 2:
        assert got[2] == 2 and int(got[1].blocks.max()) == 2


def test_max_iters_past_the_int8_range_raises():
    r, c, n = graph(7, 4)
    ref, mine = both((1, 1), r, c, n)
    srcs = np.array([int(r[0])], np.int32)
    with pytest.raises(ValueError, match="int8"):
        jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs), max_iters=127)
    with pytest.raises(ValueError, match="int8"):
        bfs_batch_compact(mine, srcs, max_iters=127)


def test_ring_schedule_is_not_ported():
    """The name is older than the ring fold's port: ``ring=True`` used to
    raise. On one tile the ring has one position, and the search equals
    the reference's ring search and the port's ``ring=False``."""
    r, c, n = graph(7, 4)
    ref, mine = both((1, 1), r, c, n)
    srcs = np.array([int(r[0])], np.int32)
    got = bfs_batch_compact(mine, srcs, ring=True)
    assert_same_search(got, jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs), ring=True))
    off = bfs_batch_compact(mine, srcs)
    assert torch.equal(got[0].blocks, off[0].blocks) and torch.equal(got[1].blocks, off[1].blocks)


@pytest.mark.parametrize("shape, budgets", [((2, 2), False), ((2, 4), False), ((2, 2), True)],
                         ids=["2x2", "2x4", "2x2-csc-budgets"])
def test_bfs_batch_compact_ring_matches_reference_and_ring_off(shape, budgets):
    """``ring=True`` folds each dense level's grid row in the carousel's
    order: equal to the reference's ring search and to ``ring=False``
    (levels, parents, level count), also with the sparse step in the mix."""
    r, c, n = graph(8, 21)
    ref, mine = both(shape, r, c, n)
    srcs = np.flatnonzero(np.bincount(r, minlength=n) > 0)[[0, 3, 17, 40]].astype(np.int32)
    jkw, kw = {}, {}
    if budgets:
        jkw = dict(csc=jax_ellmat.build_csc_companion(ref.grid, r, c, n, n),
                   frontier_capacity=16, edge_capacity=256)
        kw = dict(jkw, csc=build_csc_companion(mine.grid, r, c, n, n))
    got = bfs_batch_compact(mine, srcs, ring=True, **kw)
    assert_same_search(got, jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs), ring=True, **jkw))
    if budgets:
        assert set(bfs_batch_compact.last_run["steps"]) == {"sparse", "dense"}
    off = bfs_batch_compact(mine, srcs, **kw)
    assert got[2] == off[2]
    assert torch.equal(got[0].blocks, off[0].blocks) and torch.equal(got[1].blocks, off[1].blocks)


def test_batch_traversed_edges_matches_reference_and_host():
    r, c, n = graph(7, 5, edgefactor=8)
    ref, mine = both((2, 2), r, c, n)
    deg = np.bincount(r, minlength=n)
    srcs = np.flatnonzero(deg > 0)[[1, 5]].astype(np.int32)
    srcs = np.concatenate([srcs, [PAD_ROOT]]).astype(np.int32)
    wp, _, _ = jax_bfs.bfs_batch_compact(ref, jnp.asarray(srcs))
    gp, _, _ = bfs_batch_compact(mine, srcs)
    lr = mine.local_rows
    degb = np.pad(deg, (0, lr * 2 - n)).reshape(2, lr).astype(np.int32)
    want = np.asarray(jax_bfs.batch_traversed_edges(jnp.asarray(degb), wp))
    got = batch_traversed_edges(DistVec.from_global(mine.grid, degb.reshape(-1)[:n],
                                                    align="row").blocks, gp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    P = gp.to_global()
    for k in range(len(srcs)):
        assert int(got[k]) == int(deg[P[:, k] >= 0].sum()) // 2
    assert int(got[2]) == 0


def test_batch_traversed_edges_sums_past_int32():
    """Degree sums between 2**31 and 2**32 are right (the reference sums
    in uint32; the port in int64)."""
    grid = Grid.make(1, 1, device="cpu")
    deg = torch.full((1, 4), 2**30 - 1, dtype=torch.int32)
    parents = DistMultiVec(blocks=torch.tensor([[[0, 0], [0, -1], [0, -1], [0, -1]]],
                                               dtype=torch.int32),
                           length=4, align="row", grid=grid)
    got = batch_traversed_edges(deg, parents)
    want = jax_bfs.batch_traversed_edges(
        jnp.asarray(deg.numpy()),
        JaxDistMultiVec(blocks=jnp.asarray(parents.blocks.numpy()), length=4, align="row",
                        grid=JaxGrid.make(1, 1)))
    assert got.tolist() == [2 * (2**30 - 1), (2**30 - 1) // 2] == np.asarray(want).tolist()


def _validation_case(shape):
    rng = np.random.default_rng(12345)
    n = 64
    d = rng.random((n, n)) < 0.08
    d = d | d.T
    np.fill_diagonal(d, 0)
    rr, cc = np.nonzero(d)
    ref, mine = both(shape, rr.astype(np.int64), cc.astype(np.int64), n)
    srcs = np.flatnonzero(np.bincount(rr, minlength=n) > 0)[[0, 2]].astype(np.int32)
    p, l, _ = bfs_batch_compact(mine, srcs)
    return d, ref, mine, p.to_global(), l.to_global().astype(np.int32)


BREAKS = ["good", "parent-not-a-neighbour", "level-shifted", "second-root", "undiscovered-hole"]


@pytest.mark.parametrize("how", BREAKS)
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_validate_bfs_device_matches_reference(shape, how):
    """A good tree gives all zeros; a tree broken one rule at a time is
    flagged in the rows the reference flags, with the same counts."""
    d, ref, mine, pg, lg = _validation_case(shape)
    n = d.shape[0]
    pg, lg = pg.copy(), lg.copy()
    disc = np.flatnonzero((pg[:, 0] >= 0) & (pg[:, 0] != np.arange(n)))
    victim = int(disc[-1])
    if how == "parent-not-a-neighbour":
        pg[victim, 0] = int(np.flatnonzero(~d[victim])[0])
    elif how == "level-shifted":
        lg[victim, 0] += 2
    elif how == "second-root":
        pg[victim, 0], lg[victim, 0] = victim, 0
    elif how == "undiscovered-hole":
        pg[victim, 0], lg[victim, 0] = -1, -1

    def vecs(cls, grid):
        return (cls.from_global(grid, pg.astype(np.int32), align="row"),
                cls.from_global(grid, lg.astype(np.int32), align="row"))

    want = np.asarray(jax_bfs.validate_bfs_device(ref, *vecs(JaxDistMultiVec, ref.grid)))
    got = validate_bfs_device(mine, *vecs(DistMultiVec, mine.grid))
    assert got.dtype == torch.int32 and got.shape == (4, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 1] == 0).all()  # lane 1 is untouched
    flagged = {int(k) for k in np.flatnonzero(got[:, 0].numpy())}
    expect = {"good": set(), "parent-not-a-neighbour": {2}, "second-root": {0},
              "undiscovered-hole": {3}}
    if how in expect:
        assert flagged >= expect[how] and (how != "good" or not flagged)
    else:
        assert flagged & {1, 3}


def test_distmultivec_carries_over():
    grid = Grid.make(2, 4, device="cpu")
    blocks = np.arange(2 * 5 * 3, dtype=np.int32).reshape(2, 5, 3)
    v = distmultivec_from_arrays(grid, blocks, 9, "row")
    assert v.width == 3 and v.block_len == 5
    np.testing.assert_array_equal(v.to_global(), blocks.reshape(-1, 3)[:9])
    with pytest.raises(ValueError, match="col-aligned"):
        distmultivec_from_arrays(grid, blocks, 9, "col")


@pytest.mark.parametrize("scale", [8, 10])
def test_graph_recipe_matches_the_reference_script(scale):
    """``build_graph`` / ``build_structures`` against the recipe of the
    reference's benchmark script, spelled out on the reference's own
    functions."""
    n = 1 << scale
    g = build_graph(scale, 16, nroots=8)
    rows, cols = jax_rmat_host(42, scale, 16)
    uniq = np.unique(rows * np.int64(n) + cols)
    rows_u, cols_u = (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)
    deg = np.bincount(rows_u, minlength=n)
    roots = np.random.default_rng(7).choice(np.flatnonzero(deg > 0), size=8, replace=False)
    for name, want in (("rows", rows_u), ("cols", cols_u), ("deg", deg), ("roots", roots)):
        assert g[name].dtype == np.int32
        np.testing.assert_array_equal(g[name], want, err_msg=name)
    buckets, (indptr, rowidx) = build_structures(g["rows"], g["cols"], n)
    want_b = jax_ellmat.EllParMat.host_build(
        JaxHostGrid(1, 1), rows_u, cols_u, np.zeros(len(rows_u), np.int8), n, n, headroom=0)
    assert len(buckets) == len(want_b)
    for got3, want3 in zip(buckets, want_b):
        for ga, wa in zip(got3, want3):
            assert ga.dtype == wa.dtype
            np.testing.assert_array_equal(ga, wa)
    want_c = jax_ellmat.build_csc_companion_host(JaxHostGrid(1, 1), rows_u, cols_u, n, n)
    np.testing.assert_array_equal(indptr, want_c[0])
    np.testing.assert_array_equal(rowidx, want_c[1])
