"""Parity of the port's int32 batched BFS (``bfs_batch``) and batched
Bellman-Ford (``sssp_batch``) with ``combblas_tpu`` on the CPU, over
``EllParMat`` on 1×1, 2×2 and 2×4 grids (the last with rows split by
``max_k``), with ``PAD_ROOT`` lanes and vertices no root reaches.

Parents, levels and iteration counts are integers: exact. The distances
are sums of integer-valued float32 weights far below 2**24, so every
order of summation gives the same float: exact too (``array_equal``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.models import bfs as jax_bfs
from combblas_tpu.models import sssp as jax_sssp
from combblas_tpu.parallel import ellmat as jax_ellmat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu_torch import (
    PAD_ROOT,
    EllParMat,
    Grid,
    bfs_batch,
    bfs_batch_compact,
    rmat_symmetric_coo_host,
    sssp_batch,
)

GRIDS = [((1, 1), None), ((2, 2), None), ((2, 4), 5)]
GRID_IDS = ["1x1", "2x2", "2x4-split-rows"]


def graph():
    """Symmetric R-MAT scale 8 plus eight isolated vertices."""
    n0 = 256
    r, c = rmat_symmetric_coo_host(13, 8, 6)
    key = np.unique(r * n0 + c)
    return key // n0, key % n0, n0 + 8


def sources(r, n):
    deg = np.bincount(r, minlength=n)
    live = np.flatnonzero(deg > 0)
    return np.array([live[0], PAD_ROOT, live[9], n - 3, live[30], PAD_ROOT], np.int32)


def both(shape, max_k, vals):
    r, c, n = graph()
    ref = jax_ellmat.EllParMat.from_host_coo(JaxGrid.make(*shape), r, c, vals, n, n, max_k=max_k)
    mine = EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, vals, n, n,
                                   max_k=max_k)
    return ref, mine


@pytest.mark.parametrize("shape, max_k", GRIDS, ids=GRID_IDS)
def test_bfs_batch_matches_reference(shape, max_k):
    r, c, n = graph()
    ref, mine = both(shape, max_k, np.ones(len(r), np.float32))
    srcs = sources(r, n)
    wp, wl, wit = jax_bfs.bfs_batch(ref, jnp.asarray(srcs))
    p, lv, it = bfs_batch(mine, srcs)
    assert p.blocks.dtype == lv.blocks.dtype == torch.int32
    assert (p.align, lv.align, p.length) == ("row", "row", n)
    np.testing.assert_array_equal(p.blocks.numpy(), np.asarray(wp.blocks), err_msg="parents")
    np.testing.assert_array_equal(lv.blocks.numpy(), np.asarray(wl.blocks), err_msg="levels")
    assert it == int(wit) and bfs_batch.last_run == {"readbacks": it}
    P, L = p.to_global(), lv.to_global()
    assert (P[:, [1, 5]] == -1).all() and (L[:, [1, 5]] == -1).all()  # PAD_ROOT lanes
    assert np.flatnonzero(P[:, 3] >= 0).tolist() == [n - 3]  # an isolated root
    # lane k equals lane k of the level-compressed batch
    cp, cl, cit = bfs_batch_compact(mine, srcs)
    assert torch.equal(p.blocks, cp.blocks) and torch.equal(lv.blocks, cl.blocks.to(torch.int32))
    assert it == cit


def test_bfs_batch_without_levels_and_cut_short():
    """``track_levels=False`` returns the discovery indicator; ``max_iters``
    stops the loop (the reference's default is n, not the int8 batch's
    126)."""
    r, c, n = graph()
    ref, mine = both((2, 2), None, np.ones(len(r), np.float32))
    srcs = sources(r, n)
    wp, wl, wit = jax_bfs.bfs_batch(ref, jnp.asarray(srcs), track_levels=False, max_iters=2)
    p, lv, it = bfs_batch(mine, srcs, track_levels=False, max_iters=2)
    np.testing.assert_array_equal(p.blocks.numpy(), np.asarray(wp.blocks))
    np.testing.assert_array_equal(lv.blocks.numpy(), np.asarray(wl.blocks))
    assert lv.blocks.dtype == torch.int32
    assert it == int(wit) == 2
    full_p, full_l, _ = bfs_batch(mine, srcs)
    assert torch.equal(lv.blocks, torch.where(p.blocks >= 0, 0, -1).to(torch.int32))
    assert torch.equal(p.blocks, torch.where((full_l.blocks >= 0) & (full_l.blocks <= 2),
                                             full_p.blocks, -1))


@pytest.mark.parametrize("shape, max_k", GRIDS, ids=GRID_IDS)
def test_sssp_batch_matches_reference(shape, max_k):
    r, c, n = graph()
    w = np.random.default_rng(2).integers(1, 10, len(r)).astype(np.float32)
    ref, mine = both(shape, max_k, w)
    srcs = sources(r, n)
    wd, wit = jax_sssp.sssp_batch(ref, jnp.asarray(srcs))
    d, it = sssp_batch(mine, srcs)
    assert d.blocks.dtype == torch.float32 and (d.align, d.length) == ("row", n)
    np.testing.assert_array_equal(d.blocks.numpy(), np.asarray(wd.blocks))
    assert it == int(wit) and sssp_batch.last_run == {"readbacks": it}
    D = d.to_global()
    assert np.isinf(D[:, [1, 5]]).all()  # PAD_ROOT lanes
    assert np.isinf(D[:, 3]).sum() == n - 1 and D[n - 3, 3] == 0
    assert np.isinf(D[n - 8:, 0]).all()  # the isolated vertices stay unreached


def test_sssp_batch_with_unit_weights_gives_bfs_levels():
    r, c, n = graph()
    _, mine = both((2, 4), 5, np.ones(len(r), np.float32))
    srcs = sources(r, n)
    d, it = sssp_batch(mine, srcs)
    _, lv, levels = bfs_batch(mine, srcs)
    L = lv.to_global()
    np.testing.assert_array_equal(d.to_global(), np.where(L >= 0, L, np.inf))
    # the deepest level, then one round that improves nothing
    assert it == int(L.max()) + 1 == levels
