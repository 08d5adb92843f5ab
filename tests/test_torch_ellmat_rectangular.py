"""The ELL layer on grids whose realigned column blocks are longer than a
tile's columns: ⌈pr·⌈n/pr⌉ / pc⌉ ≠ ⌈n/pc⌉ (4x2 with n = 9, 17, 33; 2x1
with n = 9).

``DistVec.realign("col")`` of a row-aligned vector keeps the reference's
blocks there, which start late against tile column j for every j ≥ 1;
``parallel.ellmat.col_blocks`` re-cuts such an operand as tile columns
before the ELL steps read it. On those grids the reference's
``bfs_batch``, ``bfs_batch_compact`` and ``bfs(EllParMat)`` raise (their
``while_loop`` carry changes shape) and its ``sssp_batch`` returns wrong
distances, so the port is held against scipy there: ``bfs_batch``,
``bfs_batch_compact`` (dense and direction-optimised), ``bfs``,
``bfs_single`` (dense and tiered), ``sssp_batch`` and the engine's
``bfs`` and ``sssp`` lanes give scipy's levels and distances exactly, and
each parent is a neighbour one level up; ``validate_bfs_device`` counts
on such a grid what it counts on 1x1 for the same tree. On 2x4 and 1x2, where the blocks already line up, the outputs stay
equal to the reference's bit for bit; on a square grid ``col_blocks``
returns its input tensor itself.

Graphs: symmetric COO of 2n random pairs from ``default_rng(9)``
(deduplicated), integer weights 1..5 symmetric in the pair.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as cg
import torch

from combblas_tpu.models import bfs as jbfs
from combblas_tpu.models import sssp as jsssp
from combblas_tpu.parallel.ellmat import EllParMat as JaxEllParMat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu_torch import PAD_ROOT, EllParMat, Grid
from combblas_tpu_torch.models.bfs import (
    DEFAULT_SEQ_TIERS, bfs, bfs_batch, bfs_batch_compact, bfs_single, parse_tier_spec,
    validate_bfs_device,
)
from combblas_tpu_torch.models.sssp import sssp_batch
from combblas_tpu_torch.parallel.ellmat import (
    build_csc_companion, build_csr_companion, col_blocks,
)
from combblas_tpu_torch.parallel.vec import DistMultiVec
from combblas_tpu_torch.serve import GraphEngine
from torch_serve_parity import own_plan_store  # noqa: F401

# engines record their lanes in the plan store: each test keeps its own
pytestmark = pytest.mark.usefixtures("own_plan_store")

ROOTS = np.array([0, 1, PAD_ROOT, 2, 3], np.int32)
MISALIGNED = [(4, 2, 9), (4, 2, 17), (4, 2, 33), (2, 1, 9)]
IDS = [f"{a}x{b}-n{n}" for a, b, n in MISALIGNED]


def graph(n, seed=9):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    keys = np.unique(np.concatenate([a * n + b, b * n + a]))
    r, c = keys // n, keys % n
    w = (1 + (np.minimum(r, c) * 7 + np.maximum(r, c) * 3) % 5).astype(np.float32)
    return r, c, w


def scipy_levels(r, c, n):
    """Hop counts from each live root, [n, W], -1 where unreachable."""
    M = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    out = np.full((n, len(ROOTS)), -1, np.int64)
    for k, s in enumerate(ROOTS):
        if s != PAD_ROOT:
            d = cg.shortest_path(M, unweighted=True, indices=int(s))
            out[:, k] = np.where(np.isinf(d), -1, d)
    return out


def scipy_dist(r, c, w, n):
    M = sp.csr_matrix((w, (c, r)), shape=(n, n))  # entry (i, j) = w(j -> i)
    out = np.full((n, len(ROOTS)), np.inf, np.float32)
    for k, s in enumerate(ROOTS):
        if s != PAD_ROOT:
            out[:, k] = cg.shortest_path(M, indices=int(s)).astype(np.float32)
    return out


def check_tree(parents, levels, r, c, want_levels):
    """Levels are scipy's; a root is its own parent; every other
    discovered vertex's parent is a neighbour one level up."""
    levels = levels.astype(np.int64)
    assert np.array_equal(levels, want_levels)
    edges = set(zip(r.tolist(), c.tolist()))
    for k, s in enumerate(ROOTS):
        for v in range(levels.shape[0]):
            p, lv = int(parents[v, k]), int(levels[v, k])
            if lv < 0:
                assert p == -1
            elif lv == 0:
                assert v == s and p == s
            else:
                assert (v, p) in edges and levels[p, k] == lv - 1, (v, k, p)


def ell(shape, n, r, c, vals):
    return EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, vals, n, n)


@pytest.mark.parametrize("pr,pc,n", MISALIGNED, ids=IDS)
def test_bfs_loops_equal_scipy(pr, pc, n):
    r, c, _ = graph(n)
    E = ell((pr, pc), n, r, c, np.ones(len(r), np.float32))
    lc = -(-n // pc)
    assert -(-pr * (-(-n // pr)) // pc) != lc  # the blocks are misaligned here
    want = scipy_levels(r, c, n)
    p, lv, _ = bfs_batch(E, ROOTS)
    check_tree(p.to_global(), lv.to_global(), r, c, want)
    p, lv, _ = bfs_batch_compact(E, ROOTS)
    check_tree(p.to_global(), lv.to_global(), r, c, want)
    assert set(bfs_batch_compact.last_run["steps"]) == {"dense"}
    csc = build_csc_companion(E.grid, r, c, n, n)
    p, lv, _ = bfs_batch_compact(E, ROOTS, csc=csc, frontier_capacity=n, edge_capacity=4 * n)
    assert "sparse" in bfs_batch_compact.last_run["steps"]
    check_tree(p.to_global(), lv.to_global(), r, c, want)
    for k in (0, 3):
        p1, l1, _ = bfs(E, int(ROOTS[k]))
        assert np.array_equal(l1.to_global().astype(np.int64), want[:, k])
        par, edges = p1.to_global(), set(zip(r.tolist(), c.tolist()))
        for v in np.flatnonzero(want[:, k] > 0):
            assert (v, par[v]) in edges and want[par[v], k] == want[v, k] - 1


@pytest.mark.parametrize("pr,pc,n", MISALIGNED, ids=IDS)
def test_sssp_batch_equals_scipy(pr, pc, n):
    r, c, w = graph(n)
    d, _ = sssp_batch(ell((pr, pc), n, r, c, w), ROOTS)
    assert np.array_equal(d.to_global(), scipy_dist(r, c, w, n))


@pytest.mark.parametrize("pr,pc,n", MISALIGNED, ids=IDS)
@pytest.mark.parametrize("spec", ["", DEFAULT_SEQ_TIERS], ids=["dense", "tiered"])
def test_bfs_single_equals_scipy(pr, pc, n, spec):
    """``bfs_single``'s dense sweep and its top-down / bottom-up walks
    read each level's frontier and the column degrees as tile columns."""
    r, c, _ = graph(n)
    E = ell((pr, pc), n, r, c, np.ones(len(r), np.float32))
    csc = build_csc_companion(E.grid, r, c, n, n)
    csr = build_csr_companion(E.grid, r, c, n, n)
    want = scipy_levels(r, c, n)
    edges = set(zip(r.tolist(), c.tolist()))
    for k in (0, 1, 3):
        p, lv, _ = bfs_single(E, int(ROOTS[k]), csc, tiers=parse_tier_spec(spec), csr=csr)
        assert np.array_equal(lv.to_global().astype(np.int64), want[:, k])
        par = p.to_global()
        for v in np.flatnonzero(want[:, k] > 0):
            assert (v, par[v]) in edges and want[par[v], k] == want[v, k] - 1


@pytest.mark.parametrize("pr,pc,n", MISALIGNED, ids=IDS)
def test_validate_bfs_device_counts_as_on_one_tile(pr, pc, n):
    """The device validator reads the levels as tile columns: on a
    misaligned grid it counts, lane by lane, what it counts on 1x1 for the
    same trees, a good tree and one with a parent moved off its edge."""
    r, c, _ = graph(n)
    ones = np.ones(len(r), np.float32)
    E, E1 = ell((pr, pc), n, r, c, ones), ell((1, 1), n, r, c, ones)
    p, lv, _ = bfs_batch(E1, ROOTS)
    P, L = p.to_global(), lv.to_global()
    bad = P.copy()
    v = int(np.flatnonzero(L[:, 0] > 1)[0])
    bad[v, 0] = int(ROOTS[0])  # the root, two or more levels up: no edge
    for parents in (P, bad):
        got = [validate_bfs_device(M, DistMultiVec.from_global(M.grid, parents, align="row"),
                                   DistMultiVec.from_global(M.grid, L, align="row")).numpy()
               for M in (E, E1)]
        assert np.array_equal(got[0], got[1])
    assert got[0][1:, 0].sum() > 0 and got[0][1:, [1, 3, 4]].sum() == 0


@pytest.mark.parametrize("pr,pc,n", MISALIGNED, ids=IDS)
def test_engine_lanes_equal_scipy(pr, pc, n):
    r, c, w = graph(n)
    eng = GraphEngine.from_coo(Grid.make(pr, pc, device="cpu"), r, c, n, weights=w,
                               kinds=("bfs", "sssp"))
    res = eng.execute("bfs", ROOTS)
    check_tree(res["parents"], res["levels"], r, c, scipy_levels(r, c, n))
    assert np.array_equal(eng.execute("sssp", ROOTS)["dist"], scipy_dist(r, c, w, n))
    srv = eng.serve()
    futs = srv.submit_many("bfs", [0, 3]) + srv.submit_many("sssp", [1])
    srv.close()
    want = scipy_levels(r, c, n)
    assert np.array_equal(futs[0].result(timeout=0)["levels"].astype(np.int64), want[:, 0])
    assert np.array_equal(futs[1].result(timeout=0)["levels"].astype(np.int64), want[:, 4])
    assert np.array_equal(futs[2].result(timeout=0)["dist"], scipy_dist(r, c, w, n)[:, 1])


@pytest.mark.parametrize("pr,pc,n", [(2, 4, 9), (2, 4, 33), (1, 2, 9)],
                         ids=["2x4-n9", "2x4-n33", "1x2-n9"])
def test_aligned_rectangles_equal_reference(pr, pc, n):
    """Where the blocks line up the outputs stay the reference's, bit for
    bit (and scipy's)."""
    r, c, w = graph(n)
    ones = np.ones(len(r), np.float32)
    mine = ell((pr, pc), n, r, c, ones)
    ref = JaxEllParMat.from_host_coo(JaxGrid.make(pr, pc), r, c, ones, n, n)
    mine_w = ell((pr, pc), n, r, c, w)
    ref_w = JaxEllParMat.from_host_coo(JaxGrid.make(pr, pc), r, c, w, n, n)
    for fn_t, fn_j in ((bfs_batch, jbfs.bfs_batch), (bfs_batch_compact, jbfs.bfs_batch_compact)):
        (tp, tl, ti), (jp, jl, ji) = fn_t(mine, ROOTS), fn_j(ref, ROOTS)
        assert ti == int(ji)
        for a, b in ((tp, jp), (tl, jl)):
            assert np.array_equal(a.blocks.numpy(), np.asarray(b.blocks))
        check_tree(tp.to_global(), tl.to_global(), r, c, scipy_levels(r, c, n))
    (tp, tl, ti), (jp, jl, ji) = bfs(mine, 1), jbfs.bfs(ref, 1)
    assert ti == int(ji)
    assert np.array_equal(tp.blocks.numpy(), np.asarray(jp.blocks))
    assert np.array_equal(tl.blocks.numpy(), np.asarray(jl.blocks))
    (td, ti), (jd, ji) = sssp_batch(mine_w, ROOTS), jsssp.sssp_batch(ref_w, ROOTS)
    assert ti == int(ji)
    assert np.array_equal(td.blocks.numpy(), np.asarray(jd.blocks))
    assert np.array_equal(td.to_global(), scipy_dist(r, c, w, n))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 4), (2, 4), (1, 2)])
def test_col_blocks_returns_aligned_input_itself(shape):
    """Where a col-aligned operand already has ``local_cols`` slots a
    block (every square grid, and 2x4 / 1x2 here), ``col_blocks`` returns
    the very tensor it was given: no copy."""
    n = 33
    r, c, _ = graph(n)
    E = ell(shape, n, r, c, np.ones(len(r), np.float32))
    x = torch.arange(n * 3, dtype=torch.int32).reshape(n, 3)
    X = DistMultiVec.from_global(E.grid, x.numpy(), align="row").realign("col").blocks
    assert col_blocks(E, X) is X


def test_col_blocks_recuts_in_global_order():
    n = 33
    r, c, _ = graph(n)
    E = ell((4, 2), n, r, c, np.ones(len(r), np.float32))
    x = np.arange(n, dtype=np.int32) + 100
    X = DistMultiVec.from_global(E.grid, np.stack([x, -x], 1), align="row").realign("col").blocks
    assert X.shape[1] == 18 and E.local_cols == 17
    got = col_blocks(E, X)
    assert got.shape == (2, 17, 2)
    assert np.array_equal(got.reshape(-1, 2)[:n].numpy(), np.stack([x, -x], 1))
