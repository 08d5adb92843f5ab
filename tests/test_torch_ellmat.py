"""Parity of the port's ``EllParMat`` (host build, companions, the three
steps of the batched BFS) with ``combblas_tpu.parallel.ellmat`` on the
CPU. Every array is an integer (or copied without arithmetic), so every
comparison is exact: ``array_equal``, no tolerance.

The reference runs on the virtual CPU mesh that ``tests/conftest.py`` sets
up; the port runs the same grids as tiles on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.parallel import ellmat as jax_ellmat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.grid import HostGrid as JaxHostGrid
from combblas_tpu_torch import (
    EllParMat,
    Grid,
    HostGrid,
    build_csc_companion,
    build_csc_companion_host,
    build_csr_companion_host,
    csc_companion_from_arrays,
    ellparmat_from_arrays,
    rmat_symmetric_coo_host,
)
from combblas_tpu_torch.parallel import ellmat as torch_ellmat

GRIDS = [(1, 1), (2, 2), (2, 4)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]


def graph(scale: int, edgefactor: int = 8):
    """Deduplicated symmetric R-MAT COO (int64) and float32 values."""
    n = 1 << scale
    r, c = rmat_symmetric_coo_host(scale, scale, edgefactor)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = np.random.default_rng(scale).integers(1, 100, len(r)).astype(np.float32)
    return r, c, v, n


def assert_buckets_equal(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        for name, ga, wa in zip(("cols", "vals", "rowids"), g, w):
            ga, wa = np.asarray(ga), np.asarray(wa)
            assert ga.dtype == wa.dtype and ga.shape == wa.shape, (b, name)
            np.testing.assert_array_equal(ga, wa, err_msg=f"bucket {b} {name}")


@pytest.mark.parametrize("kind", ["fine", "coarse"])
@pytest.mark.parametrize("max_k", [1, 2, 3, 7, 16, 100, 1000, 4097])
def test_width_ladder_matches_reference(kind, max_k):
    got = torch_ellmat._width_ladder(max_k, kind)
    want = jax_ellmat._width_ladder(max_k, kind)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_width_ladder_rejects_unknown_kind():
    with pytest.raises(ValueError, match="fine"):
        torch_ellmat._width_ladder(8, "medium")


@pytest.mark.parametrize("headroom", [0, 0.5])
@pytest.mark.parametrize("max_k", [None, 6])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("scale", [8, 9, 10])
def test_host_build_matches_reference(scale, shape, max_k, headroom):
    r, c, v, n = graph(scale)
    got = EllParMat.host_build(HostGrid(*shape), r, c, v, n, n, max_k=max_k, headroom=headroom)
    want = jax_ellmat.EllParMat.host_build(
        JaxHostGrid(*shape), r, c, v, n, n, max_k=max_k, headroom=headroom
    )
    assert_buckets_equal(got, want)


def test_host_build_coarse_ladder_and_int8_values():
    r, c, _, n = graph(9)
    v = np.zeros(len(r), np.int8)
    got = EllParMat.host_build(HostGrid(2, 2), r, c, v, n, n, ladder="coarse")
    want = jax_ellmat.EllParMat.host_build(
        JaxHostGrid(2, 2), r, c, v, n, n, ladder="coarse", headroom=0
    )
    assert_buckets_equal(got, want)


def test_small_max_k_splits_rows():
    """With max_k below the largest degree a row spans several bucket rows:
    the case the scatter-max of every step has to combine."""
    r, c, v, n = graph(8)
    buckets = EllParMat.host_build(HostGrid(1, 1), r, c, v, n, n, max_k=6)
    rowids = np.concatenate([br[0, 0][br[0, 0] < n] for _, _, br in buckets])
    assert len(np.unique(rowids)) < len(rowids)


@pytest.mark.parametrize("major", ["col", "row"])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("scale", [8, 9, 10])
def test_companion_host_matches_reference(scale, shape, major):
    r, c, _, n = graph(scale)
    mine = build_csc_companion_host if major == "col" else build_csr_companion_host
    ref = (jax_ellmat.build_csc_companion_host if major == "col"
           else jax_ellmat.build_csr_companion_host)
    got = mine(HostGrid(*shape), r, c, n, n)
    want = ref(JaxHostGrid(*shape), r, c, n, n)
    for name, g, w in zip(("indptr", "minidx"), got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("max_k", [None, 6])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_to_host_coo_round_trip(shape, max_k):
    r, c, v, n = graph(8)
    grid = Grid.make(*shape, device="cpu")
    E = EllParMat.from_host_coo(grid, r, c, v, n, n, max_k=max_k)
    gr, gc, gv = E.to_host_coo()
    np.testing.assert_array_equal(gr, r)  # `graph` sorts by (row, col)
    np.testing.assert_array_equal(gc, c)
    np.testing.assert_array_equal(gv, v)
    assert int(E.getnnz()) == len(r)
    assert E.dtype == torch.float32 and E.local_rows == -(-n // shape[0])
    ref = jax_ellmat.EllParMat.from_host_coo(JaxGrid.make(*shape), r, c, v, n, n, max_k=max_k)
    for g, w in zip((gr, gc, gv), ref.to_host_coo()):
        np.testing.assert_array_equal(g, w)
    assert int(ref.getnnz()) == int(E.getnnz())


def both_mats(shape, max_k, scale=8):
    """The reference's EllParMat on its mesh and the port's, carried over
    array by array, with the graph's COO."""
    r, c, _, n = graph(scale)
    v = np.zeros(len(r), np.int8)
    ref = jax_ellmat.EllParMat.from_host_coo(JaxGrid.make(*shape), r, c, v, n, n, max_k=max_k)
    grid = Grid.make(*shape, device="cpu")
    mine = ellparmat_from_arrays(
        grid, [tuple(np.asarray(a) for a in b) for b in ref.buckets], n, n
    )
    return ref, mine, (r, c, n)


STEP_CASES = [((1, 1), None), ((1, 1), 6), ((2, 2), None), ((2, 2), 6), ((2, 4), 6)]
STEP_IDS = [f"{a}x{b}-max_k{k}" for (a, b), k in STEP_CASES]
W = 5


@pytest.mark.parametrize("shape, max_k", STEP_CASES, ids=STEP_IDS)
def test_levels_step_matches_reference(shape, max_k):
    ref, mine, _ = both_mats(shape, max_k)
    rng = np.random.default_rng(sum(shape))
    x8 = (rng.random((shape[1], mine.local_cols, W)) < 0.05).astype(np.int8)
    u8 = (rng.random((shape[0], mine.local_rows, W)) < 0.7).astype(np.int8)
    want = np.asarray(jax_ellmat._ell_levels_step(ref, jnp.asarray(x8), jnp.asarray(u8)))
    got = torch_ellmat._ell_levels_step(mine, torch.from_numpy(x8), torch.from_numpy(u8))
    assert got.dtype == torch.int8 and want.any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape, max_k", STEP_CASES, ids=STEP_IDS)
def test_parents_from_levels_matches_reference(shape, max_k):
    ref, mine, _ = both_mats(shape, max_k)
    rng = np.random.default_rng(10 + sum(shape))
    lvl_c = rng.integers(-1, 4, (shape[1], mine.local_cols, W)).astype(np.int8)
    lvl_r = rng.integers(-1, 4, (shape[0], mine.local_rows, W)).astype(np.int8)
    want = np.asarray(
        jax_ellmat._ell_parents_from_levels(ref, jnp.asarray(lvl_c), jnp.asarray(lvl_r))
    )
    got = torch_ellmat._ell_parents_from_levels(
        mine, torch.from_numpy(lvl_c), torch.from_numpy(lvl_r)
    )
    assert got.dtype == torch.int32 and (want >= 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slicing", ["levels", "parents"])
def test_row_slicing_keeps_the_results(slicing, monkeypatch):
    """A byte envelope small enough to cut every bucket into several row
    slices gives the same arrays as the default (one slice)."""
    _, mine, _ = both_mats((2, 2), 6)
    rng = np.random.default_rng(3)
    x8 = torch.from_numpy((rng.random((2, mine.local_cols, W)) < 0.05).astype(np.int8))
    u8 = torch.ones((2, mine.local_rows, W), dtype=torch.int8)
    lvl = torch.from_numpy(rng.integers(-1, 4, (2, mine.local_rows, W)).astype(np.int8))
    if slicing == "levels":
        run = lambda: torch_ellmat._ell_levels_step(mine, x8, u8)
        name = "LEVELS_BUDGET_BYTES"
    else:
        run = lambda: torch_ellmat._ell_parents_from_levels(mine, lvl, lvl)
        name = "PARENTS_BUDGET_BYTES"
    whole = run()
    monkeypatch.setattr(torch_ellmat, name, 7 * W)
    assert len(torch_ellmat._bucket_row_slices(40, 3, W, 7 * W)) == 20
    assert torch.equal(run(), whole)


@pytest.mark.parametrize("nb, kb, w, budget", [(100, 8, 256, 1 << 32), (100, 8, 256, 4096),
                                               (7, 3, 0, 1), (0, 4, 16, 64)])
def test_bucket_row_slices_matches_reference(nb, kb, w, budget):
    assert (torch_ellmat._bucket_row_slices(nb, kb, w, budget)
            == jax_ellmat._bucket_row_slices(nb, kb, w, budget))


@pytest.mark.parametrize("budgets", ["generous", "snug"])
@pytest.mark.parametrize("shape, max_k", STEP_CASES[:4], ids=STEP_IDS[:4])
def test_union_sparse_step_matches_reference(shape, max_k, budgets):
    ref, mine, (r, c, n) = both_mats(shape, max_k)
    rng = np.random.default_rng(20 + sum(shape))
    x8 = (rng.random((shape[1], mine.local_cols, W)) < 0.02).astype(np.int8)
    u8 = (rng.random((shape[0], mine.local_rows, W)) < 0.7).astype(np.int8)
    indptr, rowidx = jax_ellmat.build_csc_companion_host(JaxHostGrid(*shape), r, c, n, n)
    if budgets == "generous":
        fcap, ecap = mine.local_cols, len(r)
    else:  # the least budgets that hold every tile's union frontier
        act = x8.max(axis=2) > 0  # [pc, lc]
        fcap = int(act.sum(axis=1).max())
        deg = indptr[:, :, 1:] - indptr[:, :, :-1]  # [pr, pc, lc]
        ecap = int((deg * act[None]).sum(axis=2).max())
    want = np.asarray(jax_ellmat._ell_union_sparse_step(
        ref, jnp.asarray(indptr), jnp.asarray(rowidx), jnp.asarray(x8), jnp.asarray(u8),
        frontier_capacity=fcap, edge_capacity=ecap,
    ))
    csc = csc_companion_from_arrays(mine.grid, indptr, rowidx)
    got = torch_ellmat._ell_union_sparse_step(
        mine, *csc, torch.from_numpy(x8), torch.from_numpy(u8), fcap, ecap
    )
    assert want.any()
    np.testing.assert_array_equal(got.numpy(), want)
    # the same level as the dense sweep computes it
    dense = torch_ellmat._ell_levels_step(mine, torch.from_numpy(x8), torch.from_numpy(u8))
    assert torch.equal(got, dense)


def test_build_csc_companion_uploads_the_host_arrays():
    r, c, _, n = graph(8)
    grid = Grid.make(2, 2, device="cpu")
    indptr, rowidx = build_csc_companion(grid, r, c, n, n)
    want = build_csc_companion_host(grid, r, c, n, n)
    assert indptr.dtype == rowidx.dtype == torch.int32
    np.testing.assert_array_equal(indptr.numpy(), want[0])
    np.testing.assert_array_equal(rowidx.numpy(), want[1])


def test_carry_over_checks_the_layout():
    grid = Grid.make(2, 2, device="cpu")
    with pytest.raises(ValueError, match="2x2 grid"):
        ellparmat_from_arrays(grid, [(np.zeros((1, 1, 4, 2)),) * 2 + (np.zeros((1, 1, 4)),)], 8, 8)
    with pytest.raises(ValueError, match="2x2 grid"):
        csc_companion_from_arrays(grid, np.zeros((1, 1, 5)), np.zeros((1, 1, 3)))
