"""Parity of the port's general SpGEMM with ``combblas_tpu`` on the CPU: the
local ESC kernel (``expand``, ``flops``, ``flops_padded``,
``local_spgemm``, ``mask_rows``), the sorted-run merge, the ESC SUMMA
(``spgemm``: merge by sort and by runs, all-gather and ring stage order)
and the scan SUMMA (``spgemm_scan`` with its retries) on 1x1 and 2x2
grids, the symbolic capacities (device and host passes),
``mem_efficient_spgemm`` with ``PhaseAdjustedWarning``, ``block_spgemm``,
the router's scan and windowed rungs, ``indexing.py`` (``subsref``,
``spasgn``) and the bit-packed support oracle.

Outputs are compared array by array (rows, cols, vals, nnz, capacity,
padding slots included). Exact for min/max semirings, for integer
results and for ``plus_times`` on integer-valued float32 weights (every
sum below 2**24); ``plus_times`` on random float32 within ``rtol=1e-6``
(and ``atol=1e-6``): the port's scatter-add folds a key's products in
another order than the reference's segment sum. A duplicated-COO input
(not deduplicated) is among the cases.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.ops import spgemm as jops
from combblas_tpu.ops.compressed import CSR as JaxCSR
from combblas_tpu.ops.tuples import SpTuples as JaxSpTuples
from combblas_tpu.parallel import indexing as jidx
from combblas_tpu.parallel import mesh3d as jmesh
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.utils.rmat import rmat_symmetric_coo_host as jax_rmat
from combblas_tpu_torch import (
    CSR,
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    Grid,
    HostGrid,
    SpParMat,
    SpTuples,
)
from combblas_tpu_torch.ops import spgemm as tops
from combblas_tpu_torch.parallel import indexing as tidx
from combblas_tpu_torch.parallel import mesh3d as tmesh
from combblas_tpu_torch.parallel import spgemm as tpar

SEMIRINGS = {
    "plus_times": (PLUS_TIMES, jsr.PLUS_TIMES),
    "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
    "max_min": (MAX_MIN, jsr.MAX_MIN),
    "select2nd_max": (SELECT2ND_MAX, jsr.SELECT2ND_MAX),
}
SCALE = 6
N = 1 << SCALE
SLOW = pytest.mark.slow
# the reference's local kernels, compiled once a semiring and capacity
jit_expand = jax.jit(jops.expand, static_argnums=(0, 3))
jit_local_spgemm = jax.jit(jops.local_spgemm, static_argnums=0,
                           static_argnames=("flop_capacity", "out_capacity"))
jit_mask_rows = jax.jit(jops.mask_rows, static_argnums=(1, 2))


def assert_same(got, want, tol=False):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:  # the reference's packed words: compare the bits
        want = want.view(np.int32)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if tol:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32), want[keep].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


def assert_same_mat(got, want, tol=False):
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "nnz"):
        assert_same(getattr(got, f), getattr(want, f))
    assert_same(got.vals, want.vals, tol)


def graph(seed=1, weights="ints", scale=SCALE, edgefactor=6):
    """An R-MAT graph: symmetrized, with its duplicates (the COO repeats
    entries), weights 1..15 or uniform float32."""
    r, c = jax_rmat(seed, scale, edgefactor)
    rng = np.random.default_rng(seed + 100)
    if weights == "float":
        v = rng.uniform(0.1, 1.0, r.shape[0]).astype(np.float32)
    else:
        v = rng.integers(1, 16, r.shape[0]).astype(np.float32)
    return r, c, v


def both(p, r, c, v, m=N, n=N, dedup=None, capacity=None):
    """The same COO loaded by each package on a p×p (or p[0]×p[1]) grid."""
    pr, pc = (p, p) if isinstance(p, int) else p
    sr, jr = SEMIRINGS[dedup] if dedup else (None, None)
    return (JaxSpParMat.from_global_coo(JaxGrid.make(pr, pc), r, c, v, m, n,
                                        capacity=capacity, dedup_sr=jr),
            SpParMat.from_global_coo(Grid.make(pr, pc, device="cpu"), r, c, v, m, n,
                                     capacity=capacity, dedup_sr=sr))


def both_tuples(r, c, v, m, n, capacity=None):
    return (JaxSpTuples.from_coo(r, c, v, m, n, capacity),
            SpTuples.from_coo(r, c, v, m, n, capacity, device="cpu"))


# --- the local ESC kernel ------------------------------------------------------


def _local_operands(seed=3, m=21, k=17, n=19, dup=True):
    """A (m×k, unsorted, with a repeated entry) and B (k×n) as tuples of
    both packages, with padding slots."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, k)) < 0.3
    b = rng.random((k, n)) < 0.35
    b[2, :] = True  # one long row: a walk of more than one 32-lane chunk
    ar, ac = np.nonzero(a)
    br, bc = np.nonzero(b)
    perm = rng.permutation(len(ar))
    ar, ac = ar[perm], ac[perm]
    if dup:
        ar, ac = np.concatenate([ar, ar[:3]]), np.concatenate([ac, ac[:3]])
    av = rng.integers(1, 9, len(ar)).astype(np.float32)
    bv = rng.integers(1, 9, len(br)).astype(np.float32)
    return (both_tuples(ar, ac, av, m, k, capacity=len(ar) + 5),
            both_tuples(br, bc, bv, k, n, capacity=len(br) + 4))


def test_flops_and_expand_match_reference():
    """``flops``, ``flops_padded``, ``expand`` at the padded count and cut
    short (a capacity below it), ``mask_rows`` and ``local_spgemm``."""
    (ja, ta), (jb, tb) = _local_operands()
    jcsr, tcsr = JaxCSR.from_tuples(jb), CSR.from_tuples(tb)
    assert_same(tops.flops(ta, tcsr), jops.flops(ja, jcsr))
    assert_same(tops.flops_padded(ta, tcsr), jops.flops_padded(ja, jcsr))
    padded = int(jops.flops_padded(ja, jcsr))
    assert padded > int(jops.flops(ja, jcsr))
    assert int(tops.expansion_slots(ta, tcsr)) == padded
    for sr_name, caps in (("plus_times", (padded,)), ("min_plus", (padded, padded - 40, 70))):
        sr, jr = SEMIRINGS[sr_name]
        for cap in caps:
            got, want = tops.expand(sr, ta, tcsr, cap), jit_expand(jr, ja, jcsr, cap)
            assert_same_mat(got, want)
        assert_same_mat(tops.mask_rows(got, 4, 13), jit_mask_rows(want, 4, 13))
        got = tops.local_spgemm(sr, ta, tcsr, flop_capacity=padded, out_capacity=200)
        assert_same_mat(got, jit_local_spgemm(jr, ja, jcsr, flop_capacity=padded,
                                              out_capacity=200))


def test_merge_sorted_runs_match_reference():
    """Three sorted runs of different capacities with shared keys: the
    merge equals the reference's and a concat + stable sort, slot for
    slot; ``_lex_searchsorted`` both sides."""
    rng = np.random.default_rng(4)
    runs = []
    for cap in (9, 14, 6):
        d = rng.random((7, 8)) < 0.2
        r, c = np.nonzero(d)
        v = rng.integers(0, 50, len(r)).astype(np.float32)
        jt, tt = both_tuples(r, c, v, 7, 8, capacity=cap)
        runs.append((jt, tt))
    got = tops.merge_sorted_runs([t for _, t in runs])
    want = jops.merge_sorted_runs([j for j, _ in runs])
    assert_same_mat(got, want)
    assert_same_mat(got, SpTuples.concat([t for _, t in runs]).sort_rowmajor())
    (ja, ta), (jb, tb) = runs[0], runs[1]
    for side in ("left", "right"):
        assert_same(tops._lex_searchsorted(ta.rows, ta.cols, tb.rows, tb.cols, side),
                    jops._lex_searchsorted(ja.rows, ja.cols, jb.rows, jb.cols, side))
    with pytest.raises(ValueError, match="at least one run"):
        tops.merge_sorted_runs([])


# --- the SUMMA tiers -----------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_min", "select2nd_max"])
def test_spgemm_matches_reference(p, sr_name):
    """A·A through the ESC tier, merge by sort, on the duplicated COO
    (``dedup_sr=None``: repeated entries fold in the product)."""
    sr, jr = SEMIRINGS[sr_name]
    jA, tA = both(p, *graph())
    assert_same_mat(tpar.spgemm(sr, tA, tA), jpar.spgemm(jr, jA, jA))


@pytest.mark.parametrize("p,merge,ring", [
    (1, "runs", False), (1, "sort", True), (1, "runs", True), (2, "runs", True),
    pytest.param(2, "runs", False, marks=SLOW), pytest.param(2, "sort", True, marks=SLOW)])
def test_summa_merge_and_ring_match_reference(p, merge, ring):
    """The sorted-run merge and the carousel order, min_plus and
    plus_times on float weights (the fold order shows), at the same
    capacities."""
    r, c, v = graph(weights="float")
    jA, tA = both(p, r, c, v, dedup="plus_times")
    fc, oc = jpar.summa_capacities(jA, jA)
    assert (fc, oc) == tpar.summa_capacities(tA, tA)
    for sr_name in ("min_plus", "plus_times"):
        sr, jr = SEMIRINGS[sr_name]
        got = tpar.summa_spgemm(sr, tA, tA, flop_capacity=fc, out_capacity=oc, ring=ring,
                                merge=merge)
        want = jpar.summa_spgemm(jr, jA, jA, flop_capacity=fc, out_capacity=oc, ring=ring,
                                 merge=merge)
        assert_same_mat(got, want, tol=sr_name == "plus_times")


def test_carousel_tables_match_reference():
    """The carousel's permutation tables, and the contraction index
    (i + j + s) % p each device holds at stage s."""
    for p in (1, 2, 3):
        assert tpar._carousel_perms(p) == jpar._carousel_perms(p)
        for s, a, b in tpar._carousel_stages(p):
            for i in range(p):
                for j in range(p):
                    k = (i + j + s) % p
                    assert a[i * p + j] == (i, k) and b[i * p + j] == (k, j)


@pytest.mark.parametrize("p", [1, 2])
def test_symbolic_pass_matches_reference(p):
    """``summa_stage_flops`` padded and not, the host twins, and the
    capacities from both (rectangular product)."""
    r, c, v = graph()
    jA, tA = both(p, r, c, v, dedup="plus_times")
    keep = c < 40
    jB, tB = both(p, r[keep], c[keep], v[keep], m=N, n=40)
    for padded in (True, False):
        assert_same(tpar.summa_stage_flops(tA, tB, padded), jpar.summa_stage_flops(jA, jB, padded))
    hg = HostGrid(p, p)
    rA, cA, _ = tA.to_global_coo()
    rB, cB, _ = tB.to_global_coo()
    host = tpar.summa_stage_flops_host(hg, rA, cA, rB, cB, N, N, 40)
    np.testing.assert_array_equal(host, jpar.summa_stage_flops_host(
        JaxGrid.make(p, p), rA, cA, rB, cB, N, N, 40))
    np.testing.assert_array_equal(host, tpar.summa_stage_flops(tA, tB).numpy())
    assert tpar.summa_capacities(tA, tB) == jpar.summa_capacities(jA, jB)
    assert (tpar.summa_capacities_host(hg, rA, cA, rB, cB, N, N, 40)
            == jpar.summa_capacities_host(JaxGrid.make(p, p), rA, cA, rB, cB, N, N, 40))
    assert tpar.estimate_flops(tA, tB) == jpar.estimate_flops(jA, jB)
    assert tpar.estimate_nnz_upper(tA, tB) == jpar.estimate_nnz_upper(jA, jB)
    for budget in (1 << 10, 1 << 14, 1 << 30):
        assert tpar.calculate_phases(tA, tB, budget) == jpar.calculate_phases(jA, jB, budget)


def test_float32_counts_give_the_reference_capacities():
    """Past 2**24 the reference's float32 flop sums round; the port counts
    exactly and rounds once. On a matrix whose counts pass 2**24 the
    capacities ``spgemm`` derives (powers of two) are the same."""
    n = 4096
    rng = np.random.default_rng(9)
    r = rng.integers(0, n, 300_000)
    c = rng.integers(0, 64, 300_000)  # 64 hub columns of B rows ~4700 long
    jA, tA = both(1, r, c, np.ones(len(r), np.float32), m=n, n=n)
    want = np.asarray(jpar.summa_stage_flops(jA, jA)).astype(np.float64)
    got = tpar.summa_stage_flops(tA, tA).numpy().astype(np.float64)
    assert got.max() > 2**24
    caps = [jpar._caps_from_stage_flops(x, n * n, 1.05) for x in (want, got)]
    pow2 = [(1 << (a - 1).bit_length(), 1 << (b - 1).bit_length()) for a, b in caps]
    assert pow2[0] == pow2[1]


@pytest.mark.parametrize("p", [pytest.param(1, marks=SLOW), 2])
def test_spgemm_scan_matches_reference(p):
    """The scan tier: a first capacity that overflows (retries grow it at
    least 2x) and one that fits; the overflow counts of one run; the ring
    order."""
    sr, jr = SEMIRINGS["min_plus"]
    jA, tA = both(p, *graph())
    for cap in (None, 64, 4096):
        assert_same_mat(tpar.spgemm_scan(sr, tA, tA, out_capacity=cap),
                        jpar.spgemm_scan(jr, jA, jA, out_capacity=cap))
    fc, _ = jpar.summa_capacities(jA, jA, 1.1)
    for ring in (False, True):
        got, gover = tpar.summa_spgemm_scan(sr, tA, tA, flop_capacity=fc, out_capacity=64,
                                            ring=ring)
        want, wover = jpar.summa_spgemm_scan(jr, jA, jA, flop_capacity=fc, out_capacity=64,
                                             ring=ring)
        assert int(gover) == int(wover) > 0
        assert_same_mat(got, want)
    with pytest.raises(ValueError, match="still overflowing"):
        tpar.spgemm_scan(sr, tA, tA, out_capacity=64, max_retries=0)


def test_mem_efficient_spgemm_matches_reference():
    """Phased SUMMA at a divisor and at a phase count moved up (with the
    warning's fields), phased scan, a prune hook."""
    sr, jr = SEMIRINGS["plus_times"]
    jA, tA = both(1, *graph())
    assert_same_mat(tpar.mem_efficient_spgemm(sr, tA, tA, 4),
                    jpar.mem_efficient_spgemm(jr, jA, jA, 4))
    with pytest.warns(tpar.PhaseAdjustedWarning) as rec:
        got = tpar.mem_efficient_spgemm(sr, tA, tA, 3, scan=True)
    w = rec[0].message
    assert (w.requested, w.actual, w.local_cols) == (3, 4, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jpar.mem_efficient_spgemm(jr, jA, jA, 3, scan=True)
    assert_same_mat(got, want)
    _, odd = both(2, *graph(), m=74, n=74)  # 37 local columns: no divisor near 2
    with pytest.raises(ValueError, match="nearest divisor"):
        tpar.mem_efficient_spgemm(sr, odd, odd, 2)
    assert_same_mat(tpar.mem_efficient_spgemm(sr, tA, tA, 2, prune_fn=lambda C: C.prune(
        lambda v: v < 20)), jpar.mem_efficient_spgemm(jr, jA, jA, 2, prune_fn=lambda C: C.prune(
            lambda v: v < 20)))


def test_block_spgemm_matches_reference():
    """The blocked product's blocks, 2 row by 2 column blocks."""
    sr, jr = SEMIRINGS["min_plus"]
    jA, tA = both(1, *graph())
    got = dict(tpar.block_spgemm(sr, tA, tA, 2, 2))
    want = dict(jpar.block_spgemm(jr, jA, jA, 2, 2))
    assert got.keys() == want.keys() == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for key in got:
        assert_same_mat(got[key], want[key])


def test_router_and_spgemm_auto_match_reference():
    """``choose_spgemm_tier`` gives the reference's tier (mxu, windowed,
    scan) for unique and duplicated tiles, generic and dense-kernel
    semirings and both backends; ``spgemm_auto`` runs esc, scan and
    windowed (routed and forced) as the reference does; forced to windowed3d
    it runs the layered route on a 2x2x2 grid as the reference does, and
    without ``grid3`` it fails as the reference's does."""
    r, c, v = graph()
    jD, tD = both(1, r, c, v)
    jU, tU = both(1, r, c, v, dedup="min_plus")
    big = 1 << 14  # past MXU_MAX_TILE_DIM: the windowed and scan rungs
    jB, tB = both(1, r, c, v, m=big, n=big)
    for sr_name in SEMIRINGS:
        sr, jr = SEMIRINGS[sr_name]
        for jm, tm in ((jD, tD), (jU, tU), (jB, tB)):
            for backend in ("scatter", "dot"):
                assert (tpar.choose_spgemm_tier(sr, tm, tm, backend=backend)
                        == jpar.choose_spgemm_tier(jr, jm, jm, backend=backend))
    assert tpar.choose_spgemm_tier(MIN_PLUS, tD, tD) == "windowed"
    assert tpar.choose_spgemm_tier(MIN_PLUS, tD, tD, assume_unique=True) == "mxu"
    args = (2**13 + 1, 2**26, 1, 1e6)
    for backend in ("scatter", "dot"):
        for allow in (True, False):
            assert (tpar.choose_tier_from_counts(MIN_PLUS, *args, backend, allow_mxu=allow)
                    == jpar.choose_tier_from_counts(jsr.MIN_PLUS, *args, backend,
                                                    allow_mxu=allow))
    assert tpar.choose_tier_from_counts(MIN_PLUS, 2**14, 2**28, 4, 1e6) == "scan"
    assert tpar.resolve_spgemm_backend() == jpar.resolve_spgemm_backend() == "scatter"
    for backend in ("scatter", "dot"):
        assert (tpar._choose_spgemm_tier_2d(MIN_PLUS, tB, tB, backend=backend)
                == jpar._choose_spgemm_tier_2d(jsr.MIN_PLUS, jB, jB, backend=backend))
    flops = tpar.summa_stage_flops(tD, tD)
    np.testing.assert_array_equal(tpar.host_value(flops),
                                  jpar.host_value(jpar.summa_stage_flops(jD, jD)))
    with pytest.raises(ValueError, match="backend"):
        tpar.resolve_spgemm_backend("hash")
    for tier, sr_name in (("esc", "min_plus"), ("scan", "plus_times"), ("esc", "select2nd_max")):
        sr, jr = SEMIRINGS[sr_name]
        assert_same_mat(tpar.spgemm_auto(sr, tD, tD, tier=tier),
                        jpar.spgemm_auto(jr, jD, jD, tier=tier))
    assert_same_mat(tpar.spgemm_auto(MIN_PLUS, tD, tD, tier="esc", merge="runs"),
                    jpar.spgemm_auto(jsr.MIN_PLUS, jD, jD, tier="esc", merge="runs"))
    assert_same_mat(tpar.spgemm_auto(MIN_PLUS, tD, tD, tier="windowed3d",
                                     grid3=tmesh.Grid3D.make(2, 2, 2, device="cpu")),
                    jpar.spgemm_auto(jsr.MIN_PLUS, jD, jD, tier="windowed3d",
                                     grid3=jmesh.Grid3D.make(2, 2, 2)))
    with pytest.raises(AssertionError, match="needs a grid3"):
        jpar.spgemm_auto(jsr.MIN_PLUS, jD, jD, tier="windowed3d")
    with pytest.raises(ValueError, match="needs a grid3"):
        tpar.spgemm_auto(MIN_PLUS, tD, tD, tier="windowed3d")
    assert tpar.choose_spgemm_tier(MAX_MIN, tD, tD) == "windowed"
    assert_same_mat(tpar.spgemm_auto(MAX_MIN, tD, tD),  # routed to windowed
                    jpar.spgemm_auto(jsr.MAX_MIN, jD, jD))
    assert_same_mat(tpar.spgemm_auto(PLUS_TIMES, tD, tD, tier="windowed", backend="dot"),
                    jpar.spgemm_auto(jsr.PLUS_TIMES, jD, jD, tier="windowed", backend="dot"))
    with pytest.raises(ValueError, match="unknown spgemm tier"):
        tpar.spgemm_auto(MIN_PLUS, tD, tD, tier="dense")


def test_square_matches_reference():
    sr, jr = SEMIRINGS["max_min"]
    jA, tA = both(2, *graph(seed=5))
    assert_same_mat(tA.square(sr), jA.square(jr))


# --- indexing ---------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, pytest.param(2, marks=SLOW)])
def test_subsref_and_spasgn_match_reference(p):
    """``A(ri, ci)`` with repeated and unsorted indices, the selectors, and
    ``A(ri, ci) = B`` with distinct indices; also against numpy."""
    r, c, v = graph(seed=2)
    jA, tA = both(p, r, c, v, dedup="plus_times")
    dense = tA.to_dense()
    rng = np.random.default_rng(6)
    ri = rng.integers(0, N, 24)
    ci = rng.permutation(N)[:19]
    got = tidx.subsref(tA, ri, ci)
    assert_same_mat(got, jidx.subsref(jA, ri, ci))
    np.testing.assert_array_equal(got.to_dense(), dense[np.ix_(ri, ci)])
    assert_same_mat(tidx.row_selector(tA.grid, ri, N, torch.float32),
                    jidx.row_selector(jA.grid, ri, N, jnp.float32))
    assert_same_mat(tidx.col_selector(tA.grid, ci, N, torch.float32),
                    jidx.col_selector(jA.grid, ci, N, jnp.float32))
    ri2 = rng.permutation(N)[:10]
    bdense = (rng.random((10, 19)) < 0.3) * rng.integers(1, 9, (10, 19))
    br, bc = np.nonzero(bdense)
    jB, tB = both(p, br, bc, bdense[br, bc].astype(np.float32), m=10, n=19)
    got = tidx.spasgn(tA, ri2, ci, tB)
    assert_same_mat(got, jidx.spasgn(jA, ri2, ci, jB))
    want = dense.copy()
    want[np.ix_(ri2, ci)] = bdense
    np.testing.assert_array_equal(got.to_dense(), want)
    with pytest.raises(ValueError, match="distinct row"):
        tidx.spasgn(tA, [1, 1], [2, 3], tB)
    with pytest.raises(ValueError, match="out of range"):
        tidx.subsref(tA, [N], [0])


def test_induced_subgraphs_match_reference():
    """Components grouped in two, each group's induced subgraph."""
    from combblas_tpu.parallel.vec import DistVec as JaxDistVec

    from combblas_tpu_torch import DistVec

    jA, tA = both(1, *graph(seed=8), dedup="plus_times")
    lab = np.random.default_rng(1).integers(0, 5, N).astype(np.int32)
    got = tA.induced_subgraphs(DistVec.from_global(tA.grid, lab, align="row"))
    want = jA.induced_subgraphs(JaxDistVec.from_global(jA.grid, lab, align="row"))
    assert len(got) == len(want) == 2
    for (gv, gm), (wv, wm) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        assert_same_mat(gm, wm)


# --- the support oracle -----------------------------------------------------------


def test_popcount32_counts_every_bit():
    """SWAR popcount on words with bit 31 set, against numpy."""
    rng = np.random.default_rng(0)
    w = rng.integers(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32)
    w[:4] = [-1, -2**31, 0, 2**31 - 1]
    want = np.array([bin(int(x) & 0xFFFFFFFF).count("1") for x in w], np.int32)
    np.testing.assert_array_equal(tops.popcount32(torch.from_numpy(w)).numpy(), want)


def test_support_bits_match_reference():
    """``pack_support_bits`` on a duplicated COO (and with
    ``assume_unique`` on unique input), ``CSR/CSC.to_bitmask``,
    ``popcount_pair_counts`` against the reference's (hi, lo) split and a
    total past 2**31, ``combine_hilo``, ``spgemm_support_bits``."""
    r, c, v = graph(seed=3, scale=7)
    n = 1 << 7
    rt, ct = torch.from_numpy(r.astype(np.int32)), torch.from_numpy(c.astype(np.int32))
    got = tops.pack_support_bits(rt, ct, n, n - 3)  # columns past ncols drop
    assert_same(got, jops.pack_support_bits(jnp.asarray(r, jnp.int32), jnp.asarray(c, jnp.int32),
                                            n, n - 3))
    dense = np.zeros((n, n), bool)
    dense[r, c] = True
    bits = got.numpy().view(np.uint32)
    for i in (0, 5, 77):
        row = np.array([(bits[i, j >> 5] >> (j & 31)) & 1 for j in range(n - 3)], bool)
        np.testing.assert_array_equal(row, dense[i, : n - 3])
    jt, tt = both_tuples(*np.nonzero(dense), np.ones(dense.sum(), np.float32), n, n)
    assert_same(CSR.from_tuples(tt).to_bitmask(), JaxCSR.from_tuples(jt).to_bitmask())
    rng = np.random.default_rng(2)
    npairs = 8192 * 2
    ii = rng.integers(0, n, npairs).astype(np.int32)
    jj = rng.integers(0, n, npairs).astype(np.int32)
    w = rng.integers(0, 3, npairs).astype(np.int32)
    full = tops.pack_support_bits(rt, ct, n, n)
    jfull = jops.pack_support_bits(jnp.asarray(r, jnp.int32), jnp.asarray(c, jnp.int32), n, n)
    hilo = tops.popcount_pair_counts(full, full, torch.from_numpy(ii), torch.from_numpy(jj),
                                     torch.from_numpy(w), chunk=8192)
    assert_same(hilo, jops.popcount_pair_counts(jfull, jfull, jnp.asarray(ii), jnp.asarray(jj),
                                                jnp.asarray(w), chunk=8192))
    want_total = int((np.logical_and(dense[ii], dense[jj]).sum(1) * w).sum())
    assert tops.combine_hilo(hilo) == jops.combine_hilo(np.asarray(hilo)) == want_total
    big = torch.full((1, 64), -1, dtype=torch.int32)  # 2048 bits set a row
    many = torch.zeros(2**20 + 7, dtype=torch.int32)
    hilo = tops.popcount_pair_counts(big, big, many, many, torch.ones_like(many))
    assert tops.combine_hilo(hilo) == 2048 * (2**20 + 7) > 2**31
    ja, ta = both_tuples(r[::3], c[::3], v[::3], n, n)
    jb, tb = both_tuples(c[1::2], r[1::2], v[1::2], n, n)
    gb, gc = tops.spgemm_support_bits(ta, tb, row_block=48)
    wb, wc = jops.spgemm_support_bits(ja, jb, row_block=48)
    assert_same(gb, wb)
    assert_same(gc, wc)
