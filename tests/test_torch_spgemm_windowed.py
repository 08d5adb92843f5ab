"""Parity of the port's windowed SpGEMM tier with ``combblas_tpu`` on the CPU:
the dense fold of the scatter backend (``accumulate_block_scatter``), the
duplicate-combining densify (``densify_combine``), the oracle's window
counts (``support_window_counts``), the symbolic passes (row block and
window, device and host forms), the plans (``windowed_plan``,
``windowed_plan_2d``, bucketing, panel capacity, packed launch lists,
the oracle's tightening, default geometry) and the scatter backend's
kernels through ``spgemm_windowed``: the fused form (gathered and carousel
stage order), the blocked and the local forms. The dot backend, the
kernels called with a plan and ``spgemm_auto`` are in
``test_torch_spgemm_windowed_dot.py``, which shares this file's helpers.

The reference's ``dot`` backend runs its Pallas kernel with
``interpret=True``; the port's runs the semiring GEMM's plain version.
Outputs are compared array by array (rows, cols, vals, nnz, capacity,
padding slots included): bit for bit for min and max semirings (NaN cells
by position), for integer values and for ``plus_times`` on integer-valued
float32 weights (every sum below 2**24); ``plus_times`` on random float32
within 1e-5 of Σ|a||b| a cell (the folds add a cell's products in another
order). Inputs are COO with repeated entries, so the folds combine
duplicates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.ops import spgemm as jops
from combblas_tpu.ops.compressed import CSR as JaxCSR
from combblas_tpu.ops.tuples import SpTuples as JaxSpTuples
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
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
from combblas_tpu_torch.parallel import spgemm as tpar

SEMIRINGS = {
    "plus_times": (PLUS_TIMES, jsr.PLUS_TIMES),
    "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
    "max_min": (MAX_MIN, jsr.MAX_MIN),
    "select2nd_max": (SELECT2ND_MAX, jsr.SELECT2ND_MAX),
}
M, K, N = 64, 48, 80
BR, BC = 16, 32  # the reference's test geometry
SPECIALS = np.array([0.0, -0.0, 1.0, 2.0, np.nan, -1.0, np.inf], np.float32)


def tensor_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want):
    """Equal arrays; floats by their bits, NaN cells by position."""
    got, want = tensor_np(got), tensor_np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32), want[keep].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


def assert_same_mat(got, want, tol=None):
    """Same layout slot for slot; values bit for bit, or with ``tol`` (the
    operands' |A| and |B| as dense host arrays) within 1e-5 of Σ|a||b|."""
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "nnz"):
        assert_same(getattr(got, f), getattr(want, f))
    if tol is None:
        assert_same(got.vals, want.vals)
        return
    g, w = tensor_np(got.to_dense()), np.asarray(want.to_dense())
    np.testing.assert_array_less(np.abs(g - w), 1e-5 * (tol[0] @ tol[1]) + 1e-30)


def coo(rng, m, n, nnz, dup=0.2, values="ints"):
    """Random COO with a ``dup`` share of repeated entries; values 1..15,
    uniform [-1, 1], or ``SPECIALS`` (±0, NaN, inf)."""
    r, c = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    k = int(nnz * dup)
    r, c = np.concatenate([r, r[:k]]), np.concatenate([c, c[:k]])
    if values == "ints":
        v = rng.integers(1, 16, len(r)).astype(np.float32)
    elif values == "float":
        v = rng.uniform(-1, 1, len(r)).astype(np.float32)
    else:
        v = rng.choice(SPECIALS, len(r), p=[.3, .3, .14, .14, .02, .08, .02])
    return r, c, v


def both(p, r, c, v, m, n):
    """The same COO loaded by each package on a p×p (or p[0]×p[1]) grid."""
    pr, pc = (p, p) if isinstance(p, int) else p
    return (JaxSpParMat.from_global_coo(JaxGrid.make(pr, pc), r, c, v, m, n),
            SpParMat.from_global_coo(Grid.make(pr, pc, device="cpu"), r, c, v, m, n))


def operands(p, seed=0, values="ints", m=M, k=K, n=N, nnz_a=500, nnz_b=600):
    rng = np.random.default_rng(seed)
    ra, ca, va = coo(rng, m, k, nnz_a, values=values)
    rb, cb, vb = coo(rng, k, n, nnz_b, values=values)
    (jA, tA), (jB, tB) = both(p, ra, ca, va, m, k), both(p, rb, cb, vb, k, n)
    dense_abs = []
    for r, c, v, shape in ((ra, ca, va, (m, k)), (rb, cb, vb, (k, n))):
        d = np.zeros(shape, np.float64)
        np.add.at(d, (r, c), np.abs(v.astype(np.float64)))
        dense_abs.append(d)
    return jA, tA, jB, tB, (ra, ca, rb, cb), tuple(dense_abs)


# --- the local ops ----------------------------------------------------------------


@pytest.mark.parametrize("sr_name", ["min_plus", "max_min", "plus_times", "select2nd_max"])
def test_dense_folds_match_reference(sr_name):
    """``densify_combine`` (repeated slots fold, entries past the block
    drop) and ``accumulate_block_scatter`` into a non-empty block, on
    values with ±0, NaN and inf for min and max, integers for plus."""
    sr, jr = SEMIRINGS[sr_name]
    rng = np.random.default_rng(5)
    values = "ints" if sr_name == "plus_times" else "specials"
    r, c, v = coo(rng, 20, 24, 150, dup=0.4, values=values)
    jt = JaxSpTuples.from_coo(r, c, v, 20, 24, capacity=len(r) + 7)
    tt = SpTuples.from_coo(r, c, v, 20, 24, capacity=len(r) + 7, device="cpu")
    for shape in ((20, 24), (16, 32), (24, 16)):
        assert_same(tops.densify_combine(sr, tt, *shape), jops.densify_combine(jr, jt, *shape))
    rb, cb, vb = coo(rng, 24, 30, 160, values=values)
    jb = JaxCSR.from_tuples(JaxSpTuples.from_coo(rb, cb, vb, 24, 30, capacity=len(rb) + 3))
    tb = CSR.from_tuples(SpTuples.from_coo(rb, cb, vb, 24, 30, capacity=len(rb) + 3,
                                           device="cpu"))
    lo, rb_ = 8, 8
    ja = jops.mask_rows(jt, lo, lo + rb_)
    ta = tops.mask_rows(tt, lo, lo + rb_)
    acc0 = tops.densify_combine(sr, tt, rb_, 128)
    cap = int(tops.expansion_slots(ta, tb, 8))
    want = jops.accumulate_block_scatter(jr, jnp.asarray(acc0.numpy()), ja, jb, row_lo=lo,
                                         flop_capacity=cap)
    got = tops.accumulate_block_scatter(sr, acc0, ta, tb, row_lo=lo, flop_capacity=cap)
    assert_same(got, want)


def test_fold_keys_round_trip_and_order():
    """``fold_keys`` orders as the reference's min/max fold (NaN on the kept
    side) and ``from_fold_keys`` inverts it."""
    v = torch.tensor([-np.inf, -2.5, -0.0, 0.0, 1e-38, 3.0, np.inf, np.nan])
    for kind in ("min", "max"):
        k = tops.fold_keys(v, kind)
        assert torch.equal(k[:7], torch.sort(k[:7]).values)
        assert int(k[7]) == (torch.iinfo(torch.int32).min if kind == "min"
                             else torch.iinfo(torch.int32).max)
        back = tops.from_fold_keys(k, torch.float32)
        assert torch.equal(back[:7].view(torch.int32), v[:7].view(torch.int32))
        assert torch.isnan(back[7])


def test_sparsify_windowed_gives_positive_zeros_as_reference():
    """A -0.0 cell comes out +0.0, as the reference's lane-sum read gives it
    (the fault this port carried through the mxu tier before the windowed
    tier's ±0 cases showed it)."""
    d = np.full((8, 16), np.inf, np.float32)
    d[0, :3] = [-0.0, 1.0, np.inf]
    d[1, :3] = [np.nan, -0.0, -3.0]
    jt, jn = jops.sparsify_windowed(jnp.asarray(d), np.inf, 2, 3, 8)
    tt, tn = tops.sparsify_windowed(torch.from_numpy(d), np.inf, 2, 3, 8)
    assert int(tn) == int(jn) == 5
    for f in ("rows", "cols", "vals", "nnz"):
        assert_same(getattr(tt, f), getattr(jt, f))
    assert not torch.signbit(tt.vals[0])


def test_support_window_counts_match_reference():
    rng = np.random.default_rng(9)
    r, c, v = coo(rng, M, K, 300)
    rb, cb, vb = coo(rng, K, N, 300)
    ja, jb = (JaxSpTuples.from_coo(x, y, z, *s) for x, y, z, s in
              ((r, c, v, (M, K)), (rb, cb, vb, (K, N))))
    ta, tb = (SpTuples.from_coo(x, y, z, *s, device="cpu") for x, y, z, s in
              ((r, c, v, (M, K)), (rb, cb, vb, (K, N))))
    jbits, _ = jops.spgemm_support_bits(ja, jb)
    tbits, _ = tops.spgemm_support_bits(ta, tb)
    for br, bc in ((BR, BC), (24, 64)):
        assert_same(tops.support_window_counts(tbits, br, bc, M, N),
                    jops.support_window_counts(jbits, br, bc, M, N))
    with pytest.raises(ValueError, match="multiple of 32"):
        tops.support_window_counts(tbits, BR, 24, M, N)


# --- the symbolic passes and the plans ----------------------------------------------


@pytest.mark.parametrize("p", [1, 2])
def test_symbolic_passes_match_reference(p):
    """Row-block and window counts (padded and true), device and host
    forms, and the per-window B counts; on a 2×4 grid the window B counts
    and the refusal of SUMMA."""
    jA, tA, jB, tB, (ra, ca, rb, cb), _ = operands(p, seed=1)
    hg = HostGrid(p, p)
    for cw in (1, 8):
        assert_same(tpar.summa_rowblock_flops_pair(tA, tB, BR, cw),
                    jpar.summa_rowblock_flops_pair(jA, jB, BR, cw))
        assert_same(tpar.summa_window_flops_pair(tA, tB, BR, BC, cw),
                    jpar.summa_window_flops_pair(jA, jB, BR, BC, cw))
    for cw in (0, 8):
        want = jpar.summa_rowblock_flops(jA, jB, BR, cw)
        assert_same(tpar.summa_rowblock_flops(tA, tB, BR, cw), want)
        host = tpar.summa_rowblock_flops_host(hg, ra, ca, rb, cb, M, K, N, BR, cw)
        assert_same(host, jpar.summa_rowblock_flops_host(jA.grid, ra, ca, rb, cb, M, K, N,
                                                         BR, cw))
        np.testing.assert_array_equal(host, np.asarray(want, np.float64))
        host2 = tpar.summa_window_flops_host(hg, ra, ca, rb, cb, M, K, N, BR, BC, cw)
        assert_same(host2, jpar.summa_window_flops_host(jA.grid, ra, ca, rb, cb, M, K, N,
                                                        BR, BC, cw))
        pair = tpar.summa_window_flops_pair(tA, tB, BR, BC, max(cw, 1))
        np.testing.assert_array_equal(host2, tensor_np(pair[0 if cw else 1]).astype(np.float64))
    bn = tpar.summa_window_bnnz(tB, BC)
    assert_same(bn, jpar.summa_window_bnnz(jB, BC))
    assert_same(tpar.summa_window_bnnz_host(hg, rb, cb, K, N, BC),
                jpar.summa_window_bnnz_host(jB.grid, rb, cb, K, N, BC))
    if p == 2:
        rng = np.random.default_rng(2)
        r, c, v = coo(rng, K, N, 400)
        jW, tW = both((2, 4), r, c, v, K, N)
        assert_same(tpar.summa_window_bnnz(tW, BC), jpar.summa_window_bnnz(jW, BC))
        assert_same(tpar.summa_window_bnnz_host(HostGrid(2, 4), r, c, K, N, BC),
                    jpar.summa_window_bnnz_host(jW.grid, r, c, K, N, BC))
        with pytest.raises(AssertionError):
            jpar.summa_rowblock_flops_pair(jW, jW, BR, 8)
        with pytest.raises(ValueError, match="square"):
            tpar.summa_rowblock_flops_pair(tW, tW, BR, 8)


def test_plans_match_reference():
    """The 1D and 2D plans (padded counts or none), bucketing, the panel
    capacity, the packed launch lists, the oracle's tightening and the
    default geometry."""
    jA, tA, jB, tB, _, _ = operands(1, seed=4)
    pair = tensor_np(tpar.summa_rowblock_flops_pair(tA, tB, BR, 8))
    for slack in (1.02, 1.5):
        want = jpar.windowed_plan(pair[0], pair[1], BR, M, N, slack=slack)
        got = tpar.windowed_plan(pair[0], pair[1], BR, M, N, slack=slack)
        assert got == want
        assert tpar.bucket_plan_caps(*got[:2]) == jpar.bucket_plan_caps(*want[:2])
        assert tpar.packed_windows(got[2]) == jpar.packed_windows(want[2])
    pair2 = tensor_np(tpar.summa_window_flops_pair(tA, tB, BR, BC, 8))
    for padded in (pair2[0], None):
        want = jpar.windowed_plan_2d(padded, pair2[1], BR, BC, M, N)
        got = tpar.windowed_plan_2d(padded, pair2[1], BR, BC, M, N)
        assert got == want
        assert tpar.bucket_plan_caps(*got[:2]) == jpar.bucket_plan_caps(*want[:2])
    skip = ((False, True, False), (True, True, True), (True, False, False))
    assert tpar.packed_windows_2d(skip) == jpar.packed_windows_2d(skip)
    assert tpar._live_windows_by_block(skip) == jpar._live_windows_by_block(skip)
    for bn in (np.array([[[0, 3, 17]]]), np.array([1]), np.array([[5, 64]])):
        for cap in (1, 20, 1000):
            assert tpar.panel_cap_from_bnnz(bn, cap) == jpar.panel_cap_from_bnnz(bn, cap)
    _, oc, sk = got
    assert (tpar._oracle_out_caps_2d(MIN_PLUS, tA, tB, BR, BC, oc, sk)
            == jpar._oracle_out_caps_2d(jsr.MIN_PLUS, jA, jB, BR, BC, oc, sk))
    for lr in (1, 8, 100, 16384, 65536, 10**6):
        for lc in (1, 100, 16384, 65536):
            assert tpar.default_block_rows(lr, lc) == jpar.default_block_rows(lr, lc)
            assert tpar.default_block_cols(lr, lc) == jpar.default_block_cols(lr, lc)


# --- the kernels -------------------------------------------------------------------


SCATTER_CASES = [  # (grid, semiring, values, forms, bucketing off as well)
    (1, "min_plus", "ints", [{}], True),
    (1, "max_min", "specials", [{}], False),
    (1, "plus_times", "float", [{}], False),
    (2, "min_plus", "specials",
     [{}, {"dispatch": "fused"}, {"ring": True, "dispatch": "blocked"}], False),
    (2, "max_min", "ints", [{}], True),
    (2, "plus_times", "float", [{"ring": True}], False),
    (2, "select2nd_max", "ints", [{}], False),
]


@pytest.mark.parametrize("p, sr_name, values, forms, unbucketed", SCATTER_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in SCATTER_CASES])
def test_scatter_backend_matches_reference(p, sr_name, values, forms, unbucketed):
    """``spgemm_windowed`` on the scatter backend: local on 1×1; blocked
    (the default), fused gathered and fused carousel (a ring asked for
    with the blocked dispatch runs fused) on 2×2; the symbolic caps
    without bucketing."""
    sr, jr = SEMIRINGS[sr_name]
    jA, tA, jB, tB, _, dense_abs = operands(p, seed=7, values=values)
    tol = dense_abs if values == "float" else None
    for kw in forms:
        got = tpar.spgemm_windowed(sr, tA, tB, block_rows=BR, **kw)
        assert_same_mat(got, jpar.spgemm_windowed(jr, jA, jB, block_rows=BR, **kw), tol)
        plan = tpar.spgemm_windowed.last_plan
        assert plan["form"] == ("local" if p == 1 else "blocked" if not kw else "fused")
        assert plan["packed"] == len(tpar.packed_windows(plan["skip"]))
    if unbucketed:  # the reference reads an env knob
        got = tpar.spgemm_windowed(sr, tA, tB, block_rows=BR, bucket=False)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("COMBBLAS_SPGEMM_BUCKET_CAPS", "0")
            want = jpar.spgemm_windowed(jr, jA, jB, block_rows=BR)
        assert_same_mat(got, want, tol)


def test_scatter_backend_takes_integer_values():
    """The scatter backend on int32 values (a dtype K1 does not take) and
    the default geometry."""
    rng = np.random.default_rng(11)
    ra, ca, _ = coo(rng, M, K, 400)
    rb, cb, _ = coo(rng, K, N, 400)
    va = rng.integers(-50, 50, len(ra)).astype(np.int32)
    vb = rng.integers(-50, 50, len(rb)).astype(np.int32)
    for p in (1, 2):
        (jA, tA), (jB, tB) = both(p, ra, ca, va, M, K), both(p, rb, cb, vb, K, N)
        for sr, jr in (SEMIRINGS["min_plus"], SEMIRINGS["plus_times"]):
            assert_same_mat(tpar.spgemm_windowed(sr, tA, tB),
                            jpar.spgemm_windowed(jr, jA, jB))
        with pytest.raises(TypeError, match="float32 only"):
            tpar.spgemm_windowed(MIN_PLUS, tA, tB, backend="dot")
