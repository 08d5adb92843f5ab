"""Parity of the port's Markov clustering with ``combblas_tpu`` on the CPU.

Within a stated tolerance (float32 sums fold in another order):
``make_col_stochastic`` and ``inflate`` (values within rtol 1e-6, the
layout exact), ``chaos`` (rtol 1e-5, atol 1e-7), the dense program's
state after 1 and 3 iterations in each product mode (atol 1e-6; f32 and
bf16 at 1e-6, bf16x3 at 1e-5), its chaos history at the same tolerance
and its kick count exactly.

Exact: ``mcl_prune_recovery_select`` fed identical arrays (both gates,
with and without recovery, with a hard threshold; the inputs are checked
to hold no mass ratio within 1e-6 of the recovery gate), the block
capacities, the jitter field against numpy's int32 arithmetic, and the
labels of ``mcl`` on a ring of cliques, bridged cliques and a planted
partition through the sparse loop (``phases`` 1 and 2, ``scan``), the
block loop (``chaos_every=3``, and a forced capacity overflow that
rerolls) and the dense loop (f32, bf16, bf16x3, with and without
``perturb_delta``), on 1x1 and 2x2 grids; ``layers`` that do not factor
the grid raise as in the reference (the 3D loop: ``test_torch_mesh3d_mcl.py``).
Heavier combinations run under ``-m slow``.
"""

import numpy as np
import pytest
import torch

from combblas_tpu.models import mcl as jmcl
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu_torch import Grid, SpParMat, spparmat_from_arrays
from combblas_tpu_torch.models import mcl as tmcl

SLOW = pytest.mark.slow


def both(shape, dense):
    dense = np.asarray(dense, np.float32)
    return (JaxSpParMat.from_dense(JaxGrid.make(*shape), dense),
            SpParMat.from_dense(Grid.make(*shape, device="cpu"), dense))


def carried(shape, J):
    """The reference matrix's arrays, carried over to the port unchanged."""
    return spparmat_from_arrays(Grid.make(*shape, device="cpu"), J.rows, J.cols, J.vals,
                                J.nnz, J.nrows, J.ncols)


def same(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def same_layout(got, want):
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "nnz"):
        same(getattr(got, f), getattr(want, f))


def close_vals(got, want, rtol=1e-6):
    same_layout(got, want)
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals), rtol=rtol, atol=0)


# --- inputs -----------------------------------------------------------------------


def ring_of_cliques(k=4, size=6, w=0.1):
    """k cliques of ``size`` vertices in a ring, joined by single edges of
    weight w."""
    n = k * size
    d = np.zeros((n, n), np.float32)
    for b in range(k):
        d[b * size:(b + 1) * size, b * size:(b + 1) * size] = 1
    np.fill_diagonal(d, 0)
    for b in range(k):
        i, j = b * size + size - 1, ((b + 1) % k) * size
        d[i, j] = d[j, i] = w
    return d


def bridged_cliques():
    """Two 8-cliques joined by one 0.05 edge (the reference's test shape)."""
    d = np.zeros((16, 16), np.float32)
    d[:8, :8] = d[8:, 8:] = 1
    np.fill_diagonal(d, 0)
    d[7, 8] = d[8, 7] = 0.05
    return d


def planted(seed=1):
    """Three dense random groups of 8 with two weak bridges."""
    rng = np.random.default_rng(seed)
    d = np.zeros((24, 24), np.float32)
    for lo in (0, 8, 16):
        blk = (rng.random((8, 8)) < 0.8).astype(np.float32)
        d[lo:lo + 8, lo:lo + 8] = np.maximum(blk, blk.T)
    np.fill_diagonal(d, 0)
    d[7, 8] = d[8, 7] = d[15, 16] = d[16, 15] = 0.05
    return d


CASES = {"ring": ring_of_cliques, "bridged": bridged_cliques, "planted": planted}


def positive(seed, n=20, m=None, density=0.5):
    rng = np.random.default_rng(seed)
    m = m or n
    return (rng.random((n, m)) * (rng.random((n, m)) < density)).astype(np.float32)


# --- the helpers ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)], ids=["1x1", "2x2", "2x4"])
def test_column_ops_match_reference(shape):
    JA, TA = both(shape, positive(0, 20, 24))
    close_vals(tmcl.make_col_stochastic(TA), jmcl.make_col_stochastic(JA))
    close_vals(tmcl.inflate(TA, 2.0), jmcl.inflate(JA, 2.0))
    close_vals(tmcl.inflate(TA, 1.7), jmcl.inflate(JA, 1.7))
    JS, TS = jmcl.make_col_stochastic(JA), tmcl.make_col_stochastic(TA)
    np.testing.assert_allclose(float(tmcl.chaos(TS)), float(jmcl.chaos(JS)), rtol=1e-5, atol=1e-7)
    eye = np.eye(24, dtype=np.float32)
    assert float(tmcl.chaos(both(shape, eye)[1])) == float(jmcl.chaos(both(shape, eye)[0])) == 0.0


PRUNE_CASES = {
    # (hard_threshold, select, recover, recover_pct): recovery on and off
    "select_only": (0.0, 3, 5, 0.0),
    "recover": (0.0, 2, 4, 0.9),
    "hard_and_recover": (0.03, 3, 6, 0.8),
}


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("case", sorted(PRUNE_CASES))
@pytest.mark.parametrize("device_gate", [False, True])
def test_prune_recovery_select_matches_reference(shape, case, device_gate):
    """Identical inputs (the reference's arrays carried over): the pruned
    matrices are equal slot for slot. Precondition checked first: no
    column's kept mass lies within 1e-6 of ``recover_pct`` of its total,
    and no value within 1e-6 of its column's thresholds."""
    hard, sel, rec, pct = PRUNE_CASES[case]
    JC = jmcl.make_col_stochastic(JaxSpParMat.from_dense(JaxGrid.make(*shape),
                                                         positive(4, 24, 24, 0.7)))
    TC = carried(shape, JC)
    d = TC.to_dense().astype(np.float64)
    if hard > 0:
        d = np.where(d < hard, 0, d)
    for j in range(d.shape[1]):
        col = np.sort(d[:, j][d[:, j] > 0])[::-1]
        for k in (sel, rec):
            if len(col) >= k:
                gaps = np.abs(col - col[k - 1])
                assert (gaps[gaps > 0] > 1e-6).all()
        if len(col) >= sel:
            assert abs(col[:sel].sum() - pct * col.sum()) > 1e-6 * col.sum()
    kw = dict(hard_threshold=hard, select_num=sel, recover_num=rec, recover_pct=pct,
              device_gate=device_gate)
    got = tmcl.mcl_prune_recovery_select(TC, **kw)
    want = jmcl.mcl_prune_recovery_select(JC, **kw)
    same_layout(got, want)
    same(got.vals, want.vals)


def test_block_caps_match_reference():
    for shape in ((1, 1), (2, 2)):
        JA, TA = both(shape, ring_of_cliques())
        JA, TA = jmcl.make_col_stochastic(JA.add_loops(np.float32(1))), \
            tmcl.make_col_stochastic(TA.add_loops(1))
        assert tmcl._mcl_block_caps(TA) == jmcl._mcl_block_caps(JA)


def test_perturb_field_is_int32_arithmetic():
    """The jitter hash wraps as int32 does: equal to numpy's int32 result
    past the point where the products overflow."""
    npad = 384
    i = np.arange(npad, dtype=np.int32)[:, None]
    j = np.arange(npad, dtype=np.int32)[None, :]
    with np.errstate(over="ignore"):
        want = (i * np.int32(-1640531527) + j * np.int32(40503)) & np.int32(0xFFFF)
    got = tmcl._perturb_field(npad, torch.device("cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --- the dense program -------------------------------------------------------------


def dense_run(pkg, A, iters, mode, eps, perturb_delta, inflation=2.0):
    """``dense_mcl_program`` of either package on the column-stochastic
    dense A: ``(M, iters, chaos, history, kicks)`` on the host."""
    n = A.shape[0]
    npad = -(-n // 128) * 128
    run = pkg.dense_mcl_program(n, npad, inflation, eps, iters, hard=1e-4, select=min(1100, n),
                                recover=min(1400, n), rpct=0.9, mode=mode,
                                perturb_delta=perturb_delta)
    r, c = np.nonzero(A)
    rows, cols, vals = r.astype(np.int32), c.astype(np.int32), A[r, c]
    if pkg is jmcl:
        import jax

        m, it, ch, hist, kicks = jax.jit(run)(rows, cols, vals)
        return np.asarray(m), int(it), float(ch), np.asarray(hist), int(kicks)
    m, it, ch, hist, kicks = run(*(torch.from_numpy(x) for x in (rows, cols, vals)))
    return m.numpy(), it, float(ch), hist.numpy(), kicks


def make_stochastic_input(d):
    a = d + np.eye(d.shape[0], dtype=np.float32)
    return (a / a.sum(axis=0, keepdims=True)).astype(np.float32)


DENSE_TOL = {"f32": 1e-6, "bf16": 1e-6, "bf16x3": 1e-5}


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
@pytest.mark.parametrize("iters", [1, 3])
def test_dense_program_iterates_match_reference(mode, iters):
    A = make_stochastic_input(planted(2))
    got = dense_run(tmcl, A, iters, mode, 1e-3, 0.0)
    want = dense_run(jmcl, A, iters, mode, 1e-3, 0.0)
    tol = DENSE_TOL[mode]
    assert got[1] == want[1] == iters and got[4] == want[4] == 0
    np.testing.assert_allclose(got[0], want[0], atol=tol, rtol=0)
    np.testing.assert_allclose(got[3], want[3], atol=tol, rtol=1e-4)


def test_dense_program_kicks_match_reference():
    """A = π1ᵀ (every column the same distribution π) is a fixed point of
    the loop at inflation 1 whose chaos, n·(max π − Σπ²), stays put: the
    plateau detector kicks on the third iteration, and again after each
    kick's transient. Kicks and iterations exact, the state and the chaos
    history within 1e-6."""
    pi = np.random.default_rng(9).random(24).astype(np.float32) + 0.5
    A = np.repeat((pi / pi.sum())[:, None], 24, axis=1).astype(np.float32)
    got = dense_run(tmcl, A, 10, "f32", 1e-3, 5e-5, inflation=1.0)
    want = dense_run(jmcl, A, 10, "f32", 1e-3, 5e-5, inflation=1.0)
    assert got[4] == want[4] >= 1
    assert got[1] == want[1] == 10
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[3], want[3], atol=1e-6, rtol=1e-4)


# --- the whole clustering -------------------------------------------------------------

LOOPS = {
    "sparse": dict(),
    "phases2": dict(phases=2),
    "scan": dict(scan=True),
    "block3": dict(chaos_every=3),
    "dense_f32": dict(expansion="dense", dense_mode="f32"),
    "dense_bf16": dict(expansion="dense", dense_mode="bf16"),
    "dense_bf16x3": dict(expansion="dense", dense_mode="bf16x3"),
    "dense_kick": dict(expansion="dense", perturb_delta=5e-5),
}
# one case per loop in tier 1; the other combinations under -m slow
FAST = {("ring", "sparse", (2, 2)), ("bridged", "phases2", (2, 2)), ("planted", "scan", (2, 2)),
        ("ring", "block3", (2, 2)), ("planted", "dense_f32", (1, 1)),
        ("bridged", "dense_bf16", (1, 1)), ("ring", "dense_bf16x3", (1, 1)),
        ("planted", "dense_kick", (1, 1)), ("bridged", "sparse", (1, 1))}
PARAMS = []
for case in CASES:
    for loop in LOOPS:
        for shape in ((1, 1),) if loop.startswith("dense") else ((1, 1), (2, 2)):
            marks = () if (case, loop, shape) in FAST else (SLOW,)
            PARAMS.append(pytest.param(case, loop, shape, marks=marks,
                                       id=f"{case}-{loop}-{shape[0]}x{shape[1]}"))


@pytest.mark.parametrize("case,loop,shape", PARAMS)
def test_mcl_labels_match_reference(case, loop, shape):
    """Labels exact, iterations exact, the final chaos within 1e-5
    relative, and the labels are the planted clusters' least ids."""
    d = CASES[case]()
    JA, TA = both(shape, d)
    jl, ji, jc = jmcl.mcl(JA, inflation=2.0, **LOOPS[loop])
    tl, ti, tc = tmcl.mcl(TA, inflation=2.0, **LOOPS[loop])
    same(tl.blocks, jl.blocks)
    assert ti == ji and tc < 1e-3
    np.testing.assert_allclose(tc, jc, rtol=1e-3 if "bf16" in loop or "kick" in loop else 1e-5,
                               atol=1e-7)
    lab = tl.to_global()
    n = d.shape[0]
    size = {"ring": 6, "bridged": 8, "planted": 8}[case]
    np.testing.assert_array_equal(lab, np.arange(n) // size * size)


def test_block_loop_reroll_stays_exact(monkeypatch):
    """A tiny first capacity overflows: the block reruns with doubled
    capacities and the labels equal the reference's default run."""
    d = ring_of_cliques()
    JA, TA = both((2, 2), d)
    real = tmcl._mcl_block_caps
    calls = {"n": 0}

    def tiny(mat):
        calls["n"] += 1
        f, o = real(mat)
        return (max(f // 16, 4), max(o // 16, 4)) if calls["n"] == 1 else (f, o)

    monkeypatch.setattr(tmcl, "_mcl_block_caps", tiny)
    tl, _, tc = tmcl.mcl(TA, inflation=2.0, chaos_every=2)
    assert tmcl.mcl.last_run["rerolls"] >= 1 and tc < 1e-3
    jl, _, _ = jmcl.mcl(JA, inflation=2.0, chaos_every=2)
    same(tl.blocks, jl.blocks)


def test_layers_raise():
    """``layers`` that do not factor the grid's tiles into layers × a
    square grid raise, as the reference's assertion does (the 3D loop
    itself: ``test_torch_mesh3d_mcl.py``); the dense loop needs one tile."""
    JA, TA = both((2, 2), bridged_cliques())
    with pytest.raises(AssertionError, match="cannot factor 4 devices into 2 layers"):
        jmcl.mcl(JA, layers=2)
    with pytest.raises(ValueError, match="cannot factor 4 devices into 2 layers"):
        tmcl.mcl(TA, layers=2)
    with pytest.raises(ValueError, match="1x1"):
        tmcl.mcl(TA, expansion="dense")
