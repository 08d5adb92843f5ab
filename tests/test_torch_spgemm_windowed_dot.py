"""Parity of the port's windowed SpGEMM tier with ``combblas_tpu`` on the CPU,
second part (the first, ``test_torch_spgemm_windowed.py``, holds the local
ops, symbolic passes, plans and the scatter backend, and the helpers and
tolerances used here): the ``dot`` backend through ``spgemm_windowed``
(local 2D with the oracle off and on, fused 2D in gathered and carousel
order), the fused, local and blocked kernels called with a plan whose skip
lists drop empty blocks and windows (the 1D dot form and an all-skipped
plan among them), ``spgemm_auto`` routed to the tier, and under ``-m slow``
a sweep of seeds and geometries. The reference's dot backend runs its
Pallas kernel with ``interpret=True``.
"""

import numpy as np
import pytest

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu_torch import MIN_PLUS, PLUS_TIMES
from combblas_tpu_torch.parallel import mesh3d as tm
from combblas_tpu_torch.parallel import spgemm as tpar
from test_torch_spgemm_windowed import (BC, BR, M, SEMIRINGS, assert_same_mat, both, operands,
                                        tensor_np)


@pytest.mark.parametrize("p, sr_name, values", [
    (1, "min_plus", "specials"), (1, "plus_times", "float"), (2, "plus_times", "ints"),
    (2, "max_min", "ints"),
])
def test_dot_backend_matches_reference(p, sr_name, values):
    """``spgemm_windowed(backend="dot")``: local 2D on 1×1 with the oracle
    off and on; fused 2D on 2×2 in gathered (and for plus_times carousel)
    order. The 2×2 tropical case is banded (A's rows in the first block, B's columns in
    the first window) so that few windows run the interpreted kernel."""
    sr, jr = SEMIRINGS[sr_name]
    kws = [{"oracle": False}, {"oracle": True}] if p == 1 else [{}]
    if p == 2 and sr_name == "max_min":
        rng = np.random.default_rng(3)
        ra, ca = rng.integers(0, 8, 120), rng.integers(0, M, 120)
        rb, cb = rng.integers(0, M, 200), rng.integers(0, 24, 200)
        va = rng.integers(1, 16, 120).astype(np.float32)
        vb = rng.integers(1, 16, 200).astype(np.float32)
        (jA, tA), (jB, tB) = both(p, ra, ca, va, M, M), both(p, rb, cb, vb, M, M)
        tol = None
    else:
        jA, tA, jB, tB, _, dense_abs = operands(p, seed=13, values=values, m=32, n=64)
        tol = dense_abs if values == "float" else None
        if p == 2:
            kws.append({"ring": True})
    for kw in kws:
        got = tpar.spgemm_windowed(sr, tA, tB, block_rows=BR, block_cols=BC, backend="dot",
                                   **kw)
        plan = tpar.spgemm_windowed.last_plan
        want = jpar.spgemm_windowed(jr, jA, jB, block_rows=BR, block_cols=BC, backend="dot",
                                    interpret=True, **kw)
        assert_same_mat(got, want, tol)
        assert plan["form"] == ("local" if p == 1 else "fused")
        assert plan["oracle"] == bool(kw.get("oracle"))


def test_fused_forms_and_skip_lists_match_reference():
    """The kernels called with a plan: a banded product whose plan skips
    every block but the first (1D) and every window but (0, 0) (2D); the
    fused scatter form on 1×1, the blocked form, the 1D dot form (no
    column windows) and an all-skipped plan (capacity 1)."""
    rng = np.random.default_rng(21)
    ra, ca = rng.integers(0, 8, 120), rng.integers(0, M, 120)
    rb, cb = rng.integers(0, M, 200), rng.integers(0, 16, 200)
    va, vb = np.ones(120, np.float32), rng.integers(1, 9, 200).astype(np.float32)
    (jA, tA), (jB, tB) = both(1, ra, ca, va, M, M), both(1, rb, cb, vb, M, M)
    pair = tensor_np(tpar.summa_rowblock_flops_pair(tA, tB, 8, 8))
    fc, oc, skip = tpar.windowed_plan(pair[0], pair[1], 8, M, M)
    assert skip == (False,) + (True,) * 7
    for fn, kw in ((tpar.summa_spgemm_windowed, {}), (tpar.local_spgemm_windowed, {}),
                   (tpar.summa_spgemm_windowed, {"backend": "dot"})):
        jfn = getattr(jpar, fn.__name__)
        got, over = fn(PLUS_TIMES, tA, tB, block_rows=8, flop_caps=fc, out_caps=oc,
                       skip=skip, **kw)
        want, jover = jfn(jsr.PLUS_TIMES, jA, jB, block_rows=8, flop_caps=fc, out_caps=oc,
                          skip=skip, **kw)
        assert int(over) == int(jover) <= 0
        assert_same_mat(got, want)
    pair2 = tensor_np(tpar.summa_window_flops_pair(tA, tB, 8, 16, 8))
    fc2, oc2, skip2 = tpar.windowed_plan_2d(pair2[0], pair2[1], 8, 16, M, M)
    assert [(g, h) for g in range(8) for h in range(4) if not skip2[g][h]] == [(0, 0)]
    pc = tpar.panel_cap_from_bnnz(tensor_np(tpar.summa_window_bnnz(tB, 16)), tB.capacity)
    got, _ = tpar.summa_spgemm_windowed(PLUS_TIMES, tA, tB, block_rows=8, flop_caps=fc2,
                                        out_caps=oc2, skip=skip2, backend="dot",
                                        block_cols=16, panel_cap=pc)
    want, _ = jpar.summa_spgemm_windowed(jsr.PLUS_TIMES, jA, jB, block_rows=8, flop_caps=fc2,
                                         out_caps=oc2, skip=skip2, backend="dot",
                                         block_cols=16, panel_cap=pc)
    assert_same_mat(got, want)
    # 2×2: blocked against fused, and an all-skipped plan
    (jA2, tA2), (jB2, tB2) = both(2, ra, ca, va, M, M), both(2, rb, cb, vb, M, M)
    pair = tensor_np(tpar.summa_rowblock_flops_pair(tA2, tB2, 8, 8))
    fc, oc, skip = tpar.windowed_plan(pair[0], pair[1], 8, M // 2, M // 2)
    for s in (skip, (True,) * len(skip)):
        args = dict(block_rows=8, flop_caps=fc, out_caps=oc, skip=s)
        got, _ = tpar.summa_spgemm_windowed_blocked(PLUS_TIMES, tA2, tB2, **args)
        want, _ = jpar.summa_spgemm_windowed_blocked(jsr.PLUS_TIMES, jA2, jB2, **args)
        assert_same_mat(got, want)
        got, _ = tpar.summa_spgemm_windowed(PLUS_TIMES, tA2, tB2, **args)
        want, _ = jpar.summa_spgemm_windowed(jsr.PLUS_TIMES, jA2, jB2, **args)
        assert_same_mat(got, want)


def test_spgemm_auto_serves_windowed():
    """``spgemm_auto`` routed or forced to ``windowed`` runs the tier as the
    reference does; forced to ``windowed3d`` it runs the layered route on a
    2x2x2 grid as the reference does, and without ``grid3`` it fails as the
    reference's does."""
    jA, tA, jB, tB, _, _ = operands(2, seed=17, m=32, n=64)
    assert (tpar.choose_spgemm_tier(MIN_PLUS, tA, tB)
            == jpar.choose_spgemm_tier(jsr.MIN_PLUS, jA, jB) == "windowed")
    assert_same_mat(tpar.spgemm_auto(MIN_PLUS, tA, tB, block_rows=BR),
                    jpar.spgemm_auto(jsr.MIN_PLUS, jA, jB, block_rows=BR))
    assert_same_mat(
        tpar.spgemm_auto(MIN_PLUS, tA, tB, tier="windowed3d", block_rows=BR,
                         grid3=tm.Grid3D.make(2, 2, 2, device="cpu")),
        jpar.spgemm_auto(jsr.MIN_PLUS, jA, jB, tier="windowed3d", block_rows=BR,
                         grid3=jm.Grid3D.make(2, 2, 2)))
    with pytest.raises(AssertionError, match="needs a grid3"):
        jpar.spgemm_auto(jsr.MIN_PLUS, jA, jB, tier="windowed3d")
    with pytest.raises(ValueError, match="needs a grid3"):
        tpar.spgemm_auto(MIN_PLUS, tA, tB, tier="windowed3d")
    with pytest.raises(ValueError, match="dispatch"):
        tpar.spgemm_windowed(MIN_PLUS, tA, tB, dispatch="eager")


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("p", [1, 2])
def test_windowed_sweep_matches_reference(seed, p):
    """More seeds and geometries on both backends (plus_times on the dot
    backend, which runs no interpreted kernel)."""
    for sr_name in ("min_plus", "max_min", "plus_times"):
        sr, jr = SEMIRINGS[sr_name]
        jA, tA, jB, tB, _, _ = operands(p, seed=100 + seed, nnz_a=300 + 100 * seed)
        for br in (8, 24):
            assert_same_mat(tpar.spgemm_windowed(sr, tA, tB, block_rows=br),
                            jpar.spgemm_windowed(jr, jA, jB, block_rows=br))
        if sr_name == "plus_times":
            for bc in (32, 64):
                assert_same_mat(
                    tpar.spgemm_windowed(sr, tA, tB, block_rows=BR, block_cols=bc,
                                         backend="dot"),
                    jpar.spgemm_windowed(jr, jA, jB, block_rows=BR, block_cols=bc,
                                         backend="dot", interpret=True))
