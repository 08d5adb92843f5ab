"""Parity of the port's micro-probe (``tuner/probe.py``) with
``combblas_tpu`` on the CPU: ``downsample_coo``, ``_proxy_dim``, the proxy
operands and ``admissible_tiers`` equal to the reference's;
``probe_spgemm`` under the reference tests' deterministic fake ``measure``
giving the reference's record (geometry included) and persisted line; the
budget cap; ``last_errors`` (a rung that raises by design is skipped and
recorded, anything else propagates); ``probe_spmm`` under a fake
``measure``; one real-measure smoke at a tiny size. ``probe_spgemm3d`` is
held in ``test_torch_tuner_routes3d.py``.

Each test points ``COMBBLAS_PLAN_STORE`` at its own ``tmp_path`` and resets
both packages' store singletons. Comparisons are exact (host data, and
the records the probes return).
"""

import json
import os

import numpy as np
import pytest

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.tuner import probe as jpr
from combblas_tpu.tuner import store as jst
from combblas_tpu_torch import MAX_MIN, MIN_PLUS, PLUS_TIMES, Grid, SpParMat
from combblas_tpu_torch.ops import semiring_matmul as tsm
from combblas_tpu_torch.parallel import spgemm as tpar
from combblas_tpu_torch.tuner import config as tcfg
from combblas_tpu_torch.tuner import probe as tpr
from combblas_tpu_torch.tuner import store as tst

SRS = {"plus_times": (PLUS_TIMES, jsr.PLUS_TIMES), "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
       "max_min": (MAX_MIN, jsr.MAX_MIN)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, str(tmp_path / "plans"))
    jst._reset_for_tests()
    tst._reset_for_tests()
    yield
    jst._reset_for_tests()
    tst._reset_for_tests()


def coo(rng, m, k, nnz, dup_frac=0.2):
    """The reference tests' operand recipe (``tests/test_tuner.py``)."""
    r = rng.integers(0, m, nnz).astype(np.int64)
    c = rng.integers(0, k, nnz).astype(np.int64)
    v = (rng.random(nnz) + 0.5).astype(np.float32)
    ndup = int(nnz * dup_frac)
    if ndup:
        r = np.concatenate([r, r[:ndup]])
        c = np.concatenate([c, c[:ndup]])
        v = np.concatenate([v, (rng.random(ndup) + 0.5).astype(np.float32)])
    return r, c, v


def both(r, c, v, m, n, p=1):
    return (SpParMat.from_global_coo(Grid.make(p, p, device="cpu"), r, c, v, m, n),
            JaxSpParMat.from_global_coo(JaxGrid.make(p, p), r, c, v, m, n))


def test_downsample_and_proxy_dim_match_reference():
    rng = np.random.default_rng(3)
    n, nnz, p = 5000, 40000, 1024
    r, c = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    for seed in (0, 11):
        for modes in (("restrict", "fold"), ("fold", "restrict")):
            got = tpr.downsample_coo(r, c, (n, n), (p, p), seed=seed, modes=modes)
            want = jpr.downsample_coo(r, c, (n, n), (p, p), seed=seed, modes=modes)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    for d in (1, 2, 3, 100, 128, 2047, 2048, 1 << 14):
        for cap in (64, 2048, 3000):
            assert tpr._proxy_dim(d, cap) == jpr._proxy_dim(d, cap), (d, cap)
    np.testing.assert_array_equal(tpr._axis_perm(777, 5), jpr._axis_perm(777, 5))
    rr, cc = rng.integers(0, 50, 300), rng.integers(0, 40, 300)
    vv = rng.random(300).astype(np.float32)
    for x, y in zip(tpr._dedup_sum(rr, cc, vv, 40), jpr._dedup_sum(rr, cc, vv, 40)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(300, 300, 300), (200, 150, 90)])
def test_proxy_operands_match_reference(shape):
    """The proxy the probe measures on is the reference's, array for
    array: ``proxy_coo`` against the reference's own steps
    (``downsample_coo`` then ``_dedup_sum``) on A·A and A·B."""
    m, k, n = shape
    rng = np.random.default_rng(9)
    ra, ca, va = coo(rng, m, k, 2500)
    rb, cb, vb = coo(rng, k, n, 1800)
    tA, jA = both(ra, ca, va, m, k)
    tB, jB = both(rb, cb, vb, k, n)
    for (tL, jL), (tR, jR) in (((tA, jA), (tA, jA)), ((tA, jA), (tB, jB))):
        got = tpr.proxy_coo(tL, tR, 64, seed=0)
        pm, pk, pn = (jpr._proxy_dim(x, 64) for x in (jL.nrows, jL.ncols, jR.ncols))
        assert got[2] == (pm, pk, pn)
        xa, ya, xv = jL.to_global_coo()
        par, pac, keep_a = jpr.downsample_coo(xa, ya, (jL.nrows, jL.ncols), (pm, pk), seed=0)
        xb, yb, xw = jR.to_global_coo()
        pbr, pbc, keep_b = jpr.downsample_coo(xb, yb, (jR.nrows, jR.ncols), (pk, pn),
                                              seed=0, modes=("fold", "restrict"))
        want = (jpr._dedup_sum(par, pac, xv[keep_a], pk),
                jpr._dedup_sum(pbr, pbc, xw[keep_b], pn))
        for g, w in zip(got[:2], want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["dup", "unique", "grid2", "small_mxu", "dot"])
def test_admissible_tiers_match_reference(monkeypatch, case):
    """The candidate list (heuristic first) for each semiring, on duplicate
    and unique entries, 1x1 and 2x2, past the mxu envelope, and under the
    dot backend."""
    rng = np.random.default_rng(4)
    r, c, v = coo(rng, 96, 96, 700, dup_frac=0.2 if case == "dup" else 0.0)
    if case != "dup":
        key = np.unique(r * 96 + c)
        r, c = key // 96, key % 96
        v = np.ones(len(key), np.float32)
    tA, jA = both(r, c, v, 96, 96, p=2 if case == "grid2" else 1)
    if case == "small_mxu":
        monkeypatch.setattr(tpar, "MXU_MAX_TILE_DIM", 32)
        monkeypatch.setattr(jpar, "MXU_MAX_TILE_DIM", 32)
    backend = "dot" if case == "dot" else "scatter"
    for sr, jr in SRS.values():
        assert (tpr.admissible_tiers(sr, tA, tA, backend)
                == jpr.admissible_tiers(jr, jA, jA, backend)), sr.name


def _persisted(path):
    """The store file's lines as dicts, the timestamps dropped."""
    out = []
    for line in open(os.path.join(path, "plans.jsonl")):
        d = json.loads(line)
        d["plan"].pop("ts")
        out.append(d)
    return out


def _probe_both(tmp_path, sr_name, tA, jA, costs, **kw):
    sr, jr = SRS[sr_name]
    recs = []
    for name, pkg, srx, A in (("jax", jpr, jr, jA), ("torch", tpr, sr, tA)):
        st_mod = jst if pkg is jpr else tst
        st = st_mod.PlanStore(str(tmp_path / name))
        key = st_mod.spgemm_plan_key(srx, A, A, "scatter")
        seq = iter(costs)
        rec = pkg.probe_spgemm(srx, A, A, backend="scatter", store=st, key=key,
                               measure=lambda fn: next(seq), **kw)
        recs.append((rec, st.stats()))
    (jrec, jstats), (trec, tstats) = recs
    assert trec.to_json() | {"ts": None} == jrec.to_json() | {"ts": None}
    for s in (jstats, tstats):
        s.pop("path")
    assert tstats == jstats
    assert _persisted(tmp_path / "torch") == _persisted(tmp_path / "jax")
    return trec


def test_probe_deterministic_record_matches_reference(tmp_path):
    """The reference test's injected costs on its 128-dim duplicate-entry
    operand: the same winner, cost, proxy dim and persisted line; two runs
    of the port give the same record."""
    rng = np.random.default_rng(0)
    r, c, v = coo(rng, 128, 128, 800)
    tA, jA = both(r, c, v, 128, 128)
    rec = _probe_both(tmp_path, "plus_times", tA, jA, [0.3, 0.01, 0.2, 0.5], geometry=False)
    assert rec.source == "probe" and rec.cost_s == 0.01 and rec.probe_dim == 128
    assert tpr.probe_spgemm.last_errors == []
    seq = iter([0.3, 0.01, 0.2, 0.5])
    again = tpr.probe_spgemm(PLUS_TIMES, tA, tA, backend="scatter",
                             measure=lambda fn: next(seq), geometry=False)
    assert again == rec


@pytest.mark.parametrize("costs,order,want_geo", [
    ([0.4, 0.5, 0.9, 0.05, 0.7, 0.7, 0.7, 0.7], ("windowed", "scan"), 1),
    ([0.1, 0.5, 0.5, 0.5], ("scan", "windowed"), None),
])
def test_probe_geometry_sweep_matches_reference(tmp_path, costs, order, want_geo):
    """The window-geometry sweep: when windowed wins the tier pass, the
    same geometry candidates are measured and the winning one is persisted
    rescaled to the real dims; when it loses, no geometry."""
    rng = np.random.default_rng(1)
    r, c, v = coo(rng, 128, 128, 700, dup_frac=0.0)
    tA, jA = both(r, c, v, 128, 128)
    rec = _probe_both(tmp_path, "min_plus", tA, jA, costs, tier_order=order)
    geo = tpr._geometry_candidates(128, 128)
    assert geo == jpr._geometry_candidates(128, 128)
    if want_geo is None:
        assert (rec.tier, rec.block_rows, rec.block_cols) == ("scan", None, None)
    else:
        assert (rec.tier, (rec.block_rows, rec.block_cols)) == ("windowed", geo[want_geo])
        assert rec.cost_s == 0.05
        assert set(tpr.probe_spgemm.last_costs["geometry"]) == {f"{b}x{c}" for b, c in geo}


def test_probe_geometry_rescaled_to_real_dims(tmp_path, monkeypatch):
    """A proxy smaller than the operand: the winning geometry is stored
    times the real-to-proxy ratio, as the reference's."""
    rng = np.random.default_rng(2)
    r, c, v = coo(rng, 256, 256, 3000, dup_frac=0.0)
    tA, jA = both(r, c, v, 256, 256)
    costs = [0.4, 0.5, 0.05, 0.9, 0.7, 0.7]
    rec = _probe_both(tmp_path, "plus_times", tA, jA, costs, tier_order=("windowed", "scan"),
                      max_dim=64)
    geo = tpr._geometry_candidates(64, 64)[0]
    assert (rec.block_rows, rec.block_cols) == (geo[0] * 4, None if geo[1] is None
                                                 else geo[1] * 4)
    assert rec.probe_dim == 64


def test_probe_budget_caps_candidates(tmp_path):
    """Budget 0: only the first (heuristic) rung is measured, in both."""
    rng = np.random.default_rng(0)
    r, c, v = coo(rng, 64, 64, 300)
    tA, jA = both(r, c, v, 64, 64)
    rec = _probe_both(tmp_path, "plus_times", tA, jA, [5.0] * 6, budget_s=0.0)
    assert rec is not None
    assert tst.PlanStore(str(tmp_path / "torch")).stats()["entries"] == 1


def test_probe_skips_by_design_and_raises_otherwise(tmp_path, monkeypatch):
    """A rung that raises one of ``PROBE_SKIPS`` (a tier's
    ``TierRefusal``, the windowed tier's ``CapacityOverflowError``) is
    skipped and listed in ``last_errors``; a rung that fails otherwise —
    K1's wrapper failing as a failed ``nvcc`` build does, or refusing a
    bad call with its own ``ValueError`` — propagates out of the probe."""
    rng = np.random.default_rng(6)
    key = np.unique(rng.integers(0, 96 * 96, 600))
    tA, _ = both(key // 96, key % 96, np.ones(len(key), np.float32), 96, 96)
    calls = []

    def scan_fails(*a, **k):
        calls.append("scan")
        raise tpar.TierRefusal("spgemm_scan still overflowing")

    def windowed_overflows(*a, **k):
        calls.append("windowed")
        raise tpar.CapacityOverflowError("windowed tier overflowed its symbolic bound by 3")

    monkeypatch.setattr(tpar, "spgemm_scan", scan_fails)
    monkeypatch.setattr(tpar, "spgemm_windowed", windowed_overflows)
    rec = tpr.probe_spgemm(MIN_PLUS, tA, tA, backend="scatter", geometry=False,
                           measure=lambda fn: 0.5)
    assert rec.tier == "mxu"
    assert [e["candidate"] for e in tpr.probe_spgemm.last_errors] == ["windowed", "scan"]
    assert "CapacityOverflowError" in tpr.probe_spgemm.last_errors[0]["error"]
    rec = tpr.probe_spgemm(MIN_PLUS, tA, tA, backend="scatter", tier_order=("scan",),
                           measure=lambda fn: 0.5)
    assert rec is None and len(tpr.probe_spgemm.last_errors) == 1

    def k1_fails(*a, **k):
        raise RuntimeError("nvcc failed for csrc/semiring_mm.cu (exit 1)")

    monkeypatch.setattr(tpar, "semiring_matmul", k1_fails)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tpr.probe_spgemm(MIN_PLUS, tA, tA, backend="scatter", geometry=False,
                         measure=lambda fn: 0.5)
    k1 = tsm.semiring_matmul

    def k1_bad_call(kind, a, b):
        return k1(kind, a, b[:1])  # operands that do not chain

    monkeypatch.setattr(tpar, "semiring_matmul", k1_bad_call)
    with pytest.raises(ValueError, match="do not chain") as got:
        tpr.probe_spgemm(MIN_PLUS, tA, tA, backend="scatter", geometry=False,
                         measure=lambda fn: 0.5)
    assert not isinstance(got.value, tpar.TierRefusal)


def test_probe_real_measure_smoke(tmp_path):
    """One wall-clock probe on a tiny product: a sane record, persisted,
    nothing skipped."""
    rng = np.random.default_rng(0)
    r, c, v = coo(rng, 96, 96, 500)
    tA, _ = both(r, c, v, 96, 96)
    st = tst.PlanStore(str(tmp_path))
    key = tst.spgemm_plan_key(PLUS_TIMES, tA, tA, "scatter")
    assert key.platform == "cpu"
    rec = tpr.probe_spgemm(PLUS_TIMES, tA, tA, backend="scatter", store=st, key=key,
                           geometry=False)
    assert rec is not None and rec.tier in ("mxu", "windowed", "scan")
    assert rec.cost_s > 0 and st.lookup(key) == rec
    assert st.stats()["probe_seconds"] > 0 and tpr.probe_spgemm.last_errors == []


def test_probe_spmm_matches_reference(tmp_path):
    """``probe_spmm`` on both packages' ELL layouts under a fake
    ``measure``: the same winner and line; one admissible backend has
    nothing to measure."""
    from combblas_tpu.parallel import ellmat as jell
    from combblas_tpu.parallel.vec import DistMultiVec as JaxDMV
    from combblas_tpu_torch import DistMultiVec, EllParMat

    rng = np.random.default_rng(8)
    n = 64
    r, c = rng.integers(0, n, 400), rng.integers(0, n, 400)
    v = np.ones(400, np.float32)
    X = rng.random((n, 8)).astype(np.float32)
    jE = jell.EllParMat.from_host_coo(JaxGrid.make(2, 2), r, c, v, n, n)
    tE = EllParMat.from_host_coo(Grid.make(2, 2, device="cpu"), r, c, v, n, n)
    jX = JaxDMV.from_global(JaxGrid.make(2, 2), X, align="col")
    tX = DistMultiVec.from_global(tE.grid, X, align="col")
    recs = {}
    for name, pkg, st_mod, sr, E, XX in (("jax", jpr, jst, jsr.PLUS_TIMES, jE, jX),
                                         ("torch", tpr, tst, PLUS_TIMES, tE, tX)):
        seq = iter([0.3, 0.1])
        st = st_mod.PlanStore(str(tmp_path / name))
        rec = pkg.probe_spmm(sr, E, XX, store=st, key=st_mod.spmm_plan_key(sr, E, 8),
                             measure=lambda fn: next(seq))
        recs[name] = rec.to_json() | {"ts": None}
    assert recs["torch"] == recs["jax"] and recs["torch"]["tier"] == "scatter"
    assert _persisted(tmp_path / "torch") == _persisted(tmp_path / "jax")
    assert tpr.probe_spmm(MIN_PLUS, tE, tX) is None
