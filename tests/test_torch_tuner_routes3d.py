"""Parity of the port's 3D and SpMM routing rungs with ``combblas_tpu`` on
the CPU: ``spgemm3d``'s chain store > ``COMBBLAS_SPGEMM3D_TIER`` > probe >
``"esc"`` with the merge through ``resolve_merge`` (the reference's source
read from its ``spgemm.auto.plan_source`` counter, the port's from
``spgemm3d.last_run``), ``probe_spgemm3d`` under a fake ``measure``, and ``resolve_spmm_backend``
(store, environment with its raise, probe on the real operands,
heuristic) with ``dist_spmm``'s routed product.

Both packages route under the same store file and environment (a probing
call: each package from an empty store of its own, then each from what it
wrote). Values are small integers, so products are compared bit for bit.
"""

import functools
import os

import numpy as np
import pytest

from combblas_tpu import obs
from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu.parallel import spmm as jspmm
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.tuner import probe as jpr
from combblas_tpu.tuner import store as jst
from combblas_tpu_torch import MIN_PLUS, PLUS_TIMES, DistMultiVec, EllParMat, Grid
from combblas_tpu_torch.parallel import mesh3d as tm
from combblas_tpu_torch.parallel import spmm as tspmm
from combblas_tpu_torch.tuner import config as tcfg
from combblas_tpu_torch.tuner import probe as tpr
from combblas_tpu_torch.tuner import store as tst
from test_torch_tuner_probe import _persisted
from test_torch_tuner_routes import ROUTE_KNOBS, operands, same


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ROUTE_KNOBS:
        monkeypatch.delenv(getattr(tcfg, name), raising=False)
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, str(tmp_path / "plans"))
    jst._reset_for_tests()
    tst._reset_for_tests()
    yield
    jst._reset_for_tests()
    tst._reset_for_tests()


def mats3d(seed=5, n=64, nnz=500):
    tA, jA = operands(seed, n=n, nnz=nnz, p=2, unique=True)
    tg, jg = tm.Grid3D.make(2, 2, 2, device="cpu"), jm.Grid3D.make(2, 2, 2)
    return ([tm.SpParMat3D.from_spmat(tA, tg, s) for s in ("col", "row")],
            [jm.SpParMat3D.from_spmat(jA, jg, s) for s in ("col", "row")])


def scripted(costs):
    seq = iter(costs)
    return lambda fn: next(seq)


def routed3d(t3, j3, stores=None, **kw):
    """Both packages' ``spgemm3d``: equal tiles, and the port's source the
    reference's (its probe's own forced calls count as ``arg``)."""
    if stores is not None:
        os.environ[tcfg.ENV_PLAN_STORE] = stores[0]
    obs.enable(install_hooks=False)
    obs.reset()
    try:
        want = jm.spgemm3d(jsr.MIN_PLUS, *j3, **kw)
        src = {(m["labels"]["source"], m["labels"]["tier"])
               for m in obs.registry.snapshot()
               if m["name"] == "spgemm.auto.plan_source" and m["labels"]["op"] == "spgemm3d"}
    finally:
        obs.disable()
        obs.reset()
    if stores is not None:
        os.environ[tcfg.ENV_PLAN_STORE] = stores[1]
    got = tm.spgemm3d(MIN_PLUS, *t3, **kw)
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "vals", "nnz"):
        same(getattr(got, f), getattr(want, f))
    run = tm.spgemm3d.last_run
    want_src = {(run["plan_source"], run["tier"])}
    if run["plan_source"] == "probe":
        assert want_src <= src and {s for s, _ in src} == {"arg", "probe"}, (src, run)
    else:
        assert src == want_src, (src, run)
    return run


def test_spgemm3d_rungs_match_reference(monkeypatch):
    """heuristic (esc) > env tier and merge > store record (tier and merge
    replayed, an explicit merge beating the record) > argument."""
    t3, j3 = mats3d()
    assert routed3d(t3, j3)["plan_source"] == "heuristic"
    monkeypatch.setenv(tcfg.ENV_TIER3D, "windowed")
    monkeypatch.setenv(tcfg.ENV_MERGE, "sort")
    run = routed3d(t3, j3)
    assert (run["tier"], run["plan_source"], run["merge_source"]) == ("windowed", "env", "env")
    assert tm.spgemm3d_windowed.last_plan["merge"] == "sort"
    monkeypatch.delenv(tcfg.ENV_TIER3D)
    monkeypatch.setenv(tcfg.ENV_MERGE, "hash")
    run = routed3d(t3, j3)
    assert (run["tier"], run["merge"], run["merge_source"]) == ("esc", "hash", "env")
    monkeypatch.delenv(tcfg.ENV_MERGE)
    key = jst.spgemm3d_plan_key(jsr.MIN_PLUS, *j3, "")
    assert key.to_json() == tst.spgemm3d_plan_key(MIN_PLUS, *t3, "").to_json()
    jst.get_store().put(key, jst.PlanRecord(tier="windowed", merge="runs", block_rows=8))
    tst._reset_for_tests()
    run = routed3d(t3, j3)
    assert (run["tier"], run["plan_source"], run["merge_source"]) == ("windowed", "store",
                                                                       "store")
    assert tm.spgemm3d_windowed.last_plan["block_rows"] == 8
    assert tm.spgemm3d_windowed.last_plan["merge"] == "runs"
    run = routed3d(t3, j3, merge="sort")
    assert run["merge_source"] == "arg" and tm.spgemm3d_windowed.last_plan["merge"] == "sort"
    assert routed3d(t3, j3, tier="esc")["plan_source"] == "arg"
    jst.get_store().put(key, jst.PlanRecord(tier="mxu"))  # not a 3D tier: vetted out
    tst._reset_for_tests()
    assert routed3d(t3, j3)["plan_source"] == "heuristic"


def test_spgemm3d_probe_then_store(monkeypatch, tmp_path):
    """``COMBBLAS_TUNER_PROBE=1``: both packages probe the (tier, merge)
    candidates with the same scripted costs and persist the same record;
    the next call replays it from the store."""
    t3, j3 = mats3d(seed=6)
    costs = [0.5, 0.4, 0.2, 0.3, 0.6]
    monkeypatch.setattr(jpr, "probe_spgemm3d",
                        functools.partial(jpr.probe_spgemm3d, measure=scripted(costs)))
    monkeypatch.setattr(tpr, "probe_spgemm3d",
                        functools.partial(tpr.probe_spgemm3d, measure=scripted(costs)))
    monkeypatch.setenv(tcfg.ENV_PROBE, "1")
    stores = (str(tmp_path / "j"), str(tmp_path / "t"))
    run = routed3d(t3, j3, stores=stores)
    assert (run["tier"], run["plan_source"], run["merge_source"]) == ("windowed", "probe", None)
    assert tpr.probe_spgemm3d.func.last_errors == []
    rec = tst.get_store().peek(tst.spgemm3d_plan_key(MIN_PLUS, *t3, ""))
    jrec = jst.PlanStore(stores[0]).peek(jst.spgemm3d_plan_key(jsr.MIN_PLUS, *j3, ""))
    assert rec.to_json() | {"ts": 0} == jrec.to_json() | {"ts": 0}
    runs = tst.get_store().stats()["probe_runs"]
    assert runs == 5
    assert routed3d(t3, j3, stores=stores)["plan_source"] == "store"
    assert tst.get_store().stats()["probe_runs"] == runs


def test_probe_spgemm3d_matches_reference(tmp_path, monkeypatch):
    """``probe_spgemm3d`` on a 2x2x2 grid under a fake ``measure``: the
    reference's candidate list (also deduplicated under
    ``COMBBLAS_SPGEMM_MERGE``), winner, merge and persisted line."""
    (tA3, tB3), (jA3, jB3) = mats3d(seed=5)
    seen = {}
    for name, pkg, st_mod, sr, A3, B3 in (("jax", jpr, jst, jsr.MIN_PLUS, jA3, jB3),
                                          ("torch", tpr, tst, MIN_PLUS, tA3, tB3)):
        order = []

        def measure(fn, order=order):
            order.append(len(order))
            return [0.5, 0.4, 0.2, 0.3, 0.6][len(order) - 1]

        st = st_mod.PlanStore(str(tmp_path / name))
        key = st_mod.spgemm3d_plan_key(sr, A3, B3, "")
        rec = pkg.probe_spgemm3d(sr, A3, B3, store=st, key=key, measure=measure)
        seen[name] = (rec.to_json() | {"ts": None}, len(order))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0]["tier"] == "windowed" and seen["torch"][0]["merge"] is None
    assert _persisted(tmp_path / "torch") == _persisted(tmp_path / "jax")
    assert tpr.probe_spgemm3d.last_errors == []
    monkeypatch.setenv(tcfg.ENV_MERGE, "runs")
    assert tpr.spgemm3d_candidates(MIN_PLUS, tA3) == [("esc", None), ("windowed", None),
                                                      ("windowed", "sort"),
                                                      ("windowed", "hash")]


def spmm_operands(seed=8, n=64, F=8):
    from combblas_tpu.parallel import ellmat as jell
    from combblas_tpu.parallel.vec import DistMultiVec as JaxDMV

    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, 400), rng.integers(0, n, 400)
    v = rng.integers(1, 4, 400).astype(np.float32)
    X = rng.integers(0, 3, (n, F)).astype(np.float32)
    tE = EllParMat.from_host_coo(Grid.make(2, 2, device="cpu"), r, c, v, n, n)
    jE = jell.EllParMat.from_host_coo(JaxGrid.make(2, 2), r, c, v, n, n)
    return (tE, DistMultiVec.from_global(tE.grid, X, align="col"),
            jE, JaxDMV.from_global(JaxGrid.make(2, 2), X, align="col"))


def test_resolve_spmm_backend_matches_reference(monkeypatch, tmp_path):
    """heuristic > env (a non-admissible value raises, naming the knob, in
    both) > store record > argument; a one-backend semiring short-circuits;
    ``dist_spmm``'s routed product equals the reference's."""
    tE, tX, jE, jX = spmm_operands()

    def both(sr, jr, **kw):
        got = outcome(tspmm.resolve_spmm_backend, sr, tE, 8, **kw)
        want = outcome(jspmm.resolve_spmm_backend, jr, jE, 8, **kw)
        assert got == want, kw
        return got

    assert both(PLUS_TIMES, jsr.PLUS_TIMES) == ("ok", "mxu_gather")
    assert both(MIN_PLUS, jsr.MIN_PLUS) == ("ok", "scatter")
    monkeypatch.setenv(tcfg.ENV_SPMM_BACKEND, "scatter")
    assert both(PLUS_TIMES, jsr.PLUS_TIMES) == ("ok", "scatter")
    same(tspmm.dist_spmm(PLUS_TIMES, tE, tX).blocks,
         jspmm.dist_spmm(jsr.PLUS_TIMES, jE, jX).blocks)
    monkeypatch.setenv(tcfg.ENV_SPMM_BACKEND, "tensor")
    assert both(PLUS_TIMES, jsr.PLUS_TIMES)[0] == "raise"
    assert "COMBBLAS_SPMM_BACKEND" in both(PLUS_TIMES, jsr.PLUS_TIMES)[2]
    monkeypatch.delenv(tcfg.ENV_SPMM_BACKEND)
    key = jst.spmm_plan_key(jsr.PLUS_TIMES, jE, 8)
    jst.get_store().put(key, jst.PlanRecord(tier="scatter", cost_s=0.1))
    tst._reset_for_tests()
    monkeypatch.setenv(tcfg.ENV_SPMM_BACKEND, "mxu_gather")
    assert both(PLUS_TIMES, jsr.PLUS_TIMES) == ("ok", "scatter")  # store beats env
    assert both(PLUS_TIMES, jsr.PLUS_TIMES, backend="mxu_gather") == ("ok", "mxu_gather")
    assert both(MIN_PLUS, jsr.MIN_PLUS, backend="mxu_gather")[0] == "raise"
    same(tspmm.dist_spmm(PLUS_TIMES, tE, tX).blocks,
         jspmm.dist_spmm(jsr.PLUS_TIMES, jE, jX).blocks)


def test_resolve_spmm_backend_probe_then_store(monkeypatch, tmp_path):
    """With the probe on and ``X`` given, both backends are measured on the
    real operands (scripted costs), the winner persisted, and the next
    call, without ``X``, replays it."""
    tE, tX, jE, jX = spmm_operands(seed=9)
    monkeypatch.setattr(jpr, "probe_spmm", functools.partial(jpr.probe_spmm,
                                                             measure=scripted([0.3, 0.1])))
    monkeypatch.setattr(tpr, "probe_spmm", functools.partial(tpr.probe_spmm,
                                                             measure=scripted([0.3, 0.1])))
    monkeypatch.setenv(tcfg.ENV_PROBE, "1")
    os.environ[tcfg.ENV_PLAN_STORE] = str(tmp_path / "j")
    want = jspmm.resolve_spmm_backend(jsr.PLUS_TIMES, jE, 8, X=jX)
    os.environ[tcfg.ENV_PLAN_STORE] = str(tmp_path / "t")
    got = tspmm.resolve_spmm_backend(PLUS_TIMES, tE, 8, X=tX)
    assert got == want == "scatter"
    assert tpr.probe_spmm.func.last_errors == []
    st = tst.get_store()
    assert st.stats()["probe_runs"] == 2 and st.entries() == 1
    assert tspmm.resolve_spmm_backend(PLUS_TIMES, tE, 8) == "scatter"
    assert st.stats()["hits"] == 1 and st.stats()["probe_runs"] == 2
    rec = st.peek(tst.spmm_plan_key(PLUS_TIMES, tE, 8))
    jrec = jst.PlanStore(str(tmp_path / "j")).peek(jst.spmm_plan_key(jsr.PLUS_TIMES, jE, 8))
    assert rec.to_json() | {"ts": 0} == jrec.to_json() | {"ts": 0}


def outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # the raise itself is what is compared
        return ("raise", type(exc).__name__, str(exc))
