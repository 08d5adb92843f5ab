"""Parity of the port's routing sites with ``combblas_tpu``'s on the CPU:
``spgemm_auto``'s tier and plan-source counts and its mxu retry, the 3D
tier (``parallel/mesh3d.py``), and the tuner (``tuner/store.py``,
``resolve.py``, ``probe.py``), compared as in ``test_torch_obs_spgemm.py``
(series by name, labels and value; spans without times). The probe's cost
functional is injected, so both packages measure the same costs.
"""

import jax
import numpy as np
import pytest

from combblas_tpu.parallel import mesh3d as jmesh
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.tuner import probe as jprobe
from combblas_tpu.tuner import resolve as jresolve
from combblas_tpu.tuner import store as jstore
from combblas_tpu_torch import Grid, Grid3D, SpParMat
from combblas_tpu_torch.parallel import mesh3d as tmesh
from combblas_tpu_torch.parallel import spgemm as tpar
from combblas_tpu_torch.tuner import probe as tprobe
from combblas_tpu_torch.tuner import resolve as tresolve
from combblas_tpu_torch.tuner import store as tstore
from torch_obs_parity import SR, clean, graph, jobs, mats, recording, run_both, series, tobs


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Both packages on a fresh, empty plan store of the test's own, so
    that each builds its store (and gauges its entries) inside the
    recorded call."""
    monkeypatch.setenv("COMBBLAS_PLAN_STORE", str(tmp_path / "plans"))
    jstore._reset_for_tests()
    tstore._reset_for_tests()
    with clean():
        yield
    jstore._reset_for_tests()
    tstore._reset_for_tests()


# --- parallel/spgemm.py: the router


def test_auto_router_sites():
    d = graph(4, n=48, density=0.1)
    jA, tA = mats((1, 1), d)
    sr, jsr_ = SR["min_plus"]
    run_both(lambda: jpar.spgemm_auto(jsr_, jA, jA, out_capacity=64, interpret=True),
             lambda: tpar.spgemm_auto(sr, tA, tA, out_capacity=64), device_sync=True)
    assert tobs.registry.get_counter("spgemm.auto.tier", tier="mxu", sr="min_plus") == 1
    assert tobs.registry.get_counter("spgemm.mxu.overflow_retries") == 1
    run_both(lambda: jpar.spgemm_auto(jsr_, jA, jA, tier="esc", merge="runs"),
             lambda: tpar.spgemm_auto(sr, tA, tA, tier="esc", merge="runs"))
    # duplicate entries demote the mxu rung
    r, c = np.nonzero(d)
    r, c = np.concatenate([r, r[:5]]), np.concatenate([c, c[:5]])
    v = np.ones(len(r), np.float32)
    jU = JaxSpParMat.from_global_coo(JaxGrid.make(1, 1), r, c, v, 48, 48)
    tU = SpParMat.from_global_coo(Grid.make(1, 1, device="cpu"), r, c, v, 48, 48)
    run_both(lambda: jpar.spgemm_auto(jsr_, jU, jU), lambda: tpar.spgemm_auto(sr, tU, tU))
    assert tobs.registry.get_counter("spgemm.auto.dedup_fallback", sr="min_plus") == 1


# --- parallel/mesh3d.py --------------------------------------------------------------


def test_mesh3d_sites():
    d = graph(5, n=32, density=0.15)
    sr, jsr_ = SR["min_plus"]
    jg3, tg3 = jmesh.Grid3D.make(2, 2, 2), Grid3D.make(2, 2, 2, device="cpu")
    jA, tA = mats((2, 2), d)
    jA3, tA3 = (jmesh.SpParMat3D.from_spmat(jA, jg3, split="col"),
                tmesh.SpParMat3D.from_spmat(tA, tg3, split="col"))
    jB3, tB3 = (jmesh.SpParMat3D.from_spmat(jA, jg3, split="row"),
                tmesh.SpParMat3D.from_spmat(tA, tg3, split="row"))
    for kw in (dict(tier="esc", ring=True, merge="hash"), dict(tier="windowed", ring=True)):
        run_both(lambda: jmesh.spgemm3d(jsr_, jA3, jB3, **kw),
                 lambda: tmesh.spgemm3d(sr, tA3, tB3, **kw))
    assert tobs.registry.get_counter("spgemm.merge.tier", tier="runs", source="heuristic",
                                     op="spgemm3d") == 1


# --- tuner/ --------------------------------------------------------------------------


def test_store_resolve_and_probe_sites(tmp_path, monkeypatch):
    d = graph(6)
    jA, tA = mats((1, 1), d)
    sr, jsr_ = SR["plus_times"]
    monkeypatch.setenv("COMBBLAS_PLAN_STORE_MAX", "2")
    monkeypatch.setenv("COMBBLAS_PLAN_STORE_COMPACT_MIN", "1")

    def store_ops(mod, sub):
        path = tmp_path / sub
        path.mkdir()
        (path / "plans.jsonl").write_text("not json\n")
        st = mod.PlanStore(str(path))
        keys = [mod.PlanKey(op="spgemm", shape=(i, 8, 8), band=(1, 1), sr="plus_times",
                            backend="scatter", grid="1x1", platform="cpu")
                for i in range(3)]
        for i, k in enumerate(keys):
            st.lookup(k)
            st.put(k, mod.PlanRecord(tier="esc", cost_s=0.1 * i, ts=float(i)))
            st.lookup(k)
        st.put(keys[2], mod.PlanRecord(tier="bogus", ts=9.0))
        return st, keys

    def run(mod, res, sub):
        st, keys = store_ops(mod, sub)
        res.resolve_tier(keys[2], allowed=("esc", "scan"), heuristic="scan", store=st)
        res.resolve_tier(keys[0], allowed=("esc", "scan"), heuristic="scan", store=st,
                         tier="esc")
        res.resolve_tier(None, allowed=("esc", "scan"), heuristic="scan", store=st,
                         account=False)
        mod.PlanStore(st.path)  # reload: shadowed lines are compacted

    jax.clear_caches()
    with recording(jobs):
        run(jstore, jresolve, "jax")
    with recording(tobs):
        run(tstore, tresolve, "torch")

    def nodir(o):
        return {(k[0], k[1], tuple(x for x in k[2] if x[0] != "dir")): v
                for k, v in series(o).items()}

    assert nodir(tobs) == nodir(jobs)
    assert tobs.registry.get_counter("tuner.store.invalid") == jobs.registry.get_counter(
        "tuner.store.invalid") >= 1

    # the probe, with a cost functional that depends only on the call order
    def costs():
        seq = iter([0.5, 0.2, 0.3, 0.1, 0.4, 0.6, 0.7, 0.8])
        return lambda fn: (fn(), next(seq))[1]

    run_both(lambda: jprobe.probe_spgemm(jsr_, jA, jA, backend="scatter", measure=costs(),
                                         tier_order=["esc", "windowed", "scan"],
                                         budget_s=10.0, max_dim=32),
             lambda: tprobe.probe_spgemm(sr, tA, tA, backend="scatter", measure=costs(),
                                         tier_order=["esc", "windowed", "scan"],
                                         budget_s=10.0, max_dim=32))
    assert tobs.registry.get_counter("tuner.probe.winner", tier="windowed") == 1
    assert tobs.registry.get_counter("tuner.probe.geometry_runs") > 0
    run_both(lambda: jprobe.probe_spgemm(jsr_, jA, jA, backend="scatter", measure=costs(),
                                         tier_order=["esc", "scan"], budget_s=0.1,
                                         max_dim=32),
             lambda: tprobe.probe_spgemm(sr, tA, tA, backend="scatter", measure=costs(),
                                         tier_order=["esc", "scan"], budget_s=0.1,
                                         max_dim=32))
    assert tobs.registry.get_counter("tuner.probe.budget_exhausted") == 1
