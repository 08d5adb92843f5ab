"""Parity of the port's 2D routing rungs with ``combblas_tpu`` on the CPU:
``spgemm_auto``'s precedence arg > store > env > probe > heuristic (the
reference's source read from its ``spgemm.auto.plan_source`` counter, the
port's from ``spgemm_auto.last_run``), the replay of a record's tier,
geometry, schedule, dispatch and merge with explicit arguments beating it,
the environment's geometry after the record, the record vetting (a tier the
router does not serve, ``windowed3d`` without ``grid3``, the mxu duplicate
guard), the probe's call then the store's replay of its geometry,
``resolve_tier`` and ``resolve_merge``. The backend, merge, dispatch and
bucketing knobs of the tiers are held in ``test_torch_tuner_knobs.py``,
the 3D and SpMM rungs in ``test_torch_tuner_routes3d.py``.

Both packages route under the same store file and environment. Values are
small integers, so every product — plus_times too — is compared bit for
bit: tiles with their padding, ``nnz`` and capacity. The reference runs its
semiring GEMM in interpret mode. Left out of this file, as of the
reference's ``tests/test_tuner.py``: the serve-lane replay through the
engine (``:595``, ``:625``; the engine comes with ROADMAP item 15) and the
``obs`` provider (``:644``; item 13b).
"""

import contextlib
import os

import numpy as np
import pytest

from combblas_tpu import obs
from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.tuner import probe as jpr
from combblas_tpu.tuner import resolve as jres
from combblas_tpu.tuner import store as jst
from combblas_tpu_torch import MAX_MIN, MIN_PLUS, PLUS_TIMES, Grid, SpParMat
from combblas_tpu_torch.parallel import spgemm as tpar
from combblas_tpu_torch.tuner import config as tcfg
from combblas_tpu_torch.tuner import probe as tpr
from combblas_tpu_torch.tuner import resolve as tres
from combblas_tpu_torch.tuner import store as tst

SRS = {"plus_times": (PLUS_TIMES, jsr.PLUS_TIMES), "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
       "max_min": (MAX_MIN, jsr.MAX_MIN)}
ROUTE_KNOBS = ("ENV_TIER", "ENV_BACKEND", "ENV_BLOCK_ROWS", "ENV_BLOCK_COLS", "ENV_DISPATCH",
               "ENV_BUCKET_CAPS", "ENV_PROBE", "ENV_MERGE", "ENV_TIER3D", "ENV_SPMM_BACKEND")


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


def same(got, want):
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def same_mat(got, want):
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "vals", "nnz"):
        same(getattr(got, f), getattr(want, f))


def operands(seed, n=64, nnz=400, p=1, dup=0.0, unique=False):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    if unique:
        key = np.unique(r * n + c)
        r, c = key // n, key % n
    v = rng.integers(1, 4, len(r)).astype(np.float32)
    k = int(len(r) * dup)
    r, c, v = (np.concatenate([x, x[:k]]) for x in (r, c, v))
    return (SpParMat.from_global_coo(Grid.make(p, p, device="cpu"), r, c, v, n, n),
            JaxSpParMat.from_global_coo(JaxGrid.make(p, p), r, c, v, n, n))


@contextlib.contextmanager
def ref_sources():
    """The reference's ``spgemm.auto.plan_source`` counter labels over the
    block, as a list of (source, tier)."""
    got = []
    obs.enable(install_hooks=False)
    obs.reset()
    try:
        yield got
        got.extend((m["labels"]["source"], m["labels"]["tier"])
                   for m in obs.registry.snapshot()
                   if m["name"] == "spgemm.auto.plan_source")
    finally:
        obs.disable()
        obs.reset()


def routed(srname, tA, jA, stores=None, **kw):
    """Both packages' ``spgemm_auto(A, A)``: equal products, and the port's
    (tier, source) among the reference's (source, tier) labels — the only
    one but where the reference's probe counted its own forced calls.
    ``stores``: a (reference, port) pair of store dirs, one for each
    package's call, for calls that write the store."""
    sr, jr = SRS[srname]
    if stores is not None:
        os.environ[tcfg.ENV_PLAN_STORE] = stores[0]
    with ref_sources() as src:
        want = jpar.spgemm_auto(jr, jA, jA, interpret=True, **kw)
    if stores is not None:
        os.environ[tcfg.ENV_PLAN_STORE] = stores[1]
    got = tpar.spgemm_auto(sr, tA, tA, **kw)
    same_mat(got, want)
    run = tpar.spgemm_auto.last_run
    if run["plan_source"] == "probe":
        assert (run["plan_source"], run["tier"]) in src and {s for s, _ in src} == {
            "arg", "probe"}, (src, run)
    else:
        assert src == [(run["plan_source"], run["tier"])], (src, run)
    return run


def put_both(key_sr, tA, jA, backend="scatter", **rec):
    """One record under the key of A·A, written by the reference into the
    shared store file; the port reads the same file."""
    sr, jr = SRS[key_sr]
    key = jst.spgemm_plan_key(jr, jA, jA, backend)
    assert key.to_json() == tst.spgemm_plan_key(sr, tA, tA, backend).to_json()
    jst.get_store().put(key, jst.PlanRecord(**rec))
    tst._reset_for_tests()


def test_precedence_matches_reference(monkeypatch):
    """arg > store > env > heuristic, as the reference's test walks it."""
    tA, jA = operands(1, unique=True)
    put_both("plus_times", tA, jA, tier="scan", cost_s=0.5)
    monkeypatch.setenv(tcfg.ENV_TIER, "windowed")
    assert routed("plus_times", tA, jA) == {"tier": "scan", "plan_source": "store",
                                            "merge_source": None}
    assert routed("plus_times", tA, jA, tier="esc")["plan_source"] == "arg"
    assert routed("min_plus", tA, jA) == {"tier": "windowed", "plan_source": "env",
                                          "merge_source": None}
    monkeypatch.delenv(tcfg.ENV_TIER)
    assert routed("max_min", tA, jA) == {"tier": "mxu", "plan_source": "heuristic",
                                         "merge_source": None}
    assert tst.get_store().stats()["hits"] == 1


def test_record_geometry_schedule_and_args(monkeypatch):
    """A windowed record replays block_rows and ring (the carousel runs
    fused); an explicit ring=False beats it (the blocked form); the
    environment's block_rows fills in only where the record has none."""
    tA, jA = operands(2, p=2, nnz=500, unique=True)
    put_both("plus_times", tA, jA, tier="windowed", block_rows=16, ring=True)
    routed("plus_times", tA, jA)
    assert tpar.spgemm_windowed.last_plan["form"] == "fused"
    assert tpar.spgemm_windowed.last_plan["block_rows"] == 16
    routed("plus_times", tA, jA, ring=False)
    assert tpar.spgemm_windowed.last_plan["form"] == "blocked"
    monkeypatch.setenv(tcfg.ENV_BLOCK_ROWS, "8")
    routed("plus_times", tA, jA)
    assert tpar.spgemm_windowed.last_plan["block_rows"] == 16  # the record's
    routed("min_plus", tA, jA, tier="windowed")
    assert tpar.spgemm_windowed.last_plan["block_rows"] == 8  # the environment's
    routed("min_plus", tA, jA, tier="windowed", block_rows=4)
    assert tpar.spgemm_windowed.last_plan["block_rows"] == 4  # the argument


def test_record_dispatch_and_merge_replay():
    """A record's dispatch reaches the windowed tier, its merge the esc
    tier (``merge_source`` "store"); an explicit merge beats it."""
    tA, jA = operands(3, p=2, nnz=500, dup=0.1)
    put_both("min_plus", tA, jA, tier="windowed", block_rows=8, dispatch="fused")
    routed("min_plus", tA, jA)
    assert tpar.spgemm_windowed.last_plan["form"] == "fused"
    put_both("max_min", tA, jA, tier="esc", merge="runs")
    assert routed("max_min", tA, jA)["merge_source"] == "store"
    assert routed("max_min", tA, jA, merge="sort")["merge_source"] == "arg"


@pytest.mark.parametrize("case", ["serve_tier", "windowed3d_no_grid3", "mxu_duplicates"])
def test_record_vetting_matches_reference(case):
    """A record the router must not trust is discarded and the call
    degrades to the heuristic, in both packages."""
    tA, jA = operands(4, dup=0.25 if case == "mxu_duplicates" else 0.0,
                      unique=case != "mxu_duplicates")
    tier = {"serve_tier": "serve", "windowed3d_no_grid3": "windowed3d",
            "mxu_duplicates": "mxu"}[case]
    put_both("plus_times", tA, jA, tier=tier)
    run = routed("plus_times", tA, jA)
    assert run["plan_source"] == "heuristic"
    assert tst.get_store().stats()["hits"] == 1  # the key matched, the record went


def test_probe_then_store_replays_geometry(monkeypatch, tmp_path):
    """``COMBBLAS_TUNER_PROBE=1`` on a store miss: both packages probe with
    the same scripted costs (windowed wins, then a geometry candidate) and
    persist the same record; the probing call runs the winner at its
    default geometry, the next call replays the stored geometry from the
    store."""
    tA, jA = operands(5, n=128, nnz=900, unique=True)
    costs = [0.5, 0.4, 0.6, 0.9, 0.05, 0.7, 0.7]  # mxu, windowed, scan; then geometry

    def scripted():
        seq = iter(costs)
        return lambda fn: next(seq)

    fake = {"t": scripted(), "j": scripted()}
    monkeypatch.setattr(tpr, "wall_measure", lambda device: fake["t"])
    monkeypatch.setattr(jpr, "_default_measure", lambda fn: fake["j"](fn))
    monkeypatch.setenv(tcfg.ENV_PROBE, "1")
    stores = (str(tmp_path / "j"), str(tmp_path / "t"))
    run = routed("plus_times", tA, jA, stores=stores)
    assert run == {"tier": "windowed", "plan_source": "probe", "merge_source": None}
    assert tpar.spgemm_windowed.last_plan["block_rows"] == tpar.default_block_rows(128, 128)
    rec = tst.get_store().peek(tst.spgemm_plan_key(PLUS_TIMES, tA, tA, "scatter"))
    geo = tpr._geometry_candidates(128, 128)[1]
    assert (rec.tier, rec.block_rows, rec.block_cols, rec.cost_s) == ("windowed", *geo, 0.05)
    assert tpr.probe_spgemm.last_errors == []
    jrec = jst.PlanStore(stores[0]).peek(jst.spgemm_plan_key(jsr.PLUS_TIMES, jA, jA, "scatter"))
    assert rec.to_json() | {"ts": 0} == jrec.to_json() | {"ts": 0}
    runs = tst.get_store().stats()["probe_runs"]
    assert routed("plus_times", tA, jA, stores=stores)["plan_source"] == "store"
    assert tpar.spgemm_windowed.last_plan["block_rows"] == geo[0]
    assert tst.get_store().stats()["probe_runs"] == runs
    # a fresh store instance reads the record back from the file
    tst._reset_for_tests()
    jst._reset_for_tests()
    assert routed("plus_times", tA, jA, stores=stores)["plan_source"] == "store"
    # the probe covers the 2D ladder only: with grid3 the store misses and
    # the heuristic answers without probing
    from combblas_tpu_torch.parallel import mesh3d as tm

    runs = tst.get_store().stats()["probe_runs"]
    tpar.spgemm_auto(MIN_PLUS, tA, tA, grid3=tm.Grid3D.make(1, 1, 1, device="cpu"))
    assert tpar.spgemm_auto.last_run["plan_source"] == "heuristic"
    assert tst.get_store().stats()["probe_runs"] == runs


def test_store_off_skips_key_and_probe(monkeypatch, tmp_path):
    """With the store disabled nothing is looked up or probed; with an empty
    store and probing off, no key is built (no host nnz readback)."""
    tA, jA = operands(6, unique=True)
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, "0")
    monkeypatch.setenv(tcfg.ENV_PROBE, "1")
    assert routed("plus_times", tA, jA)["plan_source"] == "heuristic"
    assert getattr(tA, "_host_nnz_cache", None) is None
    monkeypatch.delenv(tcfg.ENV_PROBE)
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, str(tmp_path / "empty"))
    tst._reset_for_tests()
    jst._reset_for_tests()
    assert routed("plus_times", tA, jA)["plan_source"] == "heuristic"
    assert getattr(tA, "_host_nnz_cache", None) is None
    assert tst.get_store().stats()["misses"] == 0


def test_resolve_tier_and_merge_match_reference(monkeypatch, tmp_path):
    """``resolve_tier`` walks arg > store > env > probe > heuristic with the
    record vetting, ``account=False`` peeks; ``resolve_merge`` walks arg >
    record > env — both as the reference's."""
    jstore = jst.PlanStore(str(tmp_path / "s"))
    key_j = jst.plan_key_from_counts("plus_times", 1 << 14, 1 << 14, 1 << 14, 131072, 131072,
                                     "scatter", "1x1", platform="cpu")
    key_t = tst.PlanKey.from_json(key_j.to_json())

    def both_resolve(**kw):
        tstore_ = tst.PlanStore(str(tmp_path / "s"))
        got = tres.resolve_tier(key_t, store=tstore_, **kw)
        want = jres.resolve_tier(key_j, store=jst.PlanStore(str(tmp_path / "s")), **kw)
        norm = lambda r: (r[0], r[1], None if r[2] is None else r[2].to_json() | {"ts": 0})  # noqa: E731
        assert norm(got) == norm(want), kw
        return got, tstore_

    assert both_resolve(allowed=("scan", "esc"), heuristic=lambda: "esc")[0][:2] == (
        "esc", "heuristic")
    jstore.put(key_j, jst.PlanRecord(tier="scan", cost_s=0.5, merge="runs"))
    assert both_resolve(allowed=("scan", "esc"), heuristic="esc")[0][:2] == ("scan", "store")
    assert both_resolve(op="spgemm3d", allowed=("esc", "windowed"),
                        heuristic="esc")[0][:2] == ("esc", "heuristic")
    monkeypatch.setenv(tcfg.ENV_TIER3D, "windowed")
    assert both_resolve(op="spgemm3d", allowed=("esc", "windowed"),
                        heuristic="esc")[0][:2] == ("windowed", "env")
    assert both_resolve(allowed=("scan", "esc"), heuristic="esc", tier="mxu")[0][:2] == (
        "mxu", "arg")
    got, st = both_resolve(allowed=("scan", "esc"), heuristic="esc", account=False)
    assert st.stats()["hits"] == 0 and got[1] == "store"
    monkeypatch.setenv(tcfg.ENV_PROBE, "1")
    probe = lambda: jst.PlanRecord(tier="esc", cost_s=0.1)  # noqa: E731
    miss = jst.plan_key_from_counts("min_plus", 8, 8, 8, 8, 8, "scatter", "1x1",
                                    platform="cpu")
    got = tres.resolve_tier(tst.PlanKey.from_json(miss.to_json()), allowed=("scan", "esc"),
                            heuristic="scan", store=tst.PlanStore(str(tmp_path / "s")),
                            probe=probe)
    want = jres.resolve_tier(miss, allowed=("scan", "esc"), heuristic="scan",
                             store=jst.PlanStore(str(tmp_path / "s")), probe=probe)
    assert got[:2] == want[:2] == ("esc", "probe")
    rec = tst.PlanRecord(tier="esc", merge="hash")
    for merge, env in ((None, None), ("sort", "runs"), (None, "runs")):
        if env:
            monkeypatch.setenv(tcfg.ENV_MERGE, env)
        for r in (None, rec, tst.PlanRecord(tier="esc")):
            jr_ = None if r is None else jst.PlanRecord.from_json(r.to_json())
            assert tres.resolve_merge(merge, r) == jres.resolve_merge(merge, jr_)
    with pytest.raises(ValueError, match="merge must be one of"):
        tres.resolve_merge("quick", None)
