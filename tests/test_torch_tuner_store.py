"""Parity of the port's tuner knobs and plan store with ``combblas_tpu`` on
the CPU: every ``COMBBLAS_*`` parser of ``tuner/config.py`` against the
reference's (values, defaults and raises), ``shape_bucket`` /
``density_band``, plan keys (from counts, from matrices of both packages,
the serve key from a plain namespace) and record JSON field for field,
the store's robustness scenarios run through both packages with equal
lookups and ``stats()``, a plans file crossing between the packages in
both directions, concurrent appends of whole lines from two processes,
and the port's ``utils/compile_cache`` (its idempotence contract, the
store's default as the cache's sibling, ``_build`` following the
committed dir).

Each test points ``COMBBLAS_PLAN_STORE`` at its own ``tmp_path`` and resets
both packages' store singletons. The comparisons are exact (host data).
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.tuner import config as jcfg
from combblas_tpu.tuner import store as jst
from combblas_tpu.utils import compile_cache as jcc
from combblas_tpu_torch import Grid, SpParMat, _build
from combblas_tpu_torch import obs as tobs
from combblas_tpu_torch.tuner import config as tcfg
from combblas_tpu_torch.tuner import store as tst
from combblas_tpu_torch.utils import compile_cache as tcc
from combblas_tpu import semiring as jsr


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, str(tmp_path / "plans"))
    jst._reset_for_tests()
    tst._reset_for_tests()
    yield
    jst._reset_for_tests()
    tst._reset_for_tests()


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # the raise itself is what is compared
        return ("raise", type(exc).__name__, str(exc))


# --- the knobs --------------------------------------------------------------

KNOBS = [
    ("env_tier", "ENV_TIER", ["", "mxu", "windowed"]),
    ("env_backend", "ENV_BACKEND", ["", "dot", "scatter"]),
    ("env_block_rows", "ENV_BLOCK_ROWS", ["", "0", "64", "abc"]),
    ("env_block_cols", "ENV_BLOCK_COLS", ["", "0", "512"]),
    ("env_tier3d", "ENV_TIER3D", ["", "esc", "windowed"]),
    ("env_dispatch", "ENV_DISPATCH", ["", "fused", "blocked"]),
    ("bucket_caps_enabled", "ENV_BUCKET_CAPS", ["", "0", "1", "2"]),
    ("probe_enabled", "ENV_PROBE", ["", "0", "1", "yes"]),
    ("probe_budget_s", "ENV_PROBE_BUDGET", ["", "1.5", "x"]),
    ("probe_max_dim", "ENV_PROBE_MAX_DIM", ["", "256", "3000"]),
    ("store_max_entries", "ENV_STORE_MAX", ["", "0", "3"]),
    ("store_compact_min", "ENV_STORE_COMPACT", ["", "0", "5"]),
    ("env_merge", "ENV_MERGE", ["", "sort", "runs", "hash", "bogus"]),
    ("env_spmm_backend", "ENV_SPMM_BACKEND", ["", "scatter", "mxu_gather"]),
    ("dynamic_headroom", "ENV_DYNAMIC_HEADROOM", ["", "0.25", "-1"]),
    ("obs_trace_sample", "ENV_OBS_TRACE_SAMPLE", ["", "0", "0.25", "2", "-1", "x"]),
    ("dynamic_spill_frac", "ENV_DYNAMIC_SPILL", ["", "0.25", "1", "x"]),
    ("wal_fsync", "ENV_WAL_FSYNC", ["", "always", "off", "sometimes"]),
]

GIVEN = {
    "dynamic_headroom": [0.5, -2.0],
    "obs_trace_sample": [0.5, 3.0],
    "wal_fsync": ["off", "always", "bogus"],
}


@pytest.mark.parametrize("fn,env,values", KNOBS, ids=[k[0] for k in KNOBS])
def test_knob_matches_reference(monkeypatch, fn, env, values):
    """Each parser gives the reference's value (or the reference's raise,
    type and message) for each setting, unset included; where it takes an
    explicit argument, the argument beats the environment in both."""
    name = getattr(jcfg, env)
    assert getattr(tcfg, env) == name
    monkeypatch.delenv(name, raising=False)
    assert outcome(getattr(tcfg, fn)) == outcome(getattr(jcfg, fn))
    for v in values:
        monkeypatch.setenv(name, v)
        assert outcome(getattr(tcfg, fn)) == outcome(getattr(jcfg, fn)), v
        for g in GIVEN.get(fn, ()):
            assert outcome(getattr(tcfg, fn), g) == outcome(getattr(jcfg, fn), g), (v, g)


def test_knob_constants_match_reference():
    """Every knob name, default and vetted value set of the port is the
    reference's, and every knob the port parses is held above."""
    names = {n for n in dir(tcfg) if n.isupper()}
    assert names <= {n for n in dir(jcfg) if n.isupper()}
    for n in names:
        assert getattr(tcfg, n) == getattr(jcfg, n), n
    assert {n for n in names if n.startswith("ENV_")} == {env for _, env, _ in KNOBS} | {
        "ENV_PLAN_STORE"}
    assert tcfg.MERGE_TIER_NAMES == ("sort", "runs", "hash")


def test_dispatch_and_store_dir(monkeypatch, tmp_path):
    """``resolve_dispatch`` gives the reference's value for every valid
    argument and setting, and raises ``ValueError`` where the reference
    asserts; ``store_dir`` follows ``COMBBLAS_PLAN_STORE`` as the
    reference's does, and defaults to the sibling of the port's build
    cache (the reference: of its XLA cache)."""
    monkeypatch.delenv(jcfg.ENV_DISPATCH, raising=False)
    for v in (None, "auto", "fused", "blocked"):
        assert tcfg.resolve_dispatch(v) == jcfg.resolve_dispatch(v)
    monkeypatch.setenv(jcfg.ENV_DISPATCH, "blocked")
    assert tcfg.resolve_dispatch() == jcfg.resolve_dispatch() == "blocked"
    assert tcfg.resolve_dispatch("fused") == "fused"
    monkeypatch.setenv(jcfg.ENV_DISPATCH, "block")
    with pytest.raises(AssertionError):
        jcfg.resolve_dispatch()
    with pytest.raises(ValueError, match="dispatch must be"):
        tcfg.resolve_dispatch()
    for v in ("0", "off", "none", " OFF ", "", str(tmp_path / "s")):
        monkeypatch.setenv(jcfg.ENV_PLAN_STORE, v)
        assert tcfg.store_dir() == jcfg.store_dir(), v
    monkeypatch.delenv(jcfg.ENV_PLAN_STORE)
    assert tcfg.store_dir() == tcc.plan_store_dir()
    assert tcfg.store_dir().endswith(os.path.join("build", ".plan_store"))
    assert tcfg.store_dir() != jcfg.store_dir()


# --- keys and records -------------------------------------------------------


def test_buckets_and_bands_match_reference():
    for d in list(range(0, 70)) + [1 << 14, (1 << 14) + 1, 10**9]:
        assert tst.shape_bucket(d) == jst.shape_bucket(d)
    for nnz in (0, 1, 5, 1024, 16 * 1024, 10**7, 10**12):
        for dim in (0, 1, 7, 1024, 1 << 20):
            assert tst.density_band(nnz, dim) == jst.density_band(nnz, dim), (nnz, dim)


def _rand_mats(seed=7, n=96, nnz=700, pr=2, pc=2):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n, nnz) * n + rng.integers(0, n, nnz))
    r, c = key // n, key % n
    v = rng.integers(1, 5, len(key)).astype(np.float32)
    return (JaxSpParMat.from_global_coo(JaxGrid.make(pr, pc), r, c, v, n, n),
            SpParMat.from_global_coo(Grid.make(pr, pc, device="cpu"), r, c, v, n, n))


def test_keys_match_reference():
    """Keys from counts (``platform="cpu"``) and from matrices of both
    packages on the CPU are equal field for field, JSON included; the
    count key's platform defaults to ``"cuda"`` in the port."""
    for kw in (dict(), dict(grid3="2x2x2", op="spgemm3d")):
        args = ("min_plus", 1 << 14, 1 << 13, 1 << 12, 131072, 9000, "scatter", "2x2")
        want = jst.plan_key_from_counts(*args, platform="cpu", **kw)
        got = tst.plan_key_from_counts(*args, platform="cpu", **kw)
        assert got.to_json() == want.to_json()
        assert tst.PlanKey.from_json(want.to_json()) == got
        assert tst.plan_key_from_counts(*args, **kw).platform == "cuda"
    jA, tA = _rand_mats()
    for backend in ("scatter", "dot"):
        want = jst.spgemm_plan_key(jsr.MIN_PLUS, jA, jA, backend)
        got = tst.spgemm_plan_key(_sr("min_plus"), tA, tA, backend)
        assert got.to_json() == want.to_json()
    assert tA._host_nnz_cache == int(tA.getnnz())  # memoized on the frozen matrix
    jB, tB = _rand_mats(seed=8, nnz=300)
    assert (tst.spgemm_plan_key(_sr("plus_times"), tA, tB, "scatter").to_json()
            == jst.spgemm_plan_key(jsr.PLUS_TIMES, jA, jB, "scatter").to_json())


def _sr(name):
    import combblas_tpu_torch as t

    return {"plus_times": t.PLUS_TIMES, "min_plus": t.MIN_PLUS, "max_min": t.MAX_MIN}[name]


def test_spmm_3d_and_serve_keys_match_reference():
    """``spmm_plan_key`` on both packages' ELL layouts, ``spgemm3d_plan_key``
    on both packages' 3D matrices, and ``serve_plan_key`` on a plain
    namespace (it reads attributes only)."""
    from combblas_tpu.parallel import ellmat as jell
    from combblas_tpu.parallel import mesh3d as jm
    from combblas_tpu_torch import EllParMat
    from combblas_tpu_torch.parallel import mesh3d as tm

    rng = np.random.default_rng(3)
    n = 64
    r, c = rng.integers(0, n, 400), rng.integers(0, n, 400)
    v = np.ones(400, np.float32)
    jE = jell.EllParMat.from_host_coo(JaxGrid.make(2, 2), r, c, v, n, n)
    tE = EllParMat.from_host_coo(Grid.make(2, 2, device="cpu"), r, c, v, n, n)
    for F in (1, 64, 100):
        assert (tst.spmm_plan_key(_sr("plus_times"), tE, F).to_json()
                == jst.spmm_plan_key(jsr.PLUS_TIMES, jE, F).to_json())
    jA, tA = _rand_mats()
    jA3 = jm.SpParMat3D.from_spmat(jA, jm.Grid3D.make(2, 2, 2), "col")
    tA3 = tm.SpParMat3D.from_spmat(tA, tm.Grid3D.make(2, 2, 2, device="cpu"), "col")
    jB3 = jm.SpParMat3D.from_spmat(jA, jm.Grid3D.make(2, 2, 2), "row")
    tB3 = tm.SpParMat3D.from_spmat(tA, tm.Grid3D.make(2, 2, 2, device="cpu"), "row")
    assert (tst.spgemm3d_plan_key(_sr("min_plus"), tA3, tB3, "").to_json()
            == jst.spgemm3d_plan_key(jsr.MIN_PLUS, jA3, jB3, "").to_json())
    for nnz in (5000, -1):
        ver = {"nrows": 1000, "ncols": 700}
        if nnz >= 0:
            ver["nnz"] = nnz
        eng = types.SimpleNamespace(version=types.SimpleNamespace(**ver),
                                    grid=types.SimpleNamespace(pr=2, pc=4))
        assert tst.serve_plan_key(eng).to_json() == jst.serve_plan_key(eng).to_json()


RECORDS = [
    dict(tier="windowed", block_rows=256, block_cols=512, ring=True, pipeline=False,
         dispatch="blocked", cost_s=1.25, source="probe", probe_dim=2048, ts=5.0),
    dict(tier="esc", merge="runs", cost_s=0.5, source="bench"),
    dict(tier="serve", source="serve", lanes=(("bfs", 32), ("sssp", 8))),
    dict(tier="mxu_gather"),
]


@pytest.mark.parametrize("rec", RECORDS, ids=[r["tier"] for r in RECORDS])
def test_record_json_matches_reference(rec):
    got, want = tst.PlanRecord(**rec), jst.PlanRecord(**rec)
    assert got.to_json() == want.to_json()
    assert tst.PlanRecord.from_json(want.to_json()).to_json() == want.to_json()
    assert jst.PlanRecord.from_json(got.to_json()).to_json() == got.to_json()


@pytest.mark.parametrize("plan", [{"tier": "warp_drive"}, {"tier": "windowed", "dispatch": "block"},
                                  {"tier": "esc", "merge": "quick"}, {"tier": "esc", "cost_s": "x"}])
def test_record_vetting_matches_reference(plan):
    """An unknown tier, dispatch or merge (or a non-number cost) raises in
    both packages with the same message."""
    assert outcome(tst.PlanRecord.from_json, plan) == outcome(jst.PlanRecord.from_json, plan)
    assert outcome(tst.PlanRecord.from_json, plan)[0] == "raise"


# --- the store: robustness scenarios through both packages ------------------


def _key(st_mod, i=0, sr="plus_times", op="spgemm"):
    return st_mod.plan_key_from_counts(sr, 1 << (8 + i), 1 << (8 + i), 1 << (8 + i),
                                       1 << (10 + i), 1 << (10 + i), "scatter", "1x1",
                                       op=op, platform="cpu")


def _line(st_mod, key, plan, schema=None):
    return json.dumps({"v": schema or st_mod.SCHEMA, "key": key.to_json(), "plan": plan})


def sc_roundtrip(m, d):
    st = m.PlanStore(d)
    st.put(_key(m), m.PlanRecord(**RECORDS[0]))
    st2 = m.PlanStore(d)
    return [st2.lookup(_key(m)).to_json(), st2.entries()], st2


def sc_later_line_wins(m, d):
    st = m.PlanStore(d)
    st.put(_key(m), m.PlanRecord(tier="scan", cost_s=9.0))
    st.put(_key(m), m.PlanRecord(tier="windowed", cost_s=1.0))
    st2 = m.PlanStore(d)
    return [st2.lookup(_key(m)).tier, st2.entries(), len(open(st2.file).readlines())], st2


def sc_damaged_lines(m, d):
    st = m.PlanStore(d)
    st.put(_key(m), m.PlanRecord(tier="scan", cost_s=2.0))
    good = _line(m, _key(m, sr="min_plus"), m.PlanRecord(tier="windowed", cost_s=1.0).to_json())
    with open(st.file, "a") as f:
        f.write("not json at all\n")
        f.write(_line(m, _key(m), {"tier": "scan"}, schema="combblas_tpu.plans/v999") + "\n")
        f.write(good + "\n")
        f.write(json.dumps({"v": m.SCHEMA, "key": {"op": "spgemm"}}) + "\n")
        f.write(_line(m, _key(m), {"tier": "warp_drive"}) + "\n")
        f.write(_line(m, _key(m, 1), {"tier": "windowed", "dispatch": "block"}) + "\n")
        f.write(_line(m, _key(m, 2), {"tier": "esc", "merge": "quick"}) + "\n")
        f.write(good[: len(good) // 2])  # torn final write
    st2 = m.PlanStore(d)
    return [st2.lookup(_key(m)).tier, st2.lookup(_key(m, sr="min_plus")).tier,
            st2.lookup(_key(m, 1)), st2.lookup(_key(m, 2))], st2


def sc_compaction(m, d):
    st = m.PlanStore(d)
    for i in range(8):  # 7 superseded lines for one key
        st.put(_key(m), m.PlanRecord(tier="scan", cost_s=float(i + 1), ts=float(i)))
    st.put(_key(m, 1), m.PlanRecord(tier="windowed", cost_s=0.5, ts=20.0))
    st2 = m.PlanStore(d)
    lines = open(st2.file).readlines()
    st3 = m.PlanStore(d)
    return [len(lines), st2.lookup(_key(m)).cost_s, st3.stats()["compacted_lines"]], st2


def sc_compaction_below_threshold(m, d):
    os.environ[m.config.ENV_STORE_COMPACT] = "50"
    st = m.PlanStore(d)
    for i in range(4):
        st.put(_key(m), m.PlanRecord(tier="scan", cost_s=float(i + 1)))
    st2 = m.PlanStore(d)
    return [len(open(st2.file).readlines())], st2


def sc_eviction(m, d):
    os.environ[m.config.ENV_STORE_MAX] = "3"
    os.environ[m.config.ENV_STORE_COMPACT] = "1"
    st = m.PlanStore(d)
    for i in range(5):
        st.put(_key(m, i), m.PlanRecord(tier="scan", cost_s=1.0, ts=float(100 + i)))
    first = [st.entries(), st.stats()["evicted"], st.lookup(_key(m, 0)),
             st.lookup(_key(m, 4)).ts]
    st2 = m.PlanStore(d)
    return first + [st2.entries(), len(open(st2.file).readlines())], st2


def sc_unstamped_age_first(m, d):
    os.environ[m.config.ENV_STORE_MAX] = "2"
    st = m.PlanStore(d)
    st.put(_key(m, 0), m.PlanRecord(tier="scan", ts=50.0))
    with open(st.file, "a") as f:  # a line without a timestamp
        f.write(_line(m, _key(m, 1), {"tier": "scan"}) + "\n")
    st = m.PlanStore(d)
    st.put(_key(m, 2), m.PlanRecord(tier="scan", ts=60.0))
    return [st.lookup(_key(m, 1)), st.lookup(_key(m, 0)).ts, st.entries()], st


def sc_serve_lanes(m, d):
    st = m.PlanStore(d)
    key = _key(m, op="serve")
    new = [st.add_serve_lane(key, "bfs", 32), st.add_serve_lane(key, "bfs", 32),
           st.add_serve_lane(key, "sssp", 8)]
    st2 = m.PlanStore(d)
    st2.record_probe(3, 0.25)
    return new + [st2.serve_lanes(key), st2.peek(_key(m))], st2


SCENARIOS = [sc_roundtrip, sc_later_line_wins, sc_damaged_lines, sc_compaction,
             sc_compaction_below_threshold, sc_eviction, sc_unstamped_age_first,
             sc_serve_lanes]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_store_scenario_matches_reference(monkeypatch, tmp_path, scenario):
    """The same store scenario through each package in its own directory:
    equal observations and equal ``stats()`` (its path aside), and both
    files load equally in the other package."""
    monkeypatch.setenv(jcfg.ENV_STORE_COMPACT, "5")
    monkeypatch.setenv(jcfg.ENV_STORE_MAX, "0")
    results = {}
    for name, m in (("jax", jst), ("torch", tst)):
        os.environ[jcfg.ENV_STORE_COMPACT] = "5"
        os.environ[jcfg.ENV_STORE_MAX] = "0"
        obs, st = scenario(m, str(tmp_path / name))
        stats = st.stats()
        stats.pop("path")
        results[name] = (obs, stats)
    jobs, jstats = results["jax"]
    tobs, tstats = results["torch"]

    def norm(x):
        if isinstance(x, (jst.PlanRecord, tst.PlanRecord)):
            return x.to_json()
        return x

    assert [norm(x) for x in tobs] == [norm(x) for x in jobs]
    assert tstats == jstats
    # the files cross: each package loads the other's file to equal plans
    for reader, writer, other in ((tst, "jax", jst), (jst, "torch", tst)):
        a = reader.PlanStore(str(tmp_path / writer))
        b = other.PlanStore(str(tmp_path / writer))
        assert ({json.dumps(k.to_json()): r.to_json() for k, r in a._plans.items()}
                == {json.dumps(k.to_json()): r.to_json() for k, r in b._plans.items()})


def test_store_file_crosses_packages(tmp_path):
    """A store file the reference writes routes the port's lookups, and the
    reverse: the same schema tag and line layout."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jkey, tkey = _key(jst, 3, sr="min_plus"), _key(tst, 3, sr="min_plus")
    jst.PlanStore(jdir).put(jkey, jst.PlanRecord(tier="windowed", block_rows=64, merge="hash",
                                                  cost_s=0.1))
    tst.PlanStore(tdir).put(tkey, tst.PlanRecord(tier="mxu", cost_s=0.2, probe_dim=2048))
    got = tst.PlanStore(jdir).lookup(tkey)
    assert (got.tier, got.block_rows, got.merge, got.cost_s) == ("windowed", 64, "hash", 0.1)
    got = jst.PlanStore(tdir).lookup(jkey)
    assert (got.tier, got.cost_s, got.probe_dim) == ("mxu", 0.2, 2048)
    assert open(os.path.join(tdir, "plans.jsonl")).read().startswith(
        '{"v": "combblas_tpu.plans/v1", "key": {"op": "spgemm"')


def test_get_store_follows_env_and_reset(monkeypatch, tmp_path):
    """``get_store`` caches one instance per resolved dir, follows a changed
    ``COMBBLAS_PLAN_STORE``, is ``None`` when disabled, and
    ``_reset_for_tests`` reloads from disk — as the reference's."""
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, str(tmp_path / "a"))
    st = tst.get_store()
    assert st is tst.get_store() and st.path == str(tmp_path / "a")
    tst.PlanStore(str(tmp_path / "a")).put(_key(tst), tst.PlanRecord(tier="esc"))
    assert tst.get_store().entries() == 0  # cached instance
    tst._reset_for_tests()
    assert tst.get_store().entries() == 1
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, str(tmp_path / "b"))
    assert tst.get_store().path == str(tmp_path / "b")
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, "off")
    assert tst.get_store() is None and jst.get_store() is None


# --- concurrent appends -----------------------------------------------------

_WRITER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[5])
    from combblas_tpu_torch.tuner import store
    path, worker, count = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    st = store.PlanStore(path)
    for k in range(count):
        key = store.PlanKey(op="spgemm", shape=(worker, k, 0), band=(0, 0),
                            sr=sys.argv[4], backend="cpu", grid="1x1")
        st.put(key, store.PlanRecord(tier="esc", cost_s=0.5, ts=1000.0 + worker))
""")


def test_concurrent_appends_only_whole_lines(tmp_path):
    """Two processes appending through the port's ``PlanStore.put`` to one
    file: every line parses whole in both packages (no invalid line), and
    every (worker, k) key is there — the twin of the reference's
    ``test_plan_store_concurrent_appends_only_whole_lines``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "plans")
    env = {**os.environ, "COMBBLAS_PLAN_STORE_MAX": "0"}
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, path, str(w), "300",
                               "plusmul", repo], env=env) for w in range(2)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    for m in (tst, jst):
        s = m.PlanStore(path).stats()
        assert s["invalid_lines"] == 0
        assert s["entries"] + s["evicted"] == 600
    key = tst.PlanKey(op="spgemm", shape=(9, 9, 9), band=(0, 0), sr="plusmul",
                      backend="cpu", grid="1x1")
    tst.PlanStore(path).put(key, tst.PlanRecord(tier="esc", cost_s=0.1))
    assert jst.PlanStore(path).lookup(jst.PlanKey(**{**key.to_json(), "shape": (9, 9, 9),
                                                     "band": (0, 0)})) is not None


def test_compaction_skipped_under_contention(monkeypatch, tmp_path):
    """A sibling holding the sidecar lock makes the load's compaction a
    skip (the file untouched); once released the next load compacts."""
    import fcntl

    monkeypatch.setenv(tcfg.ENV_STORE_COMPACT, "5")
    d = str(tmp_path / "store")
    os.makedirs(d)
    f = os.path.join(d, "plans.jsonl")
    with open(f, "w") as fh:
        for i in range(31):
            fh.write(_line(tst, _key(tst), {"tier": "esc", "cost_s": float(i),
                                             "ts": float(i)}) + "\n")
    lf = os.open(f + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(lf, fcntl.LOCK_EX)
        assert tst.PlanStore(d).stats()["compacted_lines"] == 0
        assert sum(1 for _ in open(f)) == 31
    finally:
        fcntl.flock(lf, fcntl.LOCK_UN)
        os.close(lf)
    assert tst.PlanStore(d).stats()["compacted_lines"] == 30
    assert sum(1 for _ in open(f)) == 1


# --- compile_cache ----------------------------------------------------------


@pytest.fixture
def clean_cache():
    # enable_compile_cache registers the port's compile-cache provider in
    # combblas_tpu_torch.obs._providers; the list is restored at the end,
    # so no later test on this worker snapshots the provider's gauges
    prior_t, prior_j = tcc._configured_dir, jcc._configured_dir
    prior_providers = list(tobs._providers)
    tcc._reset_for_tests()
    yield
    tcc._configured_dir, jcc._configured_dir = prior_t, prior_j
    tobs._providers[:] = prior_providers


def test_compile_cache_idempotence_contract(clean_cache, monkeypatch, tmp_path):
    """The reference's contract: the first enable wins; no argument or the
    same resolved dir is a no-op; another explicit dir raises the
    reference's message. ``_build`` builds into the committed dir and the
    plan store defaults to its sibling ``.plan_store``."""
    assert tcc.configured_dir() is None
    assert _build.build_dir() == _build.BUILD_DIR
    assert tcc.plan_store_dir() == os.path.join(os.path.dirname(tcc.CACHE_DIR), ".plan_store")
    monkeypatch.chdir(tmp_path)
    tcc.enable_compile_cache("c1")
    assert tcc.configured_dir() == str(tmp_path / "c1")
    tcc.enable_compile_cache()
    tcc.enable_compile_cache(str(tmp_path / "c1"))
    assert tcc.configured_dir() == str(tmp_path / "c1")
    with pytest.raises(ValueError, match="compile cache already enabled at") as got:
        tcc.enable_compile_cache(str(tmp_path / "c2"))
    assert "cannot retarget to" in str(got.value)
    assert tcc.configured_dir() == str(tmp_path / "c1")
    assert _build.build_dir() == tmp_path / "c1"
    assert _build.library_path("semiring_mm").parent == tmp_path / "c1"
    assert _build.host_library_path("mmparse").parent == tmp_path / "c1"
    monkeypatch.delenv(tcfg.ENV_PLAN_STORE)
    assert tcfg.store_dir() == str(tmp_path / ".plan_store")
    tst._reset_for_tests()
    assert tst.get_store().path == str(tmp_path / ".plan_store")
    tcc._reset_for_tests()
    assert tcc.configured_dir() is None and _build.build_dir() == _build.BUILD_DIR
