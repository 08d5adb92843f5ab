"""Parity of the port's serving observability (request and write-lane
traces, the flight recorder, the SLO budget in ``Server``, freshness
gauges, the live scrape) with ``combblas_tpu``'s on the CPU.

Mirrors ``tests/test_obs_serve.py``'s serving cases: deterministic
sampling and its environment knob, the stage marks of a pumped request
telescoping to its end-to-end latency, the write lane's stages, the
JSONL round trip, zero cost with telemetry off, the flight recorder's
ring and its dump on an injected fault, the SLO accounting in
``stats()`` / ``health()``, the freshness gauges after a merged write,
and the ``/metrics`` / ``/healthz`` / ``/statz`` scrape; and
``tests/test_obs.py``'s gates of the pool, fleet and durability series
(emitted with telemetry on, nothing recorded with it off). Each scenario
runs through both packages' ``Server`` on the same graph (48 vertices,
numpy seed 3, 1x1): the ``serve.*`` and ``dynamic.*`` series (names,
kinds, labels; counter and gauge values, histogram counts) equal the
reference's, and so do the trace
records' names, labels and stage sequences (durations are clock
readings and are left out).
"""

import json
import os
import urllib.request

import numpy as np
import pytest

from torch_obs_parity import series as all_series
from torch_serve_parity import NAMES, PKG, coo_pairs, grid, isolated  # noqa: F401

N = 48


@pytest.fixture(scope="module")
def engines():
    rows, cols = coo_pairs(3, N, 220)
    return {name: PKG[name].GraphEngine.from_coo(grid(name), rows, cols, N, kinds=("bfs",),
                                                 keep_coo=True)
            for name in NAMES}


def series(o):
    """The ``serve.*`` and ``dynamic.*`` series (the plan store's gauges
    are the tuner's, compared in its own files)."""
    return {k: v for k, v in all_series(o).items() if k[1].startswith(("serve.", "dynamic."))}


def _cfg(name, tmp_path, **kw):
    kw.setdefault("lane_widths", (1, 2))
    kw.setdefault("update_autostart", False)
    kw.setdefault("flight_recorder_dir", str(tmp_path / name))
    return PKG[name].ServeConfig(**kw)


def _pumped(srv):
    while srv.pump(force=True):
        pass


def _trace_shape(rec):
    """A trace record without its clock readings."""
    labels = dict(rec["labels"])
    labels.pop("version", None)  # engines in a module advance apart
    return (rec["name"], labels, [st["stage"] for st in rec["stages"]], rec.get("status"))


# --- deterministic sampling -------------------------------------------------


def test_sampling_deterministic_and_proportional():
    ids = list(range(1000)) + [f"upd-{i}" for i in range(200)]
    for rate in (0.0, 0.3, 0.6, 1.0):
        got = {i for i in ids if PKG["torch"].trace.sampled(i, rate)}
        assert got == {i for i in ids if PKG["jax"].trace.sampled(i, rate)}
    a = {i for i in ids if PKG["torch"].trace.sampled(i, 0.3)}
    assert 0.2 < len(a) / len(ids) < 0.4
    assert a <= {i for i in ids if PKG["torch"].trace.sampled(i, 0.6)}


def test_sample_rate_env_resolution(monkeypatch):
    monkeypatch.setenv("COMBBLAS_OBS_TRACE_SAMPLE", "0.25")
    for name in NAMES:
        PKG[name].trace.set_sample_rate(None)
        assert PKG[name].trace.sample_rate() == 0.25


# --- the pump stage-sum contract --------------------------------------------


def test_pump_trace_stages_sum_to_e2e(engines, tmp_path):
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        P.trace.set_sample_rate(1.0)
        srv = eng.serve(_cfg(name, tmp_path))
        srv.warmup(widths=(1, 2))
        futs = [srv.submit("bfs", i) for i in (1, 2, 3)]
        _pumped(srv)
        for f in futs:
            assert f.exception(timeout=0) is None
        srv.close()
        recs = [r for r in P.obs.trace_records() if r["name"] == "serve.request"]
        assert len(recs) == 3
        for rec in recs:
            P.obs.validate_record({"v": 1, "kind": "trace", **rec})
            stages = [st["stage"] for st in rec["stages"]]
            assert stages[:3] == ["queue_wait", "assemble", "execute"]
            assert stages[-1] == "scatter"
            # the stage durations telescope to the end-to-end latency
            assert abs(sum(st["s"] for st in rec["stages"]) - rec["wall_s"]) < 1e-6, rec
            assert rec["labels"]["status"] == "ok" and rec["labels"]["kind"] == "bfs"
            assert rec["labels"]["plan"] in ("warm", "cold")
            assert rec["labels"]["width"] in (1, 2)
            assert rec["labels"]["version"] == eng.version_id
        got[name] = ([_trace_shape(r) for r in recs], series(P.obs))
        P.obs.disable()
    assert got["torch"] == got["jax"]


def test_write_lane_trace_stages(engines, tmp_path):
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        P.trace.set_sample_rate(1.0)
        srv = eng.serve(_cfg(name, tmp_path))
        fut = srv.submit_update([("insert", 0, 9), ("insert", 9, 0)])
        srv.pump_updates(force=True)
        assert fut.result(timeout=10)["ops"] == 2
        srv.close()
        recs = [r for r in P.obs.trace_records() if r["name"] == "serve.update"]
        assert len(recs) == 1
        rec = recs[0]
        P.obs.validate_record({"v": 1, "kind": "trace", **rec})
        assert [st["stage"] for st in rec["stages"]] == ["buffer_wait", "merge", "swap", "settle"]
        assert abs(sum(st["s"] for st in rec["stages"]) - rec["wall_s"]) < 1e-6
        assert rec["labels"]["mode"] in ("incremental", "rebuild")
        got[name] = (_trace_shape(rec), series(P.obs))
        P.obs.disable()
    assert got["torch"] == got["jax"]


def test_trace_jsonl_roundtrip(engines, tmp_path):
    """Each package's JSONL parses in both packages, with the same trace
    records but for clock readings."""
    paths = {}
    for name, eng in engines.items():
        P = PKG[name]
        paths[name] = str(tmp_path / f"trace-{name}.jsonl")
        P.obs.enable(jsonl_path=paths[name], install_hooks=False)
        P.trace.set_sample_rate(1.0)
        srv = eng.serve(_cfg(name, tmp_path))
        srv.submit("bfs", 1)
        _pumped(srv)
        srv.close()
        P.obs.dump_jsonl()
        assert P.obs.registry.get_counter("serve.trace.sampled", lane="request") >= 1
        P.obs.disable()
    shapes = {}
    for writer in NAMES:
        for reader in NAMES:
            recs = PKG[reader].obs.parse_jsonl(paths[writer])  # validates every line
            traces = [r for r in recs if r["kind"] == "trace"]
            assert traces and traces[0]["name"] == "serve.request"
            assert len(PKG[reader].obs.aggregate(recs)["traces"]) == len(traces)
            shapes[writer, reader] = [_trace_shape(r) for r in traces]
    assert len({json.dumps(v, sort_keys=True, default=str) for v in shapes.values()}) == 1


# --- zero-cost-when-disabled gates ------------------------------------------


def test_zero_cost_when_disabled(engines, tmp_path):
    for name, eng in engines.items():
        P = PKG[name]
        assert not P.obs.ENABLED
        srv = eng.serve(_cfg(name, tmp_path, flight_recorder=False))
        assert srv._recorder is None and srv.slo is None
        f = srv.submit("bfs", 1)
        _pumped(srv)
        assert f.exception(timeout=0) is None
        srv.close()
        assert P.obs.registry.empty()
        assert P.obs.trace_records() == []
        P.obs.enable(install_hooks=False)
        P.trace.set_sample_rate(0.0)
        srv = eng.serve(_cfg(name, tmp_path, flight_recorder=False))
        f = srv.submit("bfs", 2)
        _pumped(srv)
        assert f.exception(timeout=0) is None
        srv.close()
        assert P.obs.trace_records() == []
        P.obs.disable()


# --- flight recorder --------------------------------------------------------


def test_flight_recorder_ring_and_dump(tmp_path):
    got = {}
    for name in NAMES:
        P = PKG[name]
        rec = P.FlightRecorder(capacity=3, out_dir=str(tmp_path / name), min_interval_s=0.0)
        for i in range(5):
            rec.record("ev", i=i, query="bfs")
        assert [e["i"] for e in rec.snapshot()] == [2, 3, 4]
        path = rec.dump("manual", query="bfs")
        recs = P.obs.parse_jsonl(path)
        assert recs[0]["schema"] == P.obs.FLIGHTREC_SCHEMA and recs[0]["reason"] == "manual"
        assert [r["i"] for r in recs[1:]] == [2, 3, 4]
        rec.min_interval_s = 60.0
        assert rec.dump("manual") is None and rec.dumps == 1
        drop = ("t_s", "ts", "wall", "path", "pid", "host")
        got[name] = [{k: v for k, v in r.items() if k not in drop} for r in recs]
    assert got["torch"] == got["jax"]


def test_injected_fault_dumps_poisoned_batch(engines, tmp_path):
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        srv = eng.serve(_cfg(name, tmp_path))
        srv.warmup(widths=(1, 2))
        srv.faults.rate("engine.execute", 1.0, seed=5)
        f = srv.submit("bfs", 1)
        _pumped(srv)
        assert f.exception(timeout=0) is not None
        dump = srv._recorder.last_dump
        assert dump is not None and os.path.dirname(dump) == str(tmp_path / name)
        recs = P.obs.parse_jsonl(dump)
        assert recs[0]["reason"] == "poisoned" and recs[0]["query"] == "bfs"
        evs = [r for r in recs if r["kind"] == "event" and r["name"] == "serve.batch"]
        assert evs and any(e.get("outcome") == "error" for e in evs)
        assert P.obs.registry.get_counter("serve.flightrec.dumps", reason="poisoned") == 1
        assert srv.stats()["flightrec"]["dumps"] == 1
        assert srv.health()["flightrec_last_dump"] == dump
        srv.faults.clear()
        srv.close()
        got[name] = ([(e.get("outcome"), e.get("requests"), e.get("toplevel")) for e in evs],
                     series(P.obs))
        P.obs.disable()
    assert got["torch"] == got["jax"]


# --- SLO accounting ---------------------------------------------------------


def test_server_slo_accounting_and_health(engines, tmp_path):
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        srv = eng.serve(_cfg(name, tmp_path, slo_deadline_s=30.0, slo_target=0.5,
                             slo_window_s=60.0))
        srv.warmup(widths=(1, 2))
        ok = [srv.submit("bfs", i) for i in (1, 2)]
        _pumped(srv)
        for f in ok:
            assert f.exception(timeout=0) is None
        st = srv.stats()["slo"]
        assert st["window_good"] == 2 and st["window_bad"] == 0
        assert P.obs.registry.get_counter("serve.slo.good", kind="bfs") == 2
        srv.faults.rate("engine.execute", 1.0, seed=5)
        bad = srv.submit("bfs", 3)
        _pumped(srv)
        assert bad.exception(timeout=0) is not None
        srv.faults.clear()
        st = srv.stats()["slo"]
        assert st["window_bad"] == 1
        assert P.obs.registry.get_counter("serve.slo.bad", kind="bfs") == 1
        assert P.obs.registry.get_gauge("serve.slo.budget_burn") is not None
        h = srv.health()
        assert h["slo"]["window_bad"] == 1
        got[name] = (h["slo"], h["status"], series(P.obs))
        srv.close()
        P.obs.disable()
    assert got["torch"] == got["jax"]


# --- freshness gauges -------------------------------------------------------


def test_freshness_gauges_on_refresh(tmp_path):
    got = {}
    rows, cols = coo_pairs(9, 32, 140)
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        eng = P.GraphEngine.from_coo(grid(name), rows, cols, 32, kinds=("bfs",), keep_coo=True)
        srv = eng.serve(_cfg(name, tmp_path))
        root = int(rows[0])
        eng.refresh("bfs", root=root)
        fut = srv.submit_update([("insert", 0, 31), ("insert", 31, 0)])
        srv.pump_updates(force=True)
        assert fut.exception(timeout=10) is None
        out = eng.refresh("bfs", root=root)
        assert out["mode"] == "warm"
        assert P.obs.registry.get_gauge("dynamic.freshness.versions_behind", kind="bfs") == 1
        assert P.obs.registry.get_gauge("dynamic.freshness.repair_ratio") == 0.5
        fresh = eng.stats()["freshness"]
        assert fresh["refresh_modes"] == {"cold": 1, "warm": 1}
        assert fresh["repair_ratio"] == 0.5 and fresh["versions_behind"] == 0
        srv.close()
        got[name] = (fresh, out["result"], series(P.obs))
        P.obs.disable()
    assert got["torch"][0] == got["jax"][0]
    assert np.array_equal(got["torch"][1], got["jax"][1])
    # the port's refresh loop series are its own (host loops): compare the
    # serve.* and freshness series
    keep = ("serve.", "dynamic.freshness.")
    assert {k: v for k, v in got["torch"][2].items() if k[1].startswith(keep)} == \
        {k: v for k, v in got["jax"][2].items() if k[1].startswith(keep)}


# --- the live scrape --------------------------------------------------------


def test_scrape_endpoint_live(engines, tmp_path):
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        srv = eng.serve(_cfg(name, tmp_path))
        f = srv.submit("bfs", 1)
        _pumped(srv)
        assert f.exception(timeout=0) is None
        port = srv.serve_metrics()
        assert port == srv.serve_metrics()  # idempotent
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert P.export.parse_exposition(text) == P.export.parse_exposition(P.export.render())
        assert "combblas_serve_requests" in text
        hz = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read())
        assert hz["status"] in ("ok", "degraded")
        sz = json.loads(urllib.request.urlopen(f"{base}/statz", timeout=10).read())
        assert sz["completed"] >= 1
        assert P.obs.registry.get_counter("obs.scrape.requests", path="/metrics") >= 1
        srv.close()
        assert srv._scrape is None
        got[name] = sorted(k for k in P.export.parse_exposition(text)
                           if k[0].startswith("combblas_serve_"))
        P.obs.disable()
    assert got["torch"] == got["jax"]


# --- the pool and fleet series, gated (tests/test_obs.py) -------------------


def _gated_series(P):
    """Series names, kinds and labels with their values, byte gauges
    aside (the packages' ``device_bytes`` differ by layout)."""
    return {k: (None if k[1].endswith("_bytes") else v) for k, v in series(P.obs).items()}


def test_pool_fleet_counters_gated(tmp_path):
    """``test_round14_pool_fleet_counters_gated``: the pool's residency
    series, the WFQ series, the fleet's routing series and the version
    checkpoint histograms are emitted with telemetry on and cost nothing
    with it off; the same series in both packages."""
    rng = np.random.default_rng(0)
    n = 32
    r, c = rng.integers(0, n, 120), rng.integers(0, n, 120)
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    got = {}
    for name in NAMES:
        P = PKG[name]
        g = grid(name)
        cfg = P.ServeConfig(lane_widths=(1,), update_autostart=False)

        def exercise(tag, P=P, g=g, cfg=cfg, name=name):
            pool = P.EnginePool(g)
            pool.add_tenant("a", rows, cols, n, config=cfg, kinds=("bfs",))
            psrv = pool.serve()
            f = psrv.submit("a", "bfs", 1)
            _pumped(psrv)
            assert f.exception(timeout=0) is None
            assert pool.evict("a")
            pool.admit("a")  # re-admission: the rebuild path
            path = os.path.join(tmp_path, f"v-{name}-{tag}.npz")
            P.checkpoint.save_version(path, pool.engine("a").version)
            P.checkpoint.load_version(path, g)
            fr = P.FleetRouter([pool.server("a")])
            fr.submit("bfs", 2)
            pool.server("a").scheduler.fail_pending(RuntimeError("gate teardown"))

        assert not P.obs.ENABLED
        exercise("off")
        assert P.obs.registry.empty()
        P.obs.enable(install_hooks=False)
        try:
            P.obs.reset()
            exercise("on")
            reg, cnt = P.obs.registry, P.obs.registry.get_counter
            assert cnt("serve.pool.admits", tenant="a") == 2
            assert cnt("serve.pool.evictions", tenant="a") == 1
            assert reg.get_gauge("serve.pool.resident_bytes") > 0
            assert reg.get_gauge("serve.pool.resident_tenants") == 1
            assert reg.get_histogram("serve.pool.rebuild_s")["count"] == 2
            assert cnt("serve.wfq.rounds") >= 1 and cnt("serve.wfq.served", tenant="a") >= 1
            assert reg.get_gauge("serve.wfq.deficit", tenant="a") is not None
            assert cnt("serve.fleet.submitted", replica=0) == 1
            assert reg.get_gauge("serve.fleet.replicas") == 1
            assert reg.get_histogram("serve.checkpoint.save_s")["count"] == 1
            assert reg.get_histogram("serve.checkpoint.load_s")["count"] == 1
            assert reg.get_gauge("serve.queue.depth", tenant="a") is not None
            got[name] = _gated_series(P)
        finally:
            P.obs.disable()
            P.obs.reset()
    assert got["torch"] == got["jax"]


def test_durability_and_fleet_counters_gated(tmp_path):
    """``test_round16_durability_counters_gated``: the WAL, checkpoint
    and recovery series and the fleet's ``versions_behind`` gauge are
    emitted with telemetry on and cost nothing with it off; the same
    series in both packages."""
    rng = np.random.default_rng(1)
    n = 32
    r, c = rng.integers(0, n, 120), rng.integers(0, n, 120)
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    present = set(zip(rows.tolist(), cols.tolist()))
    (a, b), (a2, b2) = [(i, j) for i in range(n) for j in range(i + 1, n)
                        if (i, j) not in present and (j, i) not in present][:2]
    got = {}
    for name in NAMES:
        P = PKG[name]
        g = grid(name)

        def exercise(tag, P=P, g=g, name=name):
            d = os.path.join(tmp_path, f"wal-{name}-{tag}")
            cfg = P.ServeConfig(lane_widths=(1,), update_autostart=False, update_flush=1,
                                wal_dir=d, checkpoint_retain=1)
            eng = P.GraphEngine.from_coo(g, rows, cols, n, kinds=("bfs",), keep_coo=True)
            srv = P.Server(eng, cfg)  # bootstrap checkpoint
            f = srv.submit_update([("insert", a, b), ("insert", b, a)])
            srv.pump_updates(force=True)
            assert f.exception(timeout=0) is None
            srv.checkpoint_now()  # truncates the replayed WAL prefix
            wal = P.wal.open_wal(d)
            P.wal.recover_version(d, wal, g, kinds=("bfs",))
            wal.close()
            srv.scheduler.close()
            fr = P.FleetRouter.build(g, rows, cols, n, replicas=2, kinds=("bfs",),
                                     config=P.ServeConfig(lane_widths=(1,), update_flush=1,
                                                          update_max_delay_s=0.005),
                                     start=False)
            fr.replicas[0].submit_update([("insert", a2, b2), ("insert", b2, a2)])
            fr.replicas[0].pump_updates(force=True)
            fr.fan_out()
            fr.close(drain=False)

        assert not P.obs.ENABLED
        exercise("off")
        assert P.obs.registry.empty()
        P.obs.enable(install_hooks=False)
        try:
            P.obs.reset()
            exercise("on")
            reg, cnt = P.obs.registry, P.obs.registry.get_counter
            assert cnt("serve.wal.appends") == 1
            assert reg.get_histogram("serve.wal.append_s")["count"] == 1
            assert cnt("serve.wal.truncated") >= 1
            assert cnt("serve.checkpoint.auto", reason="bootstrap") == 1
            assert cnt("serve.checkpoint.auto", reason="manual") == 1
            assert cnt("serve.recovery.runs") == 1
            assert cnt("serve.recovery.replayed_ops") == 0
            assert reg.get_histogram("serve.recovery.recover_s")["count"] == 1
            assert reg.get_gauge("serve.fleet.versions_behind", replica=1) == 0
            assert cnt("serve.fleet.fanout") == 1
            got[name] = _gated_series(P)
        finally:
            P.obs.disable()
            P.obs.reset()
    assert got["torch"] == got["jax"]
