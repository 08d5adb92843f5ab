"""Parity of the port's ``FleetRouter`` (``serve/fleet.py`` over
``serve/policy.py``), ``Server.quarantine`` and the version checkpoints it
boots from with ``combblas_tpu.serve``'s on the CPU.

Mirrors the tier-1 cases of ``tests/test_serve_fleet.py`` on its grid
(2x4) and graphs (``_coo(seed)``: 300 random pairs on 64 vertices, both
orientations): the ``save_version`` / ``load_version`` round trip
(bit-identical buckets, zero plan builds after the swap), its guards,
least-loaded routing with spillover, the home write fanned out to every
replica, and a warm replica booted from the shared plan store building no
plan. Its threaded soak stays ``slow``. Three cases are added: ``quarantine``
fails the same futures in both packages and counts
``serve.fleet.quarantined``; and the write trace of a fleet write carries
the ``fanout`` stage between ``swap`` and ``settle``, telescoping to its
wall time; and the fleet's scrape surface.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.tuner import store as jstore
from combblas_tpu_torch import SpParMat
from combblas_tpu_torch.tuner import store as tstore
from torch_serve_parity import NAMES, PKG, grid, isolated, outcome, same_outcomes  # noqa: F401

N = 64
SHAPE = (2, 4)
STORES = {"jax": jstore, "torch": tstore}
SPMAT = {"jax": JaxSpParMat, "torch": SpParMat}


def _coo(seed, n=N, m=300):
    r = np.random.default_rng(seed)
    rows = r.integers(0, n, m)
    cols = r.integers(0, n, m)
    return np.concatenate([rows, cols]), np.concatenate([cols, rows])


def _absent(rows, cols):
    present = set(zip(rows.tolist(), cols.tolist()))
    return next((i, j) for i in range(N) for j in range(N)
                if i != j and (i, j) not in present and (j, i) not in present)


def _edges(version):
    return tuple(np.asarray(x) for x in version.E.to_host_coo())


def _same_edges(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# --- checkpoint round-trip ---------------------------------------------------


def test_checkpoint_roundtrip_bit_identical_and_zero_retrace(tmp_path):
    """``load_version`` -> ``swap`` -> the warmed kinds build no plan;
    every bucket array (headroom padding included) equal to the saved
    version's, and the port's equal to the reference's."""
    rows, cols = _coo(3)
    got = {}
    for name in NAMES:
        P, g = PKG[name], grid(name, SHAPE)
        eng = P.GraphEngine.from_coo(g, rows, cols, N, kinds=("bfs", "pagerank"),
                                     keep_coo=True, headroom=0.5)
        eng.warmup(widths=(1, 4))
        path = os.path.join(tmp_path, f"v-{name}.npz")
        P.checkpoint.save_version(path, eng.version)
        v2 = P.checkpoint.load_version(path, g)
        assert v2.headroom == eng.version.headroom == 0.5
        for nm in ("E", "P_ell"):
            M1, M2 = getattr(eng.version, nm), getattr(v2, nm)
            assert len(M1.buckets) == len(M2.buckets)
            for b1, b2 in zip(M1.buckets, M2.buckets):
                for a1, a2 in zip(b1, b2):
                    assert a1.shape == a2.shape and a1.dtype == a2.dtype
                    assert np.array_equal(np.asarray(a1), np.asarray(a2))
        assert np.array_equal(np.asarray(eng.version.dangling.blocks),
                              np.asarray(v2.dangling.blocks))
        assert v2.host_coo is not None
        mark = eng.trace_mark()
        eng.swap(v2)
        r1 = eng.execute("bfs", np.asarray([3], np.int32))
        pr = eng.execute("pagerank", np.asarray([3, 4, 5, 6], np.int32))
        assert eng.retraces_since(mark) == 0
        eng3 = P.GraphEngine(g, version=P.checkpoint.load_version(path, g),
                             kinds=("bfs", "pagerank"))
        r3 = eng3.execute("bfs", np.asarray([3], np.int32))
        assert np.array_equal(r1["levels"], r3["levels"])
        got[name] = (r1, pr, [[np.asarray(a) for a in b] for b in v2.E.buckets])
    for key in ("parents", "levels"):
        assert np.array_equal(got["jax"][0][key], got["torch"][0][key])
    np.testing.assert_allclose(got["torch"][1]["ranks"], got["jax"][1]["ranks"], rtol=1e-5,
                               atol=1e-6 * float(np.abs(got["jax"][1]["ranks"]).max()))
    for bj, bt in zip(got["jax"][2], got["torch"][2]):
        for x, y in zip(bj, bt):
            assert np.array_equal(x, y)


def test_checkpoint_guards(tmp_path):
    rows, cols = _coo(4)
    for name in NAMES:
        P, g = PKG[name], grid(name, SHAPE)
        eng = P.GraphEngine.from_coo(g, rows, cols, N, kinds=("bfs",))
        path = os.path.join(tmp_path, f"v-{name}.npz")
        P.checkpoint.save_version(path, eng.version)
        with pytest.raises(ValueError, match="SAME grid shape"):
            P.checkpoint.load_version(path, grid(name, (1, 1)))
        other = os.path.join(tmp_path, f"other-{name}.npz")
        r = np.arange(8) % 4
        P.checkpoint.save(other, SPMAT[name].from_global_coo(g, r, r, np.ones(8, np.float32),
                                                             8, 8))
        with pytest.raises(ValueError, match="GraphVersion"):
            P.checkpoint.load_version(other, g)


# --- routing + spillover -----------------------------------------------------


def test_fleet_routes_least_loaded_and_spills():
    """Queries spread over two worker-less replicas; a full replica spills
    to the next, a fleet-wide full raises, ``submit_many`` fails each
    rejected root's own future; the same counts in both packages."""
    rows, cols = _coo(5)
    got = {}
    for name in NAMES:
        P = PKG[name]
        cfg = P.ServeConfig(lane_widths=(1, 2), max_queue=2, max_wait_s=30.0)
        fr = P.FleetRouter.build(grid(name, SHAPE), rows, cols, N, replicas=2, config=cfg,
                                 kinds=("bfs",), start=False)
        futs = [fr.submit("bfs", 1) for _ in range(4)]
        assert all(s.scheduler.depth() == 2 for s in fr.replicas)
        with pytest.raises(P.BackpressureError):
            fr.submit("bfs", 1)
        assert fr.spillovers >= 1 and sum(fr.submitted) == 4
        many = fr.submit_many("bfs", [1, 2])
        assert all(isinstance(f.exception(timeout=0), P.BackpressureError) for f in many)
        for s in fr.replicas:
            s.pump(force=True)
        got[name] = (fr.spillovers, list(fr.submitted), [outcome(f) for f in futs])
    assert got["jax"][:2] == got["torch"][:2]
    same_outcomes(got["jax"][2], got["torch"][2])


def test_fleet_write_home_and_fanout():
    """A write routes home; its merge fans out through the atomic swap,
    and the new edge is one hop on every replica; the same lanes in both
    packages."""
    rows, cols = _coo(6)
    a, b = _absent(rows, cols)
    got = {}
    for name in NAMES:
        P = PKG[name]
        cfg = P.ServeConfig(lane_widths=(1, 2), update_flush=1, update_max_delay_s=0.005)
        with P.FleetRouter.build(grid(name, SHAPE), rows, cols, N, replicas=2, config=cfg,
                                 kinds=("bfs",)) as fr:
            fr.warmup(widths=(1, 2))
            vids = [s.engine.version_id for s in fr.replicas]
            res = fr.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=120)
            assert res["fanned_out"] == 1 and res["lagging"] == []
            for s, v0 in zip(fr.replicas, vids):
                assert s.engine.version_id == v0 + 1
            lanes = []
            for s in fr.replicas:
                lev = s.submit("bfs", a).result(timeout=120)
                assert lev["levels"][b] == 1
                lanes.append(lev)
            edges = [_edges(s.engine.version) for s in fr.replicas]
        assert fr.fanouts == 1
        _same_edges(edges[0], edges[1])
        got[name] = (lanes, edges[0], res["mode"])
    for lj, lt in zip(got["jax"][0], got["torch"][0]):
        for key in ("parents", "levels"):
            assert np.array_equal(lj[key], lt[key])
    _same_edges(got["jax"][1], got["torch"][1])
    assert got["jax"][2] == got["torch"][2]


# --- shared warm plan store --------------------------------------------------


def test_fleet_cold_vs_warm_replica_ab(tmp_path, monkeypatch):
    """A donor's traffic records its lane in the shared plan store; a cold
    replica serving that lane builds a plan, a warm-started one (fresh
    store load + ``warmup()``) builds none after its warm-up."""
    rows, cols = _coo(7)
    for name in NAMES:
        P, store = PKG[name], STORES[name]
        monkeypatch.setenv("COMBBLAS_PLAN_STORE", str(tmp_path / f"store-{name}"))
        store._reset_for_tests()

        def build(P=P, name=name):
            return P.GraphEngine.from_coo(grid(name, SHAPE), rows, cols, N, kinds=("bfs",))

        build().plan("bfs", 4)  # the traffic mix's lane, recorded
        cold = build()
        mark = cold.trace_mark()
        cold.execute("bfs", np.full(4, -1, np.int32))
        assert cold.retraces_since(mark) > 0
        store._reset_for_tests()
        warm = build()
        assert ("bfs", 4) in warm.warmup()
        mark = warm.trace_mark()
        warm.execute("bfs", np.full(4, -1, np.int32))
        assert warm.retraces_since(mark) == 0


# --- the Server hooks the fleet calls ----------------------------------------


def test_quarantine_fails_pending_reads_and_writes():
    """``Server.quarantine`` refuses admissions, fails every pending read
    and buffered write with the given error, stops the write lane
    without merging, and counts ``serve.fleet.quarantined``; the same
    count of failed futures in both packages."""
    rows, cols = _coo(8)
    got = {}
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        try:
            eng = P.GraphEngine.from_coo(grid(name, (1, 1)), rows, cols, N, kinds=("bfs",),
                                         keep_coo=True)
            srv = P.Server(eng, P.ServeConfig(lane_widths=(1, 2), update_autostart=False,
                                              update_flush=64, update_max_delay_s=30.0,
                                              max_wait_s=30.0))
            reads = srv.submit_many("bfs", [1, 2, 3])
            write = srv.submit_update([("insert", 1, 2), ("insert", 2, 1)])
            vid = eng.version_id
            n = srv.quarantine(P.ReplicaDeadError("replica 0 died"))
            assert all(isinstance(f.exception(timeout=0), P.ReplicaDeadError) for f in reads)
            assert isinstance(write.exception(timeout=5), P.ReplicaDeadError)
            assert eng.version_id == vid  # nothing merged
            assert not srv.is_serving() and srv.health()["status"] == "closed"
            with pytest.raises(RuntimeError):
                srv.submit("bfs", 1)
            got[name] = (n, P.obs.registry.get_counter("serve.fleet.quarantined"))
        finally:
            P.obs.disable()
            P.obs.reset()
    assert got["jax"] == got["torch"] == (4, 1)


def test_fleet_write_trace_carries_the_fanout_stage():
    """With every request traced, a fleet write's ``serve.update`` record
    runs buffer_wait -> merge -> swap -> fanout -> settle (the fan-out's
    mark lands inside the committed record) and its stages sum to its
    wall time; the same shape in both packages."""
    rows, cols = _coo(9)
    a, b = _absent(rows, cols)
    got = {}
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        P.trace.set_sample_rate(1.0)
        try:
            cfg = P.ServeConfig(lane_widths=(1, 2), update_autostart=False, update_flush=1,
                                flight_recorder=False)
            fr = P.FleetRouter.build(grid(name, (1, 1)), rows, cols, N, replicas=2,
                                     config=cfg, kinds=("bfs",), start=False)
            fut = fr.submit_update([("insert", a, b), ("insert", b, a)])
            fr.replicas[fr.home].pump_updates(force=True)
            assert fut.result(timeout=10)["fanned_out"] == 1
            recs = [r for r in P.obs.trace_records() if r["name"] == "serve.update"]
            assert len(recs) == 1
            rec = recs[0]
            stages = [st["stage"] for st in rec["stages"]]
            assert stages == ["buffer_wait", "merge", "swap", "fanout", "settle"]
            assert abs(sum(st["s"] for st in rec["stages"]) - rec["wall_s"]) < 1e-6
            got[name] = (stages, rec.get("status"), rec["labels"]["mode"],
                         P.obs.registry.get_counter("serve.fleet.fanout"))
            fr.close(drain=False)
        finally:
            P.trace.set_sample_rate(None)
            P.obs.disable()
            P.obs.reset()
    assert got["jax"] == got["torch"]


def test_fleet_scrape_endpoint():
    """``FleetRouter.serve_metrics`` serves the fleet's ``/healthz`` and
    ``/statz`` (the same status and routing in both packages) and
    ``close`` detaches it."""
    rows, cols = _coo(10)
    got = {}
    for name in NAMES:
        P = PKG[name]
        fr = P.FleetRouter.build(grid(name, (1, 1)), rows, cols, N, replicas=2,
                                 config=P.ServeConfig(lane_widths=(1, 2)), kinds=("bfs",),
                                 start=False)
        futs = [fr.submit("bfs", r) for r in (1, 2, 3)]
        for s in fr.replicas:
            s.pump(force=True)
        assert all(f.exception(timeout=0) is None for f in futs)
        port = fr.serve_metrics()
        base = f"http://127.0.0.1:{port}"
        hz = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read())
        sz = json.loads(urllib.request.urlopen(f"{base}/statz", timeout=10).read())
        fr.close(drain=False)
        assert fr._scrape is None
        got[name] = (hz["status"], hz["home"], sz["routed"], sz["replicas"])
    assert got["jax"] == got["torch"]
    assert got["torch"][0] == "ok" and sum(got["torch"][2]) == 3


# --- threaded soak -----------------------------------------------------------


@pytest.mark.slow
def test_fleet_threaded_reads_under_writes():
    """Reads spread over both replicas while writes stream home and fan
    out: every read settles, every write lands fleet-wide, in both
    packages."""
    rows, cols = _coo(8)
    for name in NAMES:
        P = PKG[name]
        cfg = P.ServeConfig(lane_widths=(1, 2, 4), max_queue=256, max_wait_s=0.005,
                            update_flush=2, update_max_delay_s=0.01)
        with P.FleetRouter.build(grid(name, SHAPE), rows, cols, N, replicas=2, config=cfg,
                                 kinds=("bfs",)) as fr:
            fr.warmup(widths=(1, 2, 4))
            write_futs = []

            def writer(fr=fr, write_futs=write_futs):
                for k in range(6):
                    x, y = 1 + k, 40 + k
                    write_futs.append(fr.submit_update([("insert", x, y), ("insert", y, x)]))

            wt = threading.Thread(target=writer)
            wt.start()
            read_futs = []
            for i in range(60):
                try:
                    read_futs.append(fr.submit("bfs", i % N))
                except P.BackpressureError:
                    pass
            wt.join(60)
            assert read_futs
            for f in read_futs:
                assert f.result(timeout=120) is not None
            for f in write_futs:
                assert f.result(timeout=120)["fanned_out"] == 1
        st = fr.stats()
        assert st["fanouts"] == len(write_futs)
        assert sum(st["routed"]) == len(read_futs)
