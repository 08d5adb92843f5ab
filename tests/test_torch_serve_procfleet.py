"""Parity of the port's ``ProcessFleet`` (``serve/procfleet.py`` over
``serve/_procworker.py`` children) with ``combblas_tpu.serve``'s on the
CPU: real subprocess replicas, each package's fleet on the same COO, the
same writes and the same scripted faults, the port's children on
``device="cpu"``.

Mirrors ``tests/test_serve_procfleet.py``'s spawning cases: one replica
end to end (reads over IPC, zero plan builds after warm-up asserted over
IPC, a WAL-durable write, heartbeats in ``health()``, a no-op
``supervise_once``, a write racing ``close``, recovery from the files)
and the observability plane over two replicas (one stitched trace across
the process boundary, federated ``/metrics``, the fleet log). The chaos
cases (SIGKILL respawn, SIGSTOP promotion, the scripted fault plan) are
``slow``, as in the reference. Also mirrored, over stub replicas:
``tests/test_obs.py``'s gated process-fleet counters and fleet-obs plane,
and ``tests/test_obs_serve.py``'s federation parity. BFS levels are held
bit for bit against the reference's; traces are compared by their stage
names (durations differ).
"""

import json
import os
import signal
import socket
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import combblas_tpu.serve.ipc as jipc
import combblas_tpu.serve.procfleet as jproc
import combblas_tpu_torch.serve.ipc as tipc
import combblas_tpu_torch.serve.procfleet as tproc
from combblas_tpu.obs.fleetlog import FleetLog as JaxFleetLog
from combblas_tpu_torch.obs.fleetlog import FleetLog as TorchFleetLog
from torch_serve_parity import NAMES, PKG, coo_pairs, grid, isolated  # noqa: F401

N = 64
PROC = {"jax": jproc, "torch": tproc}
IPC = {"jax": jipc, "torch": tipc}
FLEETLOG = {"jax": JaxFleetLog, "torch": TorchFleetLog}
DEVICE = {"jax": {}, "torch": {"device": "cpu"}}


def _absent_pairs(rows, cols, k, n=N):
    present = set(zip(rows.tolist(), cols.tolist()))
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            if (i, j) not in present and (j, i) not in present:
                out.append((i, j))
                if len(out) >= k:
                    return out
    return out


def _boot_ckpt(name, tmp_path, rows, cols, **kw):
    P = PKG[name]
    eng = P.GraphEngine.from_coo(grid(name), rows, cols, N, kinds=("bfs",), keep_coo=True, **kw)
    path = str(tmp_path / f"boot-{name}.npz")
    P.checkpoint.save_version(path, eng.version)
    return eng, path


def _levels(fut):
    return np.asarray(fut.result(timeout=60)["levels"])


# --- the tier-1 spawning representative --------------------------------------


def test_single_process_replica_end_to_end(tmp_path):
    """One subprocess replica on 1x1 booted from a pre-staged checkpoint:
    reads over IPC equal to the donor's, zero plan builds after warm-up
    over IPC, a WAL-durable write, heartbeat liveness in ``health()``, a
    no-op ``supervise_once``, a write racing ``close(drain=True)`` that
    still settles, and recovery from the files holding the write; the
    port's levels equal the reference's."""
    rows, cols = coo_pairs(41, N, 300)
    (a, b), (a2, b2) = _absent_pairs(rows, cols, 2)
    got = {}
    for name in NAMES:
        P = PKG[name]
        eng, ckpt = _boot_ckpt(name, tmp_path, rows, cols, headroom=0.5)
        wal_dir = str(tmp_path / f"wal-{name}")
        fr = PROC[name].ProcessFleet.from_checkpoint(
            ckpt, (1, 1), replicas=1, kinds=("bfs",),
            config=P.ServeConfig(lane_widths=(1, 2), update_flush=1, update_max_delay_s=0.005),
            wal_dir=wal_dir, workdir=str(tmp_path / f"proc-{name}"),
            hb_interval_s=0.05, hb_timeout_s=5.0, **DEVICE[name])
        try:
            marks = fr.trace_marks()
            lev3 = _levels(fr.submit("bfs", 3))
            ref = eng.execute("bfs", np.asarray([3], np.int32))["levels"]
            np.testing.assert_array_equal(lev3, np.asarray(ref)[:, 0])
            assert fr.retraces_since(marks) == 0
            res = fr.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=60)
            assert res["ops"] == 2 and res["lagging"] == []
            leva = _levels(fr.submit("bfs", a))
            assert leva[b] == 1
            h = fr.health()
            assert h["status"] == "ok" and h["durable"]
            assert h["replicas"][0]["heartbeat_age_s"] < 5.0
            assert h["replicas"][0]["pid"] == fr.replicas[0].proc.pid
            assert fr.supervise_once() == {"detected": [], "promoted": None, "replaced": []}
            late = fr.submit_update([("insert", a2, b2), ("insert", b2, a2)])
        finally:
            fr.close(drain=True)
        assert late.result(timeout=60)["ops"] == 2
        assert fr.replicas[0].proc.poll() is not None
        wal = P.wal.open_wal(wal_dir)
        v = P.wal.recover_version(wal_dir, wal, grid(name), kinds=("bfs",))
        wal.close()
        rr, rc, _ = v.E.to_host_coo()
        edges = set(zip(np.asarray(rr).tolist(), np.asarray(rc).tolist()))
        assert (a, b) in edges and (a2, b2) in edges
        got[name] = (lev3, leva, res["ops"], res["fanned_out"], sorted(edges))
        if name == "torch":  # the child ran on the device the parent named
            assert fr.replicas[0].boot["device"] == "cpu" and fr.replicas[0].boot["devices"] == 1
    for x, y in zip(got["jax"], got["torch"]):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


# --- the fleet observability plane -------------------------------------------


def test_fleet_observability_plane_end_to_end(tmp_path):
    """Over two subprocess replicas: one sampled request yields ONE
    stitched trace whose router + IPC + child stage marks telescope to
    the trace wall; heartbeat-piggybacked child snapshots federate into
    one ``/metrics`` scrape with ``replica=`` labels; the supervision
    timeline records both spawns. The same stage names in both
    packages."""
    rows, cols = coo_pairs(41, N, 300)
    got = {}
    for name in NAMES:
        P = PKG[name]
        obs, trace, export = P.obs, P.trace, P.export
        eng, ckpt = _boot_ckpt(name, tmp_path, rows, cols)
        obs.enable(install_hooks=False)
        trace.set_sample_rate(1.0)
        fr = None
        try:
            fr = PROC[name].ProcessFleet.from_checkpoint(
                ckpt, (1, 1), replicas=2, kinds=("bfs",),
                config=P.ServeConfig(lane_widths=(1, 2)),
                wal_dir=str(tmp_path / f"wal-{name}"), workdir=str(tmp_path / f"proc-{name}"),
                hb_interval_s=0.05, hb_timeout_s=5.0, metrics_interval_s=0.05,
                **DEVICE[name])
            t0 = time.perf_counter()
            lev = _levels(fr.submit("bfs", 3))
            e2e = time.perf_counter() - t0
            ref = eng.execute("bfs", np.asarray([3], np.int32))["levels"]
            np.testing.assert_array_equal(lev, np.asarray(ref)[:, 0])
            stitched = [r for r in trace.records() if r["labels"].get("fleet") == "process"]
            assert len(stitched) == 1
            (rec,) = stitched
            stages = [s["stage"] for s in rec["stages"]]
            assert stages[:2] == ["route", "ipc_send"] and stages[-1] == "ipc_recv"
            for child_stage in ("queue_wait", "assemble", "execute", "scatter", "ipc_wait"):
                assert child_stage in stages
            assert sum(s["s"] for s in rec["stages"]) == pytest.approx(rec["wall_s"], abs=1e-6)
            assert rec["wall_s"] <= e2e + 0.05
            assert rec["labels"]["replica"] in (0, 1) and rec["labels"]["kind"] == "bfs"
            deadline = time.time() + 10
            while time.time() < deadline and not all(rp.last_metrics for rp in fr.replicas):
                time.sleep(0.02)
            assert all(rp.last_metrics for rp in fr.replicas)
            fr.supervise_once()  # the tick emits the heartbeat-age gauges
            port = fr.serve_metrics()
            base = f"http://127.0.0.1:{port}"
            text = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
            parsed = export.parse_exposition(text)
            child_reqs = sorted(k for k in parsed
                                if k[0] == "combblas_serve_requests" and 'replica="' in k[1])
            assert child_reqs
            assert any(k[0] == "combblas_serve_procfleet_heartbeat_age_s" for k in parsed)
            hz = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read())
            assert hz["status"] == "ok"
            sz = json.loads(urllib.request.urlopen(f"{base}/statz", timeout=10).read())
            assert sz["fleetlog"]["recorded"] >= 2
            logged = obs.parse_jsonl(fr.fleetlog.path)
            assert logged[0]["schema"] == obs.FLEETLOG_SCHEMA
            spawns = [r for r in logged if r.get("name") == "fleet.spawn"]
            assert sorted(r["replica"] for r in spawns) == [0, 1]
            assert all(r["pid"] > 0 for r in spawns)
            got[name] = (lev, stages, len(child_reqs) > 0, logged[0]["schema"])
        finally:
            if fr is not None:
                fr.close(drain=True)
            trace.set_sample_rate(None)
            trace.clear()
            obs.disable()
            obs.reset()
        assert fr._scrape is None
    assert np.array_equal(got["jax"][0], got["torch"][0])
    assert got["torch"][1] == got["jax"][1]  # the same stages, in order
    assert got["torch"][2:] == got["jax"][2:]


# --- real-signal chaos (slow, as in the reference) ---------------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_sigkill_and_sigstop_chaos_heals(tmp_path):
    """SIGKILL a non-home replica (respawn from checkpoint+WAL serves the
    acknowledged write), then SIGSTOP the home: the heartbeat timeout
    detects it, its in-flight read fails honestly, promotion at the WAL
    frontier moves the write lane, and a later write reaches every
    replica; the same levels and counts in both packages."""
    rows, cols = coo_pairs(42, N, 300)
    (a0, b0), (a1, b1) = _absent_pairs(rows, cols, 2)
    got = {}
    for name in NAMES:
        P = PKG[name]
        fr = PROC[name].ProcessFleet.build(
            (1, 1), rows, cols, N, replicas=3, kinds=("bfs",),
            config=P.ServeConfig(lane_widths=(1, 2), update_flush=1, update_max_delay_s=0.005),
            wal_dir=str(tmp_path / f"wal-{name}"), workdir=str(tmp_path / f"proc-{name}"),
            hb_interval_s=0.1, hb_timeout_s=1.5, from_coo_kw={"headroom": 0.5},
            **DEVICE[name])
        try:
            fr.submit_update([("insert", a0, b0), ("insert", b0, a0)]).result(timeout=60)
            victim = (fr.home + 1) % 3
            os.kill(fr.replicas[victim].proc.pid, signal.SIGKILL)
            t0 = time.monotonic()
            while not fr._dead(victim):
                assert time.monotonic() - t0 < 10
                time.sleep(0.02)
            out1 = fr.supervise_once()
            assert victim in out1["replaced"]
            lev0 = _levels(fr.replicas[victim].submit("bfs", a0))
            assert lev0[b0] == 1
            home0 = fr.home
            os.kill(fr.replicas[home0].proc.pid, signal.SIGSTOP)
            stuck = fr.replicas[home0].submit("bfs", a0)
            t0 = time.monotonic()
            while not fr._dead(home0):
                assert time.monotonic() - t0 < 15
                time.sleep(0.02)
            out2 = fr.supervise_once()
            assert out2["promoted"] is not None and fr.home != home0
            assert isinstance(stuck.exception(timeout=30),
                              (P.ReplicaDeadError, PROC[name].IpcTimeoutError))
            for _ in range(4):
                assert fr.submit("bfs", a0).result(timeout=60) is not None
            res = fr.submit_update([("insert", a1, b1), ("insert", b1, a1)]).result(timeout=60)
            assert res["fanned_out"] == 2 and res["lagging"] == []
            lev1 = [_levels(rp.submit("bfs", a1)) for rp in fr.replicas]
            assert all(lv[b1] == 1 for lv in lev1)
            st = fr.stats()
            assert st["promotions"] == 1 and st["replacements"] == 2
            assert fr.health()["status"] == "ok"
            got[name] = (lev0, lev1, out1, out2, fr.home)
        finally:
            fr.close(drain=False)
    assert np.array_equal(got["jax"][0], got["torch"][0])
    for x, y in zip(got["jax"][1], got["torch"][1]):
        assert np.array_equal(x, y)
    assert got["torch"][2:] == got["jax"][2:]


@pytest.mark.slow
@pytest.mark.chaos
def test_scripted_fault_plan_kills_through_router(tmp_path):
    """``ProcessFaultPlan`` fires a real SIGKILL at a scripted routed
    submit while the supervisor heals in the background: availability
    holds and every routed read settles, in both packages."""
    rows, cols = coo_pairs(43, N, 300)
    for name in NAMES:
        P = PKG[name]
        fr = PROC[name].ProcessFleet.build(
            (1, 1), rows, cols, N, replicas=2, kinds=("bfs",),
            config=P.ServeConfig(lane_widths=(1, 2)),
            wal_dir=str(tmp_path / f"wal-{name}"), workdir=str(tmp_path / f"proc-{name}"),
            hb_interval_s=0.1, hb_timeout_s=1.5, **DEVICE[name])
        try:
            fr.start_supervisor(interval_s=0.05)
            fr.proc_faults.sigkill(5, replica=(fr.home + 1) % 2)
            ok = bad = 0
            for i in range(30):
                try:
                    fr.submit("bfs", int(rows[i % len(rows)])).result(timeout=60)
                    ok += 1
                except Exception:
                    bad += 1
            assert fr.sigkills == 1
            assert ok / (ok + bad) >= 0.9
            deadline = time.monotonic() + 30
            while (fr._needs_rebuild or any(fr._dead(i) for i in range(2))) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert fr.replacements >= 1
        finally:
            fr.close(drain=False)


# --- the gated process-fleet series, over stub replicas ----------------------


def _stub(name, peer=None):
    """A ReplicaProc over an in-process responder: ``ping`` answers,
    ``hang`` never does. Returns (replica, stop event)."""
    ipc = IPC[name]
    a, b = socket.socketpair()
    stop = threading.Event()
    ch_child = ipc.Channel(b)

    def responder():
        while not stop.is_set():
            try:
                m = ch_child.recv(timeout=0.05)
            except socket.timeout:
                continue
            except ipc.ChannelClosed:
                return
            if m.get("op") == "ping":
                ch_child.send({"id": m["id"], "ok": True, "result": {"pong": True}})

    threading.Thread(target=responder, daemon=True).start()
    return PROC[name].ReplicaProc(0, None, ipc.Channel(a, peer=peer)), stop


def _series(obs):
    return sorted((r["kind"], r["name"], tuple(sorted(r["labels"].items())),
                   r["count"] if r["kind"] == "histogram" else r["value"])
                  for r in obs.registry.snapshot() if r["name"].startswith("serve."))


def test_procfleet_counters_gated():
    """The IPC series — per-RPC latency, per-request deadline timeouts,
    quarantine — are emitted under obs and cost nothing when disabled;
    the same series in both packages."""
    got = {}
    for name in NAMES:
        P = PKG[name]
        obs = P.obs

        def exercise(tag, name=name, P=P):
            rp, stop = _stub(name)
            assert rp.call("ping", timeout_s=10)["pong"] is True
            f = rp.rpc("hang", timeout_s=0.15)
            assert isinstance(f.exception(timeout=10), PROC[name].IpcTimeoutError)
            rp.quarantine(P.ReplicaDeadError(f"gate teardown {tag}"))
            stop.set()

        assert not obs.ENABLED
        exercise("off")
        assert obs.registry.empty()
        obs.enable(install_hooks=False)
        try:
            obs.reset()
            exercise("on")
            g = obs.registry.get_counter
            assert obs.registry.get_histogram(
                "serve.procfleet.rpc_latency_s", op="ping")["count"] == 1
            assert g("serve.procfleet.ipc_timeouts", op="hang") == 1
            assert g("serve.procfleet.quarantined", replica=0) == 1
            got[name] = [s[:3] for s in _series(obs)]
        finally:
            obs.disable()
            obs.reset()
    assert got["torch"] == got["jax"]


def test_fleet_obs_gated(tmp_path):
    """The fleet-observability plane — IPC channel accounting,
    per-replica deadline misses, the supervision timeline — is emitted
    under obs and costs nothing when disabled: no series, no fleet-log
    file, no flight-recorder traffic; the same series in both
    packages."""
    got = {}
    for name in NAMES:
        P = PKG[name]
        obs = P.obs

        def exercise(tag, name=name, P=P):
            rp, stop = _stub(name, peer="replica0")
            assert rp.call("ping", timeout_s=10)["pong"] is True
            f = rp.rpc("hang", timeout_s=0.15)
            assert isinstance(f.exception(timeout=10), PROC[name].IpcTimeoutError)
            stub = types.SimpleNamespace(
                replicas=[rp],
                fleetlog=FLEETLOG[name](str(tmp_path / f"fleet-{name}-{tag}.jsonl")),
                recorder=P.FlightRecorder(out_dir=str(tmp_path / f"rec-{name}-{tag}")))
            PROC[name].ProcessFleet._fleet_event(stub, "quarantine", replica=0, reason="gate")
            rp.quarantine(P.ReplicaDeadError(f"gate teardown {tag}"))
            stop.set()
            return stub

        assert not obs.ENABLED
        stub = exercise("off")
        assert obs.registry.empty()
        assert not os.path.exists(stub.fleetlog.path)
        assert stub.recorder.recorded == 0
        obs.enable(install_hooks=False)
        try:
            obs.reset()
            stub = exercise("on")
            g = obs.registry.get_counter
            assert g("serve.ipc.bytes_out", peer="replica0") > 0
            assert g("serve.ipc.bytes_in", peer="replica0") > 0
            assert obs.registry.get_histogram("serve.ipc.encode_s", peer="replica0")["count"] >= 2
            assert obs.registry.get_histogram("serve.ipc.decode_s", peer="replica0")["count"] >= 1
            assert g("serve.ipc.deadline_missed", replica=0) == 1
            assert g("serve.fleetlog.events", event="quarantine") == 1
            (ev,) = stub.fleetlog.snapshot()
            assert ev["name"] == "fleet.quarantine" and ev["reason"] == "gate"
            assert os.path.exists(stub.fleetlog.path)
            assert stub.recorder.dumps == 1
            got[name] = ([s[:3] for s in _series(obs)],
                         g("serve.ipc.bytes_out", peer="replica0"),
                         g("serve.ipc.bytes_in", peer="replica0"))
        finally:
            obs.disable()
            obs.reset()
    assert got["torch"] == got["jax"]


def test_procfleet_metrics_federation_parity():
    """One ``ProcessFleet`` scrape federates the router's registry with
    every replica's heartbeat-piggybacked child snapshot, relabeled
    ``replica=i``: the served text equals a fresh federated render, and
    both packages serve the same exposition."""
    got = {}
    for name in NAMES:
        P = PKG[name]
        obs, export = P.obs, P.export
        obs.enable(install_hooks=False)
        try:
            obs.count("serve.requests", 3, kind="bfs")
            for v in (0.01, 0.02):
                obs.observe("serve.e2e_s", v, kind="bfs")
            child_snap = obs.metrics_snapshot()
            obs.reset()
            obs.count("serve.requests", 2, kind="pr")
            stub = types.SimpleNamespace(replicas=[
                types.SimpleNamespace(last_metrics=child_snap, last_metrics_t=1.0),
                types.SimpleNamespace(last_metrics=None, last_metrics_t=0.0)])
            stub.metrics_records = PROC[name].ProcessFleet.metrics_records.__get__(stub)
            recs = stub.metrics_records()
            assert {r["labels"].get("replica") for r in recs} == {None, 0}
            port = export.attach_scrape(stub)
            assert port == export.attach_scrape(stub)
            text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                          timeout=10).read().decode()
            parsed = export.parse_exposition(text)
            assert parsed == export.parse_exposition(export.render(stub.metrics_records()))
            child_lab = export._labels({"kind": "bfs", "replica": 0})
            assert parsed[("combblas_serve_requests", child_lab)] == 3
            assert parsed[("combblas_serve_e2e_s_count", child_lab)] == 2
            assert parsed[("combblas_serve_requests", export._labels({"kind": "pr"}))] == 2
            export.detach_scrape(stub)
            assert stub._scrape is None
            got[name] = {k: v for k, v in parsed.items() if "quantile" not in k[1]
                         and not k[0].endswith(("_sum", "_min", "_max"))}
        finally:
            obs.disable()
            obs.reset()
    assert got["torch"] == got["jax"]
