"""Parity of the port's network front door (``combblas_tpu_torch.serve.net``)
with ``combblas_tpu.serve.net`` on the CPU.

Mirrors every fast case of ``tests/test_serve_net.py`` against the port, on
the oracle's scale-6 graph (R-MAT seed 11, edgefactor 4) over a ``Server``
in this process: the status taxonomy (each package's ``wire_error`` of the
same exception gives the same dict, ``wire_exception`` the same type and
message), the shared frame codec (each package's channel reads the
other's frames), one connection end to end, the write lane over the wire,
wire deadlines and the SLO cap, typed backpressure and connection-limit
rejects, tenant-header routing into a pool, torn frames and abrupt
disconnects, trace telescoping, the client's retry policy and its
reconnect. Beyond the oracle: every pair of client and frontend across the
two packages answers bfs and sssp bit for bit alike; ``submit(trace=)``
records the reference's stage names on a ``Server``, a ``PoolServer``, a
``FleetRouter`` and a ``ProcessFleet`` (over stub replicas); a backend
that holds a CUDA error answers ``unavailable`` and reports ``down``; the
scrape plane; one short ``loadgen.run`` over a ``Server``. The two
open-loop runs over a process fleet are ``slow``, as in the reference, with
the port's children on ``device="cpu"``.
"""

import socket
import struct
import threading
import time
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import combblas_tpu.serve.frame as jframe
import combblas_tpu.serve.net as jnet
import combblas_tpu.serve.procfleet as jproc
import combblas_tpu_torch.serve.frame as tframe
import combblas_tpu_torch.serve.ipc as tipc
import combblas_tpu_torch.serve.net as tnet
import combblas_tpu_torch.serve.procfleet as tproc
from combblas_tpu.serve.net import loadgen as jloadgen
from combblas_tpu.serve.net import protocol as JP
from combblas_tpu.utils.rmat import rmat_symmetric_coo_host
from combblas_tpu_torch.serve.net import loadgen as tloadgen
from combblas_tpu_torch.serve.net import protocol as TP
from torch_serve_parity import NAMES, PKG, grid, isolated  # noqa: F401

SCALE = 6
N = 1 << SCALE
NET = {"jax": jnet, "torch": tnet}
PROTO = {"jax": JP, "torch": TP}
FRAME = {"jax": jframe, "torch": tframe}
PROC = {"jax": jproc, "torch": tproc}
KINDS = ("bfs", "sssp")
CUDA_ERR = "CUDA error: an illegal memory access was encountered"


def _wait(cond, timeout=10.0, tick=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


@pytest.fixture(scope="module")
def graph():
    rows, cols = rmat_symmetric_coo_host(11, SCALE, 4)
    w = np.random.default_rng(7).integers(1, 16, len(rows)).astype(np.float32)
    return rows, cols, w


@pytest.fixture(scope="module")
def live_roots(graph):
    rows = graph[0]
    return np.flatnonzero(np.bincount(rows, minlength=N) > 0).astype(np.int32)


@pytest.fixture(scope="module")
def engines(graph):
    rows, cols, w = graph
    return {name: PKG[name].GraphEngine.from_coo(grid(name), rows, cols, N, weights=w,
                                                 kinds=KINDS)
            for name in NAMES}


@pytest.fixture(scope="module")
def served(engines):
    """One worker server behind one frontend a package, warm, shared by the
    fast end-to-end tests (module scope: the reference's compiles once)."""
    out = {}
    for name in NAMES:
        srv = engines[name].serve(PKG[name].ServeConfig(
            lane_widths=(1, 2), max_wait_s=0.002, update_autostart=False))
        srv.start()
        srv.warmup(widths=(1, 2))
        out[name] = (srv, NET[name].NetFrontend(srv))
    yield out
    for srv, fe in out.values():
        fe.close()
        srv.close()


@pytest.fixture(scope="module")
def direct(served, live_roots):
    """The reference Server's answers, each kind and root: what every wire
    answer is held to."""
    srv = served["jax"][0]
    return {(kind, int(r)): srv.submit(kind, int(r)).result(timeout=120)
            for kind in KINDS for r in live_roots[:4]}


def _same_arrays(got: dict, want: dict, what="") -> None:
    for key, arr in want.items():
        if isinstance(arr, np.ndarray):
            assert isinstance(got[key], np.ndarray), (what, key)
            assert got[key].dtype == arr.dtype and np.array_equal(got[key], arr), (what, key)


def _port_server(engines, **cfg):
    return engines["torch"].serve(PKG["torch"].ServeConfig(update_autostart=False, **cfg))


# --- protocol taxonomy (pure, no sockets) ----------------------------------------

CASES = {
    "breaker_open": lambda P, proc: P.CircuitBreakerOpen("bfs", 0.5, tenant="web"),
    "backpressure": lambda P, proc: P.BackpressureError(7, 0.01, tenant="web"),
    "replica_dead": lambda P, proc: P.ReplicaDeadError("all replicas failed"),
    "timeout": lambda P, proc: TimeoutError("deadline"),
    "ipc_timeout": lambda P, proc: proc.IpcTimeoutError("ipc deadline"),
    "value_error": lambda P, proc: ValueError("bad root"),
    "key_error": lambda P, proc: KeyError("tenant"),
    "type_error": lambda P, proc: TypeError("not an int"),
    "runtime_error": lambda P, proc: RuntimeError("boom"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wire_status_taxonomy_round_trip(case):
    """Every taxonomy member maps to the same typed status and fields in
    both packages, and rebuilds client-side as the same exception type with
    the same message (``protocol.py``'s table, bijectively)."""
    msgs, back = {}, {}
    for name in NAMES:
        exc = CASES[case](PKG[name], PROC[name])
        msgs[name] = PROTO[name].wire_error(exc, mid=3)
        assert msgs[name]["id"] == 3
        assert msgs[name]["status"] in PROTO[name].ERROR_STATUSES
        rebuilt = PROTO[name].wire_exception(msgs[name])
        back[name] = (type(rebuilt).__name__, str(rebuilt), getattr(rebuilt, "retry_after_s", None),
                      getattr(rebuilt, "tenant", None), getattr(rebuilt, "kind", None))
    assert msgs["torch"] == msgs["jax"]
    assert back["torch"] == back["jax"]


def test_protocol_constants_and_precedence_match_reference():
    """The same version and status set; breaker_open wins over its parent
    class; retry hints survive; an unknown status degrades to
    RuntimeError; a CUDA error (a RuntimeError) answers unavailable."""
    assert TP.PROTOCOL_VERSION == JP.PROTOCOL_VERSION == 1
    assert TP.ERROR_STATUSES == JP.ERROR_STATUSES
    for name in ("ST_OK", "ST_BACKPRESSURE", "ST_BREAKER_OPEN", "ST_REPLICA_DEAD",
                 "ST_TIMEOUT", "ST_INVALID", "ST_UNAVAILABLE"):
        assert getattr(TP, name) == getattr(JP, name)
    P = PKG["torch"]
    assert isinstance(P.CircuitBreakerOpen("bfs", 0.1), P.BackpressureError)
    back = TP.wire_exception(TP.wire_error(P.CircuitBreakerOpen("bfs", 0.25, tenant="t")))
    assert type(back) is P.CircuitBreakerOpen
    assert (back.kind, back.retry_after_s, back.tenant) == ("bfs", 0.25, "t")
    assert TP.wire_exception(TP.wire_error(P.BackpressureError(9, 0.125))).retry_after_s == 0.125
    assert isinstance(TP.wire_exception({"status": "shiny_new", "error": "x"}), RuntimeError)
    for exc in (RuntimeError(CUDA_ERR), torch.OutOfMemoryError("CUDA out of memory")):
        msg = TP.wire_error(exc)
        assert msg["status"] == TP.ST_UNAVAILABLE
        assert type(TP.wire_exception(msg)) is RuntimeError


# --- the shared frame codec --------------------------------------------------------


def test_ipc_reexports_are_the_frame_codec():
    """One codec, two transports: the port's ``serve/ipc.py`` re-exports
    ``serve/frame.py`` (the reference's ``denumpy`` identity helper has no
    caller in the port and is not kept)."""
    assert tipc.Channel is tframe.Channel
    assert tipc.ChannelClosed is tframe.ChannelClosed
    assert tipc.encode is tframe.encode
    assert tipc.decode is tframe.decode
    assert tipc.MAX_FRAME == tframe.MAX_FRAME == jframe.MAX_FRAME


@pytest.mark.parametrize("sender,receiver", [(a, b) for a in NAMES for b in NAMES])
def test_channel_ndarray_round_trip_and_byte_accounting(sender, receiver):
    """A binary ndarray reply crosses a real socket bit for bit from either
    package's channel to either's, and both peers account the same
    whole-frame byte totals."""
    a, b = socket.socketpair()
    ca = FRAME[sender].Channel(a, peer="net")
    cb = FRAME[receiver].Channel(b, peer="netclient")
    try:
        arr = np.arange(8, dtype=np.int32)
        n = ca.send({"status": "ok", "result": {"levels": arr, "batch_niter": 3}})
        assert n > 0 and ca.bytes_out == n
        got = cb.recv(timeout=5)
        assert cb.bytes_in == n  # advances only on whole frames
        out = got["result"]["levels"]
        assert isinstance(out, np.ndarray) and out.dtype == np.int32
        np.testing.assert_array_equal(out, arr)
        assert got["result"]["batch_niter"] == 3
    finally:
        ca.close()
        cb.close()


# --- single connection end to end ----------------------------------------------------


def test_single_connection_e2e(served, live_roots, direct):
    """hello -> ping -> submit (binary ndarray reply, bit for bit the
    reference Server's answer) -> submit_many with per-root error isolation
    -> stats / health, then a clean unwind."""
    srv, fe = served["torch"]
    r0 = int(live_roots[0])
    with tnet.NetClient("127.0.0.1", fe.port) as c:
        assert c.server_pooled is False
        assert c.ping()["pong"] is True
        out = c.submit("bfs", r0)
        assert out["levels"].dtype == np.int32
        _same_arrays(out, direct["bfs", r0])
        many = c.submit_many("bfs", [r0, N + 99])
        assert many[0]["status"] == TP.ST_OK
        _same_arrays(many[0]["result"], direct["bfs", r0])
        assert many[1]["status"] == TP.ST_INVALID
        assert isinstance(TP.wire_exception(many[1]), ValueError)
        st = c.stats()
        assert st["net"]["connections"] == 1 and st["net"]["port"] == fe.port
        assert "backend" in st
        h = c.health()
        assert h["status"] == "ok" and h["net"]["closing"] is False
        assert h["backend"]["device_error"] is None
    assert _wait(lambda: fe.stats()["net"]["connections"] == 0)


@pytest.mark.parametrize("client_pkg,frontend_pkg", [(a, b) for a in NAMES for b in NAMES])
def test_cross_package_interop(served, live_roots, direct, client_pkg, frontend_pkg):
    """Either package's client against either package's frontend: bfs and
    sssp answers, single roots and a submit_many, bit for bit the
    reference Server's."""
    _srv, fe = served[frontend_pkg]
    roots = [int(r) for r in live_roots[:4]]
    with NET[client_pkg].NetClient("127.0.0.1", fe.port) as c:
        futs = [(kind, r, c.submit_nowait(kind, r)) for kind in KINDS for r in roots]
        for kind, r, f in futs:
            _same_arrays(f.result(timeout=60), direct[kind, r], (kind, r))
        many = c.submit_many("sssp", roots)
        assert [e["status"] for e in many] == ["ok"] * len(roots)
        for r, e in zip(roots, many):
            _same_arrays(e["result"], direct["sssp", r], r)


def test_submit_update_shares_the_protocol(graph):
    """The write lane rides the same connection: an edge insert over the
    wire merges (pump-driven) and is acknowledged with the next version,
    and the reference's acknowledgement of the same write carries the
    same version, op count and mode."""
    rows, cols, _w = graph
    present = set(zip(rows.tolist(), cols.tolist()))
    a, b = next((i, j) for i in range(N) for j in range(N) if i != j and (i, j) not in present)
    acks = {}
    for name in NAMES:
        P = PKG[name]
        eng = P.GraphEngine.from_coo(grid(name), rows, cols, N, kinds=("bfs",), keep_coo=True)
        srv = eng.serve(P.ServeConfig(lane_widths=(1,), update_autostart=False,
                                      update_flush=100))
        v0 = eng.version_id
        fe = NET[name].NetFrontend(srv)
        try:
            with NET[name].NetClient("127.0.0.1", fe.port) as c:
                fut = c.submit_update_nowait([("insert", a, b), ("insert", b, a)])
                assert _wait(lambda: srv.stats()["updates"]["pending"] > 0)
                assert srv.pump_updates(force=True) == 2
                res = fut.result(timeout=30)
                assert res["version"] == v0 + 1
                acks[name] = (res["version"] - v0, res["ops"], res["mode"], res["nnz"])
        finally:
            fe.close()
            srv.close()
    assert acks["torch"] == acks["jax"]


# --- wire deadline -> scheduler timeout ----------------------------------------------


def test_wire_deadline_becomes_scheduler_timeout(engines, live_roots):
    """``deadline_s`` on the wire is the scheduler's per-request timeout:
    the request expires in queue (the deadline sweep) and comes back as a
    typed ``timeout``; a non-positive deadline is a typed ``invalid``."""
    srv = _port_server(engines, lane_widths=(4,), max_wait_s=60.0)
    fe = tnet.NetFrontend(srv)
    try:
        with tnet.NetClient("127.0.0.1", fe.port) as c:
            fut = c.submit_nowait("bfs", int(live_roots[0]), deadline_s=0.001)
            assert _wait(lambda: srv.scheduler.depth() == 1)
            time.sleep(0.01)
            srv.pump()
            with pytest.raises(TimeoutError):
                fut.result(timeout=10)
            bad = c.submit_nowait("bfs", int(live_roots[0]), deadline_s=-1.0)
            with pytest.raises(ValueError, match="deadline_s"):
                bad.result(timeout=10)
    finally:
        fe.close()
        srv.close()


def test_slo_deadline_still_caps_wire_deadline(engines, live_roots):
    """A generous wire deadline cannot loosen ``slo_deadline_s``."""
    srv = _port_server(engines, lane_widths=(4,), max_wait_s=60.0, slo_deadline_s=0.001)
    fe = tnet.NetFrontend(srv)
    try:
        with tnet.NetClient("127.0.0.1", fe.port) as c:
            fut = c.submit_nowait("bfs", int(live_roots[0]), deadline_s=60.0)
            assert _wait(lambda: srv.scheduler.depth() == 1)
            time.sleep(0.01)
            srv.pump()
            with pytest.raises(TimeoutError):
                fut.result(timeout=10)
    finally:
        fe.close()
        srv.close()


# --- admission rejections as wire replies ----------------------------------------------


def test_backpressure_is_a_typed_wire_reply(engines, live_roots):
    """A full queue rejects over the wire with ``backpressure`` and its
    retry hint, the connection stays open, and parked futures settle when
    the backend fails them."""
    srv = _port_server(engines, lane_widths=(16,), max_queue=2, max_wait_s=60.0)
    fe = tnet.NetFrontend(srv)
    try:
        with tnet.NetClient("127.0.0.1", fe.port) as c:
            r = int(live_roots[0])
            f1 = c.submit_nowait("bfs", r)
            f2 = c.submit_nowait("bfs", r)
            f3 = c.submit_nowait("bfs", r)
            with pytest.raises(PKG["torch"].BackpressureError) as ei:
                f3.result(timeout=10)
            assert ei.value.retry_after_s > 0
            assert c.ping()["pong"] is True
            assert not f1.done() and not f2.done()
            srv.scheduler.fail_pending(RuntimeError("teardown"))
            assert isinstance(f1.exception(timeout=10), RuntimeError)
            assert isinstance(f2.exception(timeout=10), RuntimeError)
    finally:
        fe.close()
        srv.close()


def test_connection_limit_is_a_typed_hello_reject(engines):
    """Past ``max_conns`` the hello itself answers ``backpressure``."""
    srv = _port_server(engines, lane_widths=(1,))
    fe = tnet.NetFrontend(srv, max_conns=1)
    try:
        c1 = tnet.NetClient("127.0.0.1", fe.port)
        try:
            with pytest.raises(PKG["torch"].BackpressureError):
                tnet.NetClient("127.0.0.1", fe.port)
            assert fe.rejected_conns == 1
            assert c1.ping()["pong"] is True
        finally:
            c1.close()
    finally:
        fe.close()
        srv.close()


# --- tenant-header routing ---------------------------------------------------------------


def _tenant_coo(seed, n=N, m=240):
    r = np.random.default_rng(seed)
    rows, cols = r.integers(0, n, m), r.integers(0, n, m)
    return np.concatenate([rows, cols]), np.concatenate([cols, rows])


def test_tenant_header_routes_to_the_right_graph():
    """The hello's tenant header routes every request on the connection to
    that ``PoolServer`` tenant: two tenants, two graphs answering the same
    root, each equal to the reference pool's answer; unknown and missing
    tenants are typed hello rejects."""
    got = {}
    for name in NAMES:
        P = PKG[name]
        pool = P.EnginePool(grid(name))
        for i, tenant in enumerate(("a", "b")):
            rows, cols = _tenant_coo(i)
            pool.add_tenant(tenant, rows, cols, N, kinds=("bfs",),
                            config=P.ServeConfig(lane_widths=(1,), update_autostart=False))
        psrv = pool.serve()
        psrv.warmup(widths=(1,))
        fe = NET[name].NetFrontend(psrv)
        ca = cb = None
        try:
            ca = NET[name].NetClient("127.0.0.1", fe.port, tenant="a")
            cb = NET[name].NetClient("127.0.0.1", fe.port, tenant="b")
            assert ca.server_pooled is True
            fa, fb = ca.submit_nowait("bfs", 3), cb.submit_nowait("bfs", 3)

            def drain():
                while psrv.pump(force=True):
                    pass
                return fa.done() and fb.done()

            assert _wait(drain)
            got[name] = {"a": fa.result(timeout=0), "b": fb.result(timeout=0)}
            for t in ("a", "b"):
                want = pool.engine(t).execute("bfs", np.asarray([3], np.int32))["levels"][:, 0]
                np.testing.assert_array_equal(got[name][t]["levels"], want)
            assert not np.array_equal(got[name]["a"]["levels"], got[name]["b"]["levels"])
            with pytest.raises(ValueError, match="unknown tenant"):
                NET[name].NetClient("127.0.0.1", fe.port, tenant="nope")
            with pytest.raises(ValueError, match="tenant header required"):
                NET[name].NetClient("127.0.0.1", fe.port)
        finally:
            for c in (ca, cb):
                if c is not None:
                    c.close()
            fe.close()
            psrv.close()
    for t in ("a", "b"):
        _same_arrays(got["torch"][t], got["jax"][t], t)


# --- torn frames / abrupt disconnects ------------------------------------------------------


def test_torn_frame_tears_down_only_that_connection(engines):
    """A length prefix promising bytes that never arrive, and an oversized
    prefix, unwind that connection; the listener keeps serving."""
    srv = _port_server(engines, lane_widths=(1,))
    fe = tnet.NetFrontend(srv)
    try:
        def raw_hello():
            raw = socket.create_connection(("127.0.0.1", fe.port), timeout=5)
            ch = tframe.Channel(raw, peer="netclient")
            ch.send({"v": TP.PROTOCOL_VERSION, "op": "hello", "id": 0, "tenant": None})
            assert ch.recv(timeout=5)["status"] == TP.ST_OK
            return raw, ch

        raw, _ch = raw_hello()
        assert _wait(lambda: fe.stats()["net"]["connections"] == 1)
        raw.sendall(struct.pack(">I", 1000) + b"\x00\x01")  # torn
        raw.close()
        assert _wait(lambda: fe.stats()["net"]["connections"] == 0)
        raw2, _ch2 = raw_hello()
        raw2.sendall(struct.pack(">I", tframe.MAX_FRAME + 1))
        assert _wait(lambda: fe.stats()["net"]["connections"] == 0)
        raw2.close()
        with tnet.NetClient("127.0.0.1", fe.port) as c:
            assert c.ping()["pong"] is True
    finally:
        fe.close()
        srv.close()


def test_abrupt_disconnect_strands_no_futures(engines, live_roots):
    """A client vanishing with requests parked in the queue: its futures
    fail with ConnectionError at once, the backend futures still settle
    server-side, and their replies are counted as drops."""
    srv = _port_server(engines, lane_widths=(16,), max_wait_s=60.0)
    fe = tnet.NetFrontend(srv)
    try:
        c = tnet.NetClient("127.0.0.1", fe.port)
        f1 = c.submit_nowait("bfs", int(live_roots[0]))
        f2 = c.submit_nowait("bfs", int(live_roots[1]))
        assert _wait(lambda: srv.scheduler.depth() == 2)
        c.close()
        assert isinstance(f1.exception(timeout=10), ConnectionError)
        assert isinstance(f2.exception(timeout=10), ConnectionError)
        assert c.pending == 0
        assert _wait(lambda: fe.stats()["net"]["connections"] == 0)
        drops0 = fe.reply_drops
        srv.scheduler.fail_pending(RuntimeError("drain"))
        assert _wait(lambda: fe.reply_drops == drops0 + 2)
        assert srv.scheduler.depth() == 0
    finally:
        fe.close()
        srv.close()


# --- a CUDA error on the wire (the port's own) ------------------------------------------


def test_device_error_answers_unavailable_and_health_down(graph, live_roots):
    """A backend whose batch met a CUDA error (raised in place of
    ``execute``, as the resilience tests inject it) fails that request
    with it: the wire answers ``unavailable`` (the client raises
    ``RuntimeError``), the ``Server`` keeps ``device_error``, and the
    frontend's ``health()`` — over the wire too — reports ``down``; the
    next request meets the error again and answers ``unavailable``."""
    rows, cols, w = graph
    P = PKG["torch"]
    eng = P.GraphEngine.from_coo(grid("torch"), rows, cols, N, weights=w, kinds=("bfs",))
    srv = eng.serve(P.ServeConfig(lane_widths=(1,), max_wait_s=60.0, update_autostart=False))
    boom = RuntimeError(CUDA_ERR)

    def broken(kind, sources):
        raise boom

    eng.execute = broken
    fe = tnet.NetFrontend(srv)
    try:
        with tnet.NetClient("127.0.0.1", fe.port) as c:
            for k in range(2):
                fut = c.submit_nowait("bfs", int(live_roots[k]))
                assert _wait(lambda: srv.scheduler.depth() == 1)
                srv.pump(force=True)
                exc = fut.exception(timeout=10)
                assert type(exc) is RuntimeError and CUDA_ERR in str(exc)
            assert srv.device_error is boom
            assert fe.health()["status"] == "down"
            h = c.health()
            assert h["status"] == "down" and CUDA_ERR in h["backend"]["device_error"]
    finally:
        fe.close()
        srv.close()


# --- trace telescoping across the wire ---------------------------------------------------


def test_net_trace_telescopes_to_wall(served, live_roots):
    """One sampled request gives one trace record whose stages run
    net_accept -> net_read -> [serve stages] -> net_write and sum to the
    end-to-end wall (the hold/release contract), with the reference's
    stage names in the reference's order."""
    stages = {}
    for name in NAMES:
        P = PKG[name]
        _srv, fe = served[name]
        P.obs.enable(install_hooks=False)
        P.trace.set_sample_rate(1.0)
        try:
            with NET[name].NetClient("127.0.0.1", fe.port) as c:
                c.submit("bfs", int(live_roots[0]))
            assert _wait(lambda: any(r["labels"].get("transport") == "net"
                                     for r in P.trace.records()))
            recs = [r for r in P.trace.records() if r["labels"].get("transport") == "net"]
            assert len(recs) == 1
            rec = recs[0]
            stages[name] = [s["stage"] for s in rec["stages"]]
            assert stages[name][0] == "net_accept" and stages[name][1] == "net_read"
            assert stages[name][-1] == "net_write"
            assert {"queue_wait", "assemble", "execute"} <= set(stages[name])
            assert rec["labels"]["status"] == "ok"
            assert sum(s["s"] for s in rec["stages"]) == pytest.approx(
                rec["wall_s"], rel=1e-6, abs=1e-9)
        finally:
            P.obs.disable()
            P.trace.set_sample_rate(None)
    assert stages["torch"] == stages["jax"]


# --- submit(trace=) on every backend ------------------------------------------------------


def _stub_replica(name, idx):
    """A ``ReplicaProc`` whose child is a responder thread in this process:
    it answers every ``submit`` with a fixed bfs lane."""
    a, b = socket.socketpair()
    ch_child = FRAME[name].Channel(b)
    stop = threading.Event()

    def responder():
        while not stop.is_set():
            try:
                m = ch_child.recv(timeout=0.05)
            except socket.timeout:
                continue
            except FRAME[name].ChannelClosed:
                return
            if m.get("op") == "submit":
                ch_child.send({"id": m["id"], "ok": True,
                               "result": {"levels": np.arange(4, dtype=np.int32)}})

    threading.Thread(target=responder, daemon=True).start()
    return PROC[name].ReplicaProc(idx, None, FRAME[name].Channel(a)), stop


def _traced_submit(name, backend, tmp_path, graph):
    """Open, hold and charge a trace as the frontend does, hand it to
    ``backend``'s ``submit(trace=)``, settle, release: the record's stage
    names and label keys."""
    P = PKG[name]
    rows, cols, w = graph
    cleanup = []
    if backend == "server":
        eng = P.GraphEngine.from_coo(grid(name), rows, cols, N, kinds=("bfs",))
        srv = eng.serve(P.ServeConfig(lane_widths=(1,), update_autostart=False))
        submit, drive = (lambda tr: srv.submit("bfs", 3, trace=tr)), (lambda: srv.pump(force=True))
        cleanup.append(srv.close)
    elif backend == "pool":
        pool = P.EnginePool(grid(name))
        pool.add_tenant("a", rows, cols, N, kinds=("bfs",),
                        config=P.ServeConfig(lane_widths=(1,), update_autostart=False))
        psrv = pool.serve()
        submit = lambda tr: psrv.submit("a", "bfs", 3, trace=tr)  # noqa: E731
        drive = lambda: psrv.pump(force=True)  # noqa: E731
        cleanup.append(psrv.close)
    elif backend == "fleet":
        fr = P.FleetRouter.build(grid(name), rows, cols, N, replicas=2, kinds=("bfs",),
                                 config=P.ServeConfig(lane_widths=(1,), update_autostart=False),
                                 start=False)

        def drive():
            for s in fr.replicas:
                s.pump(force=True)

        submit = lambda tr: fr.submit("bfs", 3, trace=tr)  # noqa: E731
        cleanup.append(lambda: fr.close(drain=False))
    else:  # a ProcessFleet over stub replicas: the policy and stitching of the real class
        stubs = [_stub_replica(name, i) for i in range(2)]
        fr = PROC[name].ProcessFleet(
            grid_shape=(1, 1), kinds=("bfs",), config=P.ServeConfig(),
            wal_dir=str(tmp_path / f"wal-{name}"), workdir=str(tmp_path / f"proc-{name}"),
            boot_ckpt=str(tmp_path / "unused.npz"), hb_timeout_s=5.0,
            **({"device": "cpu"} if name == "torch" else {}))
        fr.replicas = [rp for rp, _stop in stubs]
        fr._init_policy()
        submit, drive = (lambda tr: fr.submit("bfs", 3, trace=tr)), (lambda: None)
        for rp, stop in stubs:
            cleanup.append(stop.set)
            cleanup.append(lambda rp=rp: rp.quarantine(P.ReplicaDeadError("teardown")))
    P.obs.enable(install_hooks=False)
    P.trace.set_sample_rate(1.0)
    try:
        tr = P.obs.request_trace("net1", kind="bfs")
        tr.hold()
        tr.annotate(transport="net")
        tr.mark("net_read")
        fut = submit(tr)
        drive()
        fut.result(timeout=30)
        assert not any(r["rid"] == "net1" for r in P.trace.records())  # held
        tr.release(status="ok", stage="net_write")
        recs = [r for r in P.trace.records() if r["rid"] == "net1"]
        assert len(recs) == 1
        rec = recs[0]
        assert sum(s["s"] for s in rec["stages"]) == pytest.approx(rec["wall_s"], rel=1e-6,
                                                                    abs=1e-9)
        return [s["stage"] for s in rec["stages"]], sorted(rec["labels"]), rec["labels"]["status"]
    finally:
        P.obs.disable()
        P.trace.set_sample_rate(None)
        for fn in cleanup:
            fn()


@pytest.mark.parametrize("backend", ["server", "pool", "fleet", "procfleet"])
def test_submit_trace_records_the_reference_stages(backend, tmp_path, graph):
    """``submit(trace=)`` adopts the transport's live trace on the
    ``Server`` (through the scheduler), the ``PoolServer``, the
    ``FleetRouter`` (the replica that admits it) and the ``ProcessFleet``
    (stitched across IPC): one record a request, its stages and label keys
    the reference's."""
    got = {name: _traced_submit(name, backend, tmp_path, graph) for name in NAMES}
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == "net_read" and got["torch"][0][-1] == "net_write"


# --- blocking-client retry policy ------------------------------------------------------------


def test_client_retry_policy_unit():
    """``_call_retrying`` driven with stub send functions: backpressure
    sleeps the server's hint and resends until the budget runs out; a send
    failure reconnects and resends even for writes; an in-flight death
    resends reads but surfaces to write callers; a closed client and
    ``max_retries=0`` fail fast."""
    P = PKG["torch"]
    cli = tnet.NetClient.__new__(tnet.NetClient)
    cli.max_retries = 3
    cli.backoff_s = 0.001
    cli.max_backoff_s = 0.004
    cli._closed = False
    reconnects = []
    cli._ensure_connected = lambda: reconnects.append(1)

    def failing(exc, fails, then=None):
        state = {"n": 0}

        def send():
            state["n"] += 1
            fut = Future()
            if state["n"] <= fails:
                fut.set_exception(exc)
            else:
                fut.set_result(then)
            return fut

        return send

    bp = P.BackpressureError(7, 0.001)
    assert cli._call_retrying(failing(bp, 2, {"ok": 1}), 5.0) == {"ok": 1}
    with pytest.raises(P.BackpressureError):
        cli._call_retrying(failing(bp, 99), 5.0)
    brk = P.CircuitBreakerOpen("bfs", 0.001)
    assert cli._call_retrying(failing(brk, 1, {"ok": 2}), 5.0) == {"ok": 2}
    state = {"n": 0}

    def send_fail_then_ok():
        state["n"] += 1
        if state["n"] == 1:
            raise ConnectionError("send failed")
        fut = Future()
        fut.set_result({"ok": 3})
        return fut

    assert cli._call_retrying(send_fail_then_ok, 5.0, retry_inflight=False) == {"ok": 3}
    assert reconnects
    gone = ConnectionError("server gone")
    assert cli._call_retrying(failing(gone, 1, {"ok": 4}), 5.0) == {"ok": 4}
    with pytest.raises(ConnectionError):
        cli._call_retrying(failing(gone, 1, {"ok": 5}), 5.0, retry_inflight=False)
    cli._closed = True
    with pytest.raises(ConnectionError):
        cli._call_retrying(failing(gone, 1, {"ok": 6}), 5.0)
    cli._closed = False
    cli.max_retries = 0
    with pytest.raises(P.BackpressureError):
        cli._call_retrying(failing(bp, 1, {"ok": 7}), 5.0)


def test_client_reconnects_after_connection_drop(served, live_roots, direct):
    """The connection dies under the client; the next blocking submit
    reconnects (new socket, hello, reader generation) and answers bit for
    bit; the nowait primitives stay fail-fast."""
    _srv, fe = served["torch"]
    root = int(live_roots[0])
    cli = tnet.NetClient("127.0.0.1", fe.port)
    try:
        _same_arrays(cli.submit("bfs", root), direct["bfs", root])
        cli.ch.close()
        _same_arrays(cli.submit("bfs", root), direct["bfs", root])
        assert cli.reconnects >= 1
        assert cli.pending == 0
        cli.ch.close()
        with pytest.raises(ConnectionError):
            cli.submit_nowait("bfs", root)
        cli.submit("bfs", root)
    finally:
        cli.close()


# --- observability ---------------------------------------------------------------------------


def test_scrape_plane_and_net_series(served, live_roots):
    """``serve_metrics`` attaches the shared scrape endpoint: ``/metrics``
    carries the ``serve.net.*`` series of the requests just served and
    ``/healthz`` the frontend's health; the series are the ones the
    reference's frontend emits for the same requests."""
    series = {}
    for name in NAMES:
        P = PKG[name]
        _srv, fe = served[name]
        P.obs.enable(install_hooks=False)
        try:
            with NET[name].NetClient("127.0.0.1", fe.port) as c:
                c.submit("bfs", int(live_roots[1]))
                c.ping()
                with pytest.raises(ValueError):
                    c.submit("nope", 1)
            assert _wait(lambda: fe.stats()["net"]["connections"] == 0)
            snap = [r for r in P.obs.metrics_snapshot() if r["name"].startswith("serve.net.")]
            series[name] = sorted((r["kind"], r["name"], tuple(sorted(r["labels"].items())))
                                  for r in snap)
            if name == "torch":
                port = fe.serve_metrics()
                base = f"http://127.0.0.1:{port}"
                body = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
                assert "serve_net_requests" in body and "serve_net_bytes_out" in body
                h = urllib.request.urlopen(base + "/healthz", timeout=10).read().decode()
                assert '"net"' in h and '"status": "ok"' in h
                assert any(r["name"] == "serve.net.requests" for r in fe.metrics_records())
        finally:
            P.obs.disable()
            P.obs.reset()
    assert series["torch"] == series["jax"]


# --- the open-loop load generator ---------------------------------------------------------


def test_loadgen_classify_and_decompose_match_reference():
    """The harness's status buckets and its trace fold are the
    reference's."""
    P, J = PKG["torch"], PKG["jax"]
    for t, j in ((None, None), (P.CircuitBreakerOpen("bfs", 0.1), J.CircuitBreakerOpen("bfs", 0.1)),
                 (P.BackpressureError(1, 0.1), J.BackpressureError(1, 0.1)),
                 (P.ReplicaDeadError("x"), J.ReplicaDeadError("x")),
                 (TimeoutError("x"),) * 2, (ValueError("x"),) * 2,
                 (ConnectionError("x"),) * 2, (RuntimeError("x"),) * 2, (KeyboardInterrupt(),) * 2):
        assert tloadgen._classify(t) == jloadgen._classify(j)
    recs = [{"labels": {"transport": "net"}, "wall_s": 0.01,
             "stages": [{"stage": s, "s": v} for s, v in (("net_accept", 1e-4), ("net_read", 2e-5),
                                                          ("route", 1e-4), ("ipc_send", 3e-4),
                                                          ("execute", 8e-3), ("net_write", 1e-3))]},
            {"labels": {}, "wall_s": 1.0, "stages": []}]
    assert tloadgen._decompose(recs) == jloadgen._decompose(recs)
    assert tloadgen._decompose([]) == {"traced": 0}


def test_loadgen_run_over_a_server(served):
    """One short open-loop run over the port's ``Server`` (no process
    fleet): seeded Poisson arrivals over 4 connections for about a second;
    the gate holds (availability, no stranded future, every failure typed)
    and the decomposition folds the net-transport traces."""
    srv, _fe = served["torch"]
    out = tloadgen.run(rate=30, conns=4, seconds=1, scale=SCALE, edgefactor=4, kind="bfs",
                       deadline_s=5.0, backend=srv)
    assert out["ok"], out
    assert out["availability"] >= 0.99 and out["stranded_futures"] == 0
    assert out["untyped_failures"] == 0 and out["retraces_after_warmup"] == 0
    assert out["requests"] == 30 and out["replicas"] == 1
    assert out["offered_qps"] > 0 and out["achieved_qps"] > 0
    assert out["decomposition"]["traced"] > 0
    assert out["warning"] is None and out["metric"] == "serve.net.open_loop"


@pytest.mark.slow
def test_open_loop_gate_small_fleet():
    """The reference's open-loop gate, scaled down, against a two-replica
    process fleet of the port's children on the CPU."""
    out = tloadgen.run(rate=50, conns=8, seconds=2, scale=6, edgefactor=4, replicas=2,
                       device="cpu")
    assert out["ok"], out
    assert out["availability"] >= 0.99
    assert out["stranded_futures"] == 0
    assert out["retraces_after_warmup"] == 0
    assert out["untyped_failures"] == 0
    assert out["offered_qps"] > 0 and out["achieved_qps"] > 0
    assert out["decomposition"], out


@pytest.mark.slow
@pytest.mark.chaos
def test_open_loop_under_sigkill_chaos():
    """Open loop with a scripted SIGKILL mid-run: failures stay typed and no
    future strands while the port's fleet heals."""
    out = tloadgen.run(rate=40, conns=8, seconds=3, scale=6, edgefactor=4, replicas=2,
                       chaos=True, device="cpu")
    assert out["chaos"] is True
    assert out["untyped_failures"] == 0, out
    assert out["stranded_futures"] == 0
    assert out["availability"] >= 0.9, out
