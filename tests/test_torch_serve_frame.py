"""Parity of the port's frame codec (``serve/frame.py``, ``serve/ipc.py``),
its parent-side replica client (``serve/procfleet.py:ReplicaProc``) and
``ProcessFaultPlan`` with ``combblas_tpu.serve``'s on the CPU, with no
subprocess.

Mirrors the nine stub-level cases of ``tests/test_serve_procfleet.py``
through both packages: the channel round trip, the ``__spf__`` and bf16
codecs, a send that outlives the reader's poll tick, the frame cap, the
replica client over an in-process stub responder (deadlines, the error
taxonomy over the wire, heartbeats, quarantine, local backpressure, a
broken channel) and the deterministic fault plan. What each package
observed is held equal. Added: ``encode`` gives the reference's bytes for
the same message; a CPU ``torch.Tensor`` rides as an ``__ndb__`` array
(a bfloat16 one raises, never a repr); and the policy split of a child's
CUDA error: the process fleet retries the read on the other replica and,
once the child's heartbeat says it stopped serving, quarantines and
replaces it, while the thread fleet (one context) is ``down`` and heals
nothing; and the port's real child loop, run on a thread over a
socketpair, turns its ``Server``'s CUDA error into a ``serving: false``
heartbeat that ``ProcessFleet._dead`` reads, and fails a boot whose
warm-up meets one.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import combblas_tpu.serve.frame as jframe
import combblas_tpu.serve.ipc as jipc
import combblas_tpu.serve.procfleet as jproc
import combblas_tpu_torch.serve.frame as tframe
import combblas_tpu_torch.serve.ipc as tipc
import combblas_tpu_torch.serve.procfleet as tproc
from torch_serve_parity import NAMES, PKG, grid, isolated  # noqa: F401

IPC = {"jax": jipc, "torch": tipc}
FRAME = {"jax": jframe, "torch": tframe}
PROC = {"jax": jproc, "torch": tproc}
CUDA_ERR = "CUDA error: an illegal memory access was encountered"


def _pair(name, peer=None):
    a, b = socket.socketpair()
    return IPC[name].Channel(a, peer=peer), IPC[name].Channel(b)


# --- IPC framing (no processes) ----------------------------------------------


def test_ipc_channel_roundtrip_with_ndarrays():
    got = {}
    for name in NAMES:
        ca, cb = _pair(name)
        msg = {"id": 1, "ok": True,
               "result": {"levels": np.arange(6, dtype=np.int32).reshape(2, 3),
                          "n": np.int64(7), "f": np.float32(0.5)}}
        ca.send(msg)
        g = cb.recv(timeout=5)  # arrays rebuilt by decode()
        np.testing.assert_array_equal(g["result"]["levels"], np.arange(6).reshape(2, 3))
        assert g["result"]["levels"].dtype == np.int32
        assert g["result"]["n"] == 7
        # a closed peer is a clean ChannelClosed, never a desync
        ca.close()
        with pytest.raises(IPC[name].ChannelClosed):
            cb.recv(timeout=5)
        cb.close()
        got[name] = (g, ca.bytes_out, cb.bytes_in)
    assert got["torch"][1:] == got["jax"][1:]
    assert repr(got["torch"][0]) == repr(got["jax"][0])


def test_ipc_sparse_frontier_and_bf16_roundtrip():
    """The ``__spf__`` envelope round-trips a SparseFrontier (rows int32,
    lanes uint8, optional vals f32), the width bound holds at
    construction, and bf16 pack/unpack is round-to-nearest-even with
    |err| <= 2^-8 relative; both packages give the same bits."""
    q = np.array([0.0, 1.0, -2.5, 3.140625, 1e-3, 7e4], np.float32)
    packed = {}
    for name in NAMES:
        F = FRAME[name]
        ca, cb = _pair(name)
        sf = F.SparseFrontier(40, 3, np.array([1, 7, 39]), np.array([0, 2, 1]))
        sfv = F.SparseFrontier(40, 3, np.array([5]), np.array([1]), np.array([0.25]))
        ca.send({"id": 1, "ok": True, "result": {"xs": sf, "ds": sfv}})
        got = cb.recv(timeout=5)["result"]
        for orig, back in ((sf, got["xs"]), (sfv, got["ds"])):
            assert isinstance(back, F.SparseFrontier)
            assert (back.n, back.width, back.nnz) == (orig.n, orig.width, orig.nnz)
            np.testing.assert_array_equal(back.rows, orig.rows)
            assert back.rows.dtype == np.int32
            np.testing.assert_array_equal(back.lanes, orig.lanes)
            assert back.lanes.dtype == np.uint8
        assert got["xs"].vals is None
        np.testing.assert_array_equal(got["ds"].vals, [0.25])
        assert got["ds"].vals.dtype == np.float32
        dense = got["xs"].to_dense(np.int32(-1))
        assert dense.shape == (40, 3)
        assert dense[7, 2] == 7 and dense[0, 0] == -1
        assert got["xs"].nbytes() == 3 * (4 + 1)
        ca.close()
        cb.close()
        with pytest.raises(ValueError, match="width"):
            F.SparseFrontier(10, 257, np.zeros(0), np.zeros(0))
        back = F.unpack_bf16(F.pack_bf16(q))
        np.testing.assert_array_equal(back[:4], q[:4])  # representable
        assert np.all(np.abs(back - q) <= np.abs(q) * 2.0 ** -8)
        packed[name] = (F.pack_bf16(q), back)
    for x, y in zip(packed["jax"], packed["torch"]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_ipc_send_survives_reader_poll_timeout():
    """A reader polling ``recv`` with a short tick must not impose that
    tick on a concurrent send of a frame bigger than the socket buffer
    to a peer slow to drain: the chunked sender keeps partial progress."""
    for name in NAMES:
        ca, cb = _pair(name)
        stop = threading.Event()

        def _reader_ticks(ca=ca, stop=stop, closed=IPC[name].ChannelClosed):
            while not stop.is_set():
                try:
                    ca.recv(timeout=0.02)
                except socket.timeout:
                    continue
                except closed:
                    return

        t = threading.Thread(target=_reader_ticks, daemon=True)
        t.start()
        big = {"id": 1, "blob": np.arange(1 << 20, dtype=np.int64)}  # 8 MB
        got: dict = {}

        def _slow_drain(cb=cb, got=got):
            time.sleep(1.0)  # peer busy "importing its runtime"
            got.update(cb.recv(timeout=30))

        d = threading.Thread(target=_slow_drain, daemon=True)
        d.start()
        ca.send(big)
        d.join(timeout=30)
        stop.set()
        assert not d.is_alive()
        np.testing.assert_array_equal(got["blob"], big["blob"])
        ca.close()
        cb.close()
        t.join(timeout=5)
        assert not t.is_alive()


def test_ipc_oversized_frame_refused():
    for name in NAMES:
        ca, cb = _pair(name)
        big = "x" * (IPC[name].MAX_FRAME + 1)
        with pytest.raises(ValueError, match="too large"):
            ca.send({"blob": big})
        ca.close()
        cb.close()
    assert tipc.MAX_FRAME == jipc.MAX_FRAME and tframe.SEND_TIMEOUT_S == jframe.SEND_TIMEOUT_S


def test_encode_gives_the_reference_bytes():
    """One message of arrays of several dtypes, numpy scalars, nested
    lists and a SparseFrontier: the port's frame body is the reference's,
    byte for byte, and each package decodes the other's."""
    r = np.random.default_rng(3)
    msg = {"id": 9, "ok": True, "result": {
        "levels": r.integers(-1, 9, (5, 3)).astype(np.int32),
        "parents": r.integers(0, 64, 17).astype(np.int64),
        "dist": r.random(7).astype(np.float32), "ranks": r.random((2, 2)),
        "mask": r.random(4) > 0.5, "empty": np.zeros((0, 3), np.float32),
        "n": np.int64(7), "f": np.float32(0.25), "b": np.bool_(True),
        "nested": [1, (2.5, "x"), None, {"k": np.arange(3, dtype=np.uint8)}]}}
    bodies = {}
    for name in NAMES:
        F = FRAME[name]
        m = dict(msg, result=dict(msg["result"], spf=F.SparseFrontier(
            40, 3, np.array([1, 7]), np.array([0, 2]), np.array([0.5, 1.5]))))
        bodies[name] = F.encode(m)
    assert bodies["torch"] == bodies["jax"]
    (hl,) = struct.unpack(">I", bodies["torch"][:4])
    assert b'"__ndb__":"<i4"' in bodies["torch"][4:4 + hl]
    for a, b in (("jax", "torch"), ("torch", "jax")):
        got = FRAME[b].decode(bodies[a])["result"]
        for k in ("levels", "parents", "dist", "ranks", "mask", "empty"):
            assert got[k].dtype == msg["result"][k].dtype
            assert np.array_equal(got[k], msg["result"][k])
        assert isinstance(got["spf"], FRAME[b].SparseFrontier)


def test_torch_tensor_rides_as_an_array():
    """A CPU tensor is hoisted as an ``__ndb__`` array (one host
    transfer), the same bytes as its numpy twin; a bfloat16 tensor, which
    numpy cannot hold, raises instead of going out as its repr."""
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    w = torch.linspace(0, 1, 5, requires_grad=True)
    body = tframe.encode({"levels": t, "w": w})
    assert body == jframe.encode({"levels": t.numpy(), "w": w.detach().numpy()})
    assert b"tensor(" not in body
    got = tframe.decode(body)
    assert np.array_equal(got["levels"], t.numpy()) and got["levels"].dtype == np.int32
    with pytest.raises(TypeError, match="bfloat16"):
        tframe.encode({"x": torch.ones(3, dtype=torch.bfloat16)})


# --- parent-side replica client over a stub responder ------------------------


def _stub_replica(name, idx=0, answers=None, **kw):
    """A ReplicaProc whose 'child' is an in-process responder thread —
    the parent-side bookkeeping (deadline sweep, heartbeat tracking,
    error mapping, quarantine) without spawning an interpreter.
    ``answers[op]`` overrides a reply: a dict is the result, a string the
    RuntimeError's text. Returns (replica, stop event, child channel,
    heartbeat sender)."""
    a, b = socket.socketpair()
    ipc = IPC[name]
    stop = threading.Event()
    ch_child = ipc.Channel(b)
    answers = answers or {}

    def responder():
        while not stop.is_set():
            try:
                m = ch_child.recv(timeout=0.05)
            except socket.timeout:
                continue
            except ipc.ChannelClosed:
                return
            op = m.get("op")
            if op in answers:
                ans = answers[op]
                if isinstance(ans, str):
                    ch_child.send({"id": m["id"], "ok": False, "etype": "RuntimeError",
                                   "error": ans})
                else:
                    ch_child.send({"id": m["id"], "ok": True, "result": ans})
            elif op == "ping":
                ch_child.send({"id": m["id"], "ok": True, "result": {"pong": True}})
            elif op == "hang":
                pass  # never answers: the deadline sweep's case
            elif op == "badroot":
                ch_child.send({"id": m["id"], "ok": False, "etype": "ValueError",
                               "error": "root out of range"})
            elif op == "busy":
                ch_child.send({"id": m["id"], "ok": False, "etype": "BackpressureError",
                               "error": "queue full", "retry_after_s": 0.02})
            elif op == "hb":
                ch_child.send({"hb": {"depth": 3, "serving": True, "t": time.time()}})

    threading.Thread(target=responder, daemon=True).start()
    rp = PROC[name].ReplicaProc(idx, None, ipc.Channel(a), **kw)
    return rp, stop, ch_child, lambda hb: ch_child.send({"hb": hb})


def _wait(cond, limit=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < limit
        time.sleep(0.005)


def test_replica_client_rpc_deadline_and_error_mapping():
    seen = {}
    for name in NAMES:
        P = PKG[name]
        rp, stop, _ch, _hb = _stub_replica(name, ipc_timeout_s=30.0)
        try:
            assert rp.call("ping")["pong"] is True
            # per-request deadline: a hung op fails ITS future with the
            # replica-level (read-retried) error — the router never wedges
            f = rp.rpc("hang", timeout_s=0.2)
            with pytest.raises(PROC[name].IpcTimeoutError):
                f.result(timeout=10)
            assert rp.ipc_timeouts == 1
            # child-side taxonomy survives the wire
            with pytest.raises(ValueError):
                rp.rpc("badroot", timeout_s=5).result(timeout=10)
            exc = rp.rpc("busy", timeout_s=5).exception(timeout=10)
            assert isinstance(exc, P.BackpressureError)
            # heartbeats update the hang detector's clock
            rp.rpc("hb", timeout_s=5)
            _wait(lambda: rp.last_hb.get("depth") == 3, 5)
            assert rp.heartbeat_age() < 5
            assert rp.depth() >= 3  # hb depth counts toward routing load
            seen[name] = (str(exc), exc.retry_after_s, rp.rpcs, rp.ipc_timeouts)
        finally:
            stop.set()
            rp.quarantine(P.ReplicaDeadError("teardown"))
    assert seen["torch"] == seen["jax"]


def test_replica_client_quarantine_fails_pending_honestly():
    for name in NAMES:
        P = PKG[name]
        rp, stop, _ch, _hb = _stub_replica(name)
        try:
            f = rp.rpc("hang", timeout_s=60)
            n = rp.quarantine(P.ReplicaDeadError("replica 0 died"))
            assert n == 1
            assert isinstance(f.exception(timeout=5), P.ReplicaDeadError)
            assert not rp.is_serving()
            with pytest.raises(P.ReplicaDeadError):
                rp.rpc("ping")
            assert rp.quarantine(P.ReplicaDeadError("again")) == 0
        finally:
            stop.set()


def test_replica_client_local_backpressure_bound():
    for name in NAMES:
        P = PKG[name]
        rp, stop, _ch, _hb = _stub_replica(name, max_inflight=2)
        try:
            rp.rpc("hang", timeout_s=60)
            rp.rpc("hang", timeout_s=60)
            with pytest.raises(P.BackpressureError):
                rp.submit("bfs", 1)
        finally:
            stop.set()
            rp.quarantine(P.ReplicaDeadError("teardown"))


def test_broken_channel_fails_pending_and_marks_dead():
    for name in NAMES:
        P = PKG[name]
        rp, stop, ch_child, _hb = _stub_replica(name)
        try:
            f = rp.rpc("hang", timeout_s=60)
            ch_child.close()  # the process died: EOF on the socket
            assert isinstance(f.exception(timeout=10), P.ReplicaDeadError)
            _wait(lambda: rp.broken, 5)
            assert not rp.is_serving()
        finally:
            stop.set()


# --- deterministic process fault plan ----------------------------------------


def test_process_fault_plan_is_deterministic():
    got = {}
    for name in NAMES:
        plan = PKG[name].ProcessFaultPlan()
        plan.sigkill(2, replica="home").sigstop(4, replica=1)
        fired = []
        for _ in range(6):
            fired.extend(plan.step())
        assert fired == [("SIGKILL", "home"), ("SIGSTOP", 1)]
        assert plan.stats()["calls"] == 6
        assert [f[0] for f in plan.stats()["fired"]] == [2, 4]
        # unarmed plans cost one attribute read and fire nothing
        assert PKG[name].ProcessFaultPlan().step() == []
        got[name] = plan.stats()
    assert got["torch"] == got["jax"]


# --- a child's CUDA error: one replica's in the process fleet ----------------


def _stub_fleet(name, tmp_path, replicas):
    """A ProcessFleet over stub replicas (no subprocess): the policy,
    supervision and health of the real class."""
    P = PKG[name]
    fr = PROC[name].ProcessFleet(
        grid_shape=(1, 1), kinds=("bfs",), config=P.ServeConfig(),
        wal_dir=str(tmp_path / f"wal-{name}"), workdir=str(tmp_path / f"proc-{name}"),
        boot_ckpt=str(tmp_path / "unused.npz"), hb_timeout_s=5.0,
        **({"device": "cpu"} if name == "torch" else {}))
    fr.replicas = list(replicas)
    fr._init_policy()
    return fr


def test_child_cuda_error_is_one_replicas(tmp_path):
    """Replica 1's child answers a read with a CUDA error: the read is
    retried on replica 0 in both packages (the reference retries every
    replica-level error). In the port the child's heartbeat then reports
    ``serving: false`` with the error: routing skips it, the fleet is
    ``degraded`` (not ``down``), and ``supervise_once`` quarantines the
    slot and respawns it, backing off after a respawn that fails; health
    is ``ok`` again."""
    good = {"levels": np.arange(4, dtype=np.int32)}
    got = {}
    for name in NAMES:
        stubs = [_stub_replica(name, idx=0, answers={"submit": good}),
                 _stub_replica(name, idx=1, answers={"submit": CUDA_ERR})]
        fr = _stub_fleet(name, tmp_path, [s[0] for s in stubs])
        try:
            first = fr.submit("bfs", 3).result(timeout=10)  # rotation: replica 0
            second = fr.submit("bfs", 3).result(timeout=10)  # replica 1, retried on 0
            assert fr.submitted == [2, 1] and fr.read_retries == 1
            got[name] = (first, second, list(fr.submitted), fr.read_retries)
            if name == "torch":
                assert fr.device_error() is None
                err = f"RuntimeError('{CUDA_ERR}')"
                stubs[1][3]({"depth": 0, "serving": False, "device_error": err,
                             "t": time.time()})
                _wait(lambda: fr.replicas[1].last_hb.get("serving") is False)
                assert fr._route_order() == [0]
                h = fr.health()
                assert h["status"] == "degraded" and h["device_error"] is None
                assert h["replicas"][1]["status"] == "down"
                assert h["replicas"][1]["device_error"] == err
                spawned = []

                def _spawn(i, recover, home):
                    spawned.append((i, recover, home))
                    if len(spawned) == 1:  # the first respawn fails to boot
                        raise RuntimeError("replica 1 failed to boot")
                    rp = _stub_replica(name, idx=i, answers={"submit": good})
                    stubs.append(rp)
                    return rp[0]

                fr._spawn = _spawn
                old = fr.replicas[1]
                out = fr.supervise_once()
                assert out == {"detected": [1], "promoted": None, "replaced": []}
                assert old.quarantined and fr.respawn_failures == 1
                # backing off: the next tick leaves the slot alone
                assert fr.supervise_once()["replaced"] == [] and len(spawned) == 1
                fr._respawn_next[1] = 0.0  # the backoff ran out
                out = fr.supervise_once()
                assert out == {"detected": [1], "promoted": None, "replaced": [1]}
                assert spawned == [(1, True, False)] * 2 and not fr._respawn_backoff
                assert fr.replacements == 1 and fr.health()["status"] == "ok"
                again = fr.submit("bfs", 3).result(timeout=10)
                assert np.array_equal(again["levels"], good["levels"])
        finally:
            for rp, stop, _ch, _hb in stubs:
                stop.set()
                rp.quarantine(PKG[name].ReplicaDeadError("teardown"))
            fr._fan_pool.shutdown(wait=False)
    assert repr(got["torch"]) == repr(got["jax"])


def test_thread_fleet_cuda_error_stays_down(tmp_path):
    """The same error in a thread fleet replica is the card's: the read
    is not retried, the fleet is ``down`` with the error, and
    ``supervise_once`` heals nothing."""
    P = PKG["torch"]
    rows = np.array([0, 1, 1, 2, 2, 3], np.int64)
    cols = np.array([1, 0, 2, 1, 3, 2], np.int64)
    fr = P.FleetRouter.build(grid("torch"), rows, cols, 4, replicas=2, kinds=("bfs",),
                             config=P.ServeConfig(lane_widths=(1,)))
    try:
        assert fr.submit("bfs", 0).result(timeout=60)["levels"][3] == 3

        def boom(kind, sources):
            raise RuntimeError(CUDA_ERR)

        fr.replicas[1].engine.execute = boom
        f = fr.submit("bfs", 0)  # rotation: replica 1
        assert CUDA_ERR in str(f.exception(timeout=60))
        assert fr.read_retries == 0
        h = fr.health()
        assert h["status"] == "down" and CUDA_ERR in h["device_error"]
        # replica 1's worker then dies too (the replica.death fault)
        fr.replicas[1].faults.script("replica.death", at=(0,))
        fr.replicas[1].submit("bfs", 1)
        _wait(lambda: fr._dead(1))
        assert fr.supervise_once() == {"detected": [], "promoted": None, "replaced": []}
        assert fr.replacements == 0
    finally:
        fr.close(drain=False)


# --- the port's real child loop, in process -----------------------------------


def _inproc_child(tmp_path):
    """The port's child loop (``ProcWorker.run``) on a thread of this
    process, over a socketpair, with a ``ReplicaProc`` on the other end:
    what ``ProcessFleet._launch`` gives, without an interpreter. Returns
    (worker, its thread, replica, a tiny CPU snapshot to boot from)."""
    from combblas_tpu_torch.serve._procworker import ProcWorker
    from combblas_tpu_torch.utils import checkpoint

    rows = np.array([0, 1, 1, 2], np.int64)
    cols = np.array([1, 0, 2, 1], np.int64)
    eng = PKG["torch"].GraphEngine.from_coo(grid("torch"), rows, cols, 3, kinds=("bfs",))
    ckpt = str(tmp_path / "boot.npz")
    checkpoint.save_version(ckpt, eng.version)
    a, b = socket.socketpair()
    w = ProcWorker(tipc.Channel(a, peer="parent"))
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    return w, t, tproc.ReplicaProc(0, None, tipc.Channel(b, peer="replica0")), ckpt


def _booting_fleet(tmp_path, rp, ckpt):
    """A one-replica port fleet whose boot message names ``ckpt`` on the
    CPU, one lane wide, with a 20 ms heartbeat."""
    fr = _stub_fleet("torch", tmp_path, [rp])
    fr.boot_ckpt, fr.hb_interval_s = ckpt, 0.02
    fr.config = PKG["torch"].ServeConfig(lane_widths=(1,))
    return fr


def test_child_heartbeat_carries_its_cuda_error(tmp_path):
    """The wiring of a child's CUDA error end to end: once the child's
    ``Server`` holds one, ``Server.is_serving()`` is false, the next
    heartbeat says ``serving: false`` with the error's repr, and
    ``ProcessFleet._dead`` takes the replica for dead."""
    w, t, rp, ckpt = _inproc_child(tmp_path)
    fr = _booting_fleet(tmp_path, rp, ckpt)
    try:
        boot = rp.call("boot", fr._boot_msg(0, recover=False, home=False), timeout_s=60)
        assert boot["device"] == "cpu"
        fr._admit_boot(rp, boot)
        _wait(lambda: "t" in rp.last_hb)  # the child's own first beat
        assert rp.last_hb["serving"] is True and rp.last_hb["device_error"] is None
        assert not fr._dead(0)
        err = RuntimeError(CUDA_ERR)
        w.srv.device_error = err
        assert not w.srv.is_serving()
        _wait(lambda: rp.last_hb.get("serving") is False)
        assert rp.last_hb["device_error"] == repr(err)
        assert fr._dead(0) and fr.device_error() is None
    finally:
        rp.call("close", {"drain": False, "timeout": 10}, timeout_s=30)
        t.join(30)
        rp.quarantine(PKG["torch"].ReplicaDeadError("teardown"))
        fr._fan_pool.shutdown(wait=False)
    assert not t.is_alive()


def test_child_cuda_error_in_warmup_fails_its_boot(tmp_path, monkeypatch):
    """A CUDA error in the boot's warm-up fails the boot instead of
    joining a poisoned context to the fleet: ``_spawn`` raises it and
    quarantines the new child, and the heartbeat thread never starts."""
    from combblas_tpu_torch.serve import api

    def warmup(self):
        raise RuntimeError(CUDA_ERR)

    monkeypatch.setattr(api.Server, "warmup", warmup)
    w, t, rp, ckpt = _inproc_child(tmp_path)
    fr = _booting_fleet(tmp_path, rp, ckpt)
    fr._launch = lambda i: rp
    try:
        with pytest.raises(RuntimeError, match=CUDA_ERR):
            fr._spawn(0, recover=False, home=False)
        assert rp.quarantined and w.srv is not None
        time.sleep(0.1)
        assert rp.last_hb == {}  # no beat: the boot never finished
        t.join(10)  # the quarantine closed the channel: the loop ends
        assert not t.is_alive()
    finally:
        if w.srv is not None:
            w.srv.close(drain=False)  # a SIGKILL ends these threads in a real child
        fr._fan_pool.shutdown(wait=False)
