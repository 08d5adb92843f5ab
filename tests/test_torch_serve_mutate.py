"""Parity of the port's write lane (``Server.submit_update``, the
mutation thread, ``pump_updates``) with ``combblas_tpu.serve`` on the
CPU.

Mirrors every case of ``tests/test_serve_mutate.py``: the end-to-end
write, deterministic coalescing through ``pump_updates``, backpressure,
an invalid batch, the host edge list requirement, the merge fault
(``chaos``), closing with and without drain (a live mutator included)
and mixed reads and writes under load. Both packages build the same
random symmetric graph (``default_rng(0)``, as the reference's ``rng``
fixture) on 2x2 and take the same writes: merge modes, versions, op
counts, every merged edge set (``to_host_coo``) and the lanes served
after a write (BFS bit for bit, PageRank within ``rtol=1e-5``,
``atol = 1e-6 · max |x|``) are held equal.
"""

import threading
import time

import numpy as np
import pytest

from torch_serve_parity import (  # noqa: F401
    NAMES, PKG, grid, isolated, outcome, same_edges, same_outcomes,
)


def _engines(n=96, m=500, grid_shape=(2, 2), kinds=("bfs",), seed=0):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    return {name: PKG[name].GraphEngine.from_coo(grid(name, grid_shape), rows, cols, n,
                                                 kinds=kinds, keep_coo=True)
            for name in NAMES}


def _absent_pair(engine, avoid=()):
    r0, c0, _ = engine.version.host_coo
    present = set(zip(np.asarray(r0).tolist(), np.asarray(c0).tolist()))
    n = engine.nrows
    return next((a, b) for a in range(n) for b in range(n)
                if a != b and (a, b) not in present and (a, b) not in avoid)


def cfg(name, **kw):
    return PKG[name].ServeConfig(**kw)


def _coo_set(eng):
    r, c, _ = eng.version.host_coo
    return set(zip(np.asarray(r).tolist(), np.asarray(c).tolist()))


def _strip(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "merge_s"}


def test_submit_update_end_to_end():
    engs = _engines()
    got = {}
    for name, eng in engs.items():
        a, b = _absent_pair(eng)
        c = cfg(name, lane_widths=(1, 4), max_wait_s=0.005, update_flush=2,
                update_max_delay_s=0.01)
        with eng.serve(c) as srv:
            srv.warmup()
            mark = eng.trace_mark()
            v0 = eng.version_id
            res = srv.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=60)
            assert res["mode"] == "incremental" and res["version"] == v0 + 1
            out = srv.submit("bfs", a).result(timeout=60)
            assert out["levels"][b] == 1
            assert eng.retraces_since(mark) == 0
            st = srv.stats()["updates"]
            assert st["merges"] == 1 and st["by_mode"] == {"incremental": 1}
            assert st["pending"] == 0
        got[name] = (_strip(res), [("ok", out)], (a, b))
    assert got["torch"][0] == got["jax"][0] and got["torch"][2] == got["jax"][2]
    same_outcomes(got["jax"][1], got["torch"][1])
    same_edges(engs["jax"].version, engs["torch"].version)


def test_pump_updates_deterministic_and_ordered():
    """Worker-less: two queued updates coalesce into one merge through
    ``pump_updates(force=True)``; both futures see the same version."""
    engs = _engines()
    got = {}
    for name, eng in engs.items():
        srv = eng.serve(cfg(name, lane_widths=(1,), update_autostart=False, update_flush=100))
        a, b = _absent_pair(eng)
        a2, b2 = _absent_pair(eng, avoid={(a, b), (b, a)})
        f1 = srv.submit_update([("insert", a, b), ("insert", b, a)])
        f2 = srv.submit_update([("insert", a2, b2), ("insert", b2, a2)])
        assert not f1.done() and not f2.done()
        assert srv.pump_updates() == 0  # not due
        assert srv.pump_updates(force=True) == 4
        r1, r2 = f1.result(timeout=5), f2.result(timeout=5)
        assert r1["version"] == r2["version"] and r1["ops"] == 4
        assert {(a, b), (a2, b2)} <= _coo_set(eng)
        got[name] = (_strip(r1), _strip(r2), srv.stats()["updates"]["by_mode"])
        srv.close()
    assert got["torch"] == got["jax"]
    same_edges(engs["jax"].version, engs["torch"].version)


def test_update_backpressure_rejects():
    engs = _engines(n=32, m=100)
    for name, eng in engs.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(1,), update_autostart=False, update_buffer=3))
        srv.submit_update([("insert", 0, 1), ("insert", 1, 0)])
        with pytest.raises(P.BackpressureError) as ei:
            srv.submit_update([("insert", 2, 3), ("insert", 3, 2)])
        assert ei.value.retry_after_s >= 0
        assert srv.pump_updates(force=True) == 2
        srv.close()
    same_edges(engs["jax"].version, engs["torch"].version)


def test_update_invalid_isolated():
    engs = _engines(n=32, m=100)
    got = {}
    for name, eng in engs.items():
        srv = eng.serve(cfg(name, lane_widths=(1,), update_autostart=False))
        bad = srv.submit_update([("insert", 0, 1), ("insert", 99, 0)])
        bad2 = srv.submit_update([("rename", 0, 1)])
        for f in (bad, bad2):
            assert isinstance(f.exception(timeout=1), ValueError)
        st = srv.stats()["updates"]
        assert st["invalid"] == 2 and st["pending"] == 0
        got[name] = ([outcome(bad), outcome(bad2)], str(bad.exception()), str(bad2.exception()))
        srv.close()
    assert got["torch"] == got["jax"]


def test_update_requires_host_coo():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 32, 100)
    for name in NAMES:
        eng = PKG[name].GraphEngine.from_coo(grid(name), np.concatenate([r, r]),
                                             np.concatenate([r, r]), 32, kinds=("bfs",))
        srv = eng.serve(cfg(name, lane_widths=(1,)))
        with pytest.raises(ValueError, match="keep_coo"):
            srv.submit_update([("insert", 0, 1)])
        srv.close()


@pytest.mark.chaos
def test_update_merge_fault_isolated():
    """A merge fault fails exactly the updates it carried; the old version
    keeps serving and the next update merges."""
    engs = _engines()
    got = {}
    for name, eng in engs.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(1,), update_autostart=False))
        srv.faults.script("update.merge", [0])
        a, b = _absent_pair(eng)
        v0 = eng.version_id
        f1 = srv.submit_update([("insert", a, b), ("insert", b, a)])
        srv.pump_updates(force=True)
        assert isinstance(f1.exception(timeout=1), P.InjectedFault)
        assert eng.version_id == v0 and srv.stats()["updates"]["failed"] == 1
        f2 = srv.submit_update([("insert", a, b), ("insert", b, a)])
        srv.pump_updates(force=True)
        assert f2.result(timeout=5)["version"] == v0 + 1
        got[name] = (outcome(f1), _strip(f2.result(timeout=0)), srv.stats()["updates"]["failed"])
        srv.close()
    assert got["torch"] == got["jax"]
    same_edges(engs["jax"].version, engs["torch"].version)


def test_close_drains_pending_updates():
    engs = _engines()
    got = {}
    for name, eng in engs.items():
        srv = eng.serve(cfg(name, lane_widths=(1,), update_autostart=False))
        a, b = _absent_pair(eng)
        fut = srv.submit_update([("insert", a, b), ("insert", b, a)])
        srv.close(drain=True)
        assert fut.result(timeout=5)["mode"] == "incremental"
        assert (a, b) in _coo_set(eng)
        got[name] = _strip(fut.result(timeout=0))
    assert got["torch"] == got["jax"]
    same_edges(engs["jax"].version, engs["torch"].version)


def test_close_without_drain_fails_updates():
    engs = _engines()
    for name, eng in engs.items():
        srv = eng.serve(cfg(name, lane_widths=(1,), update_autostart=False))
        fut = srv.submit_update([("insert", 0, 1), ("insert", 1, 0)])
        srv.close(drain=False)
        assert isinstance(fut.exception(timeout=1), RuntimeError)
        assert "closed without drain" in str(fut.exception())
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit_update([("insert", 2, 3)])


def test_close_without_drain_aborts_live_mutator():
    """drain=False with a running mutation thread: the buffered write is
    abandoned (failed future, graph untouched)."""
    engs = _engines()
    for name, eng in engs.items():
        srv = eng.serve(cfg(name, lane_widths=(1,), update_flush=10_000,
                            update_max_delay_s=60.0)).start()
        a, b = _absent_pair(eng)
        v0 = eng.version_id
        fut = srv.submit_update([("insert", a, b), ("insert", b, a)])
        assert srv.health()["mutator_alive"]
        srv.close(drain=False)
        assert isinstance(fut.exception(timeout=5), RuntimeError)
        assert eng.version_id == v0 and (a, b) not in _coo_set(eng)


def test_mixed_read_write_under_load():
    """Concurrent readers and a writer through the threaded server: every
    read completes, every write merges in place, zero plan builds, the
    version advances; the final edge sets are equal (each insert is
    deleted again) and so are the lanes of reads served afterwards."""
    engs = _engines(n=128, m=700, kinds=("bfs", "pagerank"))
    rng = np.random.default_rng(0)
    first = engs["torch"]
    r0, c0, _ = first.version.host_coo
    deg = np.asarray(first.version.deg)
    roots = rng.choice(np.flatnonzero(deg > 0), size=64)
    slack = np.isin(deg, (5, 7, 9, 10, 11, 13, 14, 15))
    present = set(zip(np.asarray(r0).tolist(), np.asarray(c0).tolist()))
    pool = np.flatnonzero(slack).tolist()
    pairs = [(a, b) for a, b in zip(pool[0::2], pool[1::2]) if (a, b) not in present][:12]
    assert len(pairs) >= 4
    after = {}
    for name, eng in engs.items():
        c = cfg(name, lane_widths=(1, 2, 4), max_wait_s=0.002, update_flush=8,
                update_max_delay_s=0.005)
        with eng.serve(c) as srv:
            srv.warmup()
            mark = eng.trace_mark()
            v0 = eng.version_id
            write_futs = []
            stop = threading.Event()

            def writer(srv=srv, write_futs=write_futs, stop=stop):
                for k, (a, b) in enumerate(pairs + pairs):
                    if stop.is_set():
                        break
                    op = "insert" if k < len(pairs) else "delete"
                    try:
                        write_futs.append(srv.submit_update([(op, a, b), (op, b, a)]))
                    except PKG[name].BackpressureError:
                        pass
                    time.sleep(0.002)

            t = threading.Thread(target=writer)
            t.start()
            read_futs = [srv.submit(("bfs", "pagerank")[i % 2], int(root))
                         for i, root in enumerate(roots)]
            for f in read_futs:
                f.result(timeout=120)
            t.join(10)
            stop.set()
            for f in write_futs:
                f.result(timeout=60)
            st = srv.stats()
            assert st["updates"]["merges"] >= 1
            assert st["updates"]["by_mode"].get("rebuild", 0) == 0
            assert eng.version_id > v0
            assert eng.retraces_since(mark) == 0
            assert st["completed"] == len(roots)
        after[name] = [("ok", {k: v for k, v in eng.execute(kind, roots[:4].astype(np.int32))
                               .items() if k != "batch_niter"}) for kind in ("bfs", "pagerank")]
    same_edges(engs["jax"].version, engs["torch"].version)
    same_outcomes(after["jax"], after["torch"])
