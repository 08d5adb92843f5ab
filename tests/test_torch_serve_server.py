"""Parity of the port's ``Server`` (``serve/api.py``, through
``GraphEngine.serve``) with ``combblas_tpu.serve.Server`` on the CPU.

Both packages' servers serve the same R-MAT graph (scale 7 on 2x2, from
a numpy seed, unit weights for SSSP) and the same roots. Mirrors the
``Server`` cases of ``tests/test_serve.py``: close drains without a
started worker, ``submit_many`` over a generator, lane copies, result
mapping, concurrent submit, backpressure, a malformed root, timeouts
(queue sweep, a re-entrant done-callback, the tightened flush deadline)
and a closed server; its stress case stays ``slow``. A further case
serves every kind through both servers on 1x1 (scale 8), 2x2 (scale 7)
and 2x4 (scale 9).

Results are compared with ``torch_serve_parity.same_result``: BFS
parents and levels and SSSP distances bit for bit, PageRank ranks and BC
scores within ``rtol=1e-5``, ``atol = 1e-6 · max |x|``.
"""

import threading
import time

import numpy as np
import pytest

from combblas_tpu_torch import PAD_ROOT
from combblas_tpu_torch.utils.rmat import rmat_symmetric_coo_host
from torch_serve_parity import NAMES, PKG, grid, isolated, outcome, same_outcomes  # noqa: F401

SCALE = 7
N = 1 << SCALE
KINDS = ("bfs", "sssp", "pagerank", "bc")


def _graph(scale):
    rows, cols = rmat_symmetric_coo_host(3, scale, 8)
    live = np.flatnonzero(np.bincount(rows, minlength=1 << scale)).astype(np.int32)
    return rows, cols, live


def _engines(scale, shape, kinds=KINDS):
    rows, cols, _ = _graph(scale)
    w = np.ones(len(rows), np.float32)
    return {name: PKG[name].GraphEngine.from_coo(grid(name, shape), rows, cols, 1 << scale,
                                                 weights=w, kinds=kinds)
            for name in NAMES}


@pytest.fixture(scope="module")
def live_roots():
    return _graph(SCALE)[2]


@pytest.fixture(scope="module")
def engines():
    return _engines(SCALE, (2, 2))


def lanes(res: dict) -> dict:
    """A result's per-lane arrays, without the batch's iteration count."""
    return {k: v for k, v in res.items() if k != "batch_niter"}


def cfg(name, **kw):
    return PKG[name].ServeConfig(**kw)


@pytest.mark.parametrize("scale,shape", [(8, (1, 1)), (7, (2, 2)), (9, (2, 4))],
                         ids=["1x1", "2x2", "2x4"])
def test_served_kinds_match_reference(scale, shape):
    """Six roots of every kind through each package's ``Server`` (4-lane
    buckets: one full batch and one padded): equal dispositions and
    lanes, equal batch accounting, and each lane equal to the engine's
    direct ``execute`` of the same bucket."""
    engs = _engines(scale, shape)
    live = _graph(scale)[2]
    roots = [int(r) for r in live[[0, 3, 5, 11, 17, 2]]]
    got = {}
    for name, eng in engs.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        futs = {k: srv.submit_many(k, roots) for k in KINDS}
        assert srv.pump(force=True) == 2 * len(KINDS)
        got[name] = {k: [outcome(f) for f in fs] for k, fs in futs.items()}
        st = srv.stats()
        got[name]["stats"] = (st["batches"], st["completed"], st["mean_occupancy"],
                              st["submitted"], st["queue_depth"])
        for k in KINDS:
            src = np.array(roots[4:] + [PAD_ROOT] * 2, np.int32)
            direct = eng.execute(k, src)
            for lane, (_, res) in enumerate(got[name][k][4:]):
                for key, arr in direct.items():
                    if isinstance(arr, np.ndarray):
                        assert np.array_equal(res[key], arr[..., lane]), (k, key)
        srv.close()
    for k in KINDS:
        same_outcomes(got["jax"][k], got["torch"][k])
        for r, (status, res) in zip(roots, got["torch"][k]):
            assert status == "ok"
            if k == "bfs":
                assert res["levels"][r] == 0 and res["parents"][r] == r
    assert got["torch"]["stats"] == got["jax"]["stats"] == (8, 24, 0.75, 24, 0)


def test_close_drains_without_started_worker(engines, live_roots):
    """close(drain=True) on a server whose worker never started still
    executes the queue in the caller's thread."""
    got = {}
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        f = srv.submit("bfs", int(live_roots[0]))
        srv.close()  # no start(): the caller's thread drains
        assert f.result(timeout=0)["levels"][int(live_roots[0])] == 0
        assert srv.health()["status"] == "closed"
        got[name] = [outcome(f)]
    same_outcomes(got["jax"], got["torch"])


def test_submit_many_generator_keeps_future_per_root(engines, live_roots):
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(16,), max_queue=2, max_wait_s=60.0))
        roots = [int(r) for r in live_roots[:5]]
        futs = srv.submit_many("bfs", (r for r in roots))
        assert len(futs) == len(roots)
        assert [f.done() for f in futs] == [False, False, True, True, True]
        assert all(isinstance(f.exception(timeout=0), P.BackpressureError) for f in futs[2:])
        assert srv.scheduler.fail_pending(RuntimeError("test teardown")) == 2


def test_scatter_returns_lane_copies(engines, live_roots):
    """Per-request results are copies, not views pinning the batch."""
    got = {}
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=0.01))
        f = srv.submit("bfs", int(live_roots[0]))
        srv.pump(force=True)
        res = f.result(timeout=0)
        assert all(v.base is None for v in res.values() if isinstance(v, np.ndarray))
        got[name] = [outcome(f)]
    same_outcomes(got["jax"], got["torch"])


def test_results_map_to_request_ids(engines, live_roots):
    """5 requests flush as one width-8 batch: every future gets its own
    root's answer, pad lanes reach nobody, occupancy 5/8."""
    from combblas_tpu_torch.models.bfs import bfs

    got = {}
    roots = [int(r) for r in live_roots[[9, 1, 5, 13, 2]]]
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(8,), max_wait_s=0.01))
        srv.warmup(kinds=("bfs",), widths=(8,))
        futs = [srv.submit("bfs", r) for r in roots]
        assert srv.pump(force=True) == 1  # one coalesced batch
        assert srv.stats()["mean_occupancy"] == pytest.approx(5 / 8)
        got[name] = [("ok", lanes(f.result(timeout=0))) for f in futs]
    same_outcomes(got["jax"], got["torch"])
    for r, (_, res) in zip(roots, got["torch"]):
        _, l1, _ = bfs(engines["torch"].E, r)
        np.testing.assert_array_equal(res["levels"], l1.to_global())
        assert res["levels"][r] == 0


def test_concurrent_submit_maps_results(engines, live_roots):
    """Under concurrent submit() from 4 threads every future maps to its
    own request; the port's lanes equal the reference's for each root."""
    roots = [int(r) for r in live_roots[:24]]
    got = {}
    for name, eng in engines.items():
        eng.warmup(kinds=("bfs",), widths=(1, 2, 4, 8))
        mark = eng.trace_mark()
        srv = eng.serve(cfg(name, lane_widths=(1, 2, 4, 8), max_wait_s=0.002)).start()
        results, errs = {}, []

        def worker(rs, srv=srv, results=results, errs=errs):
            try:
                for r in rs:
                    results[r] = srv.submit("bfs", r).result(timeout=60)
            except Exception as e:  # pragma: no cover - fail loudly
                errs.append(e)

        try:
            threads = [threading.Thread(target=worker, args=(roots[i::4],)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        finally:
            srv.close()
        assert not errs and len(results) == len(roots)
        for r, res in results.items():
            assert res["levels"][r] == 0, r
            assert (res["parents"] != PAD_ROOT).any()
        assert eng.retraces_since(mark) == 0
        assert srv.stats()["completed"] == len(roots)
        # batch_niter is the batch's: lane-mates depend on the timing
        got[name] = [("ok", lanes(results[r])) for r in roots]
    same_outcomes(got["jax"], got["torch"])


def test_backpressure_rejects_when_full(engines, live_roots):
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(16,), max_queue=3, max_wait_s=7.5))
        for r in live_roots[:3]:
            srv.submit("bfs", int(r))
        with pytest.raises(P.BackpressureError) as ei:
            srv.submit("bfs", int(live_roots[3]))
        assert ei.value.retry_after_s == pytest.approx(7.5)
        assert "queue full (3 pending)" in str(ei.value)
        assert srv.stats()["rejected"] == 1
        futs = srv.submit_many("bfs", [int(r) for r in live_roots[4:7]])
        assert len(futs) == 3
        assert all(isinstance(f.exception(timeout=0), P.BackpressureError) for f in futs)
        assert srv.stats()["per_kind"]["bfs"]["rejected"] == 2
        srv.scheduler.fail_pending(RuntimeError("test teardown"))


def test_malformed_root_fails_request_not_batch(engines, live_roots):
    """A bad root's future carries the ValueError; its batch-mates
    complete with the reference's lanes."""
    got = {}
    good = [int(r) for r in live_roots[:3]]
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=0.01))
        f_good = [srv.submit("bfs", r) for r in good]
        f_bad = srv.submit("bfs", N + 5)  # out of range
        f_bad2 = srv.submit("bfs", "not-a-root")
        f_bad3 = srv.submit("bfs", -3)
        for f in (f_bad, f_bad2, f_bad3):
            assert isinstance(f.exception(timeout=0), ValueError)
        srv.pump(force=True)
        for r, f in zip(good, f_good):
            assert f.result(timeout=0)["levels"][r] == 0
        with pytest.raises(ValueError):
            srv.submit("nope", good[0])  # unknown kind: a caller bug, raises
        assert srv.stats()["per_kind"]["bfs"]["invalid"] == 3
        got[name] = [outcome(f) for f in f_good + [f_bad, f_bad2, f_bad3]]
    same_outcomes(got["jax"], got["torch"])


def test_unknown_kind_raises_at_submit():
    rows, cols, _ = _graph(SCALE)
    for name in NAMES:
        eng = PKG[name].GraphEngine.from_coo(grid(name), rows, cols, N, kinds=("bfs",))
        with pytest.raises(ValueError, match="unknown query kind"):
            eng.serve().submit("sssp", 1)


def test_request_timeout_expires_in_queue(engines, live_roots):
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        f = srv.submit("bfs", int(live_roots[0]), timeout_s=0.001)
        time.sleep(0.01)
        srv.pump()  # the deadline sweep runs before batching
        assert isinstance(f.exception(timeout=0), TimeoutError)
        assert srv.stats()["per_kind"]["bfs"]["timeout"] == 1


def test_timeout_callback_may_resubmit(engines, live_roots):
    """Futures settle outside the scheduler lock: a done-callback that
    re-enters submit() must not deadlock the sweep."""
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        f = srv.submit("bfs", int(live_roots[0]), timeout_s=0.001)
        retried = []
        f.add_done_callback(lambda _f, srv=srv, retried=retried:
                            retried.append(srv.submit("bfs", int(live_roots[0]))))
        time.sleep(0.01)
        done = threading.Event()

        def sweep(srv=srv, done=done):
            srv.scheduler.pop_ready()
            done.set()

        threading.Thread(target=sweep, daemon=True).start()
        assert done.wait(10), "pop_ready deadlocked on re-entrant submit"
        assert isinstance(f.exception(timeout=0), TimeoutError)
        assert len(retried) == 1
        srv.scheduler.fail_pending(RuntimeError("test teardown"))


def test_short_timeout_tightens_flush_deadline(engines, live_roots):
    """A timeout shorter than the max-wait pulls the flush forward to
    half the timeout budget; at that time the batch flushes."""
    got = {}
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        t0 = time.monotonic()
        f = srv.submit("bfs", int(live_roots[0]), timeout_s=1.0)
        nd = srv.scheduler.next_deadline()
        assert nd is not None and nd - t0 == pytest.approx(0.5, abs=0.1)
        assert not srv.scheduler.pop_ready(now=t0 + 0.3)
        ready = srv.scheduler.pop_ready(now=t0 + 0.6)
        assert ready
        srv._execute_batches(ready)
        assert f.done() and f.exception(timeout=0) is None
        got[name] = [outcome(f)]
    same_outcomes(got["jax"], got["torch"])


def test_closed_server_rejects_submit(engines, live_roots):
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=0.01))
        srv.close()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit("bfs", int(live_roots[0]))
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit("bfs", N + 5)  # malformed root: same close semantics
        with pytest.raises(RuntimeError, match="closed"):
            srv.start()
        assert not srv.is_serving()


def test_health_and_stats_keys_match_reference(engines, live_roots):
    """``health()`` and ``stats()`` carry the reference's keys (the port
    adds ``device_error`` to ``health()``) with equal values for what is
    not a clock reading."""
    got = {}
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0, slo_deadline_s=30.0))
        srv.submit_many("bfs", [int(r) for r in live_roots[:3]])
        srv.pump(force=True)
        h, st = srv.health(), srv.stats()
        for d in (h, st):
            d.pop("graph_version", None)
        got[name] = (h, st)
        srv.close()
    (jh, jst), (th, tst) = got["jax"], got["torch"]
    assert set(th) == set(jh) | {"device_error"} and th["device_error"] is None
    for key in ("status", "worker_alive", "closed", "queue_depth", "worker_errors", "breakers",
                "updates_pending", "durable", "checkpoints", "tenant"):
        assert th[key] == jh[key], key
    assert th["slo"] == jh["slo"]
    for key in ("batches", "completed", "submitted", "rejected", "per_kind", "mean_occupancy",
                "lane_widths", "max_queue", "updates", "durability", "faults", "queue_depth"):
        assert tst[key] == jst[key], key
    assert set(tst) >= set(jst) - {"traces"}


@pytest.mark.slow
def test_serve_stress_throughput(engines, live_roots):
    """200 mixed queries through the threaded worker: everything
    completes, batches coalesce, warm plans are not rebuilt, and the
    port's lanes equal the reference's."""
    got = {}
    for name, eng in engines.items():
        eng.warmup(kinds=("bfs", "pagerank"), widths=(1, 2, 4, 8, 16))
        mark = eng.trace_mark()
        srv = eng.serve(cfg(name, lane_widths=(1, 2, 4, 8, 16), max_wait_s=0.005,
                            max_queue=512)).start()
        try:
            kinds = ["bfs", "pagerank"]
            futs = [srv.submit(kinds[i % 2], int(live_roots[i % len(live_roots)]))
                    for i in range(200)]
            done = [f.result(timeout=300) for f in futs]
            assert len(done) == 200
            st = srv.stats()
            assert st["completed"] == 200 and st["batches"] < 200
            assert eng.retraces_since(mark) == 0
        finally:
            srv.close()
        got[name] = [("ok", lanes(f.result(timeout=0))) for f in futs]
    same_outcomes(got["jax"], got["torch"])
