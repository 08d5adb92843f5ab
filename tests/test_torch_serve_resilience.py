"""Parity of the port's resilient serving (``serve/api.py``'s recovery
ladder, the breakers, the worker backoff and hot swaps) with
``combblas_tpu.serve`` on the CPU.

Mirrors ``tests/test_serve_resilience.py``'s server cases: poisoned-batch
bisection, transient and persistent execute faults, the scatter fault,
execution-time expiry, the half-open probe released on a full queue, the
breaker opening, fast-failing and recovering, the admission fault in
``submit_many``, the worker's backoff, the swap cases and the hot swap
under load; the seeded chaos case keeps its ``chaos`` marker and the soak
``chaos`` and ``slow``. Both packages serve the same R-MAT graph (scale
7, 2x2, numpy seed) with the same fault schedules: dispositions, the
exception types, retry and batch counts and every lane that succeeds
(BFS bit for bit, PageRank within ``rtol=1e-5``,
``atol = 1e-6 · max |x|``) are held equal.
"""

import time
from concurrent.futures import Future

import numpy as np
import pytest

from combblas_tpu_torch.utils.rmat import rmat_symmetric_coo_host
from torch_serve_parity import NAMES, PKG, grid, isolated, outcome, same_outcomes  # noqa: F401

SCALE = 7
N = 1 << SCALE


@pytest.fixture(scope="module")
def graph():
    return rmat_symmetric_coo_host(5, SCALE, 8)


@pytest.fixture(scope="module")
def engines(graph):
    rows, cols = graph
    return {name: PKG[name].GraphEngine.from_coo(grid(name, (2, 2)), rows, cols, N,
                                                 kinds=("bfs", "pagerank"))
            for name in NAMES}


@pytest.fixture(scope="module")
def live_roots(graph):
    return np.flatnonzero(np.bincount(graph[0], minlength=N)).astype(np.int32)


def cfg(name, **kw):
    return PKG[name].ServeConfig(**kw)


def lanes(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "batch_niter"}


def kind_stats(srv, kind="bfs"):
    st = dict(srv.stats()["per_kind"][kind])
    br = st.pop("breaker", None)
    if br is not None:  # the clock readings differ between runs
        st["breaker"] = {k: v for k, v in br.items() if k not in ("retry_after_s", "open_for_s")}
    return st


# --- poisoned-batch isolation ------------------------------------------------


def test_poisoned_batch_bisection_isolates_one_request(engines, live_roots):
    """One poison request in a width-16 batch fails alone; its 15
    lane-mates succeed through bisection, equal to the reference's."""
    roots = [int(r) for r in live_roots[:16]]
    poison = roots[5]
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(16,), max_wait_s=60.0))
        srv.faults.when("engine.execute", lambda ctx: poison in ctx["roots"])
        futs = [srv.submit("bfs", r) for r in roots]
        srv.pump(force=True)
        for r, f in zip(roots, futs):
            assert f.done(), r
            if r == poison:
                assert isinstance(f.exception(timeout=0), P.InjectedFault)
            else:
                assert f.result(timeout=0)["levels"][r] == 0, r
        st = kind_stats(srv)
        assert st["poisoned"] == 1 and st["retried"] > 0
        assert st["breaker"]["state"] == "closed"
        got[name] = ([outcome(f) for f in futs], st, srv.batches, srv.retry_batches,
                     srv.faults.stats())
    same_outcomes(got["jax"][0], got["torch"][0])
    assert got["torch"][1:] == got["jax"][1:]


def test_transient_fault_retries_and_succeeds(engines, live_roots):
    roots = [int(r) for r in live_roots[:8]]
    got = {}
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(8,), max_wait_s=60.0))
        srv.faults.script("engine.execute", at=(0,))
        futs = [srv.submit("bfs", r) for r in roots]
        srv.pump(force=True)
        for r, f in zip(roots, futs):
            assert f.result(timeout=0)["levels"][r] == 0
        assert kind_stats(srv)["poisoned"] == 0
        got[name] = ([("ok", lanes(f.result(timeout=0))) for f in futs], kind_stats(srv),
                     srv.retry_batches)
    same_outcomes(got["jax"][0], got["torch"][0])
    assert got["torch"][1:] == got["jax"][1:]


def test_persistent_fault_exhausts_budget_no_stranded(engines, live_roots):
    """Under a 100% execute-fault rate every request fails after its
    retry budget: 1 top-level batch and 2 + 4 retry sub-batches."""
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0, retry_budget=3))
        srv.faults.rate("engine.execute", 1.0, seed=0)
        futs = [srv.submit("bfs", int(r)) for r in live_roots[:4]]
        srv.pump(force=True)
        assert all(isinstance(f.exception(timeout=0), P.InjectedFault) for f in futs)
        assert (srv.batches, srv.retry_batches, srv.scheduler.depth()) == (1, 6, 0)
        got[name] = ([outcome(f) for f in futs], kind_stats(srv), srv.faults.stats())
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["poisoned"] == 4


def test_scatter_fault_is_recovered_like_execute(engines, live_roots):
    roots = [int(r) for r in live_roots[:4]]
    got = {}
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        srv.faults.script("batch.scatter", at=(0,))
        futs = [srv.submit("bfs", r) for r in roots]
        srv.pump(force=True)
        for r, f in zip(roots, futs):
            assert f.result(timeout=0)["levels"][r] == 0
        got[name] = ([("ok", lanes(f.result(timeout=0))) for f in futs], kind_stats(srv))
    same_outcomes(got["jax"][0], got["torch"][0])
    assert got["torch"][1] == got["jax"][1]


# --- execution-time deadline enforcement -------------------------------------


def test_expired_request_dropped_before_execution(engines, live_roots):
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        now = time.monotonic()
        dead = P.Request(rid=0, kind="bfs", root=int(live_roots[0]), future=Future(),
                         submitted_at=now - 1.0, deadline=now - 0.5)
        live = P.Request(rid=1, kind="bfs", root=int(live_roots[1]), future=Future(),
                         submitted_at=now, deadline=None)
        before = srv.batches
        srv._run_batch([dead, live])
        assert isinstance(dead.future.exception(timeout=0), TimeoutError)
        assert live.future.result(timeout=0)["levels"][int(live_roots[1])] == 0
        assert srv.batches == before + 1  # one batch; the dead lane never rode
        assert kind_stats(srv)["timeout"] == 1
        got[name] = [outcome(dead.future), outcome(live.future)]
    same_outcomes(got["jax"], got["torch"])


# --- circuit breakers --------------------------------------------------------


def test_half_open_probe_released_on_queue_full(engines, live_roots):
    """A submit that claims the half-open probe slot and then meets a full
    queue releases the slot: the next submit is the probe and closes the
    breaker."""
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(1,), max_wait_s=60.0, retry_budget=1,
                            max_queue=1, breaker_threshold=1, breaker_cooldown_s=0.01))
        srv.faults.rate("engine.execute", 1.0, seed=0)
        srv.submit("bfs", int(live_roots[0]))
        srv.pump(force=True)  # one failure opens the breaker (threshold 1)
        srv.faults.clear()
        assert srv.health()["breakers"]["bfs"]["state"] == "open"
        time.sleep(0.02)
        srv.scheduler.submit("pagerank", int(live_roots[0]))
        with pytest.raises(P.BackpressureError):
            srv.submit("bfs", int(live_roots[1]))
        srv.pump(force=True)
        probe = srv.submit("bfs", int(live_roots[1]))
        srv.pump(force=True)
        assert probe.result(timeout=0)["levels"][int(live_roots[1])] == 0
        assert srv.health()["breakers"]["bfs"]["state"] == "closed"


def test_breaker_opens_fast_fails_and_recovers(engines, live_roots):
    """Three failed batches open the bfs breaker; submits fast-fail with
    the retry-after hint; pagerank keeps serving; after the cooldown a
    half-open probe closes it."""
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(1,), max_wait_s=60.0, retry_budget=1,
                            breaker_threshold=3, breaker_cooldown_s=0.05))
        srv.faults.rate("engine.execute", 1.0, seed=0)
        for _ in range(3):
            srv.submit("bfs", int(live_roots[0]))
            srv.pump(force=True)
        assert srv.health()["breakers"]["bfs"]["state"] == "open"
        with pytest.raises(P.CircuitBreakerOpen) as ei:
            srv.submit("bfs", int(live_roots[0]))
        assert ei.value.retry_after_s <= 0.05
        assert srv.health()["status"] == "degraded"
        f = srv.submit("pagerank", int(live_roots[1]))
        srv.faults.clear()
        srv.pump(force=True)
        assert f.result(timeout=0)["ranks"].sum() > 0
        time.sleep(0.06)
        probe = srv.submit("bfs", int(live_roots[2]))
        assert srv.health()["breakers"]["bfs"]["state"] == "half_open"
        srv.pump(force=True)
        assert probe.result(timeout=0)["levels"][int(live_roots[2])] == 0
        h = srv.health()
        assert h["breakers"]["bfs"]["state"] == "closed" and h["status"] == "ok"
        st = kind_stats(srv)
        assert st["breaker_rejected"] == 1 and st["breaker"]["opened_total"] == 1
        got[name] = ([outcome(f), outcome(probe)], st)
    same_outcomes(got["jax"][0], got["torch"][0])
    assert got["torch"][1] == got["jax"][1]


# --- submit_many prefix semantics under injected faults ----------------------


def test_submit_many_prefix_under_injected_admit_fault(engines, live_roots):
    roots = [int(r) for r in live_roots[:5]]
    got = {}
    for name, eng in engines.items():
        P = PKG[name]
        srv = eng.serve(cfg(name, lane_widths=(4,), max_wait_s=60.0))
        srv.faults.script("scheduler.admit", at=(2,))
        futs = srv.submit_many("bfs", roots)
        assert [f.done() for f in futs] == [False, False, True, True, True]
        assert all(isinstance(f.exception(timeout=0), P.InjectedFault) for f in futs[2:])
        srv.pump(force=True)
        for r, f in zip(roots[:2], futs[:2]):
            assert f.result(timeout=0)["levels"][r] == 0
        got[name] = [outcome(f) for f in futs]
    same_outcomes(got["jax"], got["torch"])


# --- worker backoff ----------------------------------------------------------


def test_worker_error_backoff_grows_and_resets(engines, live_roots):
    """A scheduler-level error makes the worker back off exponentially;
    a successful pump resets it and the retained error shows in
    stats()."""
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(1,), max_wait_s=0.001, worker_backoff_s=0.002,
                            worker_backoff_max_s=0.016))
        real_pop = srv.scheduler.pop_ready
        boom = RuntimeError("scheduler bug (injected)")

        def bad_pop(*a, boom=boom, **k):
            raise boom

        srv.scheduler.pop_ready = bad_pop
        srv.start()
        try:
            srv.submit("bfs", int(live_roots[0]))
            deadline = time.monotonic() + 5
            while srv.worker_errors < 4 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert srv.worker_errors >= 4 and srv._backoff_s > 0.002
            st = srv.stats()
            assert st["last_worker_error"]["repr"] == repr(boom)
            assert st["last_worker_error"]["at"] is not None
            srv.scheduler.pop_ready = real_pop
            f = srv.submit("bfs", int(live_roots[1]))
            assert f.result(timeout=30)["levels"][int(live_roots[1])] == 0
            deadline = time.monotonic() + 5
            while srv._backoff_s != 0.002 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert srv._backoff_s == 0.002
        finally:
            srv.scheduler.pop_ready = real_pop
            srv.close()


def test_worker_death_is_reported_not_swallowed(engines, live_roots):
    """``replica.death`` kills the worker outside the ladder: ``health()``
    reports ``down`` in both packages and the pending future is not
    settled by the dead worker."""
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(1,), max_wait_s=60.0))
        srv.faults.script("replica.death", at=(0,))
        srv.start()
        f = srv.submit("bfs", int(live_roots[0]))
        deadline = time.monotonic() + 5
        while srv._worker.is_alive() and time.monotonic() < deadline:
            time.sleep(0.005)
        h = srv.health()
        assert h["status"] == "down" and not h["worker_alive"] and not srv.is_serving()
        assert not f.done()
        srv.scheduler.fail_pending(RuntimeError("test teardown"))
        srv._worker = None
        srv.close()


# --- graph-version hot-swap --------------------------------------------------


def test_swap_same_shape_keeps_plans(engines, graph, live_roots):
    """A same-shape swap keeps every plan: zero plan builds after it, the
    version id bumped, the answers unchanged and equal across packages."""
    rows, cols = graph
    got = {}
    for name, eng in engines.items():
        eng.warmup(kinds=("bfs",), widths=(1, 4))
        v0 = eng.version_id
        mark = eng.trace_mark()
        r0 = eng.execute("bfs", live_roots[:4])
        swap_s = eng.swap(eng.build_version(rows, cols))
        assert eng.version_id == v0 + 1 and swap_s >= 0
        r1 = eng.execute("bfs", live_roots[:4])
        np.testing.assert_array_equal(r0["levels"], r1["levels"])
        assert eng.retraces_since(mark) == 0
        assert eng.stats()["swaps"] >= 1
        got[name] = [("ok", r1)]
    same_outcomes(got["jax"], got["torch"])


def test_swap_changes_served_results():
    rows = np.array([0, 1, 1, 2, 2, 3], np.int64)
    cols = np.array([1, 0, 2, 1, 3, 2], np.int64)
    for name in NAMES:
        eng = PKG[name].GraphEngine.from_coo(grid(name), rows, cols, 4, kinds=("bfs",))
        before = eng.execute("bfs", np.asarray([0], np.int32))
        assert before["levels"][3, 0] == 3
        eng.swap(eng.build_version(np.concatenate([rows, [0, 3]]),
                                   np.concatenate([cols, [3, 0]])))
        after = eng.execute("bfs", np.asarray([0], np.int32))
        assert after["levels"][3, 0] == 1


def test_swap_validation_rejects_bad_versions(engines, graph):
    rows, cols = graph
    for name, eng in engines.items():
        P = PKG[name]
        with pytest.raises(TypeError, match="GraphVersion"):
            eng.swap("not-a-version")
        small = P.GraphEngine.from_coo(grid(name), np.array([0, 1]), np.array([1, 0]), 2,
                                       kinds=("bfs",))
        with pytest.raises(ValueError, match="nrows"):
            eng.swap(small.build_version(np.array([0, 1]), np.array([1, 0])))
        rect = P.GraphEngine.from_coo(grid(name), np.array([0, 3]), np.array([5, 2]), 4,
                                      ncols=8, kinds=("bfs",), symmetric=False)
        v_rect = rect.build_version(np.array([1, 2]), np.array([7, 0]))
        assert v_rect.ncols == 8
        rect.swap(v_rect)
        with pytest.raises(ValueError, match="ncols"):
            rect.swap(rect.build_version(np.array([1, 2]), np.array([3, 0]), ncols=4))
        weighted = P.GraphEngine.from_coo(grid(name), rows, cols, N,
                                          weights=np.ones(len(rows), np.float32),
                                          kinds=("bfs", "sssp"))
        with pytest.raises(ValueError, match="weights"):
            weighted.swap(weighted.build_version(rows, cols))
        weighted.swap(weighted.build_version(rows, cols,
                                             weights=np.ones(len(rows), np.float32)))
        assert weighted.version_id == 2
        # an injected swap fault leaves the old version serving
        srv = eng.serve(cfg(name, lane_widths=(1,), max_wait_s=60.0))
        srv.faults.script("engine.swap", at=(0,))
        vid = eng.version_id
        with pytest.raises(P.InjectedFault):
            srv.swap_graph(eng.build_version(rows, cols))
        assert eng.version_id == vid
        with pytest.raises(ValueError, match="swap_graph needs"):
            srv.swap_graph(rows=rows)


def test_hot_swap_under_concurrent_load_zero_stranded(engines, graph, live_roots):
    """A swap under threaded load: zero failed in-flight queries, zero
    stranded futures, zero plan builds after it; every lane equal to the
    reference's."""
    rows, cols = graph
    got = {}
    for name, eng in engines.items():
        eng.warmup(kinds=("bfs", "pagerank"), widths=(1, 2, 4, 8))
        v_next = eng.build_version(rows, cols)
        v_before = eng.version_id
        mark = eng.trace_mark()
        srv = eng.serve(cfg(name, lane_widths=(1, 2, 4, 8), max_wait_s=0.002,
                            max_queue=512)).start()
        try:
            kinds = ("bfs", "pagerank")
            futs, swap_info = [], {}
            for i in range(60):
                futs.append(srv.submit(kinds[i % 2], int(live_roots[i % len(live_roots)])))
                if i == 30:
                    swap_info = srv.swap_graph(v_next)
            results = [f.result(timeout=120) for f in futs]
            assert len(results) == 60
            assert swap_info["version"] == v_before + 1
            assert eng.retraces_since(mark) == 0
            st = srv.stats()
            assert st["completed"] == 60 and st["per_kind"]["bfs"]["poisoned"] == 0
        finally:
            srv.close()
        got[name] = [("ok", lanes(r)) for r in results]
    same_outcomes(got["jax"], got["torch"])


# --- seeded chaos scenarios --------------------------------------------------


@pytest.mark.chaos
def test_chaos_availability_under_seeded_execute_faults(engines, live_roots):
    """A 5% seeded execute-fault rate: the same schedule fires in both
    packages, >= 95% of requests complete, none is stranded, and every
    disposition and lane equals the reference's."""
    got = {}
    for name, eng in engines.items():
        srv = eng.serve(cfg(name, lane_widths=(1, 2, 4, 8, 16), max_wait_s=60.0, max_queue=512))
        srv.faults.rate("engine.execute", 0.05, seed=11)
        nq = 200
        futs = [srv.submit("bfs", int(live_roots[i % len(live_roots)])) for i in range(nq)]
        while srv.scheduler.depth():
            srv.pump(force=True)
        assert all(f.done() for f in futs)
        ok = sum(1 for f in futs if f.exception(timeout=0) is None)
        assert ok / nq >= 0.95
        st = srv.stats()
        assert st["faults"]["fired"].get("engine.execute", 0) > 0
        assert st["per_kind"]["bfs"]["retried"] > 0
        got[name] = ([(s, lanes(r) if s == "ok" else r) for s, r in map(outcome, futs)],
                     st["faults"], kind_stats(srv), srv.batches, srv.retry_batches)
    same_outcomes(got["jax"][0], got["torch"][0])
    assert got["torch"][1:] == got["jax"][1:]


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_soak_threaded_faults_and_swap_storm(engines, graph, live_roots):
    rows, cols = graph
    for name, eng in engines.items():
        eng.warmup(kinds=("bfs", "pagerank"), widths=(1, 2, 4, 8, 16))
        versions = [eng.build_version(rows, cols) for _ in range(3)]
        swaps_before = eng.swaps
        srv = eng.serve(cfg(name, lane_widths=(1, 2, 4, 8, 16), max_wait_s=0.005,
                            max_queue=1024)).start()
        srv.faults.rate("engine.execute", 0.05, seed=99)
        try:
            futs = []
            for i in range(300):
                futs.append(srv.submit(("bfs", "pagerank")[i % 2],
                                       int(live_roots[i % len(live_roots)])))
                if i in (75, 150, 225):
                    srv.swap_graph(versions[(i // 75) - 1])
            ok = sum(1 for f in futs if f.exception(timeout=120) is None)
            assert all(f.done() for f in futs)
            assert ok / len(futs) >= 0.95
            assert eng.swaps == swaps_before + 3
        finally:
            srv.close()


# --- the port's own: a CUDA error is not a poison request --------------------


def test_cuda_error_fails_its_batch_and_reports_down(engines, live_roots):
    """A CUDA error (here raised in place of ``execute``'s readback) fails
    its batch at once, without bisection, and ``health()`` reports
    ``down`` with the error; an ordinary execution error still bisects."""
    eng = engines["torch"]
    srv = eng.serve(cfg("torch", lane_widths=(4,), max_wait_s=60.0))
    real = eng.execute
    boom = RuntimeError("CUDA error: an illegal memory access was encountered")

    def broken(kind, sources):
        raise boom

    eng.execute = broken
    try:
        futs = srv.submit_many("bfs", [int(r) for r in live_roots[:4]])
        srv.pump(force=True)
    finally:
        del eng.execute
    assert eng.execute == real
    assert all(f.exception(timeout=0) is boom for f in futs)
    assert srv.retry_batches == 0 and srv.device_error is boom
    h = srv.health()
    assert h["status"] == "down" and h["device_error"] == repr(boom)
    assert not srv.is_serving()
    srv.close()
    # a RuntimeError that is not the card's is a batch failure: bisected
    srv = eng.serve(cfg("torch", lane_widths=(4,), max_wait_s=60.0))
    calls = []

    def flaky(kind, sources):
        calls.append(len(sources))
        if len(calls) == 1:
            raise RuntimeError("shape mismatch")
        return real(kind, sources)

    eng.execute = flaky
    try:
        futs = srv.submit_many("bfs", [int(r) for r in live_roots[:4]])
        srv.pump(force=True)
    finally:
        del eng.execute
    assert all(f.exception(timeout=0) is None for f in futs)
    assert srv.retry_batches == 2 and srv.device_error is None
    assert srv.health()["status"] == "ok"
    srv.close()


@pytest.mark.parametrize("lane", ["merge", "checkpoint"])
def test_cuda_error_on_write_and_checkpoint_lanes_reports_down(
        tmp_path, monkeypatch, graph, lane):
    """A CUDA error met by the mutation thread (``apply_delta``) or by the
    checkpointer (``save_version``) fails that merge or snapshot, and
    ``health()`` reports ``down`` with the error, as for the worker."""
    from combblas_tpu_torch.utils import checkpoint as ckpt

    rows, cols = graph
    eng = PKG["torch"].GraphEngine.from_coo(grid("torch", (2, 2)), rows, cols, N,
                                            kinds=("bfs",), keep_coo=True)
    srv = eng.serve(cfg("torch", lane_widths=(1,), update_autostart=False,
                        wal_dir=str(tmp_path)))
    boom = RuntimeError("CUDA error: an illegal memory access was encountered")

    def broken(*args, **kwargs):
        raise boom

    v0 = eng.version_id
    if lane == "merge":
        monkeypatch.setattr(eng, "apply_delta", broken)
        fut = srv.submit_update([("insert", 0, 1), ("insert", 1, 0)])
        srv.pump_updates(force=True)
        assert fut.exception(timeout=0) is boom
        assert srv.stats()["updates"]["failed"] == 1
    else:
        monkeypatch.setattr(ckpt, "save_version", broken)
        assert srv.checkpoint_now() is None
        assert srv.checkpoint_failures == 1
    assert eng.version_id == v0 and srv.device_error is boom
    h = srv.health()
    assert h["status"] == "down" and h["device_error"] == repr(boom)
    assert not srv.is_serving()
    srv.close(drain=False)
