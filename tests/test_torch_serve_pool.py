"""Parity of the port's ``EnginePool`` / ``PoolServer`` (``serve/pool.py``)
with ``combblas_tpu.serve``'s on the CPU.

Mirrors the tier-1 cases of ``tests/test_serve_pool.py`` on its grid
(2x4) and graphs (``_coo(seed)``: 300 random pairs on 64 vertices, both
orientations): tenant routing, zero plan builds after warm-up, LRU
eviction under a byte budget with a bit-exact rebuild, writes that
survive eviction, busy and pending tenants kept, SLO admission naming the
tenant, breaker isolation, the 3 : 1 WFQ share, write merges charging the
meter, stats and health labels, WFQ pruning and removal failing pending
futures; and the pool's scrape surface. Its threaded soak stays
``slow``. Also mirrors ``tests/test_obs_serve.py``'s tenant-churn case
(the label space is pruned). Each scenario runs through both packages' pools; dispositions,
BFS lanes (bit for bit), WFQ shares and residency counts must agree.

Two cases hold the port alone: an evicted tenant's bucket tensor is
freed (a ``weakref`` dies after ``gc.collect()``), and a CUDA error in a
tenant's batch turns ``PoolServer.health()`` to ``down``.
"""

import gc
import json
import threading
import urllib.request
import weakref

import numpy as np
import pytest

from torch_serve_parity import NAMES, PKG, grid, isolated, outcome, same_outcomes  # noqa: F401

N = 64
SHAPE = (2, 4)


def _coo(seed, n=N, m=300):
    r = np.random.default_rng(seed)
    rows = r.integers(0, n, m)
    cols = r.integers(0, n, m)
    return np.concatenate([rows, cols]), np.concatenate([cols, rows])


def _cfg(name, **kw):
    kw.setdefault("lane_widths", (1, 2, 4))
    kw.setdefault("update_autostart", False)
    return PKG[name].ServeConfig(**kw)


def _pool(name, names, weights=None, cfg=None, kinds=("bfs",), shape=SHAPE):
    pool = PKG[name].EnginePool(grid(name, shape))
    for i, t in enumerate(names):
        rows, cols = _coo(i)
        pool.add_tenant(t, rows, cols, N, weight=(weights or {}).get(t, 1.0),
                        config=cfg or _cfg(name), kinds=kinds)
    return pool


def _drain(psrv):
    while psrv.pump(force=True):
        pass


def _absent(rows, cols):
    present = set(zip(rows.tolist(), cols.tolist()))
    return next((i, j) for i in range(N) for j in range(N)
                if i != j and (i, j) not in present and (j, i) not in present)


def _edges(eng):
    return tuple(np.asarray(x) for x in eng.version.E.to_host_coo())


def _same_edges(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# --- routing + serving ------------------------------------------------------


def test_pool_serves_each_tenant_its_own_graph():
    """Tenant -> engine routing: one root through two tenants answers from
    two graphs, each equal to a direct ``execute``; equal across
    packages."""
    got = {}
    for name in NAMES:
        pool = _pool(name, ("a", "b"))
        psrv = pool.serve()
        psrv.warmup(widths=(1,))
        futs = {t: psrv.submit(t, "bfs", 3, timeout_s=None) for t in ("a", "b")}
        _drain(psrv)
        for t in ("a", "b"):
            direct = pool.engine(t).execute("bfs", np.asarray([3], np.int32))["levels"][:, 0]
            assert np.array_equal(futs[t].result(timeout=0)["levels"], direct)
        assert not np.array_equal(futs["a"].result(timeout=0)["levels"],
                                  futs["b"].result(timeout=0)["levels"])
        got[name] = [outcome(futs[t]) for t in ("a", "b")]
    same_outcomes(got["jax"], got["torch"])


def test_pool_zero_retraces_after_warmup():
    """A warmed pool serves a mixed two-tenant stream with zero plan
    builds (zero retraces in the reference)."""
    got = {}
    for name in NAMES:
        pool = _pool(name, ("a", "b"))
        psrv = pool.serve()
        psrv.warmup(widths=(1, 2, 4))
        marks = {t: pool.engine(t).trace_mark() for t in ("a", "b")}
        futs = [psrv.submit(("a", "b")[i % 2], "bfs", i % N) for i in range(12)]
        _drain(psrv)
        for t, m in marks.items():
            assert pool.engine(t).retraces_since(m) == 0, (name, t)
        got[name] = [outcome(f) for f in futs]
        assert all(o[0] == "ok" for o in got[name])
    same_outcomes(got["jax"], got["torch"])


def test_unknown_tenant_rejected():
    for name in NAMES:
        psrv = _pool(name, ("a",)).serve()
        with pytest.raises(ValueError, match="unknown tenant"):
            psrv.submit("nope", "bfs", 0)


# --- byte-accounted LRU eviction --------------------------------------------


def test_lru_eviction_under_byte_budget():
    """The LRU sweep keeps resident bytes under the budget, evicts the
    coldest idle tenant, and a re-admitted tenant rebuilds bit-exactly;
    the same residency in both packages, the same rebuilt edges."""
    got = {}
    for name in NAMES:
        pool = _pool(name, ("a", "b", "c"))
        sizes = {t: pool.stats()["tenants"][t]["device_bytes"] for t in ("a", "b", "c")}
        assert all(v > 0 for v in sizes.values())
        before_a = _edges(pool.engine("a"))
        for t in ("a", "b", "c"):
            pool.engine(t)
        pool.byte_budget = sum(sizes.values()) - 1
        pool.refresh_bytes("c")  # triggers the sweep
        st = pool.stats()
        assert st["resident_bytes"] <= pool.byte_budget
        resident = {t: s["resident"] for t, s in st["tenants"].items()}
        assert resident == {"a": False, "b": True, "c": True}
        assert st["tenants"]["a"]["evictions"] == 1
        after_a = _edges(pool.engine("a"))
        _same_edges(before_a, after_a)
        st = pool.stats()
        assert st["tenants"]["a"]["admits"] == 2
        assert st["resident_bytes"] <= pool.byte_budget
        got[name] = (after_a, {t: (s["resident"], s["admits"], s["evictions"])
                               for t, s in st["tenants"].items()})
    _same_edges(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]


def test_merged_mutations_survive_eviction():
    """An acknowledged write survives the evict / re-admit cycle: the
    rebuild source is the current version's host COO."""
    got = {}
    rows, cols = _coo(0)
    a, b = _absent(rows, cols)
    for name in NAMES:
        pool = PKG[name].EnginePool(grid(name, SHAPE))
        pool.add_tenant("m", rows, cols, N, config=_cfg(name, update_flush=1,
                                                        update_max_delay_s=0.001),
                        kinds=("bfs",), keep_coo=True)
        psrv = pool.serve()
        fut = psrv.submit_update("m", [("insert", a, b), ("insert", b, a)])
        _drain(psrv)
        assert fut.result(timeout=0)["ops"] == 2
        merged = _edges(pool.engine("m"))
        assert pool.evict("m")
        readmitted = _edges(pool.engine("m"))
        _same_edges(merged, readmitted)
        lev = pool.engine("m").execute("bfs", np.asarray([a], np.int32))["levels"][:, 0]
        assert lev[b] == 1
        got[name] = (readmitted, lev)
    _same_edges(got["jax"][0], got["torch"][0])
    assert np.array_equal(got["jax"][1], got["torch"][1])


def test_eviction_refuses_busy_and_pending():
    for name in NAMES:
        pool = _pool(name, ("a",))
        srv = pool.server("a")
        f = srv.submit("bfs", 1)
        assert not pool.evict("a")  # pending read -> not idle
        assert pool.stats()["tenants"]["a"]["resident"]
        _drain(pool.serve())
        assert f.exception(timeout=0) is None
        assert pool.evict("a")  # drained -> cold, evictable
        t = pool._get("a")
        pool.admit("a")
        t.busy = True
        assert not pool.evict("a", force=True)  # never mid-batch
        t.busy = False


# --- SLO admission ----------------------------------------------------------


def test_slo_admission_names_tenant():
    for name in NAMES:
        P = PKG[name]
        cfg = _cfg(name, slo_queue_budget=2, slo_deadline_s=5.0, max_wait_s=30.0)
        pool = _pool(name, ("acme",), cfg=cfg)
        psrv = pool.serve()
        psrv.submit("acme", "bfs", 1)
        psrv.submit("acme", "bfs", 2)
        with pytest.raises(P.BackpressureError) as ei:
            psrv.submit("acme", "bfs", 3)
        assert ei.value.tenant == "acme" and "acme" in str(ei.value)
        q = pool.server("acme").scheduler._pending["bfs"]
        assert all(r.deadline is not None for r in q)
        assert pool.server("acme").scheduler.fail_pending(RuntimeError("teardown")) == 2


# --- per-tenant breaker + fault isolation -----------------------------------


def test_breaker_isolation_across_tenants():
    """Tenant a's poison trips a's breaker only: b keeps serving; equal
    dispositions and health in both packages."""
    got = {}
    for name in NAMES:
        P = PKG[name]
        pool = _pool(name, ("a", "b"), cfg=_cfg(name, lane_widths=(1,), breaker_threshold=1))
        psrv = pool.serve()
        psrv.warmup(widths=(1,))
        psrv.faults("a").when("engine.execute", lambda ctx: True)
        fa, fb = psrv.submit("a", "bfs", 1), psrv.submit("b", "bfs", 1)
        _drain(psrv)
        assert fa.exception(timeout=0) is not None
        assert fb.exception(timeout=0) is None
        with pytest.raises(P.CircuitBreakerOpen) as ei:
            psrv.submit("a", "bfs", 2)
        assert ei.value.tenant == "a"
        f2 = psrv.submit("b", "bfs", 2)
        _drain(psrv)
        h = psrv.health()
        assert h["status"] == "degraded"
        states = {t: h["breakers"][t]["bfs"]["state"] for t in ("a", "b")}
        assert states == {"a": "open", "b": "closed"}
        got[name] = ([outcome(f) for f in (fa, fb, f2)], states)
    same_outcomes(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]


# --- weighted fair queueing -------------------------------------------------


def test_wfq_weighted_share_under_saturation():
    """Three DRR rounds over saturated queues serve 3 : 1 (within the
    reference's band), the same counts in both packages."""
    got = {}
    for name in NAMES:
        cfg = _cfg(name, lane_widths=(1,), max_queue=64, max_wait_s=30.0)
        pool = _pool(name, ("heavy", "light"), weights={"heavy": 3.0, "light": 1.0}, cfg=cfg)
        psrv = pool.serve(quantum=4)
        psrv.warmup(widths=(1,))
        futs = []
        for i in range(40):
            futs.append(psrv.submit("heavy", "bfs", i % N))
            futs.append(psrv.submit("light", "bfs", i % N))
        for _ in range(3):
            psrv.pump(force=True)
        served = dict(psrv.wfq.describe()["served"])
        ratio = served["heavy"] / max(served["light"], 1)
        assert 2.4 <= ratio <= 3.6, served
        _drain(psrv)
        got[name] = (served, [outcome(f) for f in futs])
    assert got["jax"][0] == got["torch"][0]
    same_outcomes(got["jax"][1], got["torch"][1])


def test_wfq_write_merges_charge_the_tenant():
    got = {}
    rows, cols = _coo(0)
    for name in NAMES:
        pool = PKG[name].EnginePool(grid(name, SHAPE))
        pool.add_tenant("w", rows, cols, N, kinds=("bfs",), keep_coo=True,
                        config=_cfg(name, lane_widths=(1, 2), update_flush=1,
                                    update_max_delay_s=0.001))
        psrv = pool.serve()
        vid0 = pool.engine("w").version_id
        fut = psrv.submit_update("w", [("insert", 1, 2), ("insert", 2, 1)])
        _drain(psrv)
        res = fut.result(timeout=0)
        assert res["ops"] == 2
        assert pool.engine("w").version_id == vid0 + 1
        served = psrv.wfq.describe()["served"]["w"]
        assert served >= 2
        got[name] = (res["mode"], res["version"], served, _edges(pool.engine("w")))
    assert got["jax"][:3] == got["torch"][:3]
    _same_edges(got["jax"][3], got["torch"][3])


# --- introspection ----------------------------------------------------------


def test_pool_stats_and_health_carry_tenant_labels():
    for name in NAMES:
        pool = _pool(name, ("a", "b"))
        psrv = pool.serve()
        st = psrv.stats()
        assert set(st["tenants"]) == {"a", "b"}
        for t in ("a", "b"):
            assert st["servers"][t]["tenant"] == t
            assert "per_kind" in st["servers"][t]
        assert st["resident_bytes"] > 0
        assert st["byte_budget"] == 0  # the test session pins unbounded
        h = psrv.health()
        assert h["status"] == "ok" and set(h["breakers"]) == {"a", "b"}
        assert pool.server("a").stats()["tenant"] == "a"
        assert pool.server("a").health()["tenant"] == "a"
    assert psrv.health()["device_error"] is None  # the port's


def test_wfq_prunes_removed_tenants():
    got = {}
    for name in NAMES:
        pool = _pool(name, ("a", "b"))
        psrv = pool.serve()
        psrv.warmup(widths=(1,))
        futs = [psrv.submit(t, "bfs", 1) for t in ("a", "b")]
        _drain(psrv)
        assert set(psrv.wfq.describe()["weights"]) == {"a", "b"}
        pool.remove_tenant("b")
        psrv._has_ready()
        psrv._next_deadline()
        futs.append(psrv.submit("a", "bfs", 2))
        _drain(psrv)
        d = psrv.wfq.describe()
        assert set(d["weights"]) == {"a"}
        assert "b" not in d["deficit"] and "b" not in d["served"]
        got[name] = ([outcome(f) for f in futs], d["served"])
    same_outcomes(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]


def test_remove_tenant_fails_pending():
    rows, cols = _coo(0)
    for name in NAMES:
        pool = PKG[name].EnginePool(grid(name, SHAPE))
        pool.add_tenant("a", rows, cols, N, config=_cfg(name), kinds=("bfs",), keep_coo=True)
        f = pool.server("a").submit("bfs", 1)
        w = pool.serve().submit_update("a", [("insert", 1, 2)])
        pool.remove_tenant("a")
        assert isinstance(f.exception(timeout=0), RuntimeError)
        assert isinstance(w.exception(timeout=5), RuntimeError)
        with pytest.raises(ValueError, match="unknown tenant"):
            pool.engine("a")


def test_pool_tenant_churn_prunes_label_space():
    """``tests/test_obs_serve.py``'s churn case: add / serve / remove
    cycles leave no tenant-labeled series, in either package's
    registry."""
    rng = np.random.default_rng(4)
    r, c = rng.integers(0, 32, 120), rng.integers(0, 32, 120)
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    got = {}
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        try:
            cfg = P.ServeConfig(lane_widths=(1,), update_autostart=False, flight_recorder=False)
            pool = P.EnginePool(grid(name, (1, 1)))
            psrv = pool.serve()
            baseline = len(P.obs.metrics_snapshot())

            def tenant_series(P=P):
                return [rec for rec in P.obs.metrics_snapshot()
                        if rec["labels"].get("tenant") == "x"]

            seen = []
            for _ in range(2):
                pool.add_tenant("x", rows, cols, 32, config=cfg, kinds=("bfs",))
                f = psrv.submit("x", "bfs", 1)
                _drain(psrv)
                assert f.exception(timeout=0) is None
                seen.append(sorted(rec["name"] for rec in tenant_series()))
                pool.remove_tenant("x")
                assert tenant_series() == []
            assert len(P.obs.metrics_snapshot()) <= baseline + 24
            P.obs.gauge("serve.wfq.deficit", 1.0, tenant="ghost")
            psrv.wfq.add("ghost", 1.0)
            psrv.pump(force=True)  # no backlog, but it prunes first
            assert not [rec for rec in P.obs.metrics_snapshot()
                        if rec["labels"].get("tenant") == "ghost"]
            got[name] = seen
        finally:
            P.obs.disable()
            P.obs.reset()
    assert got["jax"] == got["torch"]


def test_pool_scrape_endpoint():
    """``PoolServer.serve_metrics`` serves ``/healthz`` and ``/statz`` for
    the pool (the same status and keys in both packages) and ``close``
    detaches it."""
    got = {}
    for name in NAMES:
        psrv = _pool(name, ("a", "b")).serve()
        f = psrv.submit("a", "bfs", 1)
        _drain(psrv)
        assert f.exception(timeout=0) is None
        port = psrv.serve_metrics()
        assert port == psrv.serve_metrics()  # idempotent
        base = f"http://127.0.0.1:{port}"
        hz = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read())
        sz = json.loads(urllib.request.urlopen(f"{base}/statz", timeout=10).read())
        assert set(sz["tenants"]) == {"a", "b"}
        psrv.close()
        assert psrv._scrape is None
        got[name] = (hz["status"], sorted(hz["breakers"]), sorted(sz["servers"]))
    assert got["jax"] == got["torch"] == ("ok", ["a", "b"], ["a", "b"])


# --- the port alone ---------------------------------------------------------


def test_evicted_tenant_frees_its_tensors():
    """Eviction drops everything that holds the tenant's version: after
    serving, a warm-up and ``gc.collect()``, a ``weakref`` to one of its
    bucket tensors dies (on the card, ``memory_allocated`` falls with
    it)."""
    pool = _pool("torch", ("a", "b"), kinds=("bfs", "sssp"))
    psrv = pool.serve()
    psrv.warmup(widths=(1,))
    futs = [psrv.submit("a", k, 3) for k in ("bfs", "sssp")]
    _drain(psrv)
    assert all(f.exception(timeout=0) is None for f in futs)
    ref = weakref.ref(pool.engine("a").version.E.buckets[0][0])
    gc.collect()
    assert ref() is not None
    assert pool.evict("a")
    gc.collect()
    assert ref() is None
    assert pool.stats()["tenants"]["a"]["device_bytes"] == 0


def test_cuda_error_in_a_tenant_batch_reports_down():
    """A CUDA error raised in tenant a's batch fails that batch's futures
    with it and turns ``PoolServer.health()`` to ``down``, carrying the
    error; tenant b's queue is not dropped."""
    pool = _pool("torch", ("a", "b"))
    psrv = pool.serve()
    psrv.warmup(widths=(1,))
    eng = pool.engine("a")

    def boom(kind, sources):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    eng.execute = boom
    fa, fb = psrv.submit("a", "bfs", 1), psrv.submit("b", "bfs", 1)
    _drain(psrv)
    assert "CUDA error" in str(fa.exception(timeout=0))
    assert fb.exception(timeout=0) is None
    h = psrv.health()
    assert h["status"] == "down" and "CUDA error" in h["device_error"]
    assert pool.server("a").health()["status"] == "down"


# --- threaded soak ----------------------------------------------------------


@pytest.mark.slow
def test_pool_threaded_mixed_tenants_with_evictions():
    """The worker-threaded pool under a concurrent three-tenant stream with
    a byte budget forcing evictions: every future settles with its
    tenant's golden lane, in both packages, and the pool ends under
    budget."""
    got = {}
    for name in NAMES:
        pool = _pool(name, ("a", "b", "c"))
        sizes = [pool.stats()["tenants"][t]["device_bytes"] for t in ("a", "b", "c")]
        pool.byte_budget = sum(sizes) - 1
        golden = {t: pool.engine(t).execute("bfs", np.asarray([5], np.int32))["levels"][:, 0]
                  for t in ("a", "b", "c")}
        futs, errs = [], []
        with pool.serve() as psrv:
            def client(tenant, psrv=psrv):
                for _ in range(10):
                    try:
                        futs.append((tenant, psrv.submit(tenant, "bfs", 5)))
                    except PKG[name].BackpressureError as e:
                        errs.append(e)

            threads = [threading.Thread(target=client, args=(t,)) for t in ("a", "b", "c")]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for tenant, f in futs:
                assert np.array_equal(f.result(timeout=120)["levels"], golden[tenant])
        resident = [t for t, s in pool.stats()["tenants"].items() if s["resident"]]
        pool.refresh_bytes(resident[0])
        st = pool.stats()
        assert st["resident_bytes"] <= pool.byte_budget
        assert sum(t["evictions"] for t in st["tenants"].values()) >= 1
        got[name] = golden
    for t in ("a", "b", "c"):
        assert np.array_equal(got["jax"][t], got["torch"][t])
