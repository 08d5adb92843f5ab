"""Parity of the port's fleet self-healing (``FleetRouter`` supervision,
promotion, replacement, read retry, drain / restore) with
``combblas_tpu.serve``'s on the CPU.

Mirrors the fleet cases of ``tests/test_serve_recovery.py`` on its grids
and graphs (``_coo(seed)``: 300 random pairs on 64 vertices, both
orientations; 1x1, and 2x4 where the reference takes it): a dead
non-durable home rebuilt from its retained COO, routing that skips a dead
replica, a failed fan-out that lags visibly and heals, a dead home
promoted at the WAL frontier, bounded read retry, ``close`` draining or
aborting the home's buffered writes, and the rolling restart. Its
replacement-from-checkpoint case, the fleet recovery boot and the kill
storm stay ``slow``. Workers die through the ``replica.death`` fault
point. Each scenario runs in both packages: the supervision outcomes,
dispositions and BFS lanes (bit for bit) must agree, as must the edges of
the recovered versions.

Three cases hold the port alone: a CUDA error is the card's, whether a
replica's batch, a fan-out's rebuild or a replacement's rebuild meets it
— the fleet reports ``down`` with the error and ``supervise_once``
detects, promotes and replaces nothing after it.
"""

import threading
import time

import numpy as np
import pytest

from torch_serve_parity import NAMES, PKG, grid, isolated, outcome  # noqa: F401

N = 64


def _coo(seed, n=N, m=300):
    r = np.random.default_rng(seed)
    rows = r.integers(0, n, m)
    cols = r.integers(0, n, m)
    return np.concatenate([rows, cols]), np.concatenate([cols, rows])


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


def _edges(version):
    return tuple(np.asarray(x) for x in version.E.to_host_coo())


def _same_edges(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _mk_fleet(name, tmp_path, seed, replicas=2, wal=True, grid_shape=(1, 1), **cfg_kw):
    P = PKG[name]
    rows, cols = _coo(seed)
    kw = dict(lane_widths=(1, 2), update_flush=1, update_max_delay_s=0.005)
    kw.update(cfg_kw)
    fr = P.FleetRouter.build(grid(name, grid_shape), rows, cols, N, replicas=replicas,
                             config=P.ServeConfig(**kw), kinds=("bfs",),
                             wal_dir=str(tmp_path / name / "fleet-wal") if wal else None)
    return fr, rows, cols


def _kill_worker(fr, i, timeout=5.0):
    """Kill replica ``i``'s worker through the ``replica.death`` fault
    point (woken by a direct submit)."""
    fr.replicas[i].faults.script("replica.death", at=(0,))
    probe = fr.replicas[i].submit("bfs", 1)
    t0 = time.monotonic()
    while not fr._dead(i):
        assert time.monotonic() - t0 < timeout, "worker did not die"
        time.sleep(0.005)
    return probe


def _bfs(srv, root):
    return srv.submit("bfs", root).result(timeout=60)


def _same_lanes(a, b):
    for x, y in zip(a, b):
        for key in ("parents", "levels"):
            assert np.array_equal(x[key], y[key])


def test_nondurable_home_death_rebuilds_fresh_lineage(tmp_path):
    """Without a WAL a dead home is not promoted, but its slot is rebuilt
    from its retained COO; reads and writes serve again."""
    got = {}
    for name in NAMES:
        fr, rows, cols = _mk_fleet(name, tmp_path, 31, wal=False)
        try:
            fr.warmup(widths=(1, 2))
            _kill_worker(fr, 0)
            out = fr.supervise_once()
            assert out["promoted"] is None and 0 in out["replaced"]
            assert fr.home == 0
            (a, b), = _absent_pairs(rows, cols, 1)
            res = fr.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=60)
            assert res["fanned_out"] == 1
            lanes = [_bfs(srv, a) for srv in fr.replicas]
            assert all(lev["levels"][b] == 1 for lev in lanes)
            got[name] = (out, lanes, _edges(fr.replicas[0].engine.version))
        finally:
            fr.close(drain=False)
    assert got["jax"][0] == got["torch"][0]
    _same_lanes(got["jax"][1], got["torch"][1])
    _same_edges(got["jax"][2], got["torch"][2])


def test_route_order_skips_dead_replica(tmp_path):
    """A dead replica's empty queue attracts no traffic; its replacement
    (from the home's COO) rejoins the rotation."""
    got = {}
    for name in NAMES:
        fr, rows, cols = _mk_fleet(name, tmp_path, 21, wal=False, grid_shape=(2, 4))
        try:
            fr.warmup(widths=(1, 2))
            _kill_worker(fr, 1)
            assert fr._route_order() == [0]
            lanes = [fr.submit("bfs", 2).result(timeout=60) for _ in range(4)]
            assert fr.submitted[1] == 0
            out = fr.supervise_once()
            assert out["replaced"] == [1]
            assert set(fr._route_order()) == {0, 1}
            got[name] = (out, lanes)
        finally:
            fr.close(drain=False)
    assert got["jax"][0] == got["torch"][0]
    _same_lanes(got["jax"][1], got["torch"][1])


def test_fanout_failure_lags_visibly_and_heals(tmp_path):
    """A replica whose rebuild fails mid-fan-out lags (health degraded)
    instead of failing the write; the next fan-out heals it."""
    got = {}
    for name in NAMES:
        fr, rows, cols = _mk_fleet(name, tmp_path, 22, wal=False)
        try:
            fr.warmup(widths=(1, 2))
            (a, b), (a2, b2) = _absent_pairs(rows, cols, 2)
            fr.faults.script("fleet.fanout", at=(0,))
            res = fr.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=60)
            assert res["fanned_out"] == 0 and res["lagging"] == [1]
            assert fr.health()["status"] == "degraded" and fr.lagging() == [1]
            stale = _bfs(fr.replicas[1], a)
            assert stale["levels"][b] != 1
            res2 = fr.submit_update([("insert", a2, b2), ("insert", b2, a2)]).result(timeout=60)
            assert res2["fanned_out"] == 1 and res2["lagging"] == []
            assert fr.health()["status"] == "ok"
            healed = _bfs(fr.replicas[1], a)
            assert healed["levels"][b] == 1
            got[name] = ((res["fanned_out"], res["lagging"], res2["fanned_out"]),
                         [stale, healed])
        finally:
            fr.close(drain=False)
    assert got["jax"][0] == got["torch"][0]
    _same_lanes(got["jax"][1], got["torch"][1])


def test_home_death_promotes_at_wal_frontier(tmp_path):
    """The home dies with an acknowledged, unmerged write buffered: a
    survivor is promoted at the WAL frontier (the write included), the
    buffered future fails with ``ReplicaDeadError``, the dead slot is
    replaced, and the lineage continues on every replica."""
    got = {}
    for name in NAMES:
        P = PKG[name]
        fr, rows, cols = _mk_fleet(name, tmp_path, 24, replicas=3, wal=True,
                                   grid_shape=(2, 4), update_flush=64, update_max_delay_s=30.0)
        try:
            fr.warmup(widths=(1, 2))
            (a, b), (a2, b2) = _absent_pairs(rows, cols, 2)
            buffered = fr.submit_update([("insert", a, b), ("insert", b, a)])
            assert not buffered.done()
            _kill_worker(fr, 0)
            out = fr.supervise_once()
            assert out["promoted"] is not None and fr.home == out["promoted"]
            assert fr.promotions == 1
            assert isinstance(buffered.exception(timeout=10), P.ReplicaDeadError)
            first = _bfs(fr.replicas[fr.home], a)
            assert first["levels"][b] == 1
            f2 = fr.submit_update([("insert", a2, b2), ("insert", b2, a2)])
            fr.replicas[fr.home].pump_updates(force=True)
            res = f2.result(timeout=60)
            assert res["fanned_out"] == len(fr.replicas) - 1
            lanes = [_bfs(srv, a2) for srv in fr.replicas]
            assert all(lev["levels"][b2] == 1 for lev in lanes)
            assert fr.health()["status"] == "ok"
            got[name] = (out, fr.home, [first] + lanes,
                         [_edges(s.engine.version) for s in fr.replicas])
        finally:
            fr.close(drain=False)
    assert got["jax"][:2] == got["torch"][:2]
    _same_lanes(got["jax"][2], got["torch"][2])
    for ej, et in zip(got["jax"][3], got["torch"][3]):
        _same_edges(ej, et)


def test_read_retry_on_next_best_replica(tmp_path):
    """With one replica failing every execution, routed reads succeed
    through the retry on the other; a malformed root is not retried."""
    got = {}
    for name in NAMES:
        fr, rows, cols = _mk_fleet(name, tmp_path, 25, wal=False)
        try:
            fr.warmup(widths=(1, 2))
            fr.replicas[0].faults.rate("engine.execute", 1.0, seed=1)
            lanes = [fr.submit("bfs", 3).result(timeout=60) for _ in range(6)]
            assert fr.read_retries >= 1
            bad = fr.submit("bfs", N + 99)
            assert isinstance(bad.exception(timeout=60), ValueError)
            got[name] = (lanes, outcome(bad))
        finally:
            fr.close(drain=False)
    _same_lanes(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]


def test_fleet_close_drain_flushes_vs_aborts(tmp_path):
    """``close(drain=True)`` flushes the home's buffered write through
    merge (durable: WAL + final checkpoint, recovered bit-exact);
    ``close(drain=False)`` aborts it."""
    got = {}
    for name in NAMES:
        P = PKG[name]
        fr, rows, cols = _mk_fleet(name, tmp_path, 26, wal=True, update_flush=64,
                                   update_max_delay_s=30.0)
        (a, b), = _absent_pairs(rows, cols, 1)
        f = fr.submit_update([("insert", a, b), ("insert", b, a)])
        fr.close(drain=True)
        assert f.result(timeout=10)["ops"] == 2
        wal = P.wal.open_wal(fr.wal_dir)
        v = P.wal.recover_version(fr.wal_dir, wal, grid(name), kinds=("bfs",))
        wal.close()
        _same_edges(_edges(v), _edges(fr.replicas[0].engine.version))
        fr2, rows2, cols2 = _mk_fleet(name, tmp_path / "nf", 27, wal=False, update_flush=64,
                                      update_max_delay_s=30.0)
        (a2, b2), = _absent_pairs(rows2, cols2, 1)
        f2 = fr2.submit_update([("insert", a2, b2), ("insert", b2, a2)])
        fr2.close(drain=False)
        assert isinstance(f2.exception(timeout=10), RuntimeError)
        got[name] = (_edges(v), outcome(f2))
    _same_edges(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]


def test_drain_restore_rolling_restart(tmp_path):
    """Drain / restore cycles every replica with reads serving, a write
    made mid-restart healing through the restore fan-out, and zero plan
    builds (the engines are reused warm)."""
    got = {}
    for name in NAMES:
        fr, rows, cols = _mk_fleet(name, tmp_path, 28, wal=True)
        try:
            fr.warmup(widths=(1, 2))
            (a, b), = _absent_pairs(rows, cols, 1)
            marks = [s.engine.trace_mark() for s in fr.replicas]
            f = fr.submit_update([("insert", a, b), ("insert", b, a)])
            assert fr.rolling_restart() == 2
            f.result(timeout=60)
            assert fr.lagging() == []
            lanes = []
            for srv, mark in zip(fr.replicas, marks):
                lanes.append(_bfs(srv, a))
                assert lanes[-1]["levels"][b] == 1
                assert srv.engine.retraces_since(mark) == 0
            st = fr.stats()
            assert st["draining"] == [] and st["promotions"] == 0
            got[name] = lanes
        finally:
            fr.close(drain=False)
    _same_lanes(got["jax"], got["torch"])


def test_cuda_error_is_the_cards_not_one_replicas(tmp_path):
    """A CUDA error in replica 1's batch fails that read (no retry on the
    home: the card's context is shared), turns the fleet ``down`` with
    the error, and ``supervise_once`` heals nothing — not even a replica
    whose worker then dies."""
    fr, rows, cols = _mk_fleet("torch", tmp_path, 32, wal=False)
    try:
        fr.warmup(widths=(1, 2))

        def boom(kind, sources):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        fr.replicas[1].engine.execute = boom
        f = fr.replicas[1].submit("bfs", 3)
        assert "CUDA error" in str(f.exception(timeout=60))
        h = fr.health()
        assert h["status"] == "down" and "CUDA error" in h["device_error"]
        # a routed read lands on the home (replica 1 is not serving)
        assert fr.submit("bfs", 3).result(timeout=60)["levels"][3] == 0
        assert fr.read_retries == 0
        _kill_worker(fr, 0)
        out = fr.supervise_once()
        assert out == {"detected": [], "promoted": None, "replaced": []}
        assert fr.replacements == 0 and fr.promotions == 0
    finally:
        fr.close(drain=False)


CUDA_ERR = "CUDA error: an illegal memory access was encountered"


def test_fanout_cuda_error_fails_the_write_and_downs_the_fleet(tmp_path):
    """A CUDA error in a fan-out's rebuild is kept on the fleet, not
    counted as replica 1 lagging: the write fails with it, the fleet is
    ``down``, and supervision heals nothing afterwards."""
    fr, rows, cols = _mk_fleet("torch", tmp_path, 33, wal=False)
    try:
        fr.warmup(widths=(1, 2))

        def boom(*a, **k):
            raise RuntimeError(CUDA_ERR)

        fr.replicas[1].engine.build_version = boom
        (a, b), = _absent_pairs(rows, cols, 1)
        f = fr.submit_update([("insert", a, b), ("insert", b, a)])
        assert "CUDA error" in str(f.exception(timeout=60))
        h = fr.health()
        assert h["status"] == "down" and "CUDA error" in h["device_error"]
        _kill_worker(fr, 1)
        assert fr.supervise_once() == {"detected": [], "promoted": None, "replaced": []}
        assert fr.replacements == 0
    finally:
        fr.close(drain=False)


def test_replacement_cuda_error_stops_healing(tmp_path, monkeypatch):
    """A CUDA error in a replacement's rebuild ends the supervision pass
    and downs the fleet; the next pass does not rebuild on the broken
    context again."""
    from combblas_tpu_torch.serve import engine as eng_mod

    fr, rows, cols = _mk_fleet("torch", tmp_path, 34, wal=False)
    try:
        fr.warmup(widths=(1, 2))
        _kill_worker(fr, 1)
        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError(CUDA_ERR)

        monkeypatch.setattr(eng_mod.GraphEngine, "from_coo", staticmethod(boom))
        out = fr.supervise_once()
        assert out["detected"] == [1] and out["replaced"] == [] and len(calls) == 1
        h = fr.health()
        assert h["status"] == "down" and "CUDA error" in h["device_error"]
        assert fr.supervise_once() == {"detected": [], "promoted": None, "replaced": []}
        assert len(calls) == 1 and fr.replacements == 0
    finally:
        fr.close(drain=False)


# --- slow: as in the reference -----------------------------------------------


@pytest.mark.slow
def test_supervisor_replaces_dead_replica_bit_exact(tmp_path):
    got = {}
    for name in NAMES:
        P = PKG[name]
        fr, rows, cols = _mk_fleet(name, tmp_path, 23, wal=True)
        try:
            fr.warmup(widths=(1, 2))
            (a, b), = _absent_pairs(rows, cols, 1)
            fr.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=60)
            probe = _kill_worker(fr, 1)
            out = fr.supervise_once()
            assert out["detected"] == [1] and out["replaced"] == [1]
            assert isinstance(probe.exception(timeout=10), P.ReplicaDeadError)
            _same_edges(_edges(fr.replicas[1].engine.version),
                        _edges(fr.replicas[0].engine.version))
            mark = fr.replicas[1].engine.trace_mark()
            lev = _bfs(fr.replicas[1], a)
            assert lev["levels"][b] == 1
            assert fr.replicas[1].engine.retraces_since(mark) == 0
            assert fr.replacements == 1 and fr.health()["status"] == "ok"
            got[name] = (out, lev)
        finally:
            fr.close(drain=False)
    assert got["jax"][0] == got["torch"][0]
    _same_lanes([got["jax"][1]], [got["torch"][1]])


@pytest.mark.slow
def test_fleet_from_recovery_boots_whole_fleet(tmp_path):
    got = {}
    for name in NAMES:
        P = PKG[name]
        fr, rows, cols = _mk_fleet(name, tmp_path, 29, wal=True)
        (a, b), (a2, b2) = _absent_pairs(rows, cols, 2)
        fr.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=60)
        fr.close(drain=True)
        cfg = P.ServeConfig(lane_widths=(1, 2), update_flush=1, update_max_delay_s=0.005)
        with P.FleetRouter.from_recovery(grid(name), replicas=2, config=cfg, kinds=("bfs",),
                                         wal_dir=str(tmp_path / name / "fleet-wal")) as fr2:
            fr2.warmup(widths=(1, 2))
            lanes = [_bfs(srv, a) for srv in fr2.replicas]
            assert all(lev["levels"][b] == 1 for lev in lanes)
            res = fr2.submit_update([("insert", a2, b2), ("insert", b2, a2)]).result(timeout=60)
            assert res["fanned_out"] == 1
        got[name] = lanes
    _same_lanes(got["jax"], got["torch"])


@pytest.mark.slow
def test_kill_storm_soak(tmp_path):
    """Mixed reads and writes with a replica and then the home killed
    while the supervisor heals: reads stay available, and every
    acknowledged write is in the recovered version, in both packages."""
    for name in NAMES:
        P = PKG[name]
        fr, rows, cols = _mk_fleet(name, tmp_path, 30, replicas=3, wal=True, grid_shape=(2, 4))
        acked = []
        try:
            fr.warmup(widths=(1, 2))
            fr.start_supervisor(interval_s=0.02)
            pairs = _absent_pairs(rows, cols, 12)

            def writer(fr=fr, acked=acked, pairs=pairs):
                for a, b in pairs:
                    try:
                        fr.submit_update([("insert", a, b), ("insert", b, a)]).result(timeout=60)
                        acked.append((a, b))
                    except Exception:
                        pass  # failed writes may or may not be durable
                    time.sleep(0.01)

            wt = threading.Thread(target=writer)
            wt.start()
            ok = bad = 0
            for i in range(120):
                if i in (30, 70):
                    victim = fr.home if i == 70 else (fr.home + 1) % 3
                    try:
                        _kill_worker(fr, victim)
                    except AssertionError:
                        pass
                try:
                    fr.submit("bfs", int(rows[i % len(rows)])).result(timeout=60)
                    ok += 1
                except Exception:
                    bad += 1
            wt.join(120)
            assert ok / (ok + bad) >= 0.95
            deadline = time.monotonic() + 10
            while (fr._needs_rebuild or any(fr._dead(i) for i in range(3))) and (
                    time.monotonic() < deadline):
                time.sleep(0.02)
        finally:
            fr.close(drain=True)
        d = str(tmp_path / name / "fleet-wal")
        wal = P.wal.open_wal(d)
        v = P.wal.recover_version(d, wal, grid(name, (2, 4)), kinds=("bfs",))
        wal.close()
        r, c, _vals = v.E.to_host_coo()
        have = set(zip(np.asarray(r).tolist(), np.asarray(c).tolist()))
        assert not [p for p in acked if p not in have]
