"""Parity of the port's durable ``Server`` (the WAL append before the
acknowledgement, the background checkpointer, ``Server.from_recovery``)
with ``combblas_tpu.serve.Server`` on the CPU.

Mirrors ``tests/test_serve_recovery.py``'s server cases: the recovered
server resumes its lineage (writes after recovery merge in place and a
third life sees them all), a boot from COO refuses a WAL that no
snapshot covers, and a failed WAL append rejects the write. Each runs in
both packages on the same graph and writes, and the versions each
package ends with are equal: ``to_host_coo`` and every bucket array bit
for bit.

Added: a durability directory written by either package's ``Server``
(bootstrap snapshot, merges with ``checkpoint_every=1`` through the
checkpointer thread, ``checkpoint_retain=2``, and an acknowledged write
left unmerged at the crash) recovers in both packages'
``Server.from_recovery`` to the same version, on 1x1, 2x2 and 2x4.
"""

import shutil
import time

import numpy as np
import pytest

from test_torch_serve_durability import _absent_pairs, _coo, same_buckets
from torch_serve_parity import NAMES, PKG, grid, isolated  # noqa: F401

N = 64


def cfg(name, **kw):
    return PKG[name].ServeConfig(**kw)


def _edges(version):
    r, c, _ = version.E.to_host_coo()
    return set(zip(np.asarray(r).tolist(), np.asarray(c).tolist()))


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
def test_recovered_server_resumes_lineage(tmp_path, shape):
    """``from_recovery`` boots bit-exact and keeps writing on the same
    sequence line: a post-recovery write merges incrementally and a third
    life sees all three writes; both packages end on the same version."""
    rows, cols = _coo(9)
    pairs = _absent_pairs(rows, cols, 3)
    (a0, b0), (a1, b1), (a2, b2) = pairs
    final = {}
    for name in NAMES:
        P, G = PKG[name], grid(name, shape)
        d = str(tmp_path / name)
        eng = P.GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",), keep_coo=True,
                                     headroom=0.5)
        c = cfg(name, lane_widths=(1,), update_autostart=False, wal_dir=d, update_flush=1)
        srv = P.Server(eng, c)
        srv.submit_update([("insert", a0, b0), ("insert", b0, a0)])
        srv.pump_updates(force=True)
        srv.submit_update([("insert", a1, b1), ("insert", b1, a1)])
        # crash with one unmerged acknowledged write
        srv2 = P.Server.from_recovery(G, c, kinds=("bfs",))
        for x, y in ((a0, b0), (a1, b1)):
            lev = srv2.submit("bfs", x)
            srv2.pump(force=True)
            assert lev.result(timeout=60)["levels"][y] == 1
        f = srv2.submit_update([("insert", a2, b2), ("insert", b2, a2)])
        srv2.pump_updates(force=True)
        assert f.result(timeout=60)["mode"] == "incremental"
        srv3 = P.Server.from_recovery(G, c, kinds=("bfs",))
        same_buckets(srv3.engine.version, srv2.engine.version)
        assert srv3.engine.version.wal_seq == srv2.engine.version.wal_seq == 5
        assert srv3.health()["wal_frontier"] == 5 and srv3.durable
        final[name] = srv3.engine.version
        for s in (srv, srv2, srv3):
            s.scheduler.close()
    same_buckets(final["jax"], final["torch"])


def test_boot_from_coo_refuses_unreplayed_wal(tmp_path):
    rows, cols = _coo(13)
    (a, b), = _absent_pairs(rows, cols, 1)
    for name in NAMES:
        P, G = PKG[name], grid(name)
        d = str(tmp_path / name)
        c = cfg(name, lane_widths=(1,), update_autostart=False, wal_dir=d, update_flush=64,
                update_max_delay_s=30.0)
        srv = P.Server(P.GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",), keep_coo=True), c)
        srv.submit_update([("insert", a, b)])  # acknowledged, unmerged
        with pytest.raises(RuntimeError, match="would silently destroy"):
            P.Server(P.GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",), keep_coo=True), c)
        srv2 = P.Server.from_recovery(G, c, kinds=("bfs",))
        assert (a, b) in _edges(srv2.engine.version)
        srv2.scheduler.close()
        srv3 = P.Server(P.GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",), keep_coo=True), c)
        srv3.scheduler.close()
        srv.scheduler.close()
    with pytest.raises(ValueError, match="durability dir"):
        PKG["torch"].Server.from_recovery(grid("torch"), cfg("torch"))


def test_wal_append_failure_rejects_write(tmp_path):
    """A write whose WAL append failed is rejected, never acknowledged:
    the buffer rolls back, nothing merges, the next write proceeds, and
    recovery agrees."""
    rows, cols = _coo(11)
    (a, b), (a2, b2) = _absent_pairs(rows, cols, 2)
    final = {}
    for name in NAMES:
        P, G = PKG[name], grid(name)
        d = str(tmp_path / name)
        eng = P.GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",), keep_coo=True)
        srv = P.Server(eng, cfg(name, lane_widths=(1,), update_autostart=False, wal_dir=d,
                                update_flush=1))
        srv.faults.script("wal.append", at=(0,))
        with pytest.raises(RuntimeError, match="NOT acknowledged"):
            srv.submit_update([("insert", a, b)])
        assert srv._upd_buffer.depth() == 0
        assert srv.pump_updates(force=True) == 0
        f = srv.submit_update([("insert", a2, b2), ("insert", b2, a2)])
        srv.pump_updates(force=True)
        assert f.result(timeout=60)["ops"] == 2
        wal = P.wal.open_wal(d)
        v = P.wal.recover_version(d, wal, G, kinds=("bfs",))
        wal.close()
        same_buckets(v, srv.engine.version)
        assert (a, b) not in _edges(v) and (a2, b2) in _edges(v)
        final[name] = v
        srv.scheduler.close()
    same_buckets(final["jax"], final["torch"])


def _write_durable_dir(name, shape, d, rows, cols, pairs):
    """A ``Server`` of package ``name`` with a durability directory, its
    worker and checkpointer running: three merged write batches (one
    snapshot each, two retained), then an acknowledged write left
    unmerged when the process "crashes". Returns the never-crashed
    version of all four batches (the last one merged after the files
    were copied away)."""
    P = PKG[name]
    G = grid(name, shape)
    eng = P.GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs", "pagerank"), keep_coo=True,
                                 headroom=0.5)
    c = cfg(name, lane_widths=(1,), update_autostart=False, wal_dir=d, checkpoint_every=1,
            checkpoint_retain=2)
    srv = P.Server(eng, c).start()
    assert srv.checkpoints == 1  # the bootstrap snapshot
    for k, (a, b) in enumerate(pairs[:3]):
        f = srv.submit_update([("insert", a, b), ("insert", b, a)])
        srv.pump_updates(force=True)
        assert f.result(timeout=60)["mode"] == "incremental"
        deadline = time.monotonic() + 30
        while srv.checkpoints < k + 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv.checkpoints == k + 2
    with srv._ckpt_lock:  # the count moves before the prune and truncation it holds this lock for
        pass
    assert len(P.checkpoint.list_snapshots(d)) == 2
    a, b = pairs[3]
    srv.submit_update([("insert", a, b), ("insert", b, a)])
    crashed = str(d) + "-crash"
    shutil.copytree(d, crashed)
    srv.close()  # the never-crashed life merges the last write too
    return crashed, eng.version


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)], ids=["1x1", "2x2", "2x4"])
@pytest.mark.parametrize("writer", NAMES)
def test_durable_dir_recovers_in_both_packages(tmp_path, writer, shape):
    rows, cols = _coo(17)
    pairs = _absent_pairs(rows, cols, 4)
    crashed, never = _write_durable_dir(writer, shape, str(tmp_path / "d"), rows, cols, pairs)
    got = {}
    for name in NAMES:
        d = str(tmp_path / f"read-{name}")
        shutil.copytree(crashed, d)
        P = PKG[name]
        srv = P.Server.from_recovery(grid(name, shape), cfg(name, lane_widths=(1,), wal_dir=d),
                                     kinds=("bfs", "pagerank"))
        v = srv.engine.version
        assert v.wal_seq == 7 and srv.health()["wal_frontier"] == 7
        same_buckets(v, never)  # bit-exact with the life that never crashed
        got[name] = v
        srv.scheduler.close()
        srv.close(drain=False)
    same_buckets(got["jax"], got["torch"])
    assert set(pairs) <= _edges(got["torch"])


def test_attach_durability_to_running_server(tmp_path):
    """``attach_durability`` on a running server built without a WAL: the
    log starts at the seqno frontier of the writes merged before it, a
    later write is logged, the same dir again is a no-op and another one
    raises; recovery in both packages gives the server's version."""
    rows, cols = _coo(19)
    (a0, b0), (a1, b1) = _absent_pairs(rows, cols, 2)
    final = {}
    for name in NAMES:
        P, G = PKG[name], grid(name, (2, 2))
        d = str(tmp_path / name)
        eng = P.GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",), keep_coo=True)
        c = cfg(name, lane_widths=(1,), update_autostart=False)
        srv = P.Server(eng, c).start()
        f = srv.submit_update([("insert", a0, b0), ("insert", b0, a0)])
        srv.pump_updates(force=True)
        assert f.result(timeout=60)["ops"] == 2 and not srv.durable
        srv.attach_durability(d)
        assert srv.durable and srv.checkpoints == 1  # the bootstrap snapshot
        srv.attach_durability(d)
        with pytest.raises(RuntimeError, match="already durable"):
            srv.attach_durability(str(tmp_path / f"{name}-other"))
        f = srv.submit_update([("insert", a1, b1), ("insert", b1, a1)])
        srv.pump_updates(force=True)
        assert f.result(timeout=60)["ops"] == 2
        assert srv.health()["wal_frontier"] == eng.version.wal_seq == 3
        srv.close()
        rec = P.Server.from_recovery(G, cfg(name, lane_widths=(1,), wal_dir=d),
                                     kinds=("bfs",))
        same_buckets(rec.engine.version, eng.version)
        assert {(a0, b0), (a1, b1)} <= _edges(rec.engine.version)
        final[name] = rec.engine.version
        rec.scheduler.close()
        rec.close(drain=False)
    same_buckets(final["jax"], final["torch"])
