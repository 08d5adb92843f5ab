"""Parity of the port's sharded serving (``serve/shard.py`` and
``serve/_shardworker.py``) with ``combblas_tpu.serve``'s on the CPU.

Mirrors the tier-1 cases of ``tests/test_serve_shard.py`` — partition
planning, kind validation, the local-mode write / kill / heal / recover
representative, crash recovery on the vector frontier, the encoding
equivalence sweep's fast representative and the stale-epoch replay —
and ``tests/test_obs.py``'s round-21 wire-counter gate: each case runs
in both packages on the same seeds, asserts the reference test's
properties on both, and holds the two packages' answers equal bit for
bit (bfs parents, levels and ``batch_niter``, sssp distances,
``to_host_coo``, the frontier vector, the manifest, the wire bytes by
encoding).

Also held here, where the reference has no tier-1 test: a ``Server``
over a 2-slice local ``ShardedEngine`` (engine-owned durability), the
rectangular slab's foundations (``apply_delta`` on an ``ls x n`` slab
version, ``save_version(extra_meta=)`` with
``load_latest_version(writable=False)``, ``recover_version
(batch_filter=)``, bit for bit against the reference), and the port's
CUDA-error rule by mode: a local slice's error is the card's (kept,
raised at once, nothing quarantined, the ``Server`` down), a process
slice's is its own (respawned, the batch replayed, the parent ``Server``
serving), and the child fails its boot on a warm-up error and stops
serving on a held one. The process-mode cases here run the port's real
child loop (``ShardWorker.run``) on a thread over a socketpair;
``tests/test_torch_serve_shard_proc.py`` spawns real children.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

import combblas_tpu.serve.shard as jshard
import combblas_tpu_torch.serve.shard as tshard
from combblas_tpu.dynamic import DeltaBatch as JaxBatch
from combblas_tpu.dynamic import merge as jmerge
from combblas_tpu_torch.dynamic import DeltaBatch as TorchBatch
from combblas_tpu_torch.dynamic import merge as tmerge
from combblas_tpu_torch.serve import ipc as tipc
from combblas_tpu_torch.serve import procfleet as tproc
from torch_serve_parity import NAMES, PKG, grid, isolated, same_result  # noqa: F401

N = 40
SHARD = {"jax": jshard, "torch": tshard}
BATCH = {"jax": JaxBatch, "torch": TorchBatch}
MERGE = {"jax": jmerge, "torch": tmerge}
DEV = {"jax": {}, "torch": {"device": "cpu"}}
CUDA_ERR = "CUDA error: an illegal memory access was encountered"


def _coo(seed, n=N, m=170):
    r = np.random.default_rng(seed)
    return r.integers(0, n, m), r.integers(0, n, m)


def _absent_pairs(rows, cols, k, n=N):
    present = set(zip(rows.tolist(), cols.tolist()))
    out = []
    for i in range(n):
        for j in range(n):
            if i != j and (i, j) not in present:
                out.append((i, j))
                if len(out) >= k:
                    return out
    return out


def _build(name, rows, cols, home, **kw):
    kw.setdefault("mode", "local")
    return SHARD[name].ShardedEngine.build(rows, cols, home=str(home), **DEV[name], **kw)


def _recover(name, home, **kw):
    return SHARD[name].ShardedEngine.recover(str(home), **DEV[name], **kw)


def _engine(name, rows, cols, n=N, **kw):
    return PKG[name].GraphEngine.from_coo(grid(name), rows, cols, n, **kw)


def _host(x):
    return np.asarray(x)


def _same_coo(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            x, y = _host(x), _host(y)
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _same(a, b):
    """Two packages' observations: arrays bit for bit, the rest equal."""
    assert type(a) is type(b) or isinstance(a, np.ndarray), (a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        b = _host(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


# --- partition planning (pure) ----------------------------------------------


@pytest.mark.parametrize("n,p", [(10, 3), (5, 1), (40, 2), (48, 3), (7, 7)])
def test_plan_partition_matches_reference(n, p):
    """Slabs are contiguous, cover [0, n) and differ by at most one row,
    as the reference's; ``owner_of`` maps every row to its slab."""
    spec = {name: SHARD[name].plan_partition(n, p) for name in NAMES}
    assert spec["torch"].bounds == spec["jax"].bounds
    assert (spec["torch"].nslices, spec["torch"].ncols) == (p, n)
    sizes = [r1 - r0 for r0, r1 in spec["torch"].bounds]
    assert max(sizes) - min(sizes) <= 1
    for row in range(n):
        assert spec["torch"].owner_of(row) == spec["jax"].owner_of(row)
    for bad in (n, -1):
        for name in NAMES:
            with pytest.raises(ValueError):
                spec[name].owner_of(bad)


def test_plan_partition_rejects_and_shard_coo_translates():
    """p > n and p < 1 raise the reference's message; ``shard_coo``
    translates rows to slab coordinates, keeps columns global and
    passes ``None`` weights through, as the reference's."""
    for name in NAMES:
        for n, p in ((3, 8), (3, 0)):
            with pytest.raises(ValueError, match="nslices"):
                SHARD[name].plan_partition(n, p)
    rows = np.array([0, 3, 7, 9, 4])
    cols = np.array([9, 1, 2, 0, 4])
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    for i in (0, 1):
        for wt in (w, None):
            got = [SHARD[name].shard_coo(SHARD[name].plan_partition(10, 2), i, rows, cols, wt)
                   for name in NAMES]
            _same_coo(got[0], got[1])
    r1, _, _ = tshard.shard_coo(tshard.plan_partition(10, 2), 1, rows, cols, w)
    np.testing.assert_array_equal(np.sort(r1), [2, 4])


def test_sharded_kinds_validated_up_front(tmp_path):
    rows, cols = _coo(3)
    for name in NAMES:
        with pytest.raises(ValueError, match="do not decompose"):
            _build(name, rows, cols, tmp_path / f"a-{name}", nrows=N, nslices=2,
                   kinds=("bfs", "mcl"))
        with pytest.raises(ValueError, match="symmetric"):
            _build(name, rows, cols, tmp_path / f"b-{name}", nrows=N, nslices=2,
                   kinds=("propagate",), features=np.ones((N, 3), np.float32),
                   symmetric=False)
        with pytest.raises(ValueError, match="features"):
            _build(name, rows, cols, tmp_path / f"c-{name}", nrows=N, nslices=2,
                   kinds=("propagate",), symmetric=True)


# --- the local-mode representative --------------------------------------------


def test_local_bit_exact_write_kill_heal_recover(tmp_path):
    """A 2-slice local engine answers bfs as the unsharded build does, a
    two-phase write lands on both slices (the frontier vector advances
    in lockstep), a killed slice heals mid-execute through a whole-batch
    replay with the other slice untouched, and a reboot from the home
    reassembles the same global COO; every observation equal across the
    packages, the manifest too."""
    rows, cols = _coo(7)
    (a, b), (a2, b2) = _absent_pairs(rows, cols, 2)
    srcs = np.array([0, 5, 17], np.int32)
    seen = {}
    for name in NAMES:
        home = tmp_path / f"home-{name}"
        eng = _engine(name, rows, cols, kinds=("bfs",), keep_coo=True)
        sh = _build(name, rows, cols, home, nrows=N, nslices=2, kinds=("bfs",), warmup=False)
        ref = eng.execute("bfs", srcs)
        got = sh.execute("bfs", srcs)
        np.testing.assert_array_equal(_host(ref["parents"]), got["parents"])
        assert int(ref["batch_niter"]) == int(got["batch_niter"])
        assert max(sh.version.device_bytes_per_slice) < eng.version.device_bytes()
        batch = BATCH[name].from_ops([("insert", a, b), ("insert", b, a)], start_seq=0)
        eng.swap(eng.apply_delta(batch))
        v = sh.apply_delta(batch)
        assert v.frontier == [1, 1] and v.wal_seq == 1
        sh.swap(v)
        after_write = sh.execute("bfs", srcs)
        ref = eng.execute("bfs", srcs)
        np.testing.assert_array_equal(_host(ref["parents"]), after_write["parents"])
        survivor = sh.slices[1]
        sh.slices[0].kill()
        healed = sh.execute("bfs", srcs)
        np.testing.assert_array_equal(_host(ref["parents"]), healed["parents"])
        assert sh.replacements == 1 and sh.slices[1] is survivor
        batch2 = BATCH[name].from_ops([("insert", a2, b2), ("insert", b2, a2)], start_seq=2)
        sh.swap(sh.apply_delta(batch2))
        coo_before = sh.to_host_coo()
        sh.close()
        with open(home / "shard_manifest.json") as f:
            manifest = json.load(f)
        sh2 = _recover(name, home, mode="local")
        assert sh2.version.frontier == [3, 3]
        _same_coo(coo_before, sh2.to_host_coo())
        rebooted = sh2.execute("bfs", srcs)
        sh2.close()
        seen[name] = [got, after_write, healed, coo_before, manifest, rebooted]
    _same(seen["jax"], seen["torch"])


# --- crash recovery on the vector frontier -----------------------------------------


def _wal_begin_payload(batch):
    return {
        "first_seq": int(batch.first_seq),
        "rows": np.asarray(batch.rows, np.int64),
        "cols": np.asarray(batch.cols, np.int64),
        "vals": np.asarray(batch.vals, np.float32),
        "ops": np.asarray(batch.ops, np.int8),
    }


def _crash_scenario(name, tmp_path, tag, n_commit, n_append_only, commit_partial, ckpt,
                    torn):
    """The reference's ``_crash_scenario`` in one package: commit a
    prefix, append (phase 1 only) a tail, optionally commit its first
    batch on slice 0 only, checkpoint one slice mid-stream, tear slice
    0's log, crash, recover; the recovered COO must equal a never-crashed
    twin's. Returns both COOs and the recovered frontier."""
    home = tmp_path / f"crash-{tag}-{name}"
    rows, cols = _coo(11)
    pairs = _absent_pairs(rows, cols, n_commit + n_append_only)
    batches = [BATCH[name].from_ops([("insert", a, b), ("insert", b, a)], start_seq=2 * i)
               for i, (a, b) in enumerate(pairs)]
    sh = _build(name, rows, cols, home, nrows=N, nslices=2, kinds=("bfs",), warmup=False)
    for k, batch in enumerate(batches):
        if k < n_commit:
            sh.swap(sh.apply_delta(batch))
        else:
            for sl in sh.slices:  # phase 1 everywhere, then crash
                sl.call("wal_begin", _wal_begin_payload(batch))
            if commit_partial and k == n_commit:
                payload = _wal_begin_payload(batch)
                payload["last_seq"] = int(batch.last_seq)
                sh.slices[0].call("wal_commit", payload)
        if ckpt is not None and k + 1 == ckpt[1]:
            sh.slices[ckpt[0]].call("checkpoint_now", {"reason": "test"})
    if torn:
        wal_path = home / "slice0" / "wal.jsonl"
        assert wal_path.exists()
        with open(wal_path, "a") as f:
            f.write('{"v": "combblas_tpu.wal/v1", "first_se')
    for sl in sh.slices:  # CRASH: the files are all that survives
        sl.kill()
    recovered = _recover(name, home, mode="local")
    ref = _build(name, rows, cols, tmp_path / f"ref-{tag}-{name}", nrows=N, nslices=2,
                 kinds=("bfs",), warmup=False)
    for batch in batches:
        ref.swap(ref.apply_delta(batch))
    got, want = recovered.to_host_coo(), ref.to_host_coo()
    _same_coo(got, want)
    last = int(batches[-1].last_seq) if batches else -1
    assert recovered.version.frontier == [last, last]
    frontier = list(recovered.version.frontier)
    recovered.close()
    ref.close()
    return got, frontier


def test_crash_recovery_fast_representative(tmp_path):
    """Every boundary class at once — committed prefix, appended tail, a
    partial commit on one slice, a one-slice checkpoint (frontier skew),
    a torn final line — recovers to the never-crashed twin's COO in both
    packages, and the two packages' recovered COOs are equal."""
    got = {name: _crash_scenario(name, tmp_path, "fast", n_commit=2, n_append_only=1,
                                 commit_partial=True, ckpt=(1, 1), torn=True)
           for name in NAMES}
    _same(got["jax"], got["torch"])


# --- the wire protocol: encodings, resident state, epochs ----------------------------


def test_encoding_equivalence_fast_representative(tmp_path):
    """One 2-slice local engine answers bfs/sssp as the unsharded build
    does under forced sparse, forced dense and auto encodings, the
    sparse hop payloads are smaller than the dense ones, and the two
    packages' answers and wire accounting (hops, encodings chosen,
    frontier sizes, bytes by encoding) are equal."""
    rows, cols = _coo(11)
    w = np.random.default_rng(11).random(rows.shape[0]).astype(np.float32) + 0.1
    srcs = np.array([0, 5, 17], np.int32)
    seen = {}
    for name in NAMES:
        eng = _engine(name, rows, cols, weights=w, kinds=("bfs", "sssp"))
        sh = _build(name, rows, cols, tmp_path / f"enc-{name}", nrows=N, nslices=2, weights=w,
                    kinds=("bfs", "sssp"), warmup=False)
        obs = []
        try:
            refs = {k: eng.execute(k, srcs) for k in ("bfs", "sssp")}
            hop_payload = {}
            for mode in ("sparse", "dense", "auto"):
                sh.frontier_mode = mode
                for kind, keys in (("bfs", ("parents", "levels")), ("sssp", ("dist",))):
                    got = sh.execute(kind, srcs)
                    for key in keys:
                        np.testing.assert_array_equal(_host(refs[kind][key]), got[key],
                                                      err_msg=f"{kind}/{key} under {mode}")
                    assert int(got["batch_niter"]) == int(refs[kind]["batch_niter"]), mode
                    st = sh.last_exec_stats
                    assert st["collects"] == 1 and len(st["frontier_nnz"]) == st["hops"]
                    if mode in ("sparse", "dense"):
                        assert set(st["enc_hops"]) == {mode}
                        hop_payload[(kind, mode)] = st["bytes_by_enc"][mode]
                    obs.append((got, {k: st[k] for k in (
                        "hops", "collects", "bytes_out", "bytes_in", "bytes_by_enc",
                        "enc_hops", "frontier_nnz")}))
            assert set(sh.last_exec_stats["enc_hops"]) == {"sparse", "dense"}
            for kind in ("bfs", "sssp"):
                assert hop_payload[(kind, "sparse")] < hop_payload[(kind, "dense")]
        finally:
            sh.close()
        seen[name] = obs
    _same(seen["jax"], seen["torch"])


def test_stale_epoch_replay_reseeds_resident_state(tmp_path):
    """A slice that loses its resident loop state between hops 2 and 3
    reports ``StaleEpochError`` — a protocol fact from a healthy slice —
    and the router replays the whole batch under a fresh epoch without
    quarantining it; the answer equals the unsharded one in both
    packages."""
    rows, cols = _coo(13)
    srcs = np.array([0, 5, 17], np.int32)
    seen = {}
    for name in NAMES:
        stale_cls = SHARD[name].StaleEpochError
        eng = _engine(name, rows, cols, kinds=("bfs",))
        sh = _build(name, rows, cols, tmp_path / f"stale-{name}", nrows=N, nslices=2,
                    kinds=("bfs",), warmup=False, frontier="sparse")
        try:
            epoch0 = sh._epoch
            orig_fan = sh._fan_hop
            state = {"fans": 0, "stale": 0}

            def fan(kind, payload, **kw):
                if kw.get("op", "hop") == "hop" and state["fans"] == 2:
                    sh.slices[0].rt = sh.slices[0]._factory(recover=True)
                state["fans"] += 1
                try:
                    return orig_fan(kind, payload, **kw)
                except stale_cls:
                    state["stale"] += 1
                    raise

            sh._fan_hop = fan
            got = sh.execute("bfs", srcs)
            ref = eng.execute("bfs", srcs)
            assert state["stale"] == 1 and not sh._needs_rebuild
            assert sh._epoch >= epoch0 + 2
            for key in ("parents", "levels"):
                np.testing.assert_array_equal(_host(ref[key]), got[key])
            assert int(got["batch_niter"]) == int(ref["batch_niter"])
        finally:
            sh._fan_hop = orig_fan
            sh.close()
        seen[name] = (got, state, sh._epoch - epoch0)
    _same(seen["jax"], seen["torch"])


def test_round21_shard_wire_counters_gated():
    """``tests/test_obs.py``'s round-21 gate in both packages: the wire
    series (payload bytes by direction and encoding, per-hop frontier
    nnz, the encoding decision) are emitted under obs and cost nothing
    when it is off; the bytes by encoding are the same in both."""
    n = 24
    rng = np.random.default_rng(5)
    rows = rng.integers(0, n, 90)
    cols = rng.integers(0, n, 90)
    srcs = np.array([0, 7], np.int32)
    seen = {}
    for name in NAMES:
        obs = PKG[name].obs

        def exercise():
            eng = SHARD[name].ShardedEngine.build(rows, cols, nrows=n, nslices=2,
                                                  kinds=("bfs",), warmup=False,
                                                  frontier="auto", **DEV[name])
            eng.execute("bfs", srcs)
            eng.close()
            return eng

        assert not obs.ENABLED
        exercise()
        assert obs.registry.empty()
        obs.enable(install_hooks=False)
        try:
            obs.reset()
            st = exercise().last_exec_stats
            assert st["hops"] >= 1 and st["collects"] == 1
            g = obs.registry.get_counter
            by_enc = {
                e: g("serve.shard.hop_bytes", direction="out", encoding=e)
                + g("serve.shard.hop_bytes", direction="in", encoding=e)
                for e in ("sparse", "dense", "collect")
            }
            assert by_enc["collect"] > 0
            assert sum(by_enc.values()) == st["bytes_out"] + st["bytes_in"]
            assert by_enc == st["bytes_by_enc"] | {
                e: 0 for e in by_enc if e not in st["bytes_by_enc"]}
            assert sum(g("serve.shard.encoding", choice=c)
                       for c in ("sparse", "dense")) == st["hops"]
            h = obs.registry.get_histogram("serve.shard.frontier_nnz", kind="bfs")
            assert h["count"] == st["hops"] and h["max"] == max(st["frontier_nnz"])
            seen[name] = (by_enc, st["frontier_nnz"], st["enc_hops"])
        finally:
            obs.disable()
            obs.reset()
    _same(seen["jax"], seen["torch"])


# --- the Server over a sharded engine (engine-owned durability) ---------------------


def test_server_over_local_sharded_engine(tmp_path):
    """``ShardedEngine.serve()`` in both packages: reads equal the direct
    ``execute``; a ``submit_update`` is acknowledged only once both
    slices' WALs hold it and moves the frontier to ``[k, k]`` with the
    edge one hop away; the server is durable; ``checkpoint_now`` is
    delegated to the slices (each snapshots at its frontier); a
    configured ``wal_dir`` raises the reference's ``ValueError``."""
    rows, cols = _coo(17)
    w = np.random.default_rng(17).random(rows.shape[0]).astype(np.float32) + 0.1
    (a, b), = _absent_pairs(rows, cols, 1)
    roots = [0, 5, 17, 23]
    seen = {}
    for name in NAMES:
        P = PKG[name]
        home = tmp_path / f"srv-{name}"
        sh = _build(name, rows, cols, home, nrows=N, nslices=2, weights=w,
                    kinds=("bfs", "sssp"), warmup_widths=(1, 2, 4))
        with pytest.raises(ValueError, match="engine owns its own durability"):
            sh.serve(P.ServeConfig(wal_dir=str(tmp_path / f"wal-{name}")))
        srv = sh.serve(P.ServeConfig(lane_widths=(1, 2, 4), update_flush=1,
                                     update_max_delay_s=0.005))
        srv.start()
        try:
            assert srv.durable
            direct = {k: sh.execute(k, np.asarray(roots, np.int32)) for k in ("bfs", "sssp")}
            mark = sh.trace_mark()
            reads = {}
            for kind, key in (("bfs", "levels"), ("sssp", "dist")):
                futs = srv.submit_many(kind, roots)
                reads[kind] = [f.result(timeout=60)[key] for f in futs]
                for k, lane in enumerate(reads[kind]):
                    np.testing.assert_array_equal(lane, direct[kind][key][:, k])
            assert sh.retraces_since(mark) == 0
            res = srv.submit_update([("insert", a, b, 1.0), ("insert", b, a, 1.0)]).result(
                timeout=60)
            assert res["ops"] == 2
            assert sh.version.frontier == [1, 1] and sh.version.wal_seq == 1
            for i in range(2):  # both slices' logs hold the acknowledged write
                log = (home / f"slice{i}" / "wal.jsonl").read_text().splitlines()
                assert any(json.loads(ln).get("first_seq") == 0 for ln in log)
            lev = srv.submit("bfs", a).result(timeout=60)["levels"]
            assert lev[b] == 1
            ck = srv.checkpoint_now(reason="test")
            assert ck["frontier"] == [1, 1] and sorted(ck["slices"]) == [0, 1]
            for i in range(2):
                assert os.path.basename(ck["slices"][i]["path"]) in os.listdir(
                    home / f"slice{i}")
            h = srv.health()
            assert h["status"] == "ok"
        finally:
            srv.close()
            sh.close()
        with open(home / "shard_manifest.json") as f:
            manifest = json.load(f)
        assert manifest["frontier"] == [1, 1]
        seen[name] = (reads, lev, res["ops"], ck["frontier"], manifest)
    _same(seen["jax"], seen["torch"])


# --- the rectangular slab's foundations ---------------------------------------------


def _same_slab(tv, jv):
    """The port's slab version equals the reference's: every bucket array
    of E and E_weighted, the degree tables, the retained COO and
    weights, and the shape and stamps."""
    for nm in ("E", "E_weighted"):
        x, y = getattr(tv, nm), getattr(jv, nm)
        assert (x is None) == (y is None), nm
        if x is None:
            continue
        assert (x.nrows, x.ncols, len(x.buckets)) == (y.nrows, y.ncols, len(y.buckets)), nm
        for tb, jb in zip(x.buckets, y.buckets):
            for p, q in zip(tb, jb):
                q = np.asarray(q)
                assert p.numpy().dtype == q.dtype and np.array_equal(p.numpy(), q), nm
    for f in ("deg", "outdeg", "host_weights"):
        x, y = getattr(tv, f), getattr(jv, f)
        assert (x is None) == (y is None) and (x is None or np.array_equal(x, y)), f
    _same_coo(tv.host_coo, jv.host_coo)
    assert (tv.nrows, tv.ncols, tv.nnz, tv.wal_seq) == (jv.nrows, jv.ncols, jv.nnz, jv.wal_seq)


def test_rectangular_slab_merge_snapshot_and_filtered_recovery(tmp_path):
    """A slab version (``ls x n``, rows translated) in both packages:
    ``apply_delta`` of a slab sub-batch (inserts, a weight update and a
    delete), ``save_version(extra_meta=)`` read back through
    ``load_latest_version(writable=False)``, and ``recover_version`` with
    a row-slab ``batch_filter`` over a WAL of global batches — each
    version equal to the reference's bit for bit."""
    from combblas_tpu_torch.serve.engine import _build_version as t_build
    from combblas_tpu.serve.engine import _build_version as j_build

    build = {"jax": j_build, "torch": t_build}
    rng = np.random.default_rng(23)
    m = 260
    rows, cols = rng.integers(0, N, m), rng.integers(0, N, m)
    w = rng.integers(1, 9, m).astype(np.float32)
    r0, r1 = 14, 27
    spec = tshard.ShardSpec(nrows=N, ncols=N, bounds=((0, r0), (r0, r1), (r1, N)))
    lr, lc, lw = tshard.shard_coo(spec, 1, rows, cols, w)
    (pa, pb), (pc, pd) = [(i, j) for i, j in _absent_pairs(rows, cols, N * N)
                          if r0 <= i < r1][:2]
    er, ec = int(lr[0]) + r0, int(lc[0])
    k = int(np.flatnonzero((lr != lr[0]) | (lc != lc[0]))[0])
    dr, dc = int(lr[k]), int(lc[k])
    ops = [("insert", pa, pb, 2.0), ("insert", pc, pd, 3.0), ("insert", er, ec, 0.5),
           ("delete", dr + r0, dc), ("insert", 2, 3, 1.0)]
    meta = {"shard": {"idx": 1, "row0": r0, "row1": r1, "nrows": N, "ncols": N}}

    def slab(batch):
        msk = (batch.rows >= r0) & (batch.rows < r1)
        if not msk.any():
            return None
        return type(batch)(rows=batch.rows[msk] - r0, cols=batch.cols[msk],
                           vals=batch.vals[msk], ops=batch.ops[msk],
                           first_seq=batch.first_seq, last_seq=batch.last_seq,
                           oldest_at=0.0)

    got = {}
    for name in NAMES:
        P = PKG[name]
        g = grid(name)
        v0 = build[name](g, lr, lc, r1 - r0, N, lw, ("bfs", "sssp"), False, True)
        batch = BATCH[name].from_ops(ops, start_seq=0)
        v1 = MERGE[name].apply_delta(v0, slab(batch), kinds=("bfs", "sssp"), grid=g)
        v1.wal_seq = batch.last_seq
        home = tmp_path / f"slab-{name}"
        home.mkdir()
        P.checkpoint.save_version(str(home / P.checkpoint.snapshot_name(-1)), v0,
                                  extra_meta=meta)
        back, _path = P.checkpoint.load_latest_version(str(home), g, writable=False)
        assert back.extra_meta == meta
        wal = P.wal.open_wal(str(home))
        wal.append(0, batch.rows, batch.cols, batch.vals, batch.ops)
        far = BATCH[name].from_ops([("insert", 1, 2, 1.0)], start_seq=len(ops))
        wal.append(far.first_seq, far.rows, far.cols, far.vals, far.ops)  # no slab row
        rec = P.wal.recover_version(str(home), wal, g, kinds=("bfs", "sssp"),
                                    batch_filter=slab)
        wal.close()
        assert rec.wal_seq == far.last_seq
        got[name] = (v0, v1, back, rec)
    for tv, jv in zip(got["torch"], got["jax"]):
        _same_slab(tv, jv)
    # the merge applied what the sub-batch said, on the slab's rows only
    coo = set(zip(*[x.tolist() for x in got["torch"][1].host_coo[:2]]))
    assert (pa - r0, pb) in coo and (pc - r0, pd) in coo
    assert (dr, dc) not in coo
    _same_coo(got["torch"][3].host_coo, got["torch"][1].host_coo)


# --- the CUDA-error rule, by mode ------------------------------------------------------


def _raise_cuda(*a, **k):
    raise RuntimeError(CUDA_ERR)


def test_local_cuda_error_is_kept_and_downs_the_server(tmp_path):
    """Local slices share this process's context: a CUDA error a slice
    meets is kept on the engine and raised at once (no heal wait, though
    ``recover_wait_s`` is 30 s), no slice is quarantined,
    ``supervise_once`` heals nothing, later batches and writes raise it,
    and the ``Server`` over the engine reports ``down``."""
    rows, cols = _coo(19)
    sh = _build("torch", rows, cols, tmp_path / "loc", nrows=N, nslices=2, kinds=("bfs",),
                warmup_widths=(1, 2))
    assert sh.shares_context and sh.device == sh.slices[0].rt.device
    srv = sh.serve(PKG["torch"].ServeConfig(lane_widths=(1, 2)))
    srv.start()
    try:
        assert srv.submit("bfs", 0).result(timeout=60)["levels"][0] == 0
        sh.slices[1].rt.hop = _raise_cuda
        t = time.monotonic()
        f = srv.submit("bfs", 3)
        assert CUDA_ERR in str(f.exception(timeout=60))
        assert time.monotonic() - t < 5.0
        assert CUDA_ERR in repr(sh.device_error)
        assert sh._needs_rebuild == set() and sh.replacements == 0
        assert all(sl.is_serving() for sl in sh.slices)
        assert sh.supervise_once() == {"detected": [], "replaced": []}
        sh.slices[0].kill()  # even a dead slice is not respawned now
        assert sh.supervise_once() == {"detected": [], "replaced": []}
        with pytest.raises(RuntimeError, match=CUDA_ERR):
            sh.execute("bfs", np.array([1], np.int32))
        with pytest.raises(RuntimeError, match=CUDA_ERR):
            sh.apply_delta(TorchBatch.from_ops([("insert", 1, 2)], start_seq=0))
        h = srv.health()
        assert h["status"] == "down" and CUDA_ERR in h["device_error"]
        assert sh.stats()["shard"]["device_error"] == repr(sh.device_error)
    finally:
        srv.close(drain=False)
        sh.close()


class _ThreadSlice(tshard.ProcSlice):
    """A ``ProcSlice`` whose child is the port's real child loop
    (``ShardWorker.run``) on a thread of this process over a socketpair —
    what ``_launch`` gives, without an interpreter. ``workers`` collects
    every worker started (respawns included)."""

    workers: list = []

    def _launch(self):
        from combblas_tpu_torch.serve._shardworker import ShardWorker

        a, b = socket.socketpair()
        w = ShardWorker(tipc.Channel(a, peer="parent"))
        t = threading.Thread(target=w.run, daemon=True)
        t.start()
        type(self).workers.append((self.idx, w, t))
        return tproc.ReplicaProc(self.idx, None, tipc.Channel(b, peer=f"slice{self.idx}"),
                                 ipc_timeout_s=self._ipc_timeout_s)

    def respawn(self):
        boot = {k: v for k, v in self._boot_msg.items() if k != "coo"}
        boot["recover"] = True
        return _ThreadSlice(self.idx, boot, workdir=self._workdir, device=self.device,
                            hb_interval_s=self._hb_interval_s,
                            ipc_timeout_s=self._ipc_timeout_s)


def _thread_engine(tmp_path, rows, cols, **kw):
    """A 2-slice process-mode engine over ``_ThreadSlice`` children on the
    CPU, built as ``ShardedEngine.build(mode="process")`` builds one."""
    _ThreadSlice.workers = []
    spec = tshard.plan_partition(N, 2)
    home = tmp_path / "proc"
    slices = []
    for i, (r0, r1) in enumerate(spec.bounds):
        lr, lc, _ = tshard.shard_coo(spec, i, rows, cols)
        shome = home / f"slice{i}"
        shome.mkdir(parents=True)
        np.savez(shome / tshard.SLAB_COO_NAME, rows=lr, cols=lc)
        boot = {"idx": i, "row0": r0, "row1": r1, "nrows": N, "ncols": N,
                "coo": str(shome / tshard.SLAB_COO_NAME), "kinds": ["bfs"],
                "home": str(shome), "warmup": True, "warmup_widths": [1, 2],
                "recover": False}
        slices.append(_ThreadSlice(i, boot, workdir=str(home), device="cpu",
                                   hb_interval_s=0.02, wait=False))
    tshard._boot_all(slices)
    return tshard.ShardedEngine(slices, spec, ("bfs",), home=str(home), nnz=-1,
                                mode="process", device="cpu", **kw)


def _stop_workers():
    for _i, w, t in _ThreadSlice.workers:
        w.ch.close()
        t.join(10)


def test_process_cuda_error_respawns_the_slice_and_keeps_the_server(tmp_path):
    """A process slice's CUDA error is its own: the slice is quarantined
    and respawned from its home, the batch replays under a fresh epoch
    with the unsharded answer, and the parent ``Server`` keeps serving;
    when every attempt fails, the batch fails with the child's error text
    and the parent ``Server`` still does not take it for its own."""
    rows, cols = _coo(29)
    eng = _engine("torch", rows, cols, kinds=("bfs",))
    sh = _thread_engine(tmp_path, rows, cols, exec_retries=1, recover_wait_s=10.0)
    assert not sh.shares_context and sh.device.type == "cpu"
    srv = sh.serve(PKG["torch"].ServeConfig(lane_widths=(1, 2), retry_budget=1))
    srv.start()
    try:
        first = [w for i, w, _t in _ThreadSlice.workers if i == 0][0]
        first.rt.hop = _raise_cuda
        lev = srv.submit("bfs", 4).result(timeout=60)["levels"]
        np.testing.assert_array_equal(lev, eng.execute("bfs", np.array([4], np.int32))["levels"][:, 0])
        assert sh.replacements == 1 and sh.device_error is None
        assert sh.slices[0].boot_info["wal_seq"] == -1  # recovered from its home
        assert srv.health()["status"] == "ok" and srv.device_error is None
        # every child now fails every hop: the batch fails, the server
        # does not go down
        from combblas_tpu_torch.serve.shard import SliceRuntime

        orig = SliceRuntime.hop

        def hop(rt, kind, m):
            if m.get("epoch", 0):  # a batch's hops; the warm-up's run
                raise RuntimeError(CUDA_ERR)
            return orig(rt, kind, m)

        SliceRuntime.hop = hop
        try:
            f = srv.submit("bfs", 6)
            exc = f.exception(timeout=60)
        finally:
            SliceRuntime.hop = orig
        assert CUDA_ERR in str(exc) and "[replica RuntimeError]" in str(exc)
        assert srv.device_error is None and srv.health()["status"] != "down"
        assert sh.device_error is None
        sh._heal(require_all=True)
        lev = srv.submit("bfs", 6).result(timeout=60)["levels"]
        np.testing.assert_array_equal(lev, eng.execute("bfs", np.array([6], np.int32))["levels"][:, 0])
    finally:
        srv.close(drain=False)
        sh.close()
        _stop_workers()


def test_shard_child_held_cuda_error_stops_serving(tmp_path):
    """The child loop: once an op meets a CUDA error, the heartbeat says
    ``serving: false`` with the error's repr, the parent's handle is not
    serving, and ``supervise_once`` replaces the slice though no hop is
    in flight."""
    rows, cols = _coo(31)
    sh = _thread_engine(tmp_path, rows, cols)
    try:
        sl = sh.slices[1]
        w = [w for i, w, _t in _ThreadSlice.workers if i == 1][0]
        deadline = time.monotonic() + 30
        while "t" not in sl.rp.last_hb and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sl.rp.last_hb["serving"] is True and sl.rp.last_hb["device_error"] is None
        w.rt.device_bytes = _raise_cuda
        with pytest.raises(RuntimeError, match=CUDA_ERR):
            sl.call("device_bytes")
        while sl.rp.last_hb.get("serving") is not False and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sl.rp.last_hb["device_error"] == repr(RuntimeError(CUDA_ERR))
        assert not sl.is_serving()
        assert sh.supervise_once() == {"detected": [1], "replaced": [1]}
        assert sh.slices[1] is not sl and sh.slices[1].is_serving()
        assert sl.rp.quarantined
    finally:
        sh.close()
        _stop_workers()


def test_shard_child_cuda_error_in_warmup_fails_its_boot(tmp_path, monkeypatch):
    """A CUDA error in the boot's warm-up fails the boot: the handle
    raises it and quarantines the child, whose heartbeat never starts; a
    warm-up error of another kind is recorded and the boot goes on."""
    from combblas_tpu_torch.serve.shard import SliceRuntime

    rows, cols = _coo(37)
    spec = tshard.plan_partition(N, 2)
    lr, lc, _ = tshard.shard_coo(spec, 0, rows, cols)
    home = tmp_path / "warm"
    (home / "slice0").mkdir(parents=True)
    np.savez(home / "slice0" / tshard.SLAB_COO_NAME, rows=lr, cols=lc)
    boot = {"idx": 0, "row0": 0, "row1": spec.bounds[0][1], "nrows": N, "ncols": N,
            "coo": str(home / "slice0" / tshard.SLAB_COO_NAME), "kinds": ["bfs"],
            "home": str(home / "slice0"), "warmup": True, "recover": False}
    _ThreadSlice.workers = []
    monkeypatch.setattr(SliceRuntime, "warmup", _raise_cuda)
    with pytest.raises(RuntimeError, match=CUDA_ERR):
        _ThreadSlice(0, boot, workdir=str(home), device="cpu", hb_interval_s=0.02)
    (_i, w, t), = _ThreadSlice.workers
    t.join(10)  # the quarantine closed the channel: the loop ends
    assert not t.is_alive() and w.rt is None and w.hb_interval_s is None

    def other(*a, **k):
        raise ValueError("not a device error")

    monkeypatch.setattr(SliceRuntime, "warmup", other)
    sl = _ThreadSlice(0, dict(boot, recover=True), workdir=str(home), device="cpu",
                      hb_interval_s=0.02)
    try:
        assert "not a device error" in sl.boot_info["warmed"]["error"]
        assert sl.call("ping")["pong"]
    finally:
        sl.close()
        _stop_workers()
