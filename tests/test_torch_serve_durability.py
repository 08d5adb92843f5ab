"""Parity of the port's durability layer — the write-ahead log
(``combblas_tpu_torch.dynamic.wal``), the ``GraphVersion`` snapshots of
``utils.checkpoint`` and crash recovery — with ``combblas_tpu``'s on the
CPU.

The WAL cases run on both packages' logs and give the same batches,
positions and counters: round trip, torn final line, interior damage,
truncation with its frontier mark, later lines winning on reused
sequence numbers, positional drop tombstones. Each package's log replays
under the other. Snapshots are atomic; a corrupt newest one is refused
and recovery falls back to the one before; retention keeps the newest;
a snapshot either package writes loads in the other with every bucket
array equal bit for bit.

Recovery: the port has no ``Server`` yet, so the write lane of the
reference's ``Server`` (``submit_update`` → WAL append, one merge a
batch, ``checkpoint_now`` → snapshot, prune, truncate) is driven here
step by step. For a crash at every append / merge / checkpoint boundary
(a torn final line included), ``recover`` equals a never-crashed chain
of merges of the acknowledged batches: ``to_host_coo`` and every bucket
array bit for bit, on 1x1 and 2x4; and the reference's ``recover`` on the
same directory gives the same version.
"""

import os

import jax
import numpy as np
import pytest

from combblas_tpu import dynamic as jdyn
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.serve import GraphEngine as JaxEngine
from combblas_tpu.tuner import config as jcfg
from combblas_tpu.utils import checkpoint as jck
from combblas_tpu_torch import Grid
from combblas_tpu_torch import dynamic as tdyn
from combblas_tpu_torch.serve import GraphEngine
from combblas_tpu_torch.utils import checkpoint as tck
from torch_serve_parity import own_plan_store  # noqa: F401

# engines record their lanes in the plan store: each test keeps its own
pytestmark = pytest.mark.usefixtures("own_plan_store")

N = 64
WALS = {"port": tdyn, "reference": jdyn}
MATS = ("E", "E_weighted", "P_ell", "ET")


def _coo(seed, n=N, m=300):
    r = np.random.default_rng(seed)
    rows = r.integers(0, n, m)
    cols = r.integers(0, n, m)
    return np.concatenate([rows, cols]), np.concatenate([cols, rows])


def _absent_pairs(rows, cols, k, n=N):
    present = set(zip(rows.tolist(), cols.tolist()))
    out = [(i, j) for i in range(n) for j in range(i + 1, n)
           if (i, j) not in present and (j, i) not in present]
    return out[:k]


def host(a):
    return a.numpy() if hasattr(a, "numpy") else np.asarray(jax.device_get(a))


def same_buckets(va, vb):
    """``to_host_coo`` and every bucket array of every matrix equal."""
    for nm in MATS:
        a, b = getattr(va, nm), getattr(vb, nm)
        assert (a is None) == (b is None), nm
        if a is None:
            continue
        for x, y in zip(a.to_host_coo(), b.to_host_coo()):
            assert np.array_equal(np.asarray(x), np.asarray(y)), nm
        assert len(a.buckets) == len(b.buckets), nm
        for ta, tb in zip(a.buckets, b.buckets):
            for x, y in zip(ta, tb):
                x, y = host(x), host(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), nm
    for f in ("deg", "outdeg", "host_weights"):
        x, y = getattr(va, f), getattr(vb, f)
        assert (x is None) == (y is None) and (x is None or np.array_equal(x, y)), f
    assert (va.nnz, va.wal_seq, va.headroom, va.feat_dim) == (
        vb.nnz, vb.wal_seq, vb.headroom, vb.feat_dim)


# --- the WAL ----------------------------------------------------------------------


def _batches(bs):
    return [(b.first_seq, b.last_seq, b.rows.tolist(), b.cols.tolist(), b.vals.tolist(),
             b.ops.tolist()) for b in bs]


def _run_wal_cases(m, d):
    """The reference's WAL unit cases on package ``m``'s log; returns
    everything observable."""
    out = []
    w = m.WriteAheadLog(os.path.join(d, "a.jsonl"))
    out.append(w.position())
    w.append(0, [3, 9], [9, 3], [1.0, 2.5], [0, 2])
    w.append(2, [5], [6], [1.0], [1])
    out += [w.position(), _batches(w.replay()), _batches(w.replay(after_seq=0))]
    w.close()
    w = m.WriteAheadLog(os.path.join(d, "a.jsonl"))
    out.append(w.position())
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.append(3, [1], [1], [1.0], [0])
    # torn final line
    p = os.path.join(d, "torn.jsonl")
    w = m.WriteAheadLog(p)
    w.append(0, [1], [2], [1.0], [0])
    w.close()
    with open(p, "a") as f:
        f.write('{"v": "combblas_tpu.wal/v1", "first_seq": 1, "la')
    w = m.WriteAheadLog(p)
    out += [_batches(w.replay()), w.invalid_lines]
    w.close()
    # interior damage and a foreign schema
    p = os.path.join(d, "damaged.jsonl")
    with open(p, "w") as f:
        f.write('{"v": "combblas_tpu.wal/v1", "first_seq": 0, "last_seq": 0, "rows": [1], '
                '"cols": [2], "vals": [1.0], "ops": [0]}\n')
        f.write("garbage not json\n")
        f.write('{"v": "some.other/v9", "first_seq": 1, "last_seq": 1, "rows": [9], '
                '"cols": [9], "vals": [1.0], "ops": [0]}\n')
        f.write('{"v": "combblas_tpu.wal/v1", "first_seq": 1, "last_seq": 1, "rows": [4], '
                '"cols": [5], "vals": [1.0], "ops": [7]}\n')
        f.write('{"v": "combblas_tpu.wal/v1", "first_seq": 1, "last_seq": 1, "rows": [4], '
                '"cols": [5], "vals": [1.0], "ops": [0]}\n')
    w = m.WriteAheadLog(p)
    out += [_batches(w.replay()), w.invalid_lines]
    w.close()
    # truncation keeps the suffix and the frontier
    p = os.path.join(d, "trunc.jsonl")
    w = m.WriteAheadLog(p)
    w.append(0, [1], [2], [1.0], [0])
    w.append(1, [3], [4], [1.0], [0])
    out += [w.truncate(0), _batches(w.replay()), w.position(), w.truncate(1), w.replay(),
            w.position(), w.truncate(1)]
    w.close()
    w = m.WriteAheadLog(p)
    out += [w.position(), os.path.exists(p + ".tmp")]
    w.close()
    # later lines win on reused sequence numbers; positional tombstones
    w = m.WriteAheadLog(os.path.join(d, "reuse.jsonl"))
    w.append(0, [1], [2], [1.0], [0])
    w.append(0, [7], [8], [1.0], [0])
    out.append(_batches(w.replay()))
    w.close()
    w = m.WriteAheadLog(os.path.join(d, "drop.jsonl"))
    w.append(0, [1, 2, 3], [4, 5, 6], [1.0] * 3, [0, 0, 0])
    w.append_drop(0, 2)
    w.append(0, [9], [9], [1.0], [0])
    out.append(_batches(w.replay()))
    w.close()
    w = m.WriteAheadLog(os.path.join(d, "tomb.jsonl"), fsync="off")
    w.append(0, [1, 2], [2, 1], [1.0, 1.0], [0, 0])
    w.append(2, [3], [4], [1.0], [0])
    w.append_drop(0, 1)
    out += [_batches(w.replay()), w.fsync, w.stats()["appended"], w.stats()["position"]]
    w.close()
    return out


def test_wal_cases_match_reference(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = _run_wal_cases(tdyn, str(tmp_path / "t"))
    want = _run_wal_cases(jdyn, str(tmp_path / "j"))
    assert got == want
    # the reference's expectations, on the port's log
    assert got[0] == -1 and got[1] == 2 and got[4] == 2
    assert [(b[0], b[1]) for b in got[2]] == [(0, 1), (2, 2)] and got[3][0][2] == [9]
    assert got[6] == 1 and got[8] == 3  # torn tail; garbage, foreign schema, bad op
    for name in os.listdir(tmp_path / "t"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    with pytest.raises(ValueError, match="COMBBLAS_WAL_FSYNC"):
        tdyn.WriteAheadLog(str(tmp_path / "x.jsonl"), fsync="sometimes")


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_wal_replays_under_the_other_package(tmp_path, writer, reader):
    w = WALS[writer].open_wal(str(tmp_path))
    w.append(0, [3, 9, 4], [9, 3, 4], [1.0, 2.5, 0.125], [0, 2, 1])
    w.append(3, [5], [6], [1.0], [1])
    w.append_drop(3, 3)
    w.append(4, [7, 8], [8, 7], [1.5, 1.5], [0, 0])
    w.truncate(0)
    w.close()
    r = WALS[reader].open_wal(str(tmp_path))
    back = WALS[writer].open_wal(str(tmp_path))
    assert r.position() == back.position() == 5
    assert _batches(r.replay(after_seq=1)) == _batches(back.replay(after_seq=1))
    assert _batches(r.replay()) == _batches(back.replay())
    r.close()
    back.close()


# --- snapshots ----------------------------------------------------------------------


def _engine(m, G, seed=1, **kw):
    rows, cols = _coo(seed)
    w = np.random.default_rng(seed).integers(1, 9, len(rows)).astype(np.float32)
    return m.from_coo(G, rows, cols, N, weights=w, keep_coo=True, **kw), rows, cols


def test_snapshot_atomic_corrupt_refused_and_retention(tmp_path):
    """``save_version`` leaves no tmp file; a truncated snapshot is
    refused naming the file, and ``load_latest_version`` falls back to
    the one before; with nothing loadable it raises ``RecoveryError``;
    names, listing and retention follow the reference's."""
    G = Grid.make(1, 1, device="cpu")
    eng, _r, _c = _engine(GraphEngine, G, kinds=("bfs", "sssp", "pagerank"))
    assert tck.snapshot_name(-1) == jck.snapshot_name(-1) == "ckpt-000000000000.npz"
    assert tck.snapshot_seq(tck.snapshot_name(41)) == 41
    paths = []
    for seq in (0, 3, 5):
        eng.version.wal_seq = seq
        paths.append(str(tmp_path / tck.snapshot_name(seq)))
        tck.save_version(paths[-1], eng.version)
        assert not os.path.exists(paths[-1] + ".tmp")
    (tmp_path / "ckpt-000000000009.npz.tmp").write_bytes(b"in flight")
    assert tck.list_snapshots(str(tmp_path)) == jck.list_snapshots(str(tmp_path)) == paths
    retain = jcfg.DEFAULT_CHECKPOINT_RETAIN  # the serving layer's default
    for old in tck.list_snapshots(str(tmp_path))[:-retain]:
        os.unlink(old)
    assert tck.list_snapshots(str(tmp_path)) == paths[-retain:]
    blob = open(paths[-1], "rb").read()
    with open(paths[-1], "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="ckpt-000000000006"):
        tck.load_version(paths[-1], G)
    with pytest.warns(UserWarning, match="falling back"):
        v, path = tck.load_latest_version(str(tmp_path), G)
    assert path == paths[-2] and v.wal_seq == 3
    eng.version.wal_seq = 3
    same_buckets(v, eng.version)
    with pytest.raises(tck.SnapshotError, match="SAME grid shape"):
        tck.load_version(paths[-2], Grid.make(2, 1, device="cpu"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(tdyn.RecoveryError, match="no loadable"):
        tck.load_latest_version(str(tmp_path / "empty"), G)


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)])
def test_snapshots_load_across_packages(tmp_path, shape):
    """A merged version with every artifact (weights, pagerank, a
    transpose, a feature table) saved by one package loads in the other
    with every bucket array, vector block and meta field equal; a loaded
    version keeps taking merges equal to the reference's."""
    rows, cols = _coo(2)
    w = np.random.default_rng(2).integers(1, 9, len(rows)).astype(np.float32)
    X = np.random.default_rng(3).random((N, 3)).astype(np.float32)
    kw = dict(weights=w, keep_coo=True, features=X, symmetric=False, headroom=0.25,
              kinds=("bfs", "sssp", "pagerank", "bc", "propagate"))
    tG, jG = Grid.make(*shape, device="cpu"), JaxGrid.make(*shape)
    teng = GraphEngine.from_coo(tG, rows, cols, N, **kw)
    jeng = JaxEngine.from_coo(jG, rows, cols, N, **kw)
    ops = [("insert", 0, 5, 2.0), ("insert", 5, 0, 2.0), ("delete", int(rows[0]), int(cols[0]))]
    tv = tdyn.apply_delta(teng.version, tdyn.DeltaBatch.from_ops(ops), kinds=teng.kinds())
    jv = jdyn.apply_delta(jeng.version, jdyn.DeltaBatch.from_ops(ops), kinds=jeng.kinds())
    tv.wal_seq = jv.wal_seq = 2
    tck.save_version(str(tmp_path / "t.npz"), tv, extra_meta={"shard": 1})
    jck.save_version(str(tmp_path / "j.npz"), jv, extra_meta={"shard": 1})
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    from_ref = tck.load_version(str(tmp_path / "j.npz"), tG)
    from_port = jck.load_version(str(tmp_path / "t.npz"), jG)
    same_buckets(from_ref, from_port)
    same_buckets(from_ref, tv)
    assert from_ref.extra_meta == {"shard": 1}
    for f in ("dangling", "X"):
        assert np.array_equal(getattr(from_ref, f).blocks.numpy(),
                              host(getattr(from_port, f).blocks))
    ops2 = [("insert", 7, 9, 1.0), ("insert", 9, 7, 1.0), ("delete", 0, 5)]
    t2 = tdyn.apply_delta(from_ref, tdyn.DeltaBatch.from_ops(ops2), kinds=teng.kinds())
    j2 = jdyn.apply_delta(from_port, jdyn.DeltaBatch.from_ops(ops2), kinds=jeng.kinds())
    assert t2.dyn.last_stats.bootstrapped and t2.dyn.last_stats.mode == "incremental"
    same_buckets(t2, j2)
    assert not hasattr(tck.load_version(str(tmp_path / "t.npz"), tG, writable=False),
                       "dyn_source")


# --- crash recovery ----------------------------------------------------------------


class Lane:
    """The reference ``Server``'s write lane, step by step: each update
    is admitted to a ``DeltaBuffer`` and appended to the WAL (the
    acknowledgement), a merge drains the buffer into one ``apply_delta``
    and a swap, and a checkpoint snapshots the served version, prunes to
    the retention depth and truncates the WAL through the oldest
    retained snapshot."""

    def __init__(self, eng, d, retain=2):
        self.eng, self.d, self.retain = eng, str(d), retain
        self.buf = tdyn.DeltaBuffer(nrows=eng.nrows, ncols=eng.version.ncols)
        self.wal = tdyn.open_wal(self.d)
        self.checkpoint()  # the bootstrap snapshot

    def submit(self, ops):
        last = self.buf.add_many(ops)
        self.wal.append(last - len(ops) + 1, [o[1] for o in ops], [o[2] for o in ops],
                        [o[3] if len(o) > 3 else 1.0 for o in ops],
                        [tdyn.OP_NAMES.index(o[0]) for o in ops])

    def merge(self):
        batch = self.buf.drain()
        v = self.eng.apply_delta(batch)
        v.wal_seq = batch.last_seq
        self.eng.swap(v)
        return v.dyn.last_stats

    def checkpoint(self):
        v = self.eng.version
        tck.save_version(os.path.join(self.d, tck.snapshot_name(v.wal_seq)), v)
        for old in tck.list_snapshots(self.d)[:-self.retain]:
            os.unlink(old)
        self.wal.truncate(tck.snapshot_seq(tck.list_snapshots(self.d)[0]))


def _scenario(grid, jgrid, d, n_appends, n_merges, ckpt_after, torn):
    rows, cols = _coo(7)
    eng = GraphEngine.from_coo(grid, rows, cols, N, kinds=("bfs",), keep_coo=True)
    lane = Lane(eng, d)
    batches = [[("insert", a, b), ("insert", b, a)]
               for a, b in _absent_pairs(rows, cols, n_appends)]
    for k, ops in enumerate(batches):
        lane.submit(ops)
        if k < n_merges:
            lane.merge()
        if ckpt_after is not None and k + 1 == ckpt_after:
            lane.checkpoint()
    if torn:  # one more append, torn mid-line by the dying process
        with open(os.path.join(d, "wal.jsonl"), "a") as f:
            f.write('{"v": "combblas_tpu.wal/v1", "first_se')
    # CRASH: the lane is dropped; the files are all that survives
    recovered = tdyn.recover(str(d), grid, kinds=("bfs",))
    never = GraphEngine.from_coo(grid, rows, cols, N, kinds=("bfs",), keep_coo=True).version
    for k, ops in enumerate(batches):
        never = tdyn.apply_delta(never, tdyn.DeltaBatch.from_ops(ops, start_seq=2 * k),
                                 kinds=("bfs",))
        never.wal_seq = 2 * k + 1
    same_buckets(recovered, never)
    assert recovered.recovered_from[2] == 2 * (n_appends - min(ckpt_after or 0, n_appends))
    if jgrid is not None:
        same_buckets(recovered, jdyn.recover(str(d), jgrid, kinds=("bfs",)))
    return recovered


def test_crash_recovery_bit_exact_at_every_boundary(tmp_path):
    """Crashes at every append / merge / checkpoint boundary recover the
    never-crashed version bit for bit, torn final lines included; the
    reference recovers the same version from the port's files."""
    grid = Grid.make(1, 1, device="cpu")
    cases = []
    for k in (1, 2, 4):
        for m in sorted({0, k // 2, k}):
            for c in sorted({None, m if m else None}, key=lambda x: -1 if x is None else x):
                cases.append((k, m, c, False))
    cases += [(4, 2, 2, True), (3, 3, None, True)]
    for i, (k, m, c, torn) in enumerate(cases):
        d = tmp_path / f"crash-{i}"
        _scenario(grid, JaxGrid.make(1, 1) if i in (3, len(cases) - 2) else None,
                  str(d), k, m, c, torn)


def test_crash_recovery_distributed(tmp_path):
    """A 2x4 representative: a snapshot of an incrementally merged
    version plus suffix replay, crash after the checkpoint."""
    v = _scenario(Grid.make(2, 4, device="cpu"), JaxGrid.make(2, 4), str(tmp_path), 3, 2, 2,
                  False)
    assert v.wal_seq == 5


def test_recovered_version_serves_and_resumes(tmp_path):
    """A recovered version swaps into a warmed engine without a plan build
    and serves what the never-crashed engine serves; its WAL frontier
    resumes the sequence lineage."""
    grid = Grid.make(1, 1, device="cpu")
    rows, cols = _coo(9)
    eng = GraphEngine.from_coo(grid, rows, cols, N, kinds=("bfs",), keep_coo=True)
    lane = Lane(eng, tmp_path)
    for a, b in _absent_pairs(rows, cols, 3):
        lane.submit([("insert", a, b), ("insert", b, a)])
        lane.merge()
    served = eng.execute("bfs", np.arange(4, dtype=np.int32))
    warm = GraphEngine.from_coo(grid, rows, cols, N, kinds=("bfs",))
    warm.warmup(widths=(4,))
    mark = warm.trace_mark()
    v = tdyn.recover(str(tmp_path), grid)
    warm.swap(v)
    got = warm.execute("bfs", np.arange(4, dtype=np.int32))
    assert warm.retraces_since(mark) == 0
    for k in served:
        assert np.array_equal(np.asarray(got[k]), np.asarray(served[k]))
    w = tdyn.open_wal(str(tmp_path))
    buf = tdyn.DeltaBuffer(start_seq=w.position() + 1)
    assert buf.add("insert", 0, 1) == v.wal_seq + 1 == 6
    w.close()
