"""Parity of the port's delta log (``combblas_tpu_torch.dynamic.delta``)
with ``combblas_tpu.dynamic.delta`` on the CPU.

The buffer's bounds, tickets, validation, rollback, drain and
backpressure run through both packages with the same ops and give the
same sequence numbers, batches, errors and ``obs`` series. ``fold_ops``
is held against the reference's output bit for bit for every combine in
``COMBINES``, on op streams with heavy duplicate-key pressure, and
against a sequential per-op replay. Weights are multiples of 1/64, so
float32 sums are exact in any association order.
"""

import dataclasses

import numpy as np
import pytest

from combblas_tpu import obs as jobs
from combblas_tpu.dynamic import delta as jdelta
from combblas_tpu_torch import obs as tobs
from combblas_tpu_torch.dynamic import delta as tdelta
from torch_obs_parity import clean, series

BOTH = (jdelta, tdelta)


@pytest.fixture(autouse=True)
def _clean():
    with clean():
        yield


def same_batch(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif f.name != "oldest_at":
            assert x == y, f.name


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # the raise itself is what is compared
        return ("raise", type(exc).__name__, str(exc))


def test_constants_match_reference():
    assert tdelta.OP_NAMES == jdelta.OP_NAMES
    assert tdelta.COMBINES == jdelta.COMBINES
    assert (tdelta.OP_INSERT, tdelta.OP_DELETE, tdelta.OP_UPSERT) == (
        jdelta.OP_INSERT, jdelta.OP_DELETE, jdelta.OP_UPSERT)


def test_buffer_bounded_tickets_and_backpressure():
    """Tickets rise across drains; a batch that does not fit is refused
    whole (``DeltaOverflowError`` with the retry hint) — in both packages,
    with the same counters and series."""
    for o in (jobs, tobs):
        o.enable(install_hooks=False)
    got = []
    for m in BOTH:
        buf = m.DeltaBuffer(capacity=4, nrows=10, ncols=10, retry_after_s=0.25)
        out = [buf.add("insert", 1, 2, 0.5),
               buf.add_many([("delete", 2, 3), ("upsert", 3, 4, 2.0)])]
        with pytest.raises(m.DeltaOverflowError) as err:
            buf.add_many([("insert", 0, 0), ("insert", 0, 1)])  # 3 + 2 > 4
        assert err.value.retry_after_s == 0.25
        out.append(str(err.value))
        out.append(buf.depth())  # atomic: nothing was admitted
        assert buf.oldest_age() >= 0.0
        out.append(buf.add("insert", 4, 4))
        with pytest.raises(m.DeltaOverflowError):
            buf.add("insert", 5, 5)
        batch = buf.drain()
        out += [buf.drain(), buf.oldest_age(), buf.add("insert", 5, 5), buf.stats()]
        got.append((out, batch))
    assert got[0][0] == got[1][0]
    assert got[0][0][:2] == [0, 2] and got[0][0][3:5] == [3, 3]
    same_batch(got[0][1], got[1][1])
    assert len(got[1][1]) == 4 and got[1][1].last_seq == 3
    assert series(tobs) == series(jobs)
    assert ("counter", "serve.update.rejected", ()) in series(tobs)


def test_buffer_validates():
    """A malformed op is refused before any admission, whole batches
    atomically; a bad capacity or combine is refused at construction."""
    for m in BOTH:
        buf = m.DeltaBuffer(capacity=8, nrows=4, ncols=4)
        for args in (("insert", 4, 0), ("insert", 0, -1), ("frobnicate", 0, 0)):
            with pytest.raises(ValueError):
                buf.add(*args)
        with pytest.raises(ValueError):
            buf.add_many([("insert", 0, 0), ("insert", 0, 9)])
        with pytest.raises(ValueError):
            buf.add_many([])
        assert buf.depth() == 0
    for kw in ({"combine": "median"}, {"capacity": 0}):
        assert outcome(lambda: tdelta.DeltaBuffer(**kw)) == outcome(
            lambda: jdelta.DeltaBuffer(**kw))
        assert outcome(lambda: tdelta.DeltaBuffer(**kw))[0] == "raise"


def test_buffer_rollback_and_start_seq():
    """``rollback`` un-admits a pending tail and rewinds the tickets; it
    refuses to reach below the pending tail; ``start_seq`` resumes a
    lineage."""
    got = []
    for m in BOTH:
        buf = m.DeltaBuffer(capacity=16, start_seq=10)
        first = buf.add_many([("insert", 1, 1), ("insert", 2, 2)])
        tail = buf.add_many([("delete", 3, 3), ("upsert", 4, 4, 3.0)])
        out = [first, tail, buf.rollback(12), buf.rollback(12), buf.depth(),
               buf.add("insert", 9, 9), outcome(buf.rollback, 5)]
        batch = buf.drain()
        out += [outcome(buf.rollback, 12), buf.rollback(13), buf.oldest_age(),
                buf.stats()]
        got.append((out, batch))
    assert got[0][0] == got[1][0]
    assert got[1][0][:5] == [11, 13, 2, 0, 2] and got[1][0][6][0] == "raise"
    same_batch(got[0][1], got[1][1])
    assert got[1][1].first_seq == 10 and got[1][1].last_seq == 12


def test_from_ops_matches_reference():
    ops = [("insert", 1, 2, 0.5), ("delete", 2, 3), ("upsert", 3, 4, 2.0), ("insert", 5, 6)]
    same_batch(tdelta.DeltaBatch.from_ops(ops, start_seq=7, now=1.0),
               jdelta.DeltaBatch.from_ops(ops, start_seq=7, now=1.0))
    b = tdelta.DeltaBatch.from_ops([])
    assert len(b) == 0 and b.last_seq == 0
    for m in BOTH:
        with pytest.raises(ValueError, match="unknown delta op"):
            m.DeltaBatch.from_ops([("move", 1, 2)])


def _replay_naive(ops, base, combine):
    """Sequential per-op replay — the semantics ``fold_ops`` must match."""
    state = dict(base)  # key -> weight
    for op, k, w in ops:
        if op == "insert":
            state[k] = w
        elif op == "delete":
            state.pop(k, None)
        elif k not in state:
            state[k] = w
        elif combine == "min":
            state[k] = min(state[k], w)
        elif combine == "max":
            state[k] = max(state[k], w)
        elif combine == "sum":
            state[k] = state[k] + w
        else:  # last
            state[k] = w
    return state


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("combine", ["min", "max", "sum", "last"])
def test_fold_ops_matches_reference(combine, weighted):
    rng = np.random.default_rng(11)
    ncols = 16
    base_keys = np.sort(rng.choice(ncols * ncols, size=40, replace=False)).astype(np.int64)
    base_w = (rng.integers(1, 512, 40) / 64.0).astype(np.float32)
    m = 120
    keys = rng.choice(base_keys.tolist() + [7, 33, 99, 254], size=m)
    opnames = rng.choice(["insert", "delete", "upsert"], size=m)
    vals = (rng.integers(1, 512, m) / 64.0).astype(np.float32)
    ops = [(opnames[i], int(keys[i] // ncols), int(keys[i] % ncols), float(vals[i]))
           for i in range(m)]
    bw = base_w if weighted else None
    got = tdelta.fold_ops(tdelta.DeltaBatch.from_ops(ops), base_keys, bw, ncols, combine)
    want = jdelta.fold_ops(jdelta.DeltaBatch.from_ops(ops), base_keys, bw, ncols, combine)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    uniq, present, fw = got
    ref = _replay_naive([(opnames[i], int(keys[i]), float(vals[i])) for i in range(m)],
                        dict(zip(base_keys.tolist(), base_w.tolist())), combine)
    for k, p, w in zip(uniq.tolist(), present.tolist(), fw.tolist()):
        assert p == (k in ref), (k, combine)
        if p:
            assert np.float32(w) == (np.float32(ref[k]) if weighted else 1.0), (k, combine)


def test_fold_ops_edges():
    """An empty batch folds to nothing; an empty base treats every key as
    new; an unknown combine raises in both packages."""
    e = tdelta.DeltaBatch.from_ops([])
    for g, w in zip(tdelta.fold_ops(e, np.arange(3), None, 4),
                    jdelta.fold_ops(jdelta.DeltaBatch.from_ops([]), np.arange(3), None, 4)):
        assert g.dtype == w.dtype and g.shape == w.shape == (0,)
    ops = [("upsert", 1, 1, 2.0), ("upsert", 1, 1, 0.5), ("delete", 0, 3)]
    empty = np.empty(0, np.int64)
    for g, w in zip(tdelta.fold_ops(tdelta.DeltaBatch.from_ops(ops), empty, empty.astype(
            np.float32), 4), jdelta.fold_ops(jdelta.DeltaBatch.from_ops(ops), empty,
                                             empty.astype(np.float32), 4)):
        assert np.array_equal(g, w)
    b = tdelta.DeltaBatch.from_ops(ops)
    assert outcome(tdelta.fold_ops, b, empty, None, 4, "median") == outcome(
        jdelta.fold_ops, jdelta.DeltaBatch.from_ops(ops), empty, None, 4, "median")
