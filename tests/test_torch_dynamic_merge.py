"""Parity of the port's incremental merge (``combblas_tpu_torch.dynamic.merge``)
with ``combblas_tpu.dynamic.merge`` on the CPU.

The same graphs (random symmetric COO from a numpy seed, float32 weights)
load into both engines and take the same delta batches. Every merged
version is held against the reference's bit for bit: every bucket array
of E, E_weighted, P_ell and ET (dtype, shape and values, so the sticky
slots and headroom padding too), the degree tables, the dangling blocks,
the retained COO and weights, the refresh lineage (``delta_from``) and
``MergeStats`` (all but the latency), on 1x1, 2x2 and 2x4. Each is also
held against a full rebuild of its merged edge list through the port's
own ``build_version`` (the reference's acceptance contract, canonical COO
compare), and the ``dynamic.*`` series against the reference's.
"""

import dataclasses

import jax
import numpy as np
import pytest

from combblas_tpu.dynamic import DeltaBatch as JaxBatch
from combblas_tpu.dynamic import apply_delta as jax_apply
from combblas_tpu import obs as jobs
from combblas_tpu.parallel.ellmat import EllParMat as JaxEll
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.serve import GraphEngine as JaxEngine
from combblas_tpu_torch import EllParMat, Grid
from combblas_tpu_torch import obs as tobs
from combblas_tpu_torch.dynamic import DeltaBatch, apply_delta
from combblas_tpu_torch.serve import GraphEngine
from torch_obs_parity import clean, series

MATS = ("E", "E_weighted", "P_ell", "ET")


@pytest.fixture(autouse=True)
def _clean():
    with clean():
        yield


def _sym_coo(rng, n, m):
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    return np.concatenate([r, c]), np.concatenate([c, r])


def host(a):
    return a.numpy() if hasattr(a, "numpy") else np.asarray(jax.device_get(a))


def same_version(tv, jv):
    """Every artifact of the port's version equals the reference's."""
    for nm in MATS:
        a, b = getattr(tv, nm), getattr(jv, nm)
        assert (a is None) == (b is None), nm
        if a is None:
            continue
        assert (a.nrows, a.ncols, len(a.buckets)) == (b.nrows, b.ncols, len(b.buckets)), nm
        for ta, ja in zip(a.buckets, b.buckets):
            for x, y in zip(ta, ja):
                y = host(y)
                assert x.numpy().dtype == y.dtype and np.array_equal(x.numpy(), y), nm
    for f in ("deg", "outdeg", "host_weights"):
        x, y = getattr(tv, f), getattr(jv, f)
        assert (x is None) == (y is None) and (x is None or (
            x.dtype == y.dtype and np.array_equal(x, y))), f
    assert (tv.host_coo is None) == (jv.host_coo is None)
    if tv.host_coo is not None:
        for x, y in zip(tv.host_coo, jv.host_coo):
            assert np.array_equal(x, y)
    assert (tv.dangling is None) == (jv.dangling is None)
    if tv.dangling is not None:
        assert np.array_equal(tv.dangling.blocks.numpy(), host(jv.dangling.blocks))
    assert (tv.nnz, tv.nrows, tv.ncols, tv.headroom) == (jv.nnz, jv.nrows, jv.ncols, jv.headroom)
    if jv.delta_from is not None:
        assert tv.delta_from[0] == jv.delta_from[0]
        for x, y in zip(tv.delta_from[1:], jv.delta_from[1:]):
            assert np.array_equal(x, y)
    ts, js = (dataclasses.asdict(v.dyn.last_stats) for v in (tv, jv))
    ts.pop("latency_s")
    js.pop("latency_s")
    assert ts == js
    return tv.dyn.last_stats


def same_as_rebuild(eng, v):
    """The full build of ``v``'s merged edge list holds the same matrices
    (canonical COO), degrees and dangling vector."""
    r, c, _n = v.host_coo
    gold = eng.build_version(r, c, weights=v.host_weights, keep_coo=True,
                             symmetric=v.ET is None)
    for nm in MATS:
        a, b = getattr(v, nm), getattr(gold, nm)
        assert (a is None) == (b is None), nm
        if a is not None:
            for x, y in zip(a.to_host_coo(), b.to_host_coo()):
                assert np.array_equal(x, y), nm
    assert np.array_equal(v.deg, gold.deg) and np.array_equal(v.outdeg, gold.outdeg)
    if v.dangling is not None:
        assert np.array_equal(v.dangling.blocks.numpy(), gold.dangling.blocks.numpy())
    assert v.nnz == gold.nnz


def engines(shape, rows, cols, n, **kw):
    return (GraphEngine.from_coo(Grid.make(*shape, device="cpu"), rows, cols, n, **kw),
            JaxEngine.from_coo(JaxGrid.make(*shape), rows, cols, n, **kw))


def both_apply(tv, jv, ops, **kw):
    return (apply_delta(tv, DeltaBatch.from_ops(ops), **kw),
            jax_apply(jv, JaxBatch.from_ops(ops), **kw))


def weighted(shape, seed=0, n=96, m=500, **kw):
    rng = np.random.default_rng(seed)
    rows, cols = _sym_coo(rng, n, m)
    w = rng.random(len(rows)).astype(np.float32) + 0.1
    return engines(shape, rows, cols, n, weights=w, keep_coo=True, **kw) + (rows, cols)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_apply_delta_matches_reference(shape):
    """Symmetric deletes, insert-delete-reinsert of one key and stacked
    upserts in one batch: an incremental merge equal to the reference's,
    untouched classes sharing the parent's tensors, and equal to a full
    rebuild; the plans built before the swap serve it without a build."""
    teng, jeng, rows, cols = weighted(shape)
    n = teng.nrows
    er, ec = np.divmod(np.unique(rows.astype(np.int64) * n + cols), n)
    ops = []
    for t in range(4):
        ops += [("delete", int(er[t * 11]), int(ec[t * 11])),
                ("delete", int(ec[t * 11]), int(er[t * 11]))]
    ops += [("insert", 1, 2, 9.0), ("delete", 1, 2), ("insert", 1, 2, 3.5),
            ("insert", 2, 1, 3.5),
            ("upsert", int(er[50]), int(ec[50]), 0.05),
            ("upsert", int(er[50]), int(ec[50]), 0.01),
            ("upsert", int(ec[50]), int(er[50]), 0.01),
            ("insert", 7, 9, 1.25), ("insert", 9, 7, 1.25)]
    for o in (jobs, tobs):
        o.enable(install_hooks=False)
    tv, jv = both_apply(teng.version, jeng.version, ops, kinds=teng.kinds())
    for o in (jobs, tobs):
        o.disable()
    assert series(tobs) == series(jobs)
    st = same_version(tv, jv)
    assert st.mode == "incremental" and st.rows_patched > 0 and st.buckets_reused > 0
    # untouched classes are the parent's tensors themselves
    shared = sum(
        b[0] is getattr(teng.version, nm).buckets[i][0]
        for nm in ("E", "E_weighted", "P_ell") for i, b in enumerate(getattr(tv, nm).buckets))
    assert shared == st.buckets_reused
    same_as_rebuild(teng, tv)
    teng.warmup(kinds=("bfs", "sssp"), widths=(2,))
    mark = teng.trace_mark()
    teng.swap(tv)
    jeng.swap(jv)
    for kind in ("bfs", "sssp"):
        a, b = teng.execute(kind, np.asarray([1, 7], np.int32)), jeng.execute(
            kind, np.asarray([1, 7], np.int32))
        for k in a:
            assert np.array_equal(a[k], b[k]), (kind, k)
    assert teng.retraces_since(mark) == 0


def test_directed_transpose_twin():
    """ET (bc on a directed graph) is patched through the second
    orientation, as the reference's."""
    rng = np.random.default_rng(1)
    n, m = 64, 300
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    teng, jeng = engines((2, 2), rows, cols, n, kinds=("bfs", "bc"), symmetric=False,
                         keep_coo=True)
    assert teng.version.ET is not None
    ops = [("insert", 0, 5), ("insert", 5, 0), ("delete", int(rows[0]), int(cols[0])),
           ("insert", 10, 11)]
    tv, jv = both_apply(teng.version, jeng.version, ops, kinds=teng.kinds())
    assert same_version(tv, jv).mode == "incremental"
    same_as_rebuild(teng, tv)


def test_spill_threshold_and_forced_rebuild(monkeypatch):
    """A delta past the structural-change fraction rebuilds
    (``threshold``), as does ``force_rebuild``; ``COMBBLAS_DYNAMIC_SPILL_FRAC``
    moves the threshold — equal to the reference's in each case."""
    teng, jeng, _r, _c = weighted((1, 1), seed=2, n=64, m=250)
    n = teng.nrows
    ops = []
    for i in range(n):  # dense new clique rows: far past 10%
        for j in (1, 3, 5):
            ops += [("insert", i, (i + j) % n, 1.0), ("insert", (i + j) % n, i, 1.0)]
    for o in (jobs, tobs):
        o.enable(install_hooks=False)
    tv, jv = both_apply(teng.version, jeng.version, ops, kinds=teng.kinds())
    st = same_version(tv, jv)
    assert st.mode == "rebuild" and st.reason == "threshold"
    spilled = tv
    tv, jv = both_apply(teng.version, jeng.version, ops[:2], kinds=teng.kinds(),
                        force_rebuild=True)
    assert same_version(tv, jv).reason == "forced"
    monkeypatch.setenv("COMBBLAS_DYNAMIC_SPILL_FRAC", "0.9")
    tv, jv = both_apply(teng.version, jeng.version, ops, kinds=teng.kinds())
    assert same_version(tv, jv).reason not in ("threshold", "")
    for o in (jobs, tobs):
        o.disable()
    assert series(tobs) == series(jobs)
    same_as_rebuild(teng, spilled)


def test_bucket_full_spill_and_headroom(monkeypatch):
    """A tight degree-1 ring has no free slot for a growing row: an
    honest rebuild (``bucket_full``). Built with headroom, the same
    insert re-buckets into the reserve (``headroom_used``) and keeps
    every bucket shape; ``COMBBLAS_DYNAMIC_HEADROOM`` drives builds that
    pass none."""
    n = 8
    rows = np.arange(n)
    cols = (rows + 1) % n
    rs, cs = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    ops = [("insert", 0, 4), ("insert", 4, 0)]
    for headroom, mode in ((None, "rebuild"), (0.5, "incremental")):
        teng, jeng = engines((1, 1), rs, cs, n, kinds=("bfs",), keep_coo=True,
                             headroom=headroom)
        tv, jv = both_apply(teng.version, jeng.version, ops, kinds=teng.kinds(),
                            spill_frac=1.0)
        st = same_version(tv, jv)
        assert st.mode == mode
        same_as_rebuild(teng, tv)
    assert st.headroom_used > 0 and st.rows_rebucketed > 0 and tv.headroom == 0.5
    for b_new, b_old in zip(tv.E.buckets, teng.version.E.buckets):
        assert b_new[0].shape == b_old[0].shape
    tight = EllParMat.host_build(Grid.make(1, 1, device="cpu"), rows, cols,
                                 np.ones(n, np.float32), n, n)
    monkeypatch.setenv("COMBBLAS_DYNAMIC_HEADROOM", "1.0")
    slack = EllParMat.host_build(Grid.make(1, 1, device="cpu"), rows, cols,
                                 np.ones(n, np.float32), n, n)
    want = JaxEll.host_build(JaxGrid.make(1, 1), rows, cols, np.ones(n, np.float32), n, n)
    assert slack[0][0].shape[2] == 2 * tight[0][0].shape[2] == want[0][0].shape[2]
    teng = GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), rs, cs, n, kinds=("bfs",))
    assert teng.version.headroom == 1.0


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_merge_chain(shape):
    """Merge state evolves across a chain of deltas (inserts, upserts
    that lower weights, deletes of earlier inserts): each link equal to
    the reference's, the end equal to one rebuild."""
    teng, jeng, rows, cols = weighted(shape, seed=3, n=64, m=300)
    n = teng.nrows
    rng = np.random.default_rng(4)
    tv, jv = teng.version, jeng.version
    added = []
    for step in range(5):
        a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
        ops = [("insert", a, b, 0.5 + step), ("insert", b, a, 0.5 + step),
               ("upsert", int(rows[step]), int(cols[step]), 0.01),
               ("upsert", int(cols[step]), int(rows[step]), 0.01)]
        if added:
            c, d = added.pop(0)
            ops += [("delete", c, d), ("delete", d, c)]
        added.append((a, b))
        tv, jv = both_apply(tv, jv, ops, kinds=teng.kinds())
        same_version(tv, jv)
        teng.swap(tv)
        jeng.swap(jv)
    same_as_rebuild(teng, tv)


def test_requires_host_coo_and_index_checks():
    rng = np.random.default_rng(5)
    rows, cols = _sym_coo(rng, 32, 100)
    teng = GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), rows, cols, 32)  # no keep_coo
    with pytest.raises(ValueError, match="keep_coo"):
        apply_delta(teng.version, DeltaBatch.from_ops([("insert", 0, 1)]), kinds=teng.kinds())
    teng = GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), rows, cols, 32, keep_coo=True)
    for ops in ([("insert", 0, 32)], [("insert", -1, 0)]):
        with pytest.raises(ValueError, match="outside"):
            apply_delta(teng.version, DeltaBatch.from_ops(ops))
    with pytest.raises(ValueError, match="unknown combine"):
        apply_delta(teng.version, DeltaBatch.from_ops([("insert", 0, 1)]), combine="median")


@pytest.mark.parametrize("kinds", [("bfs", "bc"), ("bfs", "propagate")])
def test_symmetry_guard(kinds):
    """A bc- or propagate-serving symmetric engine (E is its own
    transpose) refuses a delta that breaks structural symmetry, with the
    reference's message."""
    rng = np.random.default_rng(6)
    n = 32
    rows, cols = _sym_coo(rng, n, 120)
    X = rng.random((n, 4)).astype(np.float32)
    teng, jeng = engines((2, 2), rows, cols, n, kinds=kinds, keep_coo=True, features=X)
    present = set(zip(rows.tolist(), cols.tolist()))
    a, b = next((a, b) for a in range(n) for b in range(n)
                if a != b and (a, b) not in present)
    msgs = []
    for fn, B, v in ((apply_delta, DeltaBatch, teng.version),
                     (jax_apply, JaxBatch, jeng.version)):
        with pytest.raises(ValueError, match="symmetr") as err:
            fn(v, B.from_ops([("insert", a, b)]), kinds=kinds)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    tv, jv = both_apply(teng.version, jeng.version, [("insert", a, b), ("insert", b, a)],
                        kinds=kinds)
    same_version(tv, jv)
    assert tv.X is teng.version.X and tv.invdeg is None


def test_csc_and_coldeg_survive_noop_merge():
    """A fold that touches no edge (an upsert that keeps the stored
    weight) carries the lazy CSC companion and coldeg; a structural change
    resets both."""
    teng, jeng, rows, cols = weighted((2, 2))
    coo = teng.version.host_coo
    csc, coldeg = teng.csc_companion(), teng.coldeg_vec()
    teng._host_coo = coo  # the companion released the COO; the merge needs it
    r0, c0 = int(rows[0]), int(cols[0])
    tv, jv = both_apply(teng.version, jeng.version, [("upsert", r0, c0, 123.0)],
                        kinds=teng.kinds())
    st = same_version(tv, jv)
    assert (st.mode, st.inserted, st.removed) == ("incremental", 0, 0)
    assert tv.csc is csc and tv.coldeg is coldeg
    free = next((a, b) for a in range(3) for b in range(3)
                if a != b and not np.any((rows == a) & (cols == b)))
    real = [("insert", free[0], free[1], 1.0), ("insert", free[1], free[0], 1.0)]
    tv, jv = both_apply(teng.version, jeng.version, real, kinds=teng.kinds())
    same_version(tv, jv)
    assert tv.csc is None and tv.coldeg is None


def test_engine_apply_delta_and_bootstrap_state():
    """``GraphEngine.apply_delta`` merges into the current version with
    the engine's kinds; the merge state is built once (``bootstrapped``)
    and carried by the merged version."""
    teng, jeng, rows, cols = weighted((1, 1), seed=8, n=48, m=200)
    ops = [("insert", 0, 1, 2.0), ("insert", 1, 0, 2.0)]
    tv = teng.apply_delta(DeltaBatch.from_ops(ops))
    jv = jeng.apply_delta(JaxBatch.from_ops(ops))
    assert same_version(tv, jv).bootstrapped
    teng.swap(tv)
    jeng.swap(jv)
    tv2 = teng.apply_delta(DeltaBatch.from_ops([("delete", 0, 1), ("delete", 1, 0)]))
    jv2 = jeng.apply_delta(JaxBatch.from_ops([("delete", 0, 1), ("delete", 1, 0)]))
    st = same_version(tv2, jv2)
    assert not st.bootstrapped and tv2.delta_from[0] == 2
    same_as_rebuild(teng, tv2)
