"""Parity of the port's serving engine and batcher
(``combblas_tpu_torch.serve``) with ``combblas_tpu.serve`` on the CPU.

Both packages load the same R-MAT graph (scale 7, from a numpy seed, with
integer weights 1..15 and a 5-wide feature table) and serve the same
batches, ``PAD_ROOT`` lanes included. Held bit for bit: BFS parents,
levels and ``batch_niter``, SSSP distances (min-plus over integer
weights), ``device_bytes``, the kinds, the plan cache's counters and
stats, the lane record in the plan store, the batcher's lanes, and the
``serve.*`` series. PageRank and BC lanes are float sums folded in
another order: held within ``rtol=1e-5`` and ``atol = 1e-6 · max |x|``;
propagate features likewise. The served lanes also equal the port's
direct calls (``bfs_batch``, ``sssp_batch``, ``pagerank_batch``,
``bc_batch_dense_lanes``, the propagate batch) bit for bit.

The engine's plans run eager torch: a plan's ``traces`` counts its
builds (one a (kind, width)), and the reference's ``trace.serve``
counter is left out of the series compared.
"""

import dataclasses
from concurrent.futures import Future

import jax
import numpy as np
import pytest

from combblas_tpu import obs as jobs
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.serve import GraphEngine as JaxEngine
from combblas_tpu.serve import batcher as jbatcher
from combblas_tpu.tuner import store as jstore
from combblas_tpu_torch import PAD_ROOT, Grid
from combblas_tpu_torch import obs as tobs
from combblas_tpu_torch.models.bc import bc_batch_dense_lanes
from combblas_tpu_torch.models.bfs import bfs_batch
from combblas_tpu_torch.models.pagerank import pagerank_batch
from combblas_tpu_torch.models.propagate import _propagate_batch_impl
from combblas_tpu_torch.models.sssp import sssp_batch
from combblas_tpu_torch.serve import KINDS, GraphEngine, GraphVersion
from combblas_tpu_torch.serve import batcher as tbatcher
from combblas_tpu_torch.tuner import store as tstore
from combblas_tpu_torch.utils.rmat import rmat_symmetric_coo_host
from torch_obs_parity import clean, series, spans

SCALE = 7
N = 1 << SCALE
FLOAT_KEYS = ("ranks", "scores", "features")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("COMBBLAS_PLAN_STORE", str(tmp_path / "plans"))
    jstore._reset_for_tests()
    tstore._reset_for_tests()
    with clean():
        yield
    jstore._reset_for_tests()
    tstore._reset_for_tests()


@pytest.fixture(scope="module")
def graph():
    rows, cols = rmat_symmetric_coo_host(3, SCALE, 8)
    rng = np.random.default_rng(7)
    w = rng.integers(1, 16, len(rows)).astype(np.float32)
    X = rng.random((N, 5)).astype(np.float32)
    live = np.flatnonzero(np.bincount(rows, minlength=N)).astype(np.int32)
    return rows, cols, w, X, live


def engines(graph, shape, **kw):
    rows, cols, w, X, _ = graph
    kw = {"weights": w, "features": X, **kw}
    return (JaxEngine.from_coo(JaxGrid.make(*shape), rows, cols, N, **kw),
            GraphEngine.from_coo(Grid.make(*shape, device="cpu"), rows, cols, N, **kw))


@pytest.fixture(scope="module")
def pair(graph):
    return engines(graph, (2, 2))


def same_result(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if not isinstance(a[k], np.ndarray):
            assert type(b[k]) is int and a[k] == b[k], k
        elif k in FLOAT_KEYS:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       atol=1e-6 * max(float(np.abs(a[k]).max()), 1e-30))
        else:
            assert b[k].dtype == a[k].dtype and np.array_equal(b[k], a[k]), k


# --- the engine against the reference ------------------------------------------


def test_default_kinds_and_symmetry_checks(graph):
    rows, cols, w, X, _ = graph
    for m, G in ((JaxEngine, JaxGrid.make(1, 1)), (GraphEngine, Grid.make(1, 1, device="cpu"))):
        assert "sssp" not in m.from_coo(G, rows, cols, N).kinds()  # no weights
        assert m.from_coo(G, rows, cols, N, weights=w, features=X).kinds() == KINDS
        # a directed chain under symmetric=True is refused for bc
        with pytest.raises(ValueError, match="not structurally symmetric"):
            m.from_coo(G, np.array([1, 2, 3]), np.array([0, 1, 2]), 4)
        eng = m.from_coo(G, np.array([1, 2, 3]), np.array([0, 1, 2]), 4, symmetric=False)
        assert eng.ET is not eng.E
        # propagate chains hops through one square operator
        with pytest.raises(ValueError, match="square graph"):
            m.from_coo(G, rows, cols, N, ncols=N + 1, kinds=("propagate",))
        rect = m.from_coo(G, rows, cols, N, ncols=N + 1, features=np.ones((N + 1, 2)))
        assert rect.kinds() == ("bfs", "pagerank")
    assert GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), rows, cols, N,
                                features=X).kinds() == ("bfs", "pagerank", "bc", "propagate")


@pytest.mark.parametrize("shape,kinds", [((1, 1), KINDS), ((2, 2), KINDS),
                                         ((2, 4), ("bfs", "pagerank", "propagate"))])
def test_served_lanes_match_reference(graph, pair, shape, kinds):
    """The kinds on a batch with a ``PAD_ROOT`` lane: the reference
    engine's results, and ``device_bytes`` equal (on 2x4, the kinds whose
    vectors change alignment between a grid's rows and columns)."""
    jeng, teng = pair if shape == (2, 2) else engines(graph, shape)
    assert teng.kinds() == jeng.kinds() == KINDS
    assert teng.version.device_bytes() == jeng.version.device_bytes()
    live = graph[4]
    srcs = np.array([live[0], PAD_ROOT, live[5], live[17]], np.int32)
    for kind in kinds:
        same_result(jeng.execute(kind, srcs), teng.execute(kind, srcs))
    assert teng.nrows == jeng.nrows and teng.version.nnz == jeng.version.nnz


def test_sorted_unique_input_builds_the_same_version(graph):
    """A COO already sorted by key and without duplicates (a CSR's order)
    skips the dedup's sort: every bucket array, the retained COO and
    weights equal those of the same graph given unsorted with duplicates,
    and the served SSSP equals the reference engine's on the raw COO."""
    rows, cols, w, X, live = graph
    key = rows.astype(np.int64) * N + cols
    uniq, inv = np.unique(key, return_inverse=True)
    wmin = np.full(len(uniq), np.inf, np.float32)
    np.minimum.at(wmin, inv, w)
    G = Grid.make(2, 2, device="cpu")
    kw = {"features": X, "keep_coo": True}
    raw = GraphEngine.from_coo(G, rows, cols, N, weights=w, **kw)
    srt = GraphEngine.from_coo(G, uniq // N, uniq % N, N, weights=wmin, **kw)
    for nm in ("E", "E_weighted", "P_ell"):
        a, b = getattr(raw.version, nm), getattr(srt.version, nm)
        assert len(a.buckets) == len(b.buckets)
        for ba, bb in zip(a.buckets, b.buckets):
            assert all(p.dtype == q.dtype and np.array_equal(p.numpy(), q.numpy())
                       for p, q in zip(ba, bb)), nm
    for p, q in zip(raw.version.host_coo, srt.version.host_coo):
        assert np.array_equal(p, q)
    assert np.array_equal(raw.version.host_weights, srt.version.host_weights)
    jeng = JaxEngine.from_coo(JaxGrid.make(2, 2), rows, cols, N, weights=w, **kw)
    srcs = live[:4].astype(np.int32)
    same_result(jeng.execute("sssp", srcs), srt.execute("sssp", srcs))


def test_pad_root_inert_and_direct_calls(pair, graph):
    """A ``PAD_ROOT`` lane discovers nothing and carries no mass; every
    served lane equals the port's direct call on the same operands."""
    _, eng = pair
    live = graph[4]
    srcs = np.array([live[0], PAD_ROOT, live[3], live[11]], np.int32)
    r = eng.execute("bfs", srcs)
    assert (r["parents"][:, 1] == -1).all() and (r["levels"][:, 1] == -1).all()
    p, lv, niter = bfs_batch(eng.E, srcs)
    assert np.array_equal(r["parents"], p.to_global()) and np.array_equal(r["levels"], lv.to_global())
    assert r["batch_niter"] == niter
    r = eng.execute("sssp", srcs)
    assert np.isinf(r["dist"][:, 1]).all()
    assert np.array_equal(r["dist"], sssp_batch(eng.E_weighted, srcs)[0].to_global())
    r = eng.execute("pagerank", srcs)
    assert r["ranks"][:, 1].sum() == 0.0
    np.testing.assert_allclose(r["ranks"][:, 0].sum(), 1.0, rtol=1e-4)
    assert np.array_equal(r["ranks"], pagerank_batch(eng.P_ell, srcs, eng.dangling)[0].to_global())
    r = eng.execute("bc", srcs)
    assert (r["scores"][:, 1] == 0).all()
    assert np.array_equal(r["scores"], bc_batch_dense_lanes(eng.E, eng.ET, srcs).to_global())
    r = eng.execute("propagate", srcs)
    assert r["features"].shape == (5, 4) and (r["features"][:, 1] == 0).all()
    direct = _propagate_batch_impl(eng.ET, eng.version.X, None, srcs, hops=2,
                                   normalize=False, backend=eng._resolve_spmm_backend())
    assert np.array_equal(r["features"], direct.numpy()[:5])


def test_normalized_propagate_and_options(graph):
    """``propagate_normalize`` (the lazy 1/deg vector), pagerank options
    and ``max_iters`` reach the plans as in the reference."""
    rows, cols, w, X, live = graph
    kw = {"features": X, "propagate_hops": 3, "propagate_normalize": True,
          "pagerank_alpha": 0.7, "pagerank_max_iters": 5, "max_iters": 2}
    kw["kinds"] = ("bfs", "pagerank", "propagate")
    jeng = JaxEngine.from_coo(JaxGrid.make(1, 1), rows, cols, N, **kw)
    teng = GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), rows, cols, N, **kw)
    srcs = live[[1, 2]]
    for kind in teng.kinds():
        same_result(jeng.execute(kind, srcs), teng.execute(kind, srcs))
    assert teng.version.device_bytes() == jeng.version.device_bytes()  # invdeg counted


def test_plan_cache_warmup_and_series(graph):
    """Hits, misses, stats and the ``serve.*`` series and spans equal the
    reference's over a warm-up and a served mix; after warm-up no plan is
    built; a kind the engine was not built for is refused."""
    rows, cols, w, X, live = graph
    got = []
    for o, m, G in ((jobs, JaxEngine, JaxGrid.make(1, 1)),
                    (tobs, GraphEngine, Grid.make(1, 1, device="cpu"))):
        jax.clear_caches()
        o.reset()
        o.enable(install_hooks=False)
        eng = m.from_coo(G, rows, cols, N, kinds=("bfs", "sssp"))
        secs = eng.warmup(widths=(1, 4))
        mark = eng.trace_mark()
        for b in (live[:4], live[4:8], live[:1]):
            eng.execute("bfs", b)
            eng.execute("sssp", b)
        assert eng.retraces_since(mark) == 0
        with pytest.raises(ValueError, match="not built for kind"):
            eng.execute("bc", live[:1])
        with pytest.raises(ValueError, match="unknown query kind"):
            eng._build_plan("toposort", 1)
        o.disable()
        # both packages write one plan-store dir here: its entry gauge
        # reads the other's record, so only the serve series are compared
        ser = {k: v for k, v in series(o).items() if k[1].startswith("serve.")}
        got.append((sorted(secs), eng.stats(), ser, spans(o)[0]))
    (jsecs, jstats, jser, jspans), (tsecs, tstats, tser, tspans) = got
    assert tsecs == jsecs == [("bfs", 1), ("bfs", 4), ("sssp", 1), ("sssp", 4)]
    assert tstats == jstats
    assert tstats["plan_misses"] == 4 and tstats["plan_hits"] == 6
    assert tser == jser
    assert [s[:3] for s in tspans] == [s[:3] for s in jspans]


def test_warmup_replays_store_lanes(graph):
    """A plan-cache miss records its lane in the plan store under the
    reference's key; a fresh engine's ``warmup()`` replays the recorded
    lanes besides the default widths."""
    rows, cols, *_ = graph
    G = Grid.make(1, 1, device="cpu")
    eng = GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",))
    jeng = JaxEngine.from_coo(JaxGrid.make(1, 1), rows, cols, N, kinds=("bfs",))
    assert dataclasses.astuple(tstore.serve_plan_key(eng)) == dataclasses.astuple(
        jstore.serve_plan_key(jeng))
    eng.execute("bfs", np.full(32, PAD_ROOT, np.int32))
    assert tstore.get_store().serve_lanes(tstore.serve_plan_key(eng)) == (("bfs", 32),)
    tstore._reset_for_tests()
    fresh = GraphEngine.from_coo(G, rows, cols, N, kinds=("bfs",))
    assert sorted(fresh.warmup()) == [("bfs", w) for w in (1, 2, 4, 8, 16, 32)]
    assert fresh.stats()["plan_misses"] == 6
    # the reference reads the port's record from the same store
    jstore._reset_for_tests()
    assert jstore.get_store().serve_lanes(jstore.serve_plan_key(jeng)) == tuple(
        ("bfs", w) for w in (1, 2, 4, 8, 16, 32))


def test_swap_refusals_and_latency(graph, pair):
    """``swap``'s five refusals carry the reference's messages; a good
    swap bumps the version id and keeps the plan cache."""
    rows, cols, w, X, live = graph
    jeng, teng = pair
    G = Grid.make(2, 2, device="cpu")
    from combblas_tpu.serve.engine import _build_version as jbuild
    from combblas_tpu_torch.serve.engine import _build_version as tbuild

    def bad(build, grid, eng):
        yield "not a version"
        yield build(grid, rows, cols, N // 2, N // 2, None, ("bfs",), True, False)
        yield build(grid, rows, cols, N, N + 1, None, ("bfs",), True, False)
        yield build(grid, rows, cols, N, N, w, ("bfs", "sssp"), True, False, features=X)
        yield build(grid, rows, cols, N, N, w, ("bfs", "pagerank"), True, False)
        yield build(grid, rows, cols, N, N, None, ("bfs", "pagerank", "propagate"), True,
                    False, features=X)

    def msg(fn):
        try:
            fn()
        except (TypeError, ValueError) as e:
            return type(e).__name__, str(e)
        raise AssertionError("swap accepted a bad version")

    want = [msg(lambda v=v: jeng.swap(v)) for v in bad(jbuild, JaxGrid.make(2, 2), jeng)]
    got = [msg(lambda v=v: teng.swap(v)) for v in bad(tbuild, G, teng)]
    assert got == want and len({m for m in got}) == 6
    teng.warmup(kinds=("bfs",), widths=(4,))
    mark = teng.trace_mark()
    v = teng.build_version(rows, cols, weights=w)
    assert isinstance(v, GraphVersion) and v.X is teng.version.X  # table carried
    vid = teng.version_id
    assert teng.swap(v) >= 0.0 and teng.version_id == vid + 1
    same_result(jeng.execute("bfs", live[:4]), teng.execute("bfs", live[:4]))
    assert teng.retraces_since(mark) == 0


def test_csc_companion_and_coldeg(graph):
    """The CSC companion builds lazily from the retained COO (opt-in) and
    releases it; without ``keep_coo`` it raises. ``coldeg_vec`` uploads
    the out-degrees once. Arrays equal the reference's."""
    rows, cols, *_ = graph
    jeng = JaxEngine.from_coo(JaxGrid.make(2, 2), rows, cols, N, kinds=("bfs",), keep_coo=True)
    teng = GraphEngine.from_coo(Grid.make(2, 2, device="cpu"), rows, cols, N, kinds=("bfs",),
                                keep_coo=True)
    csc = teng.csc_companion()
    assert len(csc) == 2 and teng._host_coo is None and teng.csc_companion() is csc
    for a, b in zip(jeng.csc_companion(), csc):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(teng.coldeg_vec().to_global(), jeng.coldeg_vec().to_global())
    assert teng.coldeg_vec() is teng.coldeg
    assert teng.version.device_bytes() == jeng.version.device_bytes()
    bare = GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), rows, cols, N, kinds=("bfs",))
    with pytest.raises(ValueError, match="keep_coo"):
        bare.csc_companion()


# --- the batcher ------------------------------------------------------------------


def _requests(m, roots, kind="bfs", deadline=None):
    return [m.Request(rid=i, kind=kind, root=int(r), future=Future(), submitted_at=0.0,
                      deadline=deadline) for i, r in enumerate(roots)]


def test_bucket_width_and_assemble():
    """Every count lands on the smallest configured bucket that fits it;
    ``assemble`` pads with ``PAD_ROOT`` and refuses an oversized batch; the
    occupancy and padding-waste histograms equal the reference's."""
    widths = (1, 2, 4, 8, 16)
    for count in range(1, 40):
        assert tbatcher.bucket_width(count, widths) == jbatcher.bucket_width(count, widths)
    for m in (jbatcher, tbatcher):
        with pytest.raises(ValueError):
            m.bucket_width(0, widths)
    for o in (jobs, tobs):
        o.enable(install_hooks=False)
    for count in (1, 3, 5, 8):
        got = tbatcher.assemble(_requests(tbatcher, range(10, 10 + count)), (1, 2, 4, 8))
        want = jbatcher.assemble(_requests(jbatcher, range(10, 10 + count)), (1, 2, 4, 8))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert (got[count:] == PAD_ROOT).all()
    tbatcher.assemble(_requests(tbatcher, [1]), (4,), record=False)
    for m in (jbatcher, tbatcher):
        with pytest.raises(ValueError, match="exceed the widest"):
            m.assemble(_requests(m, range(5)), (2, 4))
    assert series(tobs) == series(jobs)


def test_scatter_expire_and_settle(pair, graph):
    """``scatter`` hands each request a COPY of its own lane, skips settled
    futures, times out expired requests and isolates a bad lane — with
    the reference's counters."""
    _, eng = pair
    live = graph[4]
    res = eng.execute("bfs", tbatcher.assemble(_requests(tbatcher, live[:5]), (8,)))
    for o in (jobs, tobs):
        o.enable(install_hooks=False)
    outs = []
    for m in (jbatcher, tbatcher):
        reqs = _requests(m, live[:5])
        reqs[2].future.cancel()
        reqs[3].deadline = 5.0
        assert np.array_equal(m.assemble(reqs, (8,))[:5], live[:5])
        hooks = {"ok": 0, "timeout": 0}
        done = m.scatter(reqs, res, now=10.0,
                         on_ok=lambda r: hooks.__setitem__("ok", hooks["ok"] + 1),
                         on_timeout=lambda r: hooks.__setitem__("timeout", hooks["timeout"] + 1))
        lanes = [r.future.result() for r in reqs if r.future.done() and not
                 r.future.cancelled() and r.future.exception() is None]
        assert all(lane["levels"].base is None for lane in lanes)
        assert np.array_equal(lanes[0]["parents"], res["parents"][:, 0])
        assert isinstance(reqs[3].future.exception(), TimeoutError)
        bad = _requests(m, live[:1])
        assert m.scatter(bad, {"levels": np.zeros((3, 0))}) == 0  # no lane 0 to slice
        assert bad[0].future.exception() is not None
        f = Future()
        assert m.settle(f, result=1) and not m.settle(f, exc=ValueError())
        r = _requests(m, [1])[0]
        assert m.expire(r, "expired in test") and not m.expire(r, "again")
        outs.append((done, hooks, str(r.future.exception())))
    assert outs[0] == outs[1] and outs[1][:2] == (3, {"ok": 3, "timeout": 1})
    assert series(tobs) == series(jobs)
