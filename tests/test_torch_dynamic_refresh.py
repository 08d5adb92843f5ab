"""Parity of the port's warm-restart recompute (``combblas_tpu_torch.dynamic.refresh``,
``GraphEngine.refresh``) with ``combblas_tpu``'s on the CPU.

Both engines load the same symmetric graph (numpy seed, 2x2 and 2x4
grids) and take the same deltas. Each refresh returns the reference's
mode, cold reason, version id and sweep count; BFS levels and CC labels
equal the reference's bit for bit (integers), PageRank ranks within
``atol=1e-6`` (float sums folded in another order; a rank vector sums to
1). The reference's acceptance properties hold on the port: cold, then
cached; warm equal to a forced cold run after inserts (PageRank within
``atol=5e-5``, in no more sweeps); cold after deletes; bad arguments
raise. The ``dynamic.*`` series equal the reference's.
"""

import numpy as np
import pytest

from combblas_tpu import obs as jobs
from combblas_tpu.dynamic import DeltaBatch as JaxBatch
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.serve import GraphEngine as JaxEngine
from combblas_tpu_torch import Grid
from combblas_tpu_torch import obs as tobs
from combblas_tpu_torch.dynamic import REFRESH_KINDS, DeltaBatch
from combblas_tpu_torch.serve import GraphEngine
from torch_obs_parity import clean, series
from torch_serve_parity import own_plan_store  # noqa: F401

# engines record their lanes in the plan store: each test keeps its own
pytestmark = pytest.mark.usefixtures("own_plan_store")


@pytest.fixture(autouse=True)
def _clean():
    with clean():
        yield


def engines(shape, n=96, m=500, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    kw = {"kinds": ("bfs", "pagerank"), "keep_coo": True}
    return (GraphEngine.from_coo(Grid.make(*shape, device="cpu"), rows, cols, n, **kw),
            JaxEngine.from_coo(JaxGrid.make(*shape), rows, cols, n, **kw), rows)


def both(teng, jeng, *args, **kw):
    """One refresh through each engine, held equal; the port's result."""
    t, j = teng.refresh(*args, **kw), jeng.refresh(*args, **kw)
    assert set(t) == set(j)
    for k in t:
        if k == "latency_s":
            continue
        if k == "result":
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
            if t["kind"] == "pagerank":
                np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6)
            else:
                assert np.array_equal(t[k], j[k])
        else:
            assert type(t[k]) is type(j[k]) and t[k] == j[k], k
    return t


def swap_both(teng, jeng, ops):
    teng.swap(teng.apply_delta(DeltaBatch.from_ops(ops)))
    jeng.swap(jeng.apply_delta(JaxBatch.from_ops(ops)))


def test_cold_then_cached():
    teng, jeng, rows = engines((2, 2))
    root = int(rows[0])
    first = both(teng, jeng, "bfs", root=root)
    assert first["mode"] == "cold" and first["cold_reason"] == "first"
    assert first["result"].shape == (96,) and first["result"][root] == 0
    again = both(teng, jeng, "bfs", root=root)
    assert again["mode"] == "cached" and again["latency_s"] == 0.0
    assert np.array_equal(first["result"], again["result"])
    assert teng.stats()["freshness"] == jeng.stats()["freshness"]


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_warm_matches_cold_after_inserts(shape):
    """Insert-only deltas: BFS/CC repair from the previous result is
    exact, and PageRank restarts from the previous vector in no more
    sweeps — each refresh equal to the reference's."""
    teng, jeng, rows = engines(shape)
    root = int(rows[0])
    for o in (jobs, tobs):
        o.enable(install_hooks=False)
    both(teng, jeng, "bfs", root=root)
    both(teng, jeng, "cc")
    pr_cold = both(teng, jeng, "pagerank")
    far = int(np.argmax(both(teng, jeng, "bfs", root=root)["result"]))
    swap_both(teng, jeng, [("insert", root, far), ("insert", far, root),
                           ("insert", 2, 3), ("insert", 3, 2)])
    warm_bfs = both(teng, jeng, "bfs", root=root)
    assert warm_bfs["mode"] == "warm"
    cold_bfs = both(teng, jeng, "bfs", root=root, force_cold=True)
    assert cold_bfs["cold_reason"] == "forced"
    assert np.array_equal(warm_bfs["result"], cold_bfs["result"])
    warm_cc = both(teng, jeng, "cc")
    assert warm_cc["mode"] == "warm"
    assert np.array_equal(warm_cc["result"], both(teng, jeng, "cc", force_cold=True)["result"])
    warm_pr = both(teng, jeng, "pagerank")
    assert warm_pr["mode"] == "warm" and warm_pr["niter"] <= pr_cold["niter"]
    cold_pr = both(teng, jeng, "pagerank", force_cold=True)
    np.testing.assert_allclose(warm_pr["result"], cold_pr["result"], atol=5e-5)
    for o in (jobs, tobs):
        o.disable()
    ts = {k: v for k, v in series(tobs).items() if k[1].startswith("dynamic.")}
    js = {k: v for k, v in series(jobs).items() if k[1].startswith("dynamic.")}
    assert ts == js
    assert teng.stats()["freshness"] == jeng.stats()["freshness"]


def test_deletes_fall_back_cold():
    """Deletions can raise levels or split components: the refresh
    recomputes cold (reason ``deletes``), and the result is then cached."""
    teng, jeng, rows = engines((2, 2), seed=1)
    root = int(rows[0])
    both(teng, jeng, "bfs", root=root)
    both(teng, jeng, "cc")
    r, c, _ = teng.version.host_coo
    pick = next(i for i in range(len(r)) if r[i] != root and c[i] != root and r[i] != c[i])
    swap_both(teng, jeng, [("delete", int(r[pick]), int(c[pick])),
                           ("delete", int(c[pick]), int(r[pick]))])
    for kw in ({"root": root}, {}):
        out = both(teng, jeng, "bfs" if kw else "cc", **kw)
        assert out["mode"] == "cold" and out["cold_reason"] == "deletes"
        assert both(teng, jeng, "bfs" if kw else "cc", **kw)["mode"] == "cached"
    # a version two merges on from the cache is cold by lineage
    swap_both(teng, jeng, [("insert", 0, 1), ("insert", 1, 0)])
    swap_both(teng, jeng, [("insert", 0, 2), ("insert", 2, 0)])
    out = both(teng, jeng, "bfs", root=root)
    assert out["mode"] == "cold" and out["cold_reason"] == "lineage"


def test_refresh_validates():
    teng, jeng, _rows = engines((1, 1), n=32, m=100)
    assert REFRESH_KINDS == ("bfs", "cc", "pagerank")
    for eng in (teng, jeng):
        with pytest.raises(ValueError, match="root"):
            eng.refresh("bfs")
        with pytest.raises(ValueError, match="outside"):
            eng.refresh("bfs", root=32)
        with pytest.raises(ValueError, match="unknown refresh kind"):
            eng.refresh("toposort")
    bare = GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), np.array([0, 1]),
                                np.array([1, 0]), 4, kinds=("bfs",))
    with pytest.raises(ValueError, match="pagerank artifacts"):
        bare.refresh("pagerank")
