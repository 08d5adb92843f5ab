"""Shared helpers of the ``tests/test_torch_serve_*`` and
``test_torch_obs_serve.py`` parity files: each test drives the same
scenario through ``combblas_tpu.serve`` and ``combblas_tpu_torch.serve``
on the same graph and roots, asserts the reference test's properties on
both, and holds what the two observed equal.

``PKG["jax"]`` and ``PKG["torch"]`` name each package's serving API;
``grid(name, shape)`` makes a grid (the port's on the CPU).
``same_result`` compares two ``execute`` results: integer arrays (BFS
parents and levels) and SSSP distances bit for bit, PageRank ranks, BC
scores and propagate features within ``rtol=1e-5`` and
``atol = 1e-6 · max |x|`` (float sums folded in another order, the
tolerance of ``tests/test_torch_serve_engine.py``).
"""

import contextlib
import types

import numpy as np
import pytest

import combblas_tpu.obs as jobs
import combblas_tpu.serve as jserve
from combblas_tpu.dynamic import wal as jwal
from combblas_tpu.obs import export as jexport
from combblas_tpu.obs import trace as jtrace
from combblas_tpu.obs.recorder import FlightRecorder as JaxFlightRecorder
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.serve import batcher as jbatcher
from combblas_tpu.tuner import store as jstore
from combblas_tpu.utils import checkpoint as jckpt
import combblas_tpu_torch.obs as tobs
import combblas_tpu_torch.serve as tserve
from combblas_tpu_torch import Grid
from combblas_tpu_torch.dynamic import wal as twal
from combblas_tpu_torch.obs import export as texport
from combblas_tpu_torch.obs import trace as ttrace
from combblas_tpu_torch.obs.recorder import FlightRecorder as TorchFlightRecorder
from combblas_tpu_torch.serve import batcher as tbatcher
from combblas_tpu_torch.tuner import store as tstore
from combblas_tpu_torch.utils import checkpoint as tckpt
from torch_obs_parity import clean

FLOAT_KEYS = ("ranks", "scores", "features")
NAMES = ("jax", "torch")


def _api(serve, obs, trace, export, recorder, wal, ckpt, batcher, make_grid):
    return types.SimpleNamespace(
        GraphEngine=serve.GraphEngine, ServeConfig=serve.ServeConfig, Server=serve.Server,
        BackpressureError=serve.BackpressureError,
        CircuitBreaker=serve.CircuitBreaker, CircuitBreakerOpen=serve.CircuitBreakerOpen,
        DeficitRoundRobin=serve.DeficitRoundRobin, FaultInjector=serve.FaultInjector,
        InjectedFault=serve.InjectedFault, ProcessFaultPlan=serve.ProcessFaultPlan,
        FAULT_POINTS=serve.FAULT_POINTS, ErrorBudget=serve.ErrorBudget,
        EnginePool=serve.EnginePool, PoolServer=serve.PoolServer,
        FleetRouter=serve.FleetRouter, ReplicaDeadError=serve.ReplicaDeadError,
        Request=batcher.Request, obs=obs, trace=trace, export=export,
        FlightRecorder=recorder, wal=wal, checkpoint=ckpt, make_grid=make_grid)


PKG = {
    "jax": _api(jserve, jobs, jtrace, jexport, JaxFlightRecorder, jwal, jckpt, jbatcher,
                lambda shape: JaxGrid.make(*shape)),
    "torch": _api(tserve, tobs, ttrace, texport, TorchFlightRecorder, twal, tckpt, tbatcher,
                  lambda shape: Grid.make(*shape, device="cpu")),
}


def grid(name: str, shape=(1, 1)):
    return PKG[name].make_grid(tuple(shape))


@contextlib.contextmanager
def _own_stores(monkeypatch, tmp_path):
    monkeypatch.setenv("COMBBLAS_PLAN_STORE", str(tmp_path / "plans"))
    jstore._reset_for_tests()
    tstore._reset_for_tests()
    try:
        yield
    finally:
        jstore._reset_for_tests()
        tstore._reset_for_tests()


@pytest.fixture
def own_plan_store(monkeypatch, tmp_path):
    """Both packages' plan stores in the test's own directory. An engine
    records every lane it builds in the store; in the checkout's default
    store those records would reach later tests that expect it empty
    (the SpMM backend chain, for one)."""
    with _own_stores(monkeypatch, tmp_path):
        yield


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    """A fresh plan store for both packages and both telemetries off and
    empty, trace sampling unset, around each test."""
    for name in ("COMBBLAS_WAL", "COMBBLAS_CHECKPOINT_EVERY", "COMBBLAS_CHECKPOINT_RETAIN",
                 "COMBBLAS_OBS_TRACE_SAMPLE"):
        monkeypatch.delenv(name, raising=False)
    with _own_stores(monkeypatch, tmp_path), clean():
        for p in PKG.values():
            p.trace.set_sample_rate(None)
        yield
        for p in PKG.values():
            p.trace.set_sample_rate(None)


def same_result(a: dict, b: dict) -> None:
    """``b`` (the port's result) equals ``a`` (the reference's)."""
    assert a.keys() == b.keys()
    for k in a:
        if not isinstance(a[k], np.ndarray):
            assert b[k] == a[k], k
        elif k in FLOAT_KEYS:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       atol=1e-6 * max(float(np.abs(a[k]).max()), 1e-30))
        else:
            assert b[k].dtype == a[k].dtype and np.array_equal(b[k], a[k]), k


def outcome(fut):
    """A settled future as ("ok", result) or ("error", exception type
    name)."""
    assert fut.done()
    exc = fut.exception(timeout=0)
    return ("ok", fut.result(timeout=0)) if exc is None else ("error", type(exc).__name__)


def same_outcomes(a: list, b: list) -> None:
    """Two lists of ``outcome``s: the same dispositions, equal results."""
    assert [o[0] for o in a] == [o[0] for o in b]
    for (sa, ra), (_sb, rb) in zip(a, b):
        if sa == "ok":
            same_result(ra, rb)
        else:
            assert ra == rb


def coo_pairs(seed: int, n: int, m: int):
    """The reference serve tests' random symmetric COO: ``m`` pairs from
    ``default_rng(seed)``, both orientations."""
    r = np.random.default_rng(seed)
    a, b = r.integers(0, n, m), r.integers(0, n, m)
    return np.concatenate([a, b]), np.concatenate([b, a])


def host_edges(version):
    return tuple(np.asarray(x) for x in version.E.to_host_coo())


def same_edges(va, vb) -> None:
    for x, y in zip(host_edges(va), host_edges(vb)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
