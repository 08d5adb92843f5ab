"""Shared helpers of the ``tests/test_torch_obs_*`` site parity files: run
one call under each package's telemetry and hold the series and spans
equal (see ``test_torch_obs_spgemm.py``'s docstring for what is compared
and what is left out)."""

import contextlib
import math

import jax
import numpy as np
import torch

from combblas_tpu import obs as jobs
from combblas_tpu import semiring as jsr
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu_torch import MAX_MIN, MIN_PLUS, PLUS_TIMES, SELECT2ND_MAX, Grid, SpParMat
from combblas_tpu_torch import obs as tobs

SR = {"min_plus": (MIN_PLUS, jsr.MIN_PLUS), "plus_times": (PLUS_TIMES, jsr.PLUS_TIMES),
      "max_min": (MAX_MIN, jsr.MAX_MIN), "select2nd_max": (SELECT2ND_MAX, jsr.SELECT2ND_MAX)}
#: Series each package counts for its own machinery: JAX retraces, the
#: reference's BFS caches, ``jax.monitoring`` events, and the compile
#: caches (XLA's there, once a test in the process installed the hooks;
#: the hand kernels' builds here).
LEFT_OUT = ("trace.", "cache.bfs.", "/jax/", "compile_cache.")


@contextlib.contextmanager
def clean():
    """Both packages' telemetry off and empty around a test."""
    for o in (jobs, tobs):
        o.disable()
        o.reset()
    try:
        yield
    finally:
        for o in (jobs, tobs):
            o.disable()
            o.reset()


def series(o):
    out = {}
    for r in o.registry.snapshot():
        if r["name"].startswith(LEFT_OUT):
            continue
        key = (r["kind"], r["name"], tuple(sorted(r["labels"].items())))
        out[key] = r["count"] if r["kind"] == "histogram" else r["value"]
    return out


def _approx(v):
    return round(v, 4) if isinstance(v, float) and math.isfinite(v) else v


def spans(o, approx=False):
    fix = _approx if approx else (lambda v: v)

    def ev(e):
        return {k: fix(v) for k, v in e.items() if k not in ("t_s", "ts")}

    return ([(r["name"], r["path"], r.get("attrs"), [ev(e) for e in r.get("events", [])],
              r.get("failed")) for r in o._spans.log],
            [ev(e) for e in o._spans.events])


@contextlib.contextmanager
def recording(o, device_sync=False):
    o.reset()
    o.enable(device_sync=device_sync, install_hooks=False)
    try:
        yield
    finally:
        o.disable()


def run_both(jfn, tfn, *, device_sync=False, approx=False, drop=()):
    """Run ``jfn`` under the reference's telemetry and ``tfn`` under the
    port's, and hold their series and spans equal; returns both results."""
    jax.clear_caches()
    with recording(jobs, device_sync):
        want = jfn()
    with recording(tobs, device_sync):
        got = tfn()
    js, ts = series(jobs), series(tobs)
    for k in [k for k in js if k[1] in drop]:
        del js[k]
    for k in [k for k in ts if k[1] in drop]:
        del ts[k]
    assert ts == js, {k: (ts.get(k), js.get(k)) for k in set(ts) | set(js)
                      if ts.get(k) != js.get(k)}
    got_spans, want_spans = spans(tobs, approx), spans(jobs, approx)
    assert got_spans == want_spans, (got_spans, want_spans)
    return want, got


def mats(shape, d, dedup=True):
    return (JaxSpParMat.from_dense(JaxGrid.make(*shape), d),
            SpParMat.from_dense(Grid.make(*shape, device="cpu"), d))


def graph(seed, n=64, density=0.08, weights=True):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density).astype(np.float32)
    if weights:
        d *= rng.integers(1, 6, (n, n)).astype(np.float32)
    return d


def nnz(C):
    return int(np.asarray(C.nnz).sum()) if not isinstance(C.nnz, torch.Tensor) else int(
        C.nnz.sum())


