"""Parity of the port's telemetry layers (``combblas_tpu_torch.obs``,
``utils.timers``) with ``combblas_tpu.obs`` on the CPU.

The same sequence of writes goes through both packages; their registry
snapshots, span logs, JSONL records, trace records, flight-recorder and
fleet-log files and Prometheus text are compared, leaving out timestamps
and durations. Each package's files are parsed by the other's parser. The
guard holds the cost contract's semantics (nothing is recorded while
telemetry is off, ``span`` is the shared null span), not a wall-time
ratio, and the catalog test ties every series the port emits to a
reference catalog row of the same kind.
"""

import json
import os
import re
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import combblas_tpu_torch
from combblas_tpu import obs as jobs
from combblas_tpu.models import bfs as _jbfs  # noqa: F401  (registers its cache.bfs provider)
from combblas_tpu.obs import export as jexport
from combblas_tpu.obs import metrics as jmetrics
from combblas_tpu.obs.fleetlog import FleetLog as JaxFleetLog
from combblas_tpu.obs.recorder import FlightRecorder as JaxRecorder
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.utils import timers as jtimers
from combblas_tpu_torch import MIN_PLUS, Grid, SpParMat
from combblas_tpu_torch import obs as tobs
from combblas_tpu_torch.obs import export as texport
from combblas_tpu_torch.obs import metrics as tmetrics
from combblas_tpu_torch.obs.fleetlog import FleetLog as TorchFleetLog
from combblas_tpu_torch.obs.recorder import FlightRecorder as TorchRecorder
from combblas_tpu_torch.parallel.spgemm import spgemm_auto
from combblas_tpu_torch.utils import timers as ttimers

BOTH = (jobs, tobs)
TIMED = {"ts", "wall_s", "t_s"}


def _isolate_providers(monkeypatch):
    """Both packages' pull providers emptied for one test: the
    reference's models/bfs.py registers a provider of its cache.bfs.*
    gauges, which the port leaves out, and a test run earlier on the same
    worker may have left the port's compile-cache provider registered
    (``utils.compile_cache.enable_compile_cache``); the comparisons run
    without either."""
    monkeypatch.setattr(jobs, "_providers", [])
    monkeypatch.setattr(tobs, "_providers", [])


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    _isolate_providers(monkeypatch)
    for o in BOTH:
        o.disable()
        o.reset()
        o.trace.set_sample_rate(None)
    yield
    for o in BOTH:
        o.disable()
        o.reset()
        o.trace.set_sample_rate(None)


def untimed(x):
    """``x`` with every timestamp and duration field dropped, recursively."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMED}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def agg_untimed(agg):
    """An ``aggregate`` result without times: its span table as call counts."""
    out = untimed(agg)
    out["span_table"] = {k: n for k, (_, n) in agg["span_table"].items()}
    return out


def drive_registry(o):
    o.count("c", 2)
    o.count("c", 3)
    o.count("c", 1, kernel="x")
    o.gauge("g", 1.5, op="summa")
    o.gauge("g", 2.5, op="summa")
    for i in range(700):  # past the 512-sample reservoir
        o.observe("h", (i * 37 % 101) / 7.0, lane="a")
    o.observe("h2", 0.25)
    o.count("tenant.q", 1, tenant="t1", kind="bfs")
    o.count("tenant.q", 1, tenant="t2", kind="bfs")


def drive_spans(o):
    with o.span("outer", scale=3):
        o.span_event("it", round=1, chaos=0.5)
        with o.span("inner", hop=0):
            o.span_event("frontier", hop=1, nnz=7)
        with o.span("inner", hop=1):
            pass
    try:
        with o.span("failing"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    o.span_event("loose", n=1)


def test_registry_matches_reference():
    for o in BOTH:
        o.enable(install_hooks=False)
        drive_registry(o)
    assert tobs.metrics_snapshot() == jobs.metrics_snapshot()
    for o in BOTH:
        assert o.prune_labels(tenant="t1") == 1
        assert o.prune_labels() == 0
    assert tobs.registry.snapshot() == jobs.registry.snapshot()
    assert tobs.registry.get_histogram("h", lane="a") == jobs.registry.get_histogram(
        "h", lane="a")
    assert tmetrics.RESERVOIR == jmetrics.RESERVOIR == 512
    assert tobs.quantiles([3, 1, 2, 9]) == jobs.quantiles([3, 1, 2, 9])
    assert tobs.quantile_summary([]) == jobs.quantile_summary([])


def test_registry_parity_survives_a_leaked_compile_cache_provider(tmp_path, monkeypatch):
    """Regression: enabling the port's compile cache registers its
    provider of ``compile_cache.entries`` / ``tuner.store.entries`` gauges,
    as a test of another file on the same worker may do first. After the
    isolation every test here starts with, the registry comparison
    holds."""
    from combblas_tpu_torch.utils import compile_cache

    saved = compile_cache.configured_dir()
    compile_cache._reset_for_tests()
    try:
        compile_cache.enable_compile_cache(str(tmp_path))
        assert tobs._providers
        _isolate_providers(monkeypatch)
        test_registry_matches_reference()
    finally:
        compile_cache._reset_for_tests()
        if saved is not None:
            compile_cache.enable_compile_cache(saved)


def test_spans_events_and_table_match_reference():
    for o in BOTH:
        o.enable(install_hooks=False)
        drive_spans(o)
    assert untimed(tobs._spans.log) == untimed(jobs._spans.log)
    assert untimed(tobs._spans.events) == untimed(jobs._spans.events)
    assert {k: n for k, (_, n) in tobs.report().items()} == {
        k: n for k, (_, n) in jobs.report().items()}
    assert [r["path"] for r in tobs._spans.log] == ["outer/inner", "outer/inner", "outer",
                                                   "failing"]
    assert tobs.report(reset=True) and tobs.report() == {}
    assert tobs._spans.log  # the table reset keeps the structured log


def test_jsonl_records_cross_parse_and_merge(tmp_path):
    paths = {}
    for name, o in (("jax", jobs), ("torch", tobs)):
        o.enable(jsonl_path=str(tmp_path / f"{name}.jsonl"), install_hooks=False)
        drive_registry(o)
        drive_spans(o)
        paths[name] = o.dump_jsonl()
    # each package's file validates under the other's parser
    t_by_j = jobs.parse_jsonl(paths["torch"], validate=True)
    j_by_t = tobs.parse_jsonl(paths["jax"], validate=True)
    assert untimed(t_by_j) == untimed(j_by_t)
    assert t_by_j[0]["schema"] == tobs.SCHEMA == jobs.SCHEMA == "combblas_tpu.obs/v1"
    assert (t_by_j[0]["process"], t_by_j[0]["nprocs"]) == (0, 1) == tobs.process_info()
    assert agg_untimed(tobs.aggregate(j_by_t)) == agg_untimed(jobs.aggregate(t_by_j))
    # host merge over one file of each package, as two processes
    for name, proc in (("jax", 0), ("torch", 1)):
        recs = tobs.parse_jsonl(paths[name])
        recs[0]["process"], recs[0]["nprocs"] = proc, 2
        tobs.write_jsonl(paths[name], recs)
    got = tobs.merge_jsonl_files([paths["jax"], paths["torch"]], str(tmp_path / "m.jsonl"))
    want = jobs.merge_jsonl_files([paths["jax"], paths["torch"]], str(tmp_path / "n.jsonl"))
    assert agg_untimed({k: v for k, v in got.items() if k != "path"}) == agg_untimed(
        {k: v for k, v in want.items() if k != "path"})
    assert got["counters"]["c"] == 10 and got["processes"] == [0, 1]
    for bad in ({"v": 1, "kind": "span", "name": "x"}, {"v": 99, "kind": "meta"}):
        for o in BOTH:
            with pytest.raises(ValueError):
                o.validate_record(bad)


def test_trace_sampling_and_records_match_reference():
    rids = list(range(500)) + [f"req-{i}" for i in range(200)]
    for rate in (0.0, 0.05, 0.5, 1.0):
        assert [tobs.trace.sampled(r, rate) for r in rids] == [
            jobs.trace.sampled(r, rate) for r in rids]
    for o in BOTH:
        assert o.request_trace(1, kind="bfs") is None  # disabled: no trace
        o.enable(install_hooks=False)
        assert o.trace.sample_rate() == 0.0  # the pinned env default
        assert o.request_trace(1, kind="bfs") is None
        o.trace.set_sample_rate(1.0)
        tr = o.request_trace(7, kind="bfs", tenant="t")
        t0 = tr.t0
        tr.mark("queue_wait", now=t0 + 0.5)
        tr.mark("execute", now=t0 + 1.25)
        tr.mark("execute", now=t0 + 2.0)
        tr.annotate(width=4)
        tr.hold()
        tr.finish(status="ok")
        tr.release(stage="net_write")
        up = o.update_trace("w1", tenant="t")
        up.finish(status="error")
    def shape(recs):
        return [(r["name"], r["rid"], r["labels"], [st["stage"] for st in r["stages"]])
                for r in recs]

    assert shape(tobs.trace_records()) == shape(jobs.trace_records())
    rec = tobs.trace_records()[0]
    assert [s["stage"] for s in rec["stages"]] == ["queue_wait", "execute", "net_write"]
    assert abs(sum(s["s"] for s in rec["stages"]) - rec["wall_s"]) < 1e-6
    assert tobs.registry.snapshot() == jobs.registry.snapshot()
    assert set(tobs.trace.stage_summary()) == set(jobs.trace.stage_summary())


def test_flight_recorder_and_fleet_log_cross_parse(tmp_path):
    for name, o, Rec, Log in (("jax", jobs, JaxRecorder, JaxFleetLog),
                              ("torch", tobs, TorchRecorder, TorchFleetLog)):
        o.enable(install_hooks=False)
        rec = Rec(capacity=4, out_dir=str(tmp_path / f"fr-{name}"), tenant="t")
        for i in range(6):  # wraps the ring
            rec.record("serve.batch", batch=i, kind="bfs", outcome="ok")
        assert [e["batch"] for e in rec.snapshot()] == [2, 3, 4, 5]
        path = rec.dump("poisoned", force=True, name="x")
        assert rec.dump("poisoned") is None  # rate-limited
        log = Log(str(tmp_path / f"fleet-{name}.jsonl"), capacity=2, tenant="t")
        for i in range(3):
            log.event("spawn", replica=i, ts=5)
        # each package's files parse under the other's validator
        other = tobs if o is jobs else jobs
        fr = other.parse_jsonl(path, validate=True)
        fl = other.parse_jsonl(log.path, validate=True)
        assert fr[0]["schema"] == "combblas_tpu.flightrec/v1" and fr[0]["reason"] == "poisoned"
        assert fl[0]["schema"] == "combblas_tpu.fleetlog/v1"
        o._parsed = (untimed(fr[1:]), fr[0]["f_name"], untimed(fl[1:]),
                     {k: v for k, v in log.describe().items() if k != "path"},
                     {k: v for k, v in rec.describe().items()
                      if k not in ("dir", "last_dump")})
    assert tobs._parsed == jobs._parsed
    assert tobs.registry.snapshot() == jobs.registry.snapshot()


def test_prometheus_render_parse_scrape_and_cli(tmp_path, capsys):
    for o in BOTH:
        o.enable(install_hooks=False)
        drive_registry(o)
    text = texport.render()
    assert text == jexport.render()
    assert texport.parse_exposition(text) == jexport.parse_exposition(text)
    parsed = texport.parse_exposition(text)
    assert parsed[("combblas_c", "")] == 5.0
    assert parsed[("combblas_h_count", '{lane="a"}')] == 700.0

    class Owner:
        def health(self):
            return {"ok": True}

        def stats(self):
            return {"n": np.int64(3)}

    srv = texport.serve_scrape(Owner())
    try:
        body = urllib.request.urlopen(srv.url + "/metrics", timeout=10).read().decode()
        health = json.loads(urllib.request.urlopen(srv.url + "/healthz", timeout=10).read())
        stats = json.loads(urllib.request.urlopen(srv.url + "/statz", timeout=10).read())
    finally:
        srv.stop()
        srv.stop()  # idempotent
    def unscraped(text):
        return {k: v for k, v in texport.parse_exposition(text).items()
                if not k[0].startswith("combblas_obs_scrape")}

    assert unscraped(body) == unscraped(texport.render()) == unscraped(text)
    assert health == {"ok": True} and stats == {"n": "3"}
    assert tobs.registry.get_counter("obs.scrape.requests", path="/metrics") == 1
    path = str(tmp_path / "t.jsonl")
    tobs.dump_jsonl(path)
    assert texport.main([path]) == 0
    assert texport.parse_exposition(capsys.readouterr().out) == jexport.parse_exposition(
        jexport.render_from_jsonl(path))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)], ids=["1x1", "2x2", "2x4"])
def test_psum_counters_matches_reference(shape):
    pr, pc = shape
    local = np.arange(pr * pc * 3, dtype=np.int32).reshape(pr, pc, 3) * 7 - 20
    got = tobs.psum_counters(Grid.make(pr, pc, device="cpu"), torch.from_numpy(local))
    want = np.asarray(jobs.psum_counters(JaxGrid.make(pr, pc), jnp.asarray(local)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), local.sum(axis=(0, 1)))
    with pytest.raises(ValueError):
        tobs.psum_counters(Grid.make(pr, pc, device="cpu"), torch.zeros((pr + 1, pc, 3)))


def test_disabled_telemetry_records_nothing():
    """The cost contract's semantics: with telemetry off every writer
    returns at its flag, ``span`` is the shared null span, and an
    instrumented product leaves the registry, the span log and the trace
    log empty."""
    assert not tobs.enabled()
    assert tobs.span("x", a=1) is tobs.NULL_SPAN
    with tobs.span("x"):
        tobs.count("c")
        tobs.gauge("g", 1)
        tobs.observe("h", 1.0)
        tobs.span_event("e", n=1)
    assert tobs.request_trace(1) is None and tobs.update_trace(1) is None
    rng = np.random.default_rng(0)
    d = (rng.random((24, 24)) < 0.2) * rng.integers(1, 5, (24, 24))
    A = SpParMat.from_dense(Grid.make(1, 1, device="cpu"), d.astype(np.float32))
    spgemm_auto(MIN_PLUS, A, A)
    tobs.register_provider(lambda: tobs.gauge("p", 1))
    assert tobs.metrics_snapshot() == []
    assert tobs.registry.empty() and tobs._spans.empty() and tobs.trace_records() == []
    tobs._providers.clear()


def test_timers_shim_and_profiler_trace(tmp_path):
    """``phase`` accumulates with obs off (into the table only, as the
    reference's shim does); ``trace`` writes a profiler trace naming the
    spans and ``annotate`` ranges inside it."""
    for t in (jtimers, ttimers):
        with t.phase("ph"):
            pass
        with t.phase("ph"):
            pass
    assert ttimers.report()["ph"][1] == jtimers.report()["ph"][1] == 2
    assert ttimers.get("ph") > 0 and tobs._spans.log == []
    ttimers.ENABLED = False
    try:
        assert ttimers.phase("off") is tobs.NULL_SPAN
    finally:
        ttimers.ENABLED = True
    ttimers.reset_all()
    assert ttimers.report() == {}
    with ttimers.trace(str(tmp_path)):
        with ttimers.phase("traced.phase"):
            with ttimers.annotate("traced.annotation"):
                torch.ones(8).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1
    body = (tmp_path / files[0]).read_text()
    assert "traced.phase" in body and "traced.annotation" in body


def test_build_hooks_and_compile_cache_provider(tmp_path):
    """``install_hooks`` seeds the build-cache counters; ``_build`` counts a
    library found built as a hit and a compile as a miss (only with the
    hooks installed and telemetry on); the compile cache's provider
    gauges the build dir's files and the plan store."""
    from combblas_tpu_torch.utils import compile_cache

    tobs.build_event(cached=True)
    tobs.enable(install_hooks=False)
    was = tobs._hooks_installed
    tobs._hooks_installed = False
    try:
        tobs.build_event(cached=True)
        assert tobs.registry.empty()
        tobs.install_hooks()
        assert tobs.registry.get_counter("compile_cache.hits") == 0
        assert tobs.registry.get_counter("compile_cache.misses") == 0
        tobs.build_event(cached=True)
        tobs.build_event(cached=False)
        tobs.build_event(cached=True)
        assert tobs.registry.get_counter("compile_cache.hits") == 2
        assert tobs.registry.get_counter("compile_cache.misses") == 1
        saved = compile_cache.configured_dir()
        compile_cache._reset_for_tests()
        try:
            (tmp_path / "a.so").write_bytes(b"x")
            (tmp_path / "b.so").write_bytes(b"y")
            compile_cache.enable_compile_cache(str(tmp_path))
            snap = {(r["name"], tuple(sorted(r["labels"]))): r["value"]
                    for r in tobs.metrics_snapshot() if r["kind"] == "gauge"}
            assert snap[("compile_cache.entries", ("dir",))] == 2
            assert ("compile_cache.entries", ("cache", "dir")) in snap
            assert ("tuner.store.entries", ("dir",)) in snap
        finally:
            compile_cache._reset_for_tests()
            if saved is not None:
                compile_cache.enable_compile_cache(saved)
            tobs._providers.clear()
    finally:
        tobs._hooks_installed = was


# --- the catalog ----------------------------------------------------------------

PKG = os.path.dirname(os.path.abspath(combblas_tpu_torch.__file__))
_CALL = re.compile(r"""(?:obs|registry)\.(?:count|gauge|observe)\(\s*["']([A-Za-z0-9_.]+)["']""")
_KIND = r"(counter|gauge|histogram|hist)\b"
_ROW = re.compile(r"^``([^`]+)``(?: \(``[^`]+``\))?\s+" + _KIND, re.M)
# a row naming several series, one a line: "``a`` /   kind ...", then
# "``b`` [/]" lines
_ROW_SPLIT = re.compile(r"^``([^`]+)`` /\s+" + _KIND + r"[^\n]*((?:\n``[^`]+``[^\n]*)+)", re.M)


def _rows(path):
    """Catalog rows as {series: kind} (the reference abbreviates some
    histogram rows as ``hist``)."""
    text = open(path, encoding="utf-8").read()
    rows = {}
    for name, kind in _ROW.findall(text):
        for n in name.split("/"):
            rows[n if "." in n else name.rsplit(".", 1)[0] + "." + n] = kind
    for first, kind, more in _ROW_SPLIT.findall(text):
        for n in [first] + re.findall(r"^``([^`]+)``", more, re.M):
            rows[n] = kind
    return {n: "histogram" if k == "hist" else k for n, k in rows.items()}


def _port_series():
    names = {}
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                src = open(os.path.join(dirpath, fn), encoding="utf-8").read()
                for m in _CALL.finditer(src):
                    names.setdefault(m.group(1), set()).add(fn)
    return names


def test_every_emitted_series_is_cataloged_as_in_the_reference():
    port_rows = _rows(tmetrics.__file__)
    ref_rows = _rows(jmetrics.__file__)
    names = _port_series()
    assert len(names) > 50
    for name in names:
        key = name + "*" if name.endswith(".") else name
        assert key in port_rows, f"{name} is emitted but not in the port's catalog"
        assert key in ref_rows and ref_rows[key] == port_rows[key], name
    # and the port's catalog holds no row the port does not emit
    emitted = set(names) | {"tuner.store.hits", "compile_cache.hits", "compile_cache.misses",
                            "obs.scrape.requests", "serve.fleetlog.events", "k1.*"}
    assert set(port_rows) - emitted == set()
    # the rows are the reference's, word for word
    ref_text = open(jmetrics.__file__, encoding="utf-8").read()
    doc = tmetrics.__doc__
    doc = doc[doc.index("SpGEMM tier-router series"):]
    for block in re.findall(r"^``[^\n]*(?:\n {10,}[^\n]*)*", doc, re.M):
        assert block in ref_text, block.splitlines()[0]
