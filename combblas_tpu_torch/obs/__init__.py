"""``combblas_tpu_torch.obs`` — structured telemetry for the hot paths,
counterpart of ``combblas_tpu/obs``.

The reference ships a whole TIMING subsystem — global ``cblas_*`` phase
counters compiled in under ``#ifdef TIMING`` (``CombBLAS.h:77-102``) and
per-app tables printed after each run (``TopDownBFS.cpp:472-479``). This
package is its structured, machine-readable replacement, three layers:

1. **metrics registry** (``metrics.py``) — counters/gauges/histograms
   with labels for scalar facts: SpGEMM symbolic vs realized fill-in,
   redistribute/bucket drop counts, kernel build-cache hit/miss, per-op
   load imbalance.
2. **span/trace layer** (``spans.py``) — nested named wall-time spans
   wrapping ``torch.profiler.record_function`` (host spans line up with
   the kernels on the ``torch.profiler`` timeline, and show as NVTX
   ranges under ``emit_nvtx``), with attached per-iteration events
   (BFS hop + frontier nnz, MCL round + chaos, SUMMA stage).
3. **sinks** (``sinks.py``) — the in-memory per-app table, a
   schema-versioned JSONL exporter (the reference's schema strings, so
   either package parses the other's files), host-side multi-process
   merge, and a device sum for add-monoid counters.

The serving surfaces come along for the serve path that will use them:
**per-request tracing** (``trace.py``), the **flight recorder**
(``recorder.py``), the **fleet log** (``fleetlog.py``) and the **live
export surface** (``export.py`` — Prometheus text exposition and a
stdlib-HTTP scrape thread).

COST CONTRACT: everything is guarded by the module-level ``ENABLED``
flag, checked before any dict work — with telemetry off, an
instrumented call site costs one attribute read (and ``span`` returns a
shared null context manager). Instrumentation lives HOST-SIDE only: no
device synchronisation is ever added by an instrumented site; device
facts are only read back where the port already reads them back, or
when ``DEVICE_SYNC`` is explicitly opted into, at exactly the sites the
reference reads under that flag. Where the reference's site sits in
jit-traced code it counts traces; the port runs eagerly and counts calls
there (each instrumented module lists such sites).

Usage::

    from combblas_tpu_torch import obs
    obs.enable(jsonl_path="trace.jsonl")
    with obs.span("bfs", scale=20):
        ...
        obs.span_event("frontier", hop=3, nnz=1234)
    obs.count("redistribute.dropped", 0)
    obs.dump_jsonl()

The ``/jax/...`` event counts and compile-duration histograms of the
reference's ``jax.monitoring`` bridge have no counterpart: eager torch
compiles no programs. ``install_hooks`` seeds ``compile_cache.hits`` /
``compile_cache.misses``, which count the hand kernels' builds
(``_build.py``: a library found built is a hit, one that ran ``nvcc`` or
``g++`` a miss).
"""

from __future__ import annotations

import os

from ..tuner import config as _config
from .metrics import MetricsRegistry
from .sinks import (
    FLEETLOG_SCHEMA,
    FLIGHTREC_SCHEMA,
    SCHEMA,
    SCHEMA_VERSION,
    aggregate,
    encode_records,
    merge_jsonl_files,
    parse_jsonl,
    psum_counters,
    quantile_summary,
    quantiles,
    validate_record,
    write_jsonl,
)
from .spans import NULL_SPAN, SpanTracker
from . import trace as _trace

#: Master switch, checked at every instrumentation site BEFORE any work.
#: Off by default: the hot paths must cost nothing unless telemetry is
#: asked for (env COMBBLAS_OBS=1 or obs.enable()).
ENABLED: bool = _config.obs_enabled()

#: Opt-in for instrumentation that READS DEVICE SCALARS (e.g. realized
#: SpGEMM output nnz). Never enable in timed sections: each such site
#: adds a device-to-host readback, which waits for the stream.
DEVICE_SYNC: bool = _config.obs_device_sync()

registry = MetricsRegistry()
_spans = SpanTracker()
_providers: list = []
_jsonl_path: str | None = None
_hooks_installed = False


# --- lifecycle --------------------------------------------------------------


def enable(jsonl_path: str | None = None, *, device_sync: bool | None = None,
           install_hooks: bool = True) -> None:
    """Turn telemetry on (idempotent). ``jsonl_path`` configures the
    default ``dump_jsonl`` target; ``device_sync`` opts into
    readback-requiring metrics (never in a timed section)."""
    global ENABLED, DEVICE_SYNC, _jsonl_path
    ENABLED = True
    if device_sync is not None:
        DEVICE_SYNC = bool(device_sync)
    if jsonl_path is not None:
        _jsonl_path = jsonl_path
    if install_hooks:
        _install_hooks()


def disable() -> None:
    global ENABLED
    ENABLED = False


def enable_sidecar(tag: str) -> str | None:
    """The BENCH_OBS=1 convention shared by the bench drivers: enable
    telemetry with a per-process JSONL sidecar under ``$BENCH_OBS_DIR``
    (default ``<tmpdir>/combblas_obs``), named ``obs-<tag>-<pid>.jsonl``.
    Returns the sidecar path, or None when ``BENCH_OBS`` is not ``1``.
    ``DEVICE_SYNC`` stays off: a bench child must never gain a readback
    from telemetry."""
    if os.environ.get("BENCH_OBS") != "1":
        return None
    import tempfile

    d = os.environ.get("BENCH_OBS_DIR") or os.path.join(
        tempfile.gettempdir(), "combblas_obs"
    )
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"obs-{tag}-{os.getpid()}.jsonl")
    enable(jsonl_path=path, device_sync=False)
    return path


def enabled() -> bool:
    return ENABLED


def reset() -> None:
    """Clear every metric, span, event, and per-request trace (the
    flag is untouched)."""
    registry.clear()
    _spans.clear()
    _trace.clear()


def reset_spans() -> None:
    """Clear only the (seconds, calls) span table (the timers-shim
    reset) — the structured span log and events belong to the obs
    subsystem and survive; use ``reset()`` for a full wipe."""
    _spans.clear_table()


# --- writers ----------------------------------------------------------------


def count(name: str, value=1, **labels) -> None:
    if not ENABLED:
        return
    registry.count(name, value, **labels)


def gauge(name: str, value, **labels) -> None:
    if not ENABLED:
        return
    registry.gauge(name, value, **labels)


def observe(name: str, value, **labels) -> None:
    if not ENABLED:
        return
    registry.observe(name, value, **labels)


def span(name: str, *, sync=None, force: bool = False, **attrs):
    """Context manager timing the enclosed block under ``name``.

    ``sync``: optional tensor (or list, tuple, dict or dataclass of
    tensors) whose CUDA streams are synchronised before the timer closes
    (async launches must not hide device time); CPU tensors need no wait. ``force``
    records even when telemetry is globally off (the ``utils/timers``
    compatibility path) — but then only into the (seconds, calls) table,
    like the old timers, never the per-call structured log. ``attrs``
    become span attributes in the export.
    """
    if not (ENABLED or force):
        return NULL_SPAN
    return _spans.open(name, True, sync=sync, log=ENABLED, **attrs)


def span_event(name: str, **fields) -> None:
    """Attach a per-iteration record (hop/round/stage) to the innermost
    open span — or log it top-level if no span is open."""
    if not ENABLED:
        return
    _spans.event(name, **fields)


# --- per-request tracing (round 15, obs/trace.py) ---------------------------


def request_trace(rid, kind: str | None = None,
                  tenant: str | None = None):
    """Open a deterministic-sampled per-request trace (None when obs
    is off or the sampler declines ``rid``) — the serve read lane's
    entry.  One function call + flag check when disabled."""
    if not ENABLED:
        return None
    return _trace.begin(rid, "serve.request", kind=kind, tenant=tenant)


def update_trace(rid, tenant: str | None = None):
    """The write lane's trace entry (``name="serve.update"``)."""
    if not ENABLED:
        return None
    return _trace.begin(rid, "serve.update", tenant=tenant)


def trace_records() -> list[dict]:
    """Completed per-request trace records (schema kind ``trace``)."""
    return _trace.records()


def prune_labels(**labels) -> int:
    """Drop every registry series labeled with ALL the given pairs
    (tenant-churn label-space hygiene; works whether or not telemetry
    is currently enabled — stale series from an earlier enabled phase
    must still be removable)."""
    return registry.prune_labels(**labels)


# --- providers (pull-style gauges, polled at export time) -------------------


def register_provider(fn) -> None:
    """Register a zero-arg callable that refreshes gauges (via
    ``obs.gauge``) when a report/dump is produced — e.g. lru_cache
    hit/miss/size exporters that would be wasteful to push on every
    cache access."""
    if fn not in _providers:
        _providers.append(fn)


def _run_providers() -> None:
    if not ENABLED:
        return
    for fn in list(_providers):
        try:
            fn()
        except Exception:  # a broken provider must not kill the export
            registry.count("obs.provider_errors")


# --- readers / sinks --------------------------------------------------------


def report(reset: bool = False) -> dict[str, tuple[float, int]]:
    """The per-app timing table: {span name: (seconds, calls)} — what the
    reference prints after each run (TopDownBFS.cpp:472-479).
    ``reset=True`` clears only this table, not the structured span
    log/events (``reset()`` is the full wipe)."""
    out = _spans.table()
    if reset:
        _spans.clear_table()
    return out


def span_seconds(name: str) -> float:
    return _spans.seconds(name)


def print_report(reset: bool = False) -> None:
    for k, (sec, n) in report(reset=reset).items():
        print(f"{k:32s} {sec:10.4f}s  x{n}")


def metrics_snapshot() -> list[dict]:
    _run_providers()
    return registry.snapshot()


def dump_jsonl(path: str | None = None, *, process: int | None = None,
               nprocs: int | None = None) -> str:
    """Write the full telemetry state as one schema-versioned JSONL file
    (meta line, spans, events, metrics). Default path is the one given
    to ``enable``; the file is rewritten whole on each call."""
    path = path or _jsonl_path
    if path is None:
        raise ValueError("no JSONL path: pass one or enable(jsonl_path=...)")
    if process is None or nprocs is None:
        rank, world = process_info()
        process = rank if process is None else process
        nprocs = world if nprocs is None else nprocs
    _run_providers()
    records = encode_records(
        registry.snapshot(), _spans, process=process, nprocs=nprocs,
        traces=_trace.records(),
    )
    return write_jsonl(path, records)


def process_info() -> tuple[int, int]:
    """``(rank, world size)`` from ``torch.distributed`` when its process
    group is initialised, else ``(0, 1)`` — where the reference asks
    ``jax.process_index()`` / ``jax.process_count()``."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:
        pass
    return 0, 1


# --- kernel build-cache bridge ---------------------------------------------


def _install_hooks() -> bool:
    """Count the hand kernels' builds into the registry (idempotent): the
    port's counterpart of the reference's ``install_jax_hooks``. A build
    that ``_build.py`` finds already built counts as ``compile_cache.hits``,
    one that runs ``nvcc`` or ``g++`` as ``compile_cache.misses``; both are
    seeded at 0 so every dump carries them. The reference's other
    ``/jax/...`` events and duration histograms have no counterpart."""
    global _hooks_installed
    if _hooks_installed:
        return True
    registry.count("compile_cache.hits", 0)
    registry.count("compile_cache.misses", 0)
    _hooks_installed = True
    return True


#: Public name; ``enable``'s parameter of the same name shadows it there.
install_hooks = _install_hooks


def build_event(cached: bool) -> None:
    """``_build.py``'s hook: one kernel library found built (``cached``)
    or compiled. Counted only when telemetry is on and the hooks are
    installed, as the reference's listener counts only then."""
    if not (ENABLED and _hooks_installed):
        return
    registry.count("compile_cache.hits" if cached else "compile_cache.misses")


#: The per-request tracing module (``obs.trace`` — sampling knobs,
#: ``stage_summary`` for bench decompositions).
trace = _trace

__all__ = [
    "ENABLED", "DEVICE_SYNC", "SCHEMA", "SCHEMA_VERSION",
    "FLIGHTREC_SCHEMA", "FLEETLOG_SCHEMA",
    "enable", "disable", "enabled", "enable_sidecar", "reset",
    "reset_spans",
    "count", "gauge", "observe", "span", "span_event",
    "request_trace", "update_trace", "trace_records", "prune_labels",
    "register_provider", "report", "print_report", "span_seconds",
    "metrics_snapshot", "dump_jsonl", "install_hooks", "build_event",
    "process_info",
    "parse_jsonl", "merge_jsonl_files", "aggregate", "validate_record",
    "encode_records", "write_jsonl", "psum_counters", "registry",
    "quantiles", "quantile_summary", "trace",
    "MetricsRegistry", "SpanTracker", "NULL_SPAN",
]
