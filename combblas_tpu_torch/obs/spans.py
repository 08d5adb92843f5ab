"""Span/trace layer — counterpart of ``combblas_tpu/obs/spans.py``:
nested named wall-time spans with attached events.

Subsumes ``utils/timers.py`` (a compatibility shim over this module):
each span wraps ``torch.profiler.record_function`` (where the reference
wraps ``jax.profiler.TraceAnnotation``), so host spans show up as ranges
on the ``torch.profiler`` timeline beside the kernels they launched, and
as NVTX ranges under ``torch.autograd.profiler.emit_nvtx``; it
accumulates into the per-app
timing table the reference prints after each run
(``TopDownBFS.cpp:472-479``), and keeps a bounded structured log for the
JSONL exporter. Span EVENTS carry the per-iteration records — BFS hop +
frontier nnz, MCL round + chaos, SUMMA stage — that the scalar timer
table cannot express.

Disabled-path cost: ``SpanTracker.open`` returns a shared null context
manager after one flag check — no allocation, no dict work — so
instrumented hot paths are free when telemetry is off.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch


class _NullSpan:
    """Reentrant no-op context manager returned when telemetry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def _cuda_devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def sync_devices(x) -> None:
    """Wait for the current CUDA stream of every device that holds a
    tensor in ``x`` (a tensor, or lists, tuples, dicts and dataclasses of
    them): the port's ``block_until_ready``. CPU tensors need no wait."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.current_stream(dev).synchronize()

#: Bound on the structured span/event logs: long-running processes must
#: not grow memory without limit; overflow is counted, never silent.
MAX_LOG = 100_000


class _ActiveSpan:
    __slots__ = ("tracker", "name", "attrs", "sync", "events", "t0", "ts",
                 "path", "log", "_ann")

    def __init__(self, tracker, name, attrs, sync, log=True):
        self.tracker = tracker
        self.name = name
        self.attrs = attrs
        self.sync = sync
        self.log = log
        self.events = []

    def __enter__(self):
        stack = self.tracker._stack()
        parent = stack[-1].path if stack else ""
        self.path = f"{parent}/{self.name}" if parent else self.name
        stack.append(self)
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self.ts = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self.sync is not None:
                sync_devices(self.sync)
        finally:
            wall = time.perf_counter() - self.t0
            self._ann.__exit__(exc_type, exc, tb)
            stack = self.tracker._stack()
            if stack and stack[-1] is self:
                stack.pop()
            self.tracker._close(self, wall, failed=exc_type is not None)
        return False

    def event(self, name: str, **fields):
        self.events.append({
            "name": name,
            "t_s": round(time.perf_counter() - self.t0, 6),
            **fields,
        })


class SpanTracker:
    """Owns the span stack (per thread), the accumulator table, and the
    bounded structured log."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self.acc: dict[str, list] = {}  # name -> [seconds, calls]
        self.log: list[dict] = []  # closed spans, schema-shaped
        self.events: list[dict] = []  # top-level (span-less) events
        self.dropped = 0

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str, enabled: bool, sync=None, log=True, **attrs):
        if not enabled:
            return NULL_SPAN
        return _ActiveSpan(self, name, attrs, sync, log=log)

    def current(self) -> _ActiveSpan | None:
        st = self._stack()
        return st[-1] if st else None

    def event(self, name: str, **fields):
        """Attach to the innermost open span, else record top-level."""
        cur = self.current()
        if cur is not None and not isinstance(cur, _NullSpan):
            cur.event(name, **fields)
            return
        with self._lock:
            if len(self.events) >= MAX_LOG:
                self.dropped += 1
                return
            self.events.append({
                "name": name, "ts": time.time(), **fields,
            })

    def _close(self, span: _ActiveSpan, wall: float, failed: bool):
        with self._lock:
            a = self.acc.get(span.name)
            if a is None:
                self.acc[span.name] = [wall, 1]
            else:
                a[0] += wall
                a[1] += 1
            if not span.log:
                # table-only span (the timers-shim force path): the old
                # timers kept one (seconds, calls) pair per name, never
                # an unbounded structured record per call
                return
            if len(self.log) >= MAX_LOG:
                self.dropped += 1
                return
            rec = {
                "name": span.name,
                "path": span.path,
                "ts": span.ts,
                "wall_s": round(wall, 6),
            }
            if span.attrs:
                rec["attrs"] = span.attrs
            if span.events:
                rec["events"] = span.events
            if failed:
                rec["failed"] = True
            self.log.append(rec)

    # -- the per-app timing table (utils/timers.py compat) -----------------
    def seconds(self, name: str) -> float:
        a = self.acc.get(name)
        return a[0] if a else 0.0

    def table(self) -> dict[str, tuple[float, int]]:
        with self._lock:
            return {k: (v[0], v[1]) for k, v in sorted(self.acc.items())}

    def empty(self) -> bool:
        return not (self.acc or self.log or self.events)

    def clear_table(self):
        """Clear only the (seconds, calls) accumulator — the timers-shim
        reset; the structured log/events stay (they belong to obs)."""
        with self._lock:
            self.acc.clear()

    def clear(self):
        with self._lock:
            self.acc.clear()
            self.log.clear()
            self.events.clear()
            self.dropped = 0
