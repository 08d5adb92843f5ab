"""Per-request tracing — counterpart of ``combblas_tpu/obs/trace.py``: the
Dapper-style latency decomposition of the serve path (round 15). The
serve path itself comes to the port later; the sampler and
``RequestTrace`` are here for it, and the heartbeat and fleet-log parsers
of the reference's ``tuner/config.py`` come with the process fleet.

One sampled request carries a ``RequestTrace`` from admission to
settlement; every thread that touches it MARKS a stage transition, and
the durations between marks — queue wait, batch assembly, device
execute, bisection retries, result scatter (or the write lane's
buffer wait, merge, fan-out, swap) — telescope EXACTLY to the
end-to-end latency: ``sum(stage seconds) == wall_s`` by construction
(each mark records the time since the previous one).  Completed traces
land in a bounded log exported as schema ``trace`` records in the obs
JSONL (``combblas_tpu.obs/v1``; sinks.py documents the shape).

Sampling is DETERMINISTIC: a request is traced iff
``crc32(str(rid)) % 1e6 < rate * 1e6`` — the same ids at the same rate
give the same sampled set on every replica and every rerun, so a
fleet-wide trace collection lines up per request without coordination.
The rate comes from ``COMBBLAS_OBS_TRACE_SAMPLE`` (parsed in
tuner/config.py, resolved lazily and cached here) or
``set_sample_rate()``; the default is 0 — and tracing is additionally
gated on ``obs.ENABLED``, so the disabled serve path pays ONE function
call + flag check per submit (``obs.request_trace``), nothing more.
"""

from __future__ import annotations

import threading
import time
import zlib

#: Bound on the completed-trace log (the span-log convention: overflow
#: is counted, never silent, never unbounded memory).
MAX_TRACES = 10_000

_lock = threading.Lock()
_log: list[dict] = []
_dropped = 0
_rate: float | None = None  # None = unresolved (lazy env read)


def sample_rate() -> float:
    """The resolved sampling rate in [0, 1] (env read once, cached)."""
    global _rate
    if _rate is None:
        from ..tuner import config as tuner_config

        _rate = tuner_config.obs_trace_sample()
    return _rate


def set_sample_rate(rate: float | None) -> None:
    """Override the sampling rate programmatically (benches, tests);
    ``None`` re-resolves the env on next use."""
    global _rate
    if rate is None:
        _rate = None
        return
    _rate = min(max(float(rate), 0.0), 1.0)


def sampled(rid, rate: float | None = None) -> bool:
    """Deterministic sampling decision for one request id: stable
    across processes, reruns, and replicas (crc32, not Python's
    per-process-randomized ``hash``)."""
    rate = sample_rate() if rate is None else rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(str(rid).encode()) % 1_000_000) < int(
        rate * 1_000_000
    )


class RequestTrace:
    """One request's stage clock.  ``mark(stage)`` charges the time
    since the previous mark (or creation) to ``stage``; repeated stage
    names ACCUMULATE (a bisection-retried request charges 'execute'
    several times), preserving first-seen order.  ``finish`` closes
    the trace and commits it to the bounded log."""

    __slots__ = ("rid", "name", "labels", "ts", "t0", "_last",
                 "stages", "_done", "_held", "_held_status")

    def __init__(self, rid, name: str, labels: dict):
        self.rid = rid
        self.name = name
        self.labels = labels
        self.ts = time.time()
        self.t0 = time.perf_counter()
        self._last = self.t0
        self.stages: list[list] = []  # [stage, seconds], ordered
        self._done = False
        self._held = False
        self._held_status = None

    def mark(self, stage: str, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        dt = now - self._last
        self._last = now
        for st in self.stages:
            if st[0] == stage:
                st[1] += dt
                break
        else:
            self.stages.append([stage, dt])
        return dt

    def annotate(self, **labels) -> None:
        """Attach attribution facts (lane width, plan warm/cold,
        graph version, ...) discovered after admission."""
        self.labels.update(labels)

    def hold(self) -> None:
        """Defer the commit past the next ``finish`` (round 19): a
        transport that wraps the serve path — the net frontend writes
        the reply AFTER the router/scheduler settles the request —
        needs to charge its tail stage (``net_write``) after the
        downstream layer has already called ``finish``.  While held,
        the first ``finish`` marks its tail stage and records the
        status but does NOT commit; :meth:`release` appends the
        transport tail and commits with that recorded status, so the
        ``sum(stages) == wall_s`` invariant survives the hand-off."""
        self._held = True

    def release(self, status: str | None = None,
                stage: str | None = None) -> None:
        """Close a held trace: charge ``stage`` (the transport tail)
        and commit under the status the downstream ``finish`` recorded
        (falling back to ``status``, then "ok")."""
        if self._done:
            return
        self._held = False
        st = self._held_status or status or "ok"
        self._held_status = None
        self.finish(status=st, stage=stage)

    def finish(self, status: str = "ok", stage: str | None = None
               ) -> None:
        """Close the trace (idempotent — the first settle wins, like
        the future it describes).  ``stage`` charges the tail interval
        (last mark -> now) under that name, so the stage sum stays
        equal to the end-to-end wall time."""
        if self._done:
            return
        if self._held:
            if self._held_status is None:  # first settle wins
                self._held_status = status
                if stage is not None:
                    self.mark(stage)
                self.labels["status"] = status
            return
        self._done = True
        if stage is not None:
            self.mark(stage)
        self.labels["status"] = status
        _commit(self)

    def record(self) -> dict:
        """The schema-``trace`` record body (sinks.py validates it)."""
        return {
            "name": self.name,
            "rid": self.rid,
            "ts": self.ts,
            "wall_s": round(self._last - self.t0, 9),
            "stages": [
                {"stage": s, "s": round(v, 9)} for s, v in self.stages
            ],
            "labels": dict(self.labels),
        }


def begin(rid, name: str = "serve.request", **labels
          ) -> RequestTrace | None:
    """Open a trace for ``rid`` if the deterministic sampler admits it
    (None otherwise).  Callers go through ``obs.request_trace`` /
    ``obs.update_trace``, which add the ``obs.ENABLED`` gate."""
    if not sampled(rid):
        return None
    from .. import obs

    obs.count("serve.trace.sampled", lane=name.rsplit(".", 1)[-1])
    return RequestTrace(
        rid, name, {k: v for k, v in labels.items() if v is not None}
    )


def _commit(tr: RequestTrace) -> None:
    global _dropped
    with _lock:
        if len(_log) >= MAX_TRACES:
            _dropped += 1
            drop = True
        else:
            _log.append(tr.record())
            drop = False
    if drop:
        from .. import obs

        obs.count("serve.trace.dropped")


def records() -> list[dict]:
    """Snapshot of the completed-trace records (not drained — like the
    span log, ``obs.reset()`` is the wipe)."""
    with _lock:
        return list(_log)


def dropped() -> int:
    with _lock:
        return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _log.clear()
        _dropped = 0


def stage_summary(trace_records=None) -> dict:
    """Fold trace records into the latency decomposition the bench
    summaries report: ``{stage: {"mean_s", "total_s", "count"}}`` plus
    a ``"_wall"`` row for the end-to-end latency.  Accepts any iterable
    of schema-``trace`` records (default: the in-process log)."""
    trace_records = records() if trace_records is None else trace_records
    acc: dict[str, list] = {}
    wall = [0.0, 0]
    for rec in trace_records:
        wall[0] += rec["wall_s"]
        wall[1] += 1
        for st in rec["stages"]:
            a = acc.setdefault(st["stage"], [0.0, 0])
            a[0] += st["s"]
            a[1] += 1
    out = {
        stage: {
            "mean_s": a[0] / a[1], "total_s": a[0], "count": a[1],
        }
        for stage, a in acc.items()
    }
    if wall[1]:
        out["_wall"] = {
            "mean_s": wall[0] / wall[1], "total_s": wall[0],
            "count": wall[1],
        }
    return out
