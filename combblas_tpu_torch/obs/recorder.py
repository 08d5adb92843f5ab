"""Flight recorder — counterpart of ``combblas_tpu/obs/recorder.py``
(host-only): an always-on bounded ring of recent per-batch
stage events, dumped on failure (round 15).

Tracing (``obs/trace.py``) answers "where did THIS request's latency
go" — but only for sampled requests, only when enabled.  The flight
recorder answers the post-mortem question: when a worker dies, a
breaker opens, a batch is poisoned, a merge fails, or an SLO budget
burns out, WHAT was the device doing in the seconds before?  It is a
fixed-size ``deque`` of small host-side event dicts (one per batch /
merge, never per request), recorded unconditionally by the serve
worker — the cost is one ring append next to a device launch, which is
why it can afford to be always on — and written out as a
schema-versioned JSONL snapshot (``combblas_tpu.flightrec/v1``: one
meta line carrying the dump ``reason``, then ordinary ``event``
records ``obs.parse_jsonl`` validates) only when something goes wrong.

Dumps are rate-limited (``min_interval_s``) so a failure storm produces
a bounded number of files, and counted in obs
(``serve.flightrec.dumps{reason}``) when telemetry is on.  Disable per
server with ``ServeConfig(flight_recorder=False)`` — the hot path then
pays one attribute read (the zero-cost contract's shape).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from .sinks import FLIGHTREC_SCHEMA, SCHEMA_VERSION

#: Default ring capacity: enough batches to cover the seconds before a
#: failure at serving cadence without unbounded memory.
DEFAULT_EVENTS = 256

#: Dump reasons the serve stack uses (an arbitrary string is accepted;
#: these are the wired trigger points).
REASONS = (
    "worker_error", "breaker_open", "poisoned", "merge_failed",
    "slo_breach", "manual",
)


def default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "combblas_flightrec")


class FlightRecorder:
    """Bounded ring of per-batch events + the snapshot writer."""

    def __init__(self, capacity: int = DEFAULT_EVENTS,
                 out_dir: str | None = None,
                 min_interval_s: float = 1.0,
                 tenant: str | None = None):
        if capacity < 1:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = int(capacity)
        self.out_dir = out_dir or default_dir()
        self.min_interval_s = float(min_interval_s)
        self.tenant = tenant
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._head = 0  # next overwrite slot once the ring is full
        self.recorded = 0
        self.dumps = 0
        self.dump_errors = 0
        self.last_dump: str | None = None
        self._last_dump_at = 0.0
        self._seq = 0

    # -- recording ---------------------------------------------------------

    #: Field names owned by the JSONL record envelope — a caller field
    #: by one of these names would corrupt the schema discriminators,
    #: so record() remaps it to ``f_<name>`` (query kind travels as
    #: ``query=``, not ``kind=``, for exactly this reason).
    RESERVED = frozenset(("v", "kind", "name", "ts"))

    def record(self, name: str, **fields) -> None:
        """Append one event (``name`` + arbitrary JSON-scalar fields).
        O(1), no I/O — safe next to the device on every batch."""
        ev = {"name": name, "ts": time.time()}
        if self.tenant is not None:
            ev["tenant"] = self.tenant
        for k, v in fields.items():
            ev[f"f_{k}" if k in self.RESERVED else k] = v
        with self._lock:
            self.recorded += 1
            if len(self._ring) < self.capacity:
                self._ring.append(ev)
            else:
                self._ring[self._head] = ev
                self._head = (self._head + 1) % self.capacity
        from .. import obs

        obs.count("serve.flightrec.events")

    def snapshot(self) -> list[dict]:
        """The ring's events, oldest first."""
        with self._lock:
            return self._ring[self._head:] + self._ring[: self._head]

    # -- snapshots ---------------------------------------------------------

    def dump(self, reason: str = "manual", *, force: bool = False,
             **extra) -> str | None:
        """Write the ring as one ``combblas_tpu.flightrec/v1`` JSONL
        snapshot; returns the path, or None when rate-limited / empty.
        Best-effort: a full disk must never take the serve worker down
        with it (errors are counted, not raised)."""
        now = time.monotonic()
        with self._lock:
            if not self._ring:
                return None
            if not force and now - self._last_dump_at < self.min_interval_s:
                return None
            self._last_dump_at = now
            self._seq += 1
            seq = self._seq
        events = self.snapshot()
        from . import process_info

        process, nprocs = process_info()
        meta = {
            "v": SCHEMA_VERSION, "kind": "meta",
            "schema": FLIGHTREC_SCHEMA, "ts": time.time(),
            "process": int(process), "nprocs": int(nprocs),
            "reason": reason, "events": len(events),
        }
        if self.tenant is not None:
            meta["tenant"] = self.tenant
        for k, v in extra.items():  # same envelope protection as
            # record(): extra facts must not clobber the schema fields
            meta[f"f_{k}" if (k in meta or k in self.RESERVED) else k] = v
        name = (
            f"flightrec-{self.tenant or 'serve'}-{os.getpid()}"
            f"-{seq:04d}.jsonl"
        )
        path = os.path.join(self.out_dir, name)
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps(meta) + "\n")
                for ev in events:
                    f.write(json.dumps(
                        {"v": SCHEMA_VERSION, "kind": "event", **ev}
                    ) + "\n")
        except OSError:
            self.dump_errors += 1
            return None
        self.dumps += 1
        self.last_dump = path
        from .. import obs

        obs.count("serve.flightrec.dumps", reason=reason)
        return path

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "events": len(self._ring),
                "recorded": self.recorded,
                "dumps": self.dumps,
                "dump_errors": self.dump_errors,
                "last_dump": self.last_dump,
                "dir": self.out_dir,
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._head = 0
