"""Supervision event timeline — counterpart of
``combblas_tpu/obs/fleetlog.py`` (host-only): the process fleet's append-only
``combblas_tpu.fleetlog/v1`` JSONL log (round 18).

The flight recorder (``obs/recorder.py``) answers "what was the DEVICE
doing before this failure"; the fleet log answers the control-plane
question: what happened to replica 2 at 14:03?  Spawn, heartbeat-miss,
quarantine, SIGKILL/SIGSTOP detection, respawn, promotion,
drain/restore, rolling-restart, and fan-out lag/heal all land here as
they happen — written by the supervisor (one thread, no request-path
cost), so the timeline is ordered the way the supervisor actually saw
events, not the way post-hoc metric scrapes infer them.

Format: one meta line under ``FLEETLOG_SCHEMA`` (written lazily on the
first event so an idle fleet leaves no file), then ordinary ``event``
records that ``obs.parse_jsonl`` validates — the flightrec precedent.
Unlike the flight recorder the file is APPENDED per event rather than
dumped on demand (a timeline that dies with the supervisor is not a
post-mortem tool), but both the in-memory ring and the file are
bounded: the ring keeps the last ``capacity`` events for ``stats()``,
the file stops growing at ``max_file_events`` (the ring keeps
rotating, and ``truncated`` in ``describe()`` says the file is a
prefix).  Best-effort like every obs writer: a full disk increments
``write_errors``, never raises into the supervisor loop.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .sinks import FLEETLOG_SCHEMA, SCHEMA_VERSION

#: Default in-memory ring capacity — a chaos soak's worth of
#: supervision churn without unbounded memory.
DEFAULT_EVENTS = 512

#: File growth cap: the timeline is per-fleet-lifetime, so 10k events
#: covers any realistic supervision history; past it the file is a
#: truncated prefix (flagged in describe()), the ring stays live.
DEFAULT_MAX_FILE_EVENTS = 10_000


class FleetLog:
    """Bounded supervision timeline: in-memory ring + JSONL append."""

    #: Envelope field names (the FlightRecorder convention): a caller
    #: field by one of these names is remapped to ``f_<name>`` so it
    #: cannot corrupt the schema discriminators.
    RESERVED = frozenset(("v", "kind", "name", "ts"))

    def __init__(self, path: str, capacity: int = DEFAULT_EVENTS,
                 max_file_events: int = DEFAULT_MAX_FILE_EVENTS,
                 tenant: str | None = None):
        if capacity < 1:
            raise ValueError("fleet log needs capacity >= 1")
        self.path = os.path.abspath(path)
        self.capacity = int(capacity)
        self.max_file_events = int(max_file_events)
        self.tenant = tenant
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._head = 0  # next overwrite slot once the ring is full
        self._meta_written = False
        self.recorded = 0
        self.file_events = 0
        self.write_errors = 0

    def event(self, name: str, **fields) -> None:
        """Record one supervision event (``name`` + JSON-scalar
        fields): ring append + one file append.  Never raises — the
        supervisor loop must survive a full disk."""
        ev = {"name": f"fleet.{name}", "ts": time.time()}
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
            lines = []
            if not self._meta_written:
                meta = {
                    "v": SCHEMA_VERSION, "kind": "meta",
                    "schema": FLEETLOG_SCHEMA, "ts": time.time(),
                    "process": os.getpid(), "nprocs": 1,
                }
                if self.tenant is not None:
                    meta["tenant"] = self.tenant
                lines.append(meta)
            if self.file_events < self.max_file_events:
                lines.append({"v": SCHEMA_VERSION, "kind": "event", **ev})
            if lines:
                try:
                    os.makedirs(
                        os.path.dirname(self.path) or ".", exist_ok=True
                    )
                    with open(self.path, "a") as f:
                        for rec in lines:
                            f.write(json.dumps(rec) + "\n")
                except OSError:
                    self.write_errors += 1
                else:
                    self._meta_written = True
                    self.file_events += sum(
                        1 for rec in lines if rec["kind"] == "event"
                    )
        from .. import obs

        obs.count("serve.fleetlog.events", event=name)

    def snapshot(self) -> list[dict]:
        """The ring's events, oldest first."""
        with self._lock:
            return self._ring[self._head:] + self._ring[: self._head]

    def describe(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "capacity": self.capacity,
                "events": len(self._ring),
                "recorded": self.recorded,
                "file_events": self.file_events,
                "truncated": self.recorded > self.file_events,
                "write_errors": self.write_errors,
            }
