"""The network front door's versioned request/reply protocol (r19);
counterpart of ``combblas_tpu/serve/net/protocol.py``, the same frames,
status codes and mapping.

One TCP connection carries, over the shared frame codec
(``serve/frame.py`` — the same ``[4B len][4B header_len][JSON][blobs]``
frames the process fleet speaks):

1. a HELLO handshake — the client's first frame::

       {"v": 1, "op": "hello", "id": 0, "tenant": "web" | null}

   answered with ``{"id": 0, "status": "ok", "v": 1}`` or a TYPED
   rejection (protocol-version mismatch, unknown tenant, connection
   limit) — a refused connection gets a wire reply, never a silent
   close.  The auth-less ``tenant`` header routes every subsequent
   request on this connection to that ``PoolServer`` tenant; against a
   single-tenant backend (``Server``/``ProcessFleet``/``FleetRouter``)
   it is ignored.

2. pipelined requests — ``id`` correlates replies, which may arrive
   out of order (the backend batches and reorders freely)::

       {"id": 7, "op": "submit", "kind": "bfs", "root": 12,
        "deadline_s": 0.5}                      # deadline optional
       {"id": 8, "op": "submit_many", "kind": "bfs", "roots": [1, 2]}
       {"id": 9, "op": "submit_update", "ops": [["insert", u, v, w]]}
       {"id": 10, "op": "stats"} | {"op": "health"} | {"op": "ping"}

3. replies — ``{"id": n, "status": "ok", "result": {...}}`` (ndarray
   values ride the frame's binary section) or a typed rejection::

       {"id": n, "status": "backpressure", "error": "...",
        "retry_after_s": 0.01, "tenant": "web"}

``deadline_s`` is the request's END-TO-END budget in seconds from
server receipt; it propagates into the scheduler's per-request
timeout, where ``ServeConfig.slo_deadline_s`` still CAPS it (a wire
deadline may tighten the SLO budget, never loosen it).

The status codes are the serving error taxonomy, bijectively — a client
sees the same exception types an in-process caller would:

=================  ====================================================
status             server-side exception / client-side raise
=================  ====================================================
``ok``             —
``backpressure``   ``BackpressureError`` (queue full; retry_after_s)
``breaker_open``   ``CircuitBreakerOpen`` (kind's breaker tripped)
``replica_dead``   ``ReplicaDeadError`` (every routed replica failed)
``timeout``        ``TimeoutError`` / ``IpcTimeoutError`` (deadline)
``invalid``        ``ValueError``/``KeyError`` (bad kind/root/tenant/op)
``unavailable``    anything else (server closing, internal failure)
=================  ====================================================

``breaker_open`` is checked BEFORE ``backpressure`` (it is a subclass)
so the more specific code wins.

One case is the port's own: a CUDA error (``torch.AcceleratorError``,
``torch.OutOfMemoryError``) is a ``RuntimeError``, so a request that
met one — or that a backend holding a ``device_error`` refused — maps
to ``unavailable``, as any other unknown failure does.  The backend's
``health()`` reports ``down`` meanwhile; nothing on the wire retries.
"""

from __future__ import annotations

from ..policy import ReplicaDeadError
from ..procfleet import IpcTimeoutError
from ..scheduler import BackpressureError, CircuitBreakerOpen

#: Protocol version spoken by this build; hello frames carrying any
#: other version are rejected with ``invalid`` (naming both versions).
PROTOCOL_VERSION = 1

ST_OK = "ok"
ST_BACKPRESSURE = "backpressure"
ST_BREAKER_OPEN = "breaker_open"
ST_REPLICA_DEAD = "replica_dead"
ST_TIMEOUT = "timeout"
ST_INVALID = "invalid"
ST_UNAVAILABLE = "unavailable"

#: Every non-ok status a reply can carry (the wire-visible taxonomy).
ERROR_STATUSES = (
    ST_BACKPRESSURE, ST_BREAKER_OPEN, ST_REPLICA_DEAD,
    ST_TIMEOUT, ST_INVALID, ST_UNAVAILABLE,
)


def wire_error(exc: BaseException, mid=None) -> dict:
    """The reply frame for a failed request: the taxonomy mapped onto
    a status code plus the fields the client needs to rebuild the
    SAME exception type (retry hints survive the wire)."""
    out: dict = {"error": str(exc) or type(exc).__name__}
    if mid is not None:
        out["id"] = mid
    if isinstance(exc, CircuitBreakerOpen):  # before the parent class
        out["status"] = ST_BREAKER_OPEN
        out["kind"] = exc.kind
        out["retry_after_s"] = exc.retry_after_s
        out["tenant"] = exc.tenant
    elif isinstance(exc, BackpressureError):
        out["status"] = ST_BACKPRESSURE
        out["retry_after_s"] = exc.retry_after_s
        out["tenant"] = exc.tenant
    elif isinstance(exc, ReplicaDeadError):
        out["status"] = ST_REPLICA_DEAD
    elif isinstance(exc, (TimeoutError, IpcTimeoutError)):
        # IpcTimeoutError is deliberately NOT a TimeoutError subclass
        # (it must stay read-retryable inside the fleet); on the wire
        # both are the same fact — the deadline expired
        out["status"] = ST_TIMEOUT
    elif isinstance(exc, (ValueError, KeyError, TypeError)):
        out["status"] = ST_INVALID
    else:
        out["status"] = ST_UNAVAILABLE
    return out


def wire_exception(msg: dict) -> Exception:
    """Rebuild the typed exception a non-ok reply encodes (the client
    side of :func:`wire_error`); unknown statuses degrade to
    ``RuntimeError`` so a newer server cannot crash an older client."""
    status = msg.get("status")
    err = msg.get("error", status)
    retry = float(msg.get("retry_after_s") or 0.0)
    tenant = msg.get("tenant")
    if status == ST_BREAKER_OPEN:
        return CircuitBreakerOpen(
            msg.get("kind", "?"), retry, tenant=tenant
        )
    if status == ST_BACKPRESSURE:
        return BackpressureError(
            int(msg.get("depth") or 0), retry, tenant=tenant
        )
    if status == ST_REPLICA_DEAD:
        return ReplicaDeadError(err)
    if status == ST_TIMEOUT:
        return TimeoutError(err)
    if status == ST_INVALID:
        return ValueError(err)
    return RuntimeError(err)
