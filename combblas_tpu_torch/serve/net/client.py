"""``NetClient`` — the blocking wire client for the net front door;
counterpart of ``combblas_tpu/serve/net/client.py``.  It is host code
over ``serve/frame.py``'s ``Channel`` and speaks the same bytes, so a
client of either package talks to a frontend of either package.

One TCP connection, one background reader thread matching pipelined
replies to futures by ``id``.  The blocking calls
(``submit``/``submit_many``/``submit_update``/``stats``/``health``)
wrap the ``*_nowait`` future primitives the open-loop load generator
drives directly (an open-loop harness must SEND on schedule, never
block on completions — ``submit_nowait`` is that send).

Typed failures come back as the SAME exception types an in-process
caller sees (``protocol.wire_exception``): a ``backpressure`` reply
raises ``BackpressureError`` with its ``retry_after_s`` hint intact.
A dropped connection fails every pending future with
``ConnectionError`` — stranded futures are impossible by construction
(the reader thread owns its connection generation's teardown).

Round 20 (the ROADMAP front-door follow-up): the BLOCKING calls
retry.  A ``BackpressureError`` sleeps the server's own
``retry_after_s`` hint (capped) and resends; a dropped connection
reconnects — new socket, new hello, new reader — with bounded
exponential backoff and resends.  Retry budgets are per-call
(``max_retries``, default 3; ``max_retries=0`` restores the old
fail-fast behavior).  Two deliberate exclusions:

* the ``*_nowait`` primitives never retry — the open-loop harness
  measures the wire as it is, and silent resends would falsify its
  availability numbers;
* ``submit_update`` retries ONLY when the send itself failed (the
  request provably never left this process).  A write that died
  IN FLIGHT may have been applied — blindly resending a
  non-idempotent insert/delete batch could double-apply it, so that
  ``ConnectionError`` surfaces to the caller, who owns idempotency.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from concurrent.futures import Future

from ..frame import Channel
from ..scheduler import BackpressureError
from . import protocol as P


class NetClient:
    """Blocking client for one ``NetFrontend`` connection."""

    def __init__(self, host: str, port: int, *,
                 tenant: str | None = None,
                 connect_timeout_s: float = 10.0,
                 max_retries: int = 3,
                 backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.connect_timeout_s = connect_timeout_s
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        # pending: id -> (future, connection generation) — replies pop
        # by id; a dying reader fails ONLY its own generation, so a
        # reconnect's fresh in-flights can never be torn down by the
        # old connection's teardown racing in behind it
        self._pending: dict[int, tuple[Future, int]] = {}
        self._plock = threading.Lock()
        self._rid = itertools.count(1)
        self._closed = False
        self._conn_lock = threading.Lock()
        self._gen = 0
        self._conn_dead = False
        self.reconnects = 0
        self.ch: Channel = None  # set by _connect_locked
        with self._conn_lock:
            self._connect_locked()

    # -- connection lifecycle ----------------------------------------------

    def _connect_locked(self) -> None:
        """(Re)establish the connection: socket, hello, reader.  Caller
        holds ``_conn_lock``."""
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        ch = Channel(sock, peer="netclient")
        try:
            ch.send({
                "v": P.PROTOCOL_VERSION, "op": "hello", "id": 0,
                "tenant": self.tenant,
            })
            hello = ch.recv(timeout=self.connect_timeout_s)
        except Exception as e:
            ch.close()
            raise ConnectionError(f"hello failed: {e}") from e
        if hello.get("status") != P.ST_OK:
            ch.close()
            raise P.wire_exception(hello)
        self.server_pooled = bool(hello.get("pooled"))
        self.ch = ch
        self._gen += 1
        self._conn_dead = False
        reader = threading.Thread(
            target=self._read_loop, args=(ch, self._gen), daemon=True,
            name=f"combblas-net-client:{self.port}",
        )
        reader.start()
        self._reader = reader

    def _ensure_connected(self) -> None:
        """Reconnect if the current connection is known-dead (send
        failure or reader teardown); a healthy connection is a no-op,
        and concurrent callers collapse into one reconnect."""
        with self._conn_lock:
            if self._closed:
                raise ConnectionError("client closed")
            if not self._conn_dead:
                return
            try:
                self.ch.close()
            except Exception:
                pass
            self._connect_locked()
            self.reconnects += 1

    # -- reader ------------------------------------------------------------

    def _read_loop(self, ch: Channel, gen: int) -> None:
        while True:
            try:
                m = ch.recv(timeout=0.25)
            except socket.timeout:
                continue
            except Exception as e:
                self._conn_dead = True
                self._fail_all(ConnectionError(
                    "connection closed" if self._closed
                    else f"server gone: {e}"
                ), gen=gen)
                return
            if not isinstance(m, dict):
                continue
            with self._plock:
                ent = self._pending.pop(m.get("id"), None)
            if ent is None:
                continue  # reply for an id we never sent (or re-sent)
            fut, _g = ent
            if m.get("status") == P.ST_OK:
                if not fut.set_running_or_notify_cancel():
                    continue
                if "results" in m:
                    fut.set_result(m["results"])
                else:
                    fut.set_result(m.get("result"))
            else:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(P.wire_exception(m))

    def _fail_all(self, exc: Exception, gen: int | None = None) -> None:
        """Fail pending futures — all of them (close), or only one
        connection generation's (a dying reader must not tear down a
        successor's in-flights)."""
        with self._plock:
            doomed = [
                (mid, f) for mid, (f, g) in self._pending.items()
                if gen is None or g == gen
            ]
            for mid, _f in doomed:
                self._pending.pop(mid, None)
        for _mid, f in doomed:
            if f.set_running_or_notify_cancel():
                f.set_exception(exc)

    # -- send primitives (open-loop harness drives these) ------------------

    def _send(self, msg: dict) -> Future:
        fut: Future = Future()
        mid = next(self._rid)
        msg["id"] = mid
        ch = self.ch
        with self._plock:
            if self._closed:
                raise ConnectionError("client closed")
            self._pending[mid] = (fut, self._gen)
        try:
            ch.send(msg)
        except Exception as e:
            with self._plock:
                self._pending.pop(mid, None)
            self._conn_dead = True
            raise ConnectionError(f"send failed: {e}") from e
        return fut

    def submit_nowait(self, kind: str, root,
                      deadline_s: float | None = None) -> Future:
        """Send one query WITHOUT waiting; the Future resolves to the
        result dict or raises the typed rejection.  Never retries —
        the open-loop contract."""
        msg: dict = {"op": "submit", "kind": kind, "root": root}
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        return self._send(msg)

    def submit_many_nowait(self, kind: str, roots,
                           deadline_s: float | None = None) -> Future:
        msg: dict = {
            "op": "submit_many", "kind": kind, "roots": list(roots),
        }
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        return self._send(msg)

    def submit_update_nowait(self, ops) -> Future:
        return self._send({
            "op": "submit_update", "ops": [list(o) for o in ops],
        })

    # -- the retry loop -----------------------------------------------------

    def _call_retrying(self, send_fn, timeout_s: float, *,
                       retry_inflight: bool = True):
        """Send + wait with the bounded retry policy (module
        docstring): backpressure sleeps the server's hint; a dead
        connection reconnects with exponential backoff.  A request
        that FAILED IN FLIGHT is resent only when ``retry_inflight``
        (reads are; writes are not — idempotency is the caller's)."""
        backoff = self.backoff_s
        attempt = 0
        while True:
            sent = False
            try:
                fut = send_fn()
                sent = True
                return fut.result(timeout=timeout_s)
            except BackpressureError as e:
                if attempt >= self.max_retries:
                    raise
                # the server's own capacity estimate beats any local
                # guess; 0/None degrades to the local backoff ladder
                delay = e.retry_after_s or backoff
                time.sleep(min(delay, self.max_backoff_s))
            except ConnectionError:
                if (
                    self._closed
                    or attempt >= self.max_retries
                    or (sent and not retry_inflight)
                ):
                    raise
                time.sleep(min(backoff, self.max_backoff_s))
                self._ensure_connected()
            attempt += 1
            backoff = min(backoff * 2, self.max_backoff_s)

    # -- blocking API ------------------------------------------------------

    def submit(self, kind: str, root, deadline_s: float | None = None,
               timeout_s: float = 120.0) -> dict:
        return self._call_retrying(
            lambda: self.submit_nowait(kind, root,
                                       deadline_s=deadline_s),
            timeout_s,
        )

    def submit_many(self, kind: str, roots,
                    deadline_s: float | None = None,
                    timeout_s: float = 120.0) -> list[dict]:
        """One entry per root, in order: ``{"status": "ok", "result":
        {...}}`` or the typed wire-error dict — per-root failure
        isolation survives the wire without torn batches."""
        return self._call_retrying(
            lambda: self.submit_many_nowait(kind, list(roots),
                                            deadline_s=deadline_s),
            timeout_s,
        )

    def submit_update(self, ops, timeout_s: float = 120.0) -> dict:
        ops = [list(o) for o in ops]
        return self._call_retrying(
            lambda: self.submit_update_nowait(ops), timeout_s,
            retry_inflight=False,
        )

    def stats(self, timeout_s: float = 30.0) -> dict:
        return self._call_retrying(
            lambda: self._send({"op": "stats"}), timeout_s
        )

    def health(self, timeout_s: float = 30.0) -> dict:
        return self._call_retrying(
            lambda: self._send({"op": "health"}), timeout_s
        )

    def ping(self, timeout_s: float = 30.0) -> dict:
        return self._call_retrying(
            lambda: self._send({"op": "ping"}), timeout_s
        )

    @property
    def pending(self) -> int:
        with self._plock:
            return len(self._pending)

    def close(self) -> None:
        """Close the socket; pending futures fail with
        ``ConnectionError`` (reader-thread teardown — never stranded)."""
        self._closed = True
        self.ch.close()
        self._reader.join(timeout=5.0)
        self._fail_all(ConnectionError("client closed"))

    def __enter__(self) -> "NetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
