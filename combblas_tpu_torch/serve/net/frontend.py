"""``NetFrontend`` — the TCP front door over any serving backend (r19);
counterpart of ``combblas_tpu/serve/net/frontend.py``.

A stdlib-socket listener (thread-per-connection accept loop — the
repo's no-asyncio style; connection counts here are hundreds, not
millions, and every blocking read has a poll-tick timeout) that speaks
``serve/net/protocol.py`` over the shared frame codec and fronts ANY
of the in-process backends:

* ``Server`` — one graph, one tenant;
* ``PoolServer`` — the hello frame's ``tenant`` header routes each
  connection to its tenant (unknown tenant: typed ``invalid`` reject);
* ``FleetRouter`` / ``ProcessFleet`` — replica routing, spillover and
  read-retry happen behind ``submit`` exactly as for local callers.

Requests are PIPELINED per connection and dispatched without waiting
for completions, so concurrent requests from one socket coalesce into
the scheduler's existing lane buckets like any other submit storm;
replies go out in completion order, correlated by ``id``.  A wire
``deadline_s`` becomes the scheduler's per-request timeout (still
CAPPED by ``ServeConfig.slo_deadline_s``).  Every taxonomy rejection
is a first-class wire reply — a connection is only ever closed by the
client, a torn frame, or ``close()``.

Tracing (round 19): the frontend rolls the deterministic sampler ONCE
at the socket, ``hold()``s the trace, charges ``net_accept`` (the
handshake, on the connection's first sampled request) and ``net_read``
(frame parse + validation), hands the SAME trace object down the
submit path (scheduler adoption via ``trace=``; process fleet via its
rid-stitching thread-local), and ``release()``s it after writing the
reply — so one schema-``trace`` record telescopes
``net_accept → net_read → [router/queue/execute stages] → net_write``
to the request's wall time.

Round-19 metric catalog (obs/metrics.py):
``serve.net.{connections,accept_queue,requests{op},bytes_in,
bytes_out,status{code},reply_drops}``.  ``/metrics``-equivalent health
rides the existing scrape plane: ``serve_metrics()`` attaches the
shared ``obs.export`` HTTP endpoint to this frontend (delegating to
the backend's federated records when it has them).

On the card.  The frontend is host Python: its accept and connection
threads never name a CUDA device.  Over a ``Server``, a ``FleetRouter``
or a ``ProcessFleet`` admission is host work only (queues, breakers,
routing); over a ``PoolServer`` the pool's own admission rebuilds an
evicted tenant (its first read, or a write), and that build runs under
``api.device_scope`` of the pool's card, as it does for any in-process
caller.  Replies are written from the backend future's done-callback,
on the thread that settled it (a ``Server``'s worker, which holds the
card): every backend settles with host numpy arrays, so the frame
codec never moves a tensor off the card there.  A backend that holds
a CUDA error (``device_error``) fails the requests it meets with it:
they answer ``unavailable`` and ``health()`` carries the backend's
``down``.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Any

from ... import obs
from ...tuner import config as tuner_config
from ..frame import Channel, ChannelClosed
from . import protocol as P

#: Poll tick for per-connection reads: bounds how long close() and
#: disconnect detection can lag; partial frames survive ticks by
#: Channel's accumulator contract.
_POLL_S = 0.25

#: A client must complete its hello within this budget or the slot is
#: reclaimed (accept-queue hygiene; generous — one frame, not work).
_HELLO_TIMEOUT_S = 10.0


class _Conn:
    """One live connection's bookkeeping (owned by its reader thread;
    ``ch.send`` is thread-safe for the reply callbacks)."""

    __slots__ = ("cid", "ch", "tenant", "handshake_s", "traced")

    def __init__(self, cid: int, ch: Channel):
        self.cid = cid
        self.ch = ch
        self.tenant: str | None = None
        self.handshake_s = 0.0
        self.traced = False  # first sampled request charges net_accept


class NetFrontend:
    """TCP listener bridging wire frames to a serving backend.

    Knobs (tuner/config.py, argument > env > default):
    ``COMBBLAS_NET_PORT`` (0 = OS-assigned ephemeral, read back from
    :attr:`port`), ``COMBBLAS_NET_MAX_CONNS`` (connections past the
    cap get a typed ``backpressure`` hello-reply, then close),
    ``COMBBLAS_NET_ACCEPT_BACKLOG`` (``listen()`` queue).
    """

    def __init__(self, backend, *, host: str = "127.0.0.1",
                 port: int | None = None,
                 max_conns: int | None = None,
                 accept_backlog: int | None = None):
        self.backend = backend
        self._pooled = hasattr(backend, "pool")  # PoolServer duck type
        self.host = host
        self.max_conns = tuner_config.net_max_conns(max_conns)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, tuner_config.net_port(port)))
        self._lsock.listen(tuner_config.net_accept_backlog(accept_backlog))
        # poll-tick the accept loop: a blocking accept() is not
        # reliably woken by close() on another thread, and close()
        # must not stall behind its join
        self._lsock.settimeout(_POLL_S)
        self.port = self._lsock.getsockname()[1]
        self._lock = threading.Lock()
        self._conns: dict[int, _Conn] = {}
        self._threads: dict[int, threading.Thread] = {}
        self._cid = itertools.count(1)
        self._rid = itertools.count(1)  # trace rid namespace "net<n>"
        self._closing = False
        self._scrape = None
        self._hs = 0  # connections mid-handshake (accept_queue gauge)
        self.accepted = 0
        self.rejected_conns = 0
        self.requests = 0
        self.reply_drops = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"combblas-net-accept:{self.port}",
        )
        self._accept_thread.start()

    # -- accept path -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by close()
            sock.settimeout(None)  # per-recv timeouts are Channel's job
            cid = next(self._cid)
            t = threading.Thread(
                target=self._serve_conn, args=(cid, sock),
                daemon=True, name=f"combblas-net-conn{cid}",
            )
            with self._lock:
                if self._closing:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                self._threads[cid] = t
            t.start()

    def _serve_conn(self, cid: int, sock: socket.socket) -> None:
        t_accept = time.perf_counter()
        obs.gauge("serve.net.accept_queue", self._in_handshake(+1))
        # a fixed peer class (not per-connection) keeps the shared
        # serve.ipc.* series cardinality bounded under conn churn
        ch = Channel(sock, peer="net")
        conn = _Conn(cid, ch)
        registered = False
        try:
            registered = self._handshake(conn, t_accept)
        finally:
            obs.gauge("serve.net.accept_queue", self._in_handshake(-1))
        if not registered:
            ch.close()
            with self._lock:
                self._threads.pop(cid, None)
            return
        try:
            self._conn_loop(conn)
        finally:
            ch.close()
            with self._lock:
                self._conns.pop(cid, None)
                self._threads.pop(cid, None)
                n = len(self._conns)
            obs.gauge("serve.net.connections", n)

    def _in_handshake(self, delta: int) -> int:
        with self._lock:
            cur = getattr(self, "_hs", 0) + delta
            self._hs = max(cur, 0)
            return self._hs

    def _handshake(self, conn: _Conn, t_accept: float) -> bool:
        """Read + answer the hello frame; every refusal is a typed
        wire reply (never a dropped connection).  Returns whether the
        connection was admitted and registered."""
        try:
            m = conn.ch.recv(timeout=_HELLO_TIMEOUT_S)
        except Exception:
            return False  # no (whole, well-formed) hello: nothing to
            # answer — covers timeout, disconnect, torn/corrupt frame
        obs.count("serve.net.bytes_in", conn.ch.bytes_in)
        mid = m.get("id") if isinstance(m, dict) else None
        if (not isinstance(m, dict)) or m.get("op") != "hello":
            self._try_send(conn, P.wire_error(
                ValueError("first frame must be the hello"), mid
            ))
            return False
        if m.get("v") != P.PROTOCOL_VERSION:
            self._try_send(conn, P.wire_error(ValueError(
                f"protocol version {m.get('v')!r} != "
                f"{P.PROTOCOL_VERSION}"
            ), mid))
            return False
        tenant = m.get("tenant")
        if self._pooled:
            if tenant is None:
                self._try_send(conn, P.wire_error(ValueError(
                    "tenant header required by a pooled backend"
                ), mid))
                return False
            if tenant not in self.backend.pool.tenant_names():
                self._try_send(conn, P.wire_error(
                    KeyError(f"unknown tenant {tenant!r}"), mid
                ))
                return False
        conn.tenant = tenant if isinstance(tenant, str) else None
        with self._lock:
            if self._closing:
                admitted = False
            else:
                admitted = len(self._conns) < self.max_conns
                if admitted:
                    self._conns[conn.cid] = conn
                    self.accepted += 1
                n = len(self._conns)
        if not admitted:
            self.rejected_conns += 1
            obs.count("serve.net.status", code=P.ST_BACKPRESSURE)
            self._try_send(conn, {
                "id": mid, "status": P.ST_BACKPRESSURE,
                "error": f"connection limit ({self.max_conns}) reached",
                "retry_after_s": 0.05,
            })
            return False
        obs.gauge("serve.net.connections", n)
        conn.handshake_s = time.perf_counter() - t_accept
        self._try_send(conn, {
            "id": mid, "status": P.ST_OK, "v": P.PROTOCOL_VERSION,
            "pooled": self._pooled,
        })
        return True

    # -- request path ------------------------------------------------------

    def _conn_loop(self, conn: _Conn) -> None:
        while not self._closing:
            b0 = conn.ch.bytes_in  # advances only on whole frames
            try:
                m = conn.ch.recv(timeout=_POLL_S)
            except socket.timeout:
                continue
            except Exception:
                # disconnect, torn frame, oversized prefix, or corrupt
                # JSON: the stream is unrecoverable — clean up.  Any
                # in-flight backend futures still settle server-side;
                # their reply callbacks hit the closed channel and are
                # counted as reply_drops, never stranded.
                return
            obs.count("serve.net.bytes_in", conn.ch.bytes_in - b0)
            if not isinstance(m, dict):
                self._send_reply(conn, P.wire_error(
                    ValueError("request frame must be a JSON object"),
                ))
                continue
            self._dispatch(conn, m)

    def _dispatch(self, conn: _Conn, m: dict) -> None:
        op = m.get("op")
        mid = m.get("id")
        self.requests += 1
        obs.count(
            "serve.net.requests",
            op=op if isinstance(op, str) else "?",
        )
        if op == "ping":
            self._send_reply(conn, {
                "id": mid, "status": P.ST_OK,
                "result": {"pong": True, "t": time.time()},
            })
        elif op == "submit":
            self._do_submit(conn, m)
        elif op == "submit_many":
            self._do_submit_many(conn, m)
        elif op == "submit_update":
            self._do_submit_update(conn, m)
        elif op == "stats":
            self._do_info(conn, mid, self.stats)
        elif op == "health":
            self._do_info(conn, mid, self.health)
        else:
            self._send_reply(conn, P.wire_error(
                ValueError(f"unknown op {op!r}"), mid
            ))

    def _deadline(self, m: dict) -> float | None:
        d = m.get("deadline_s")
        if d is None:
            return None
        t = float(d)
        if not (t > 0):
            raise ValueError(f"deadline_s must be > 0, got {d!r}")
        return t

    def _open_trace(self, conn: _Conn, kind):
        tr = obs.request_trace(
            f"net{next(self._rid)}",
            kind=kind if isinstance(kind, str) else None,
            tenant=conn.tenant,
        )
        if tr is None:
            return None
        # deferred commit: the scheduler/fleet will call finish() when
        # the request settles; we still owe the net_write tail
        tr.hold()
        tr.annotate(transport="net")
        if not conn.traced:
            # charge the TCP handshake to this connection's first
            # sampled request: widen the wall by handshake_s and book
            # the same amount as the leading stage, preserving
            # sum(stages) == wall_s exactly
            conn.traced = True
            tr.t0 -= conn.handshake_s
            tr.stages.append(["net_accept", conn.handshake_s])
        return tr

    def _do_submit(self, conn: _Conn, m: dict) -> None:
        mid = m.get("id")
        kind = m.get("kind")
        try:
            timeout_s = self._deadline(m)
        except (TypeError, ValueError) as e:
            self._send_reply(conn, P.wire_error(
                e if isinstance(e, ValueError) else ValueError(str(e)),
                mid,
            ))
            return
        tr = self._open_trace(conn, kind)
        if tr is not None:
            tr.mark("net_read")  # frame parse + validation
        try:
            fut = self._backend_submit(
                conn, kind, m.get("root"), timeout_s, tr
            )
        except Exception as e:
            # synchronous admission rejection (backpressure, breaker,
            # unknown kind/tenant, closing): a first-class wire reply
            self._send_reply(conn, P.wire_error(e, mid), trace=tr)
            return
        fut.add_done_callback(
            lambda f: self._reply_future(conn, mid, f, tr)
        )

    def _backend_submit(self, conn: _Conn, kind, root, timeout_s, tr):
        if self._pooled:
            return self.backend.submit(
                conn.tenant, kind, root, timeout_s=timeout_s, trace=tr
            )
        return self.backend.submit(
            kind, root, timeout_s=timeout_s, trace=tr
        )

    def _do_submit_many(self, conn: _Conn, m: dict) -> None:
        mid = m.get("id")
        kind = m.get("kind")
        roots = m.get("roots")
        try:
            timeout_s = self._deadline(m)
            if not isinstance(roots, list):
                raise ValueError("submit_many needs a roots list")
        except (TypeError, ValueError) as e:
            self._send_reply(conn, P.wire_error(
                e if isinstance(e, ValueError) else ValueError(str(e)),
                mid,
            ))
            return
        try:
            if self._pooled:
                futs = self.backend.submit_many(
                    conn.tenant, kind, roots, timeout_s=timeout_s
                )
            else:
                futs = self.backend.submit_many(
                    kind, roots, timeout_s=timeout_s
                )
        except Exception as e:
            self._send_reply(conn, P.wire_error(e, mid))
            return
        if not futs:
            self._send_reply(
                conn, {"id": mid, "status": P.ST_OK, "results": []}
            )
            return
        # one reply frame once every per-root future settles; entries
        # carry their own status (prefix-rejection semantics survive
        # the wire as typed per-root entries, not a torn batch)
        results: list[Any] = [None] * len(futs)
        left = [len(futs)]
        lk = threading.Lock()

        def _on_done(j, f):
            exc = f.exception()
            if exc is None:
                results[j] = {"status": P.ST_OK, "result": f.result()}
            else:
                results[j] = P.wire_error(exc)
            with lk:
                left[0] -= 1
                done = left[0] == 0
            if done:
                self._send_reply(conn, {
                    "id": mid, "status": P.ST_OK, "results": results,
                })

        for j, f in enumerate(futs):
            f.add_done_callback(
                lambda f, j=j: _on_done(j, f)
            )

    def _do_submit_update(self, conn: _Conn, m: dict) -> None:
        mid = m.get("id")
        ops = m.get("ops")
        if not isinstance(ops, list):
            self._send_reply(conn, P.wire_error(
                ValueError("submit_update needs an ops list"), mid
            ))
            return
        try:
            ops_t = [tuple(o) for o in ops]
            if self._pooled:
                fut = self.backend.submit_update(conn.tenant, ops_t)
            else:
                fut = self.backend.submit_update(ops_t)
        except Exception as e:
            self._send_reply(conn, P.wire_error(e, mid))
            return
        fut.add_done_callback(
            lambda f: self._reply_future(conn, mid, f, None)
        )

    def _do_info(self, conn: _Conn, mid, fn) -> None:
        try:
            self._send_reply(conn, {
                "id": mid, "status": P.ST_OK, "result": fn(),
            })
        except Exception as e:
            self._send_reply(conn, P.wire_error(e, mid))

    # -- reply path --------------------------------------------------------

    def _reply_future(self, conn: _Conn, mid, fut, tr) -> None:
        exc = fut.exception()
        if exc is None:
            msg = {"id": mid, "status": P.ST_OK, "result": fut.result()}
        else:
            msg = P.wire_error(exc, mid)
        self._send_reply(conn, msg, trace=tr)

    def _send_reply(self, conn: _Conn, msg: dict, trace=None) -> None:
        code = msg.get("status", P.ST_UNAVAILABLE)
        obs.count("serve.net.status", code=code)
        try:
            n = conn.ch.send(msg)
            obs.count("serve.net.bytes_out", n)
        except ValueError:
            # reply overflowed MAX_FRAME: degrade to a typed error so
            # the request id still settles client-side
            self._try_send(conn, P.wire_error(
                RuntimeError("reply exceeds frame limit"), msg.get("id")
            ))
        except ChannelClosed:
            # client disconnected before its reply: the backend future
            # settled regardless — dropped reply, not a stranded future
            self.reply_drops += 1
            obs.count("serve.net.reply_drops")
        if trace is not None:
            trace.release(status=code, stage="net_write")

    def _try_send(self, conn: _Conn, msg: dict) -> None:
        try:
            n = conn.ch.send(msg)
            obs.count("serve.net.bytes_out", n)
        except (ChannelClosed, ValueError):
            self.reply_drops += 1
            obs.count("serve.net.reply_drops")

    # -- observability / lifecycle ----------------------------------------

    def stats(self) -> dict:
        with self._lock:
            conns = len(self._conns)
        net = {
            "port": self.port,
            "connections": conns,
            "accepted": self.accepted,
            "rejected_conns": self.rejected_conns,
            "requests": self.requests,
            "reply_drops": self.reply_drops,
            "max_conns": self.max_conns,
        }
        return {"net": net, "backend": self.backend.stats()}

    def health(self) -> dict:
        h = self.backend.health()
        return {
            "status": h.get("status", "ok"),
            "net": {
                "port": self.port,
                "connections": len(self._conns),
                "closing": self._closing,
            },
            "backend": h,
        }

    def metrics_records(self) -> list[dict]:
        """The scrape body: the backend's federated records when it
        has them (ProcessFleet replica metrics), the process-global
        registry otherwise — serve.net.* counters live there either
        way."""
        fn = getattr(self.backend, "metrics_records", None)
        if fn is not None:
            return fn()
        return obs.metrics_snapshot()

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"
                      ) -> int:
        """Attach the shared /metrics //healthz //statz scrape plane
        to this frontend; returns the bound port."""
        from ...obs import export

        return export.attach_scrape(self, port=port, host=host)

    def close(self) -> None:
        """Stop accepting, close every connection, detach the scrape.
        The BACKEND is not closed — its owner decides."""
        self._closing = True
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            threads = list(self._threads.values())
        for c in conns:
            c.ch.close()
        self._accept_thread.join(timeout=5.0)
        for t in threads:
            t.join(timeout=5.0)
        if self._scrape is not None:
            from ...obs import export

            export.detach_scrape(self)

    def __enter__(self) -> "NetFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
