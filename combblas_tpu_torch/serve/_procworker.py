"""Replica subprocess entry point (the process fleet); counterpart of
``combblas_tpu/serve/_procworker.py``.

``python -m combblas_tpu_torch.serve._procworker --fd N`` is what
``ProcessFleet`` spawns: one OS process hosting one ``Server`` with its
OWN CUDA context (a fresh interpreter, so no state of the parent's
context is inherited), so there is no shared exec lock and a sticky
CUDA error poisons this replica only.

Protocol (``serve/ipc.py`` framing) — the parent sends requests
``{"id": n, "op": ..., ...}``; the child replies ``{"id": n, "ok":
true, "result": ...}`` or ``{"id": n, "ok": false, "etype": ...,
"error": ...}``.  ``submit``/``submit_update`` dispatch to the server
and reply from the future's done-callback, so the receive loop never
blocks on device execution (requests pipeline; the server's own
scheduler provides the queue).  Unsolicited ``{"hb": {...}}``
heartbeats carry queue depth, health, and the WAL frontier on a fixed
interval — the parent's liveness signal that distinguishes a WEDGED
process (SIGSTOP: alive but silent) from a busy one.

Graph payloads never cross the socket: the child boots from a
``save_version`` checkpoint path (or ``recover=True`` over the
durability dir), and fan-out arrives as ``swap_from_checkpoint``
naming a spool file on disk.

On the card. The boot message names the device (``"cuda"`` on the
card, ``"cpu"`` in the tests); the child builds its grid there and
never picks one itself. Every op that touches the device (``boot``'s
load or recovery and warm-up, ``swap_from_checkpoint``,
``spool_version``, ``promote``) runs under ``api.device_scope`` on the
dispatch thread; the ``Server``'s own threads already do. The heartbeat
thread does host work only, so it keeps beating through a long load,
snapshot or merge. Its ``serving`` is ``Server.is_serving()``: false
once the ``Server`` holds a CUDA error, which the parent reads as this
replica's death (``ProcessFleet._dead``) and heals by SIGKILL and a
respawn with a fresh context.

Deviations from the reference, kept on purpose:

* No ``JAX_PLATFORMS`` or ``XLA_FLAGS`` are set: there is no runtime
  to pin, and the parent passes ``CUDA_VISIBLE_DEVICES`` through.
* The ops are the ones the parent sends: the reference's ``ping``,
  ``warmup``, ``health``, ``stats`` and ``checkpoint_now`` have no
  caller there, and the hand-run ``--hb-interval-s`` flag none either
  (``boot`` sets the interval).
* A CUDA error met by the warm-up of ``boot`` or ``promote`` fails the
  op (the reference records a warm-up error and goes on): the parent
  quarantines the child, so a poisoned context never joins the fleet
  or takes the home.
* ``boot`` reports ``devices`` as 1 (the one device the grid's tiles
  live on), ``device`` (its name), ``device_bytes`` (the loaded
  version's resident bytes, which the parent cannot see) and ``boot_s``
  (seconds of the load or recovery with the server's start, and of the
  warm-up), and the heartbeat carries the ``Server``'s ``device_error``
  (its repr, or None).
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
import traceback

# obs is import-light and reads COMBBLAS_OBS — which the parent pinned
# into our env — at import time, so the child's telemetry
# armed/unarmed state mirrors the router's.
from .. import obs


def _cfg_from_json(d: dict):
    """Rebuild a ServeConfig from the parent's dataclasses.asdict
    payload (tuples arrive as lists)."""
    from .scheduler import ServeConfig

    kw = dict(d or {})
    if "lane_widths" in kw and kw["lane_widths"] is not None:
        kw["lane_widths"] = tuple(kw["lane_widths"])
    return ServeConfig(**kw)


class ProcWorker:
    """The child-side dispatcher: one Server, one channel."""

    def __init__(self, channel):
        self.ch = channel
        self.srv = None
        self.grid = None
        #: heartbeat and registry-snapshot cadences, set by ``boot``
        #: (the heartbeat thread starts there)
        self.hb_interval_s = None
        self.metrics_interval_s = None
        self._last_snap_t = 0.0
        self._hb_stop = threading.Event()
        self._stop = False

    # -- replies -----------------------------------------------------------

    def _reply(self, rid, result=None, exc: Exception | None = None,
               trace: dict | None = None):
        from .ipc import ChannelClosed

        try:
            if exc is None:
                msg = {"id": rid, "ok": True, "result": result}
            else:
                msg = {
                    "id": rid, "ok": False,
                    "etype": type(exc).__name__,
                    "error": str(exc),
                    "retry_after_s": getattr(exc, "retry_after_s",
                                             None),
                }
            if trace is not None:
                # completed child-half stage marks, riding the reply's
                # JSON head home for router-side stitching
                msg["trace"] = trace
            self.ch.send(msg)
        except ChannelClosed:
            # the parent died: nothing to report to; the main loop's
            # next recv sees the same closure and exits
            pass

    def _reply_from_future(self, rid, fut, trace=None):
        def _done(f):
            rec = None
            if trace is not None:
                # finish() is idempotent first-wins: the scatter path
                # also finishes committed traces, but the reply must
                # ship COMPLETE marks, and settle order (future first,
                # trace second) means we close the tail ourselves
                trace.finish(
                    status="ok" if f.exception() is None else "error",
                    stage="scatter",
                )
                rec = trace.record()
            if f.exception() is None:
                self._reply(rid, result=f.result(), trace=rec)
            else:
                self._reply(rid, exc=f.exception(), trace=rec)

        fut.add_done_callback(_done)

    # -- heartbeat ---------------------------------------------------------

    def _hb_loop(self):
        from .ipc import ChannelClosed

        while not self._hb_stop.wait(self.hb_interval_s):
            srv = self.srv
            if srv is None:
                continue
            err = srv.device_error
            hb = {
                "t": time.time(),
                "pid": os.getpid(),
                "depth": srv.scheduler.depth(),
                "serving": srv.is_serving(),
                "device_error": repr(err) if err is not None else None,
                "worker_errors": srv.worker_errors,
                "graph_version": srv.engine.version_id,
                "wal_frontier": (
                    srv._wal_frontier
                    if srv._wal is not None else None
                ),
                "updates_pending": (
                    srv._upd_buffer.depth()
                    if srv._upd_buffer is not None else 0
                ),
            }
            if obs.ENABLED:
                # metrics federation: piggyback a compact registry
                # snapshot — the aggregate() wire shape — on the
                # liveness channel at most every metrics_interval_s;
                # the supervisor folds it into the fleet scrape with a
                # replica= label
                now = time.monotonic()
                if now - self._last_snap_t >= self.metrics_interval_s:
                    self._last_snap_t = now
                    try:
                        obs.count("serve.procfleet.hb_snapshots")
                        hb["metrics"] = obs.metrics_snapshot()
                    except Exception:
                        pass  # a broken provider must not stop
                        # heartbeats — liveness outranks telemetry
            try:
                self.ch.send({"hb": hb})
            except ChannelClosed:
                return

    # -- ops ---------------------------------------------------------------

    def _scope(self):
        from .api import device_scope

        return device_scope(self.grid.device)

    def _op_boot(self, m: dict) -> dict:
        import dataclasses

        from .api import Server, _is_device_error
        from .engine import GraphEngine
        from ..parallel.grid import Grid
        from ..utils import checkpoint

        pr, pc = m["grid"]
        self.grid = Grid.make(int(pr), int(pc), device=m["device"])
        kinds = tuple(m["kinds"]) if m.get("kinds") else None
        cfg = _cfg_from_json(m.get("config"))
        home = bool(m.get("home", False))
        #: durability dir — only the HOME attaches the WAL to it; a
        #: non-home recover boot still READS it (snapshot + suffix)
        wal_dir = m.get("wal_dir")
        tenant = m.get("tenant") or f"proc{os.getpid()}"
        t0 = time.perf_counter()
        with self._scope():
            if m.get("recover"):
                # respawn / recovery boot: latest snapshot + WAL-suffix
                # replay — every acknowledged write, the same lineage
                if home:
                    cfg = dataclasses.replace(cfg, wal_dir=wal_dir)
                    self.srv = Server.from_recovery(
                        self.grid, cfg, kinds=kinds, tenant=tenant
                    )
                else:
                    from ..dynamic import wal as dyn_wal

                    cfg = dataclasses.replace(cfg, wal_dir="off")
                    v = dyn_wal.recover(wal_dir, self.grid, kinds=kinds)
                    eng = GraphEngine(self.grid, version=v, kinds=kinds)
                    self.srv = Server(eng, cfg, tenant=tenant)
            else:
                cfg = dataclasses.replace(
                    cfg,
                    wal_dir=(wal_dir if home and wal_dir is not None
                             else "off"),
                )
                v = checkpoint.load_version(
                    m["ckpt"], self.grid, writable=home
                )
                eng = GraphEngine(self.grid, version=v, kinds=kinds)
                self.srv = Server(eng, cfg, tenant=tenant)
        self.hb_interval_s = float(m["hb_interval_s"])
        self.metrics_interval_s = float(m["metrics_interval_s"])
        self.srv.start()
        t1 = time.perf_counter()
        # warm BEFORE taking traffic: with the shared plan store
        # (COMBBLAS_PLAN_STORE in the inherited env) populated, the
        # remembered lanes replay — the parent asserts zero plan builds
        # after warm-up over IPC (trace_mark/retraces_since)
        try:
            with self._scope():
                warmed = self.srv.warmup()
        except Exception as e:
            if _is_device_error(e):
                # a poisoned context must not join the fleet: the boot
                # fails, and the parent quarantines this child (and
                # backs off before the next respawn)
                raise
            warmed = {"error": repr(e)}
        threading.Thread(
            target=self._hb_loop, name="combblas-proc-hb", daemon=True
        ).start()
        return {
            "pid": os.getpid(),
            "devices": 1,
            "device": str(self.grid.device),
            "device_bytes": int(self.srv.engine.version.device_bytes()),
            "boot_s": {"load": t1 - t0, "warmup": time.perf_counter() - t1},
            "warmed": {f"{k}": w for k, w in warmed.items()},
            "graph_version": self.srv.engine.version_id,
            "durable": self.srv.durable,
        }

    def dispatch(self, m: dict) -> bool:
        """Handle one request; returns False when the loop should
        exit (close)."""
        rid = m.get("id")
        op = m.get("op")
        try:
            if op == "boot":
                self._reply(rid, result=self._op_boot(m))
            elif op == "submit":
                fut = self.srv.submit(
                    m["kind"], m["root"],
                    timeout_s=m.get("timeout_s"),
                    trace_rid=m.get("trace"),
                )
                self._reply_from_future(
                    rid, fut,
                    trace=getattr(fut, "_combblas_trace", None),
                )
            elif op == "submit_update":
                ops = [tuple(o) for o in m["ops"]]
                fut = self.srv.submit_update(ops)
                self._reply_from_future(rid, fut)
            elif op == "spool_version":
                # fan-out source: snapshot the CURRENT version to the
                # spool path (atomic tmp+replace inside save_version);
                # sibling replicas swap from the file, not the wire
                from ..utils import checkpoint

                with self._scope():
                    checkpoint.save_version(
                        m["path"], self.srv.engine.version
                    )
                self._reply(rid, result={
                    "path": m["path"],
                    "version": self.srv.engine.version_id,
                })
            elif op == "swap_from_checkpoint":
                from ..utils import checkpoint

                with self._scope():
                    v = checkpoint.load_version(
                        m["path"], self.grid, writable=False
                    )
                    res = self.srv.swap_graph(v)
                self._reply(rid, result=res)
            elif op == "promote":
                self._reply(rid, result=self._op_promote(m))
            elif op == "trace_mark":
                self._reply(rid, result={
                    "mark": self.srv.engine.trace_mark()
                })
            elif op == "retraces_since":
                self._reply(rid, result={
                    "retraces": self.srv.engine.retraces_since(
                        int(m["mark"])
                    )
                })
            elif op == "close":
                self._hb_stop.set()
                if self.srv is not None:
                    self.srv.close(
                        drain=bool(m.get("drain", True)),
                        timeout=float(m.get("timeout", 30.0)),
                    )
                self._reply(rid, result={"closed": True})
                return False
            else:
                self._reply(rid, exc=ValueError(
                    f"unknown ipc op {op!r}"
                ))
        except Exception as e:
            # a failed op fails ITS request, never the worker: the
            # parent decides whether the error is fatal (quarantine)
            # or per-request (spill/retry)
            self._reply(rid, exc=e)
        return True

    def _op_promote(self, m: dict) -> dict:
        """Dead-home failover, child side: swap to the WAL frontier
        (``recover`` = snapshot + full suffix replay — exactly every
        acknowledged write), re-attach the write lane, re-warm."""
        from ..dynamic import wal as dyn_wal
        from .api import _is_device_error

        wal_dir = m["wal_dir"]
        with self._scope():
            v = dyn_wal.recover(
                wal_dir, self.grid, kinds=self.srv.engine.kinds()
            )
            self.srv.swap_graph(v)
            self.srv.attach_durability(wal_dir)
            try:
                self.srv.warmup()
            except Exception as e:
                if _is_device_error(e):
                    raise  # as in boot: this context cannot be home
                # warm-start is best effort; serving is not
        return {
            "wal_frontier": self.srv._wal_frontier,
            "graph_version": self.srv.engine.version_id,
        }

    def run(self) -> None:
        while not self._stop:
            try:
                m = self.ch.recv(timeout=1.0)
            except socket.timeout:
                continue
            except Exception:
                # ChannelClosed or an undecodable frame: the parent
                # is gone or corrupt — exit (the OS reaps us)
                break
            if "hb" in m:
                continue  # parent never heartbeats today; tolerate
            if not self.dispatch(m):
                break
        self._hb_stop.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fd", type=int, required=True,
                    help="inherited socketpair fd (pass_fds)")
    args = ap.parse_args(argv)
    sock = socket.socket(fileno=args.fd)
    from .ipc import Channel

    worker = ProcWorker(Channel(sock, peer="parent"))
    try:
        worker.run()
    except Exception:
        traceback.print_exc(file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
