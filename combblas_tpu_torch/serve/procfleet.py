"""ProcessFleet — replica servers as real OS subprocesses; counterpart
of ``combblas_tpu/serve/procfleet.py``.

The thread-hosted ``FleetRouter`` is the one-host analog of a replica
fleet: its "crash" is a worker-thread death inside one address space,
and all of its replicas serialize on ONE shared exec lock on one CUDA
context.  This module is the real thing on one machine: each replica is
a subprocess hosting a ``Server`` with its OWN CUDA context
(``serve/_procworker.py``), so

* replica death is PROCESS death (``SIGKILL`` kills a real crash
  domain: heap, device memory, context, locks, threads — nothing to
  clean up, nothing half-poisoned survives),
* a wedged replica (``SIGSTOP``, a runaway GC, a stuck syscall) hangs
  only ITSELF: the router's per-request IPC deadlines fail its
  in-flight futures and the heartbeat timeout routes around it, and
* replicas execute in PARALLEL — N processes, N contexts, no shared
  lock.

What is SHARED is exactly what is process-safe: the plan store
(children inherit ``COMBBLAS_PLAN_STORE`` and warm from it — zero plan
builds after warm-up, asserted over IPC), the WAL + checkpoint
durability dir (the HOME child owns the log; promotion and respawn
recover from the files), and the spool dir graph versions travel
through as ``save_version`` checkpoints (``swap_from_checkpoint`` —
never device memory over a pipe).

Routing, spillover, bounded read retry, and the supervision loop come
from ``serve/policy.py`` — the same policy the thread fleet runs,
with process-level liveness plugged into its hooks: ``Popen.poll()``
and broken-pipe detection catch crashes, heartbeat age catches hangs,
quarantine fails in-flight futures honestly (``ReplicaDeadError``),
replacements respawn warm from checkpoint+WAL, a dead HOME promotes a
survivor at the WAL frontier over IPC, and repeated respawn failures
degrade to capped-backoff retry on the survivors — never a router
crash.  ``serve/faults.py``'s ``ProcessFaultPlan`` scripts real
``SIGKILL``/``SIGSTOP`` chaos deterministically.

Usage::

    fr = ProcessFleet.from_checkpoint(
        "graph.npz", (1, 1), replicas=2, kinds=("bfs", "sssp"),
        wal_dir="dur", workdir="procfleet")
    fr.start_supervisor()                 # heal kills and hangs
    lev = fr.submit("bfs", 7).result()["levels"]
    fr.submit_update([("insert", 3, 9)]).result()   # home + fan-out
    fr.close()

On the card. Children start only as fresh interpreters
(``subprocess.Popen``; never ``fork`` from a process with a CUDA
context), each with its own context on the device the boot message
names; ``CUDA_VISIBLE_DEVICES`` passes through unchanged. The router's
only device work is ``build``'s boot checkpoint: it builds the engine,
saves it, drops it and empties the cache, so the router holds no graph
on the card. Each child's graph and context are outside the router's
``torch.cuda.memory_allocated()``; the card's free bytes
(``torch.cuda.mem_get_info()``) show them, and show them come back
when a child is killed.

Deviations from the reference, kept on purpose:

* ``device=`` (the card by default, ``"cpu"`` where a caller asks)
  takes the place of the reference's ``devices=``, which only sized
  XLA's virtual CPU devices.
* A CUDA error is one child's, not the card's (``policy.py``): a read
  that failed with one is retried on another replica; a child whose
  heartbeat reports ``serving: false`` (its ``Server`` holds a CUDA
  error, or its worker died) is dead to the supervisor, which
  quarantines it (SIGKILL) and respawns the slot with a fresh context.
  The router's own ``device_error`` stays None: it does no device work
  after ``build``.
* "Zero retraces after warm-up" is zero plan builds after warm-up.
* A fan-out with no other serving replica (a promotion whose survivors
  are all dead) spools no file: the reference writes one nobody swaps
  from (4.4 s at scale 20 on the card); respawns recover from the WAL
  directory either way.
* ``submit`` takes no ``read_retry`` argument (the budget is
  ``policy.READ_RETRY``); the IPC deadline, boot deadline and respawn
  backoff are the reference's defaults, as class constants; ``warmup``
  and the context manager, which no caller uses, are left out (the
  children warm up at boot).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from .. import obs
from ..obs.fleetlog import FleetLog
from ..obs.recorder import FlightRecorder
from ..tuner import config as tuner_config
from .batcher import settle
from .faults import ProcessFaultPlan
from .ipc import Channel, ChannelClosed
from .policy import ReplicaDeadError, ReplicaFleetBase, StaleEpochError
from .scheduler import BackpressureError, ServeConfig

#: Router-thread handoff for cross-process trace stitching:
#: ``ProcessFleet.submit`` parks the stitched trace here, the replica
#: handle it routes to picks it up and stamps its rid into the IPC
#: frame.  Thread-local because concurrent submitting threads must not
#: cross their traces; read-retry resubmits (which run on reader
#: threads, where this is empty) are deliberately untraced — the
#: stitched trace covers the FIRST attempt, the retry is visible as
#: the ``read_retry`` counter.
_stitch = threading.local()

__all__ = ["ProcessFleet", "ReplicaProc", "IpcTimeoutError",
           "ReplicaDeadError"]


class IpcTimeoutError(RuntimeError):
    """A replica did not answer an IPC request within its deadline —
    the replica-level failure of a HUNG (not just dead) process.
    Deliberately a ``RuntimeError``, not a ``TimeoutError``: the
    router's read-retry taxonomy re-submits replica-level failures to
    the next-best replica, and a wedged replica's reads should fail
    over, not surface as a caller-deadline lie."""


#: Child-error name -> parent exception class (the retry/spillover
#: taxonomy must survive the wire: BackpressureError spills,
#: ValueError/TimeoutError do NOT read-retry, StaleEpochError replays
#: the sharded batch WITHOUT quarantining the slice, anything else
#: does retry).
_EXC_TYPES = {
    "BackpressureError": BackpressureError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "StaleEpochError": StaleEpochError,
}


def _rebuild_exc(msg: dict) -> Exception:
    etype = msg.get("etype", "RuntimeError")
    text = f"[replica {etype}] {msg.get('error', '')}"
    if etype == "BackpressureError":
        e = BackpressureError(
            0, float(msg.get("retry_after_s") or 0.01)
        )
        e.args = (text,)
        return e
    cls = _EXC_TYPES.get(etype, RuntimeError)
    return cls(text)


class _Rpc:
    __slots__ = ("future", "deadline", "t0", "op", "trace")

    def __init__(self, future, deadline, t0, op, trace=None):
        self.future = future
        self.deadline = deadline
        self.t0 = t0
        self.op = op
        self.trace = trace


class ReplicaProc:
    """Parent-side handle for one replica subprocess: the Popen, the
    framed channel, the reader thread that settles RPC futures and
    tracks heartbeats, and the per-request deadline sweep that turns
    a hung replica into failed futures instead of a wedged router."""

    def __init__(self, idx: int, proc, channel: Channel, *,
                 tenant: str | None = None,
                 max_inflight: int = 256,
                 ipc_timeout_s: float = 60.0):
        self.idx = idx
        self.proc = proc  # Popen-like (poll/pid/send_signal) or None
        self.ch = channel
        self.tenant = tenant or f"proc{idx}"
        self.max_inflight = int(max_inflight)
        self.ipc_timeout_s = float(ipc_timeout_s)
        self._lock = threading.Lock()
        self._pending: dict[int, _Rpc] = {}
        self._next_id = 0
        self.quarantined = False
        self.broken = False
        self.admitted_t = time.monotonic()
        self.last_hb_t: float | None = None
        self.last_hb: dict = {}
        #: the child's boot reply (pid, device, device_bytes, ...)
        self.boot: dict = {}
        self.rpcs = 0
        self.ipc_timeouts = 0
        # federation: the child's last piggybacked registry snapshot
        # (the aggregate() wire shape), folded into the fleet scrape
        # with a replica= label by ProcessFleet.metrics_records()
        self.last_metrics: list | None = None
        self.last_metrics_t: float | None = None
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"combblas-proc-rx{idx}", daemon=True,
        )
        self._reader.start()

    # -- the RPC surface ---------------------------------------------------

    def rpc(self, op: str, payload: dict | None = None,
            timeout_s: float | None = None, trace=None) -> Future:
        """Send one request; the returned future settles from the
        reader thread (reply, error, deadline, or channel death).
        ``trace`` is a router-side stitched RequestTrace: its
        ``route``/``ipc_send`` marks are charged here, and the reader
        thread stitches the child's stage marks into it on reply."""
        fut: Future = Future()
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else self.ipc_timeout_s
        )
        with self._lock:
            if self.quarantined or self.broken:
                raise ReplicaDeadError(
                    f"replica {self.idx} is out of service"
                )
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = _Rpc(
                fut, deadline, time.perf_counter(), op, trace
            )
            self.rpcs += 1
        if trace is not None:
            # everything since submit-entry (fault step, route order,
            # admission checks) is routing time
            trace.mark("route")
        msg = {"id": rid, "op": op}
        if payload:
            msg.update(payload)
        try:
            self.ch.send(msg)
        except ChannelClosed as e:
            with self._lock:
                self._pending.pop(rid, None)
                self.broken = True
            raise ReplicaDeadError(
                f"replica {self.idx} channel broken: {e}"
            ) from e
        if trace is not None:
            trace.mark("ipc_send")
        return fut

    def call(self, op: str, payload: dict | None = None,
             timeout_s: float | None = None):
        """Synchronous RPC (construction / supervision paths)."""
        t = timeout_s if timeout_s is not None else self.ipc_timeout_s
        return self.rpc(op, payload, timeout_s=t).result(timeout=t + 5)

    def submit(self, kind: str, root, timeout_s: float | None = None
               ) -> Future:
        """The router-facing read/query surface.  Admission control is
        LOCAL (in-flight RPC bound mirroring the child's queue bound):
        a synchronous ``BackpressureError`` here is what lets the
        router's spillover loop try the next replica without paying a
        round trip; child-side rejections still arrive as failed
        futures and are not read-retried."""
        with self._lock:
            pending = len(self._pending)
        if pending >= self.max_inflight:
            raise BackpressureError(pending, 0.01, tenant=self.tenant)
        ipc_deadline = (
            (timeout_s + self.ipc_timeout_s)
            if timeout_s is not None else self.ipc_timeout_s
        )
        payload = {"kind": kind, "root": int(root)}
        if timeout_s is not None:
            payload["timeout_s"] = float(timeout_s)
        # stitched-trace handoff (module docstring): stamp the router's
        # rid + sampling decision into the frame header; cleared only
        # AFTER a successful send so a spillover to the next replica
        # keeps tracing the same request
        tr = getattr(_stitch, "trace", None)
        if tr is not None:
            payload["trace"] = tr.rid
        fut = self.rpc("submit", payload, timeout_s=ipc_deadline,
                       trace=tr)
        if tr is not None:
            _stitch.trace = None
        return fut

    # -- liveness ----------------------------------------------------------

    def depth(self) -> int:
        """Routing-time load: in-flight RPCs plus the child's last
        reported queue depth (the heartbeat's view of work the parent
        already handed over)."""
        with self._lock:
            d = len(self._pending)
        return d + int(self.last_hb.get("depth", 0))

    def is_serving(self) -> bool:
        if self.quarantined or self.broken:
            return False
        if self.proc is not None and self.proc.poll() is not None:
            return False  # exited: crash domain collapsed
        # the child's Server stopped serving (a CUDA error on its
        # context, or its worker died): its own report
        return self.last_hb.get("serving", True) is not False

    def heartbeat_age(self) -> float:
        """Seconds since the last heartbeat (or since admission when
        none arrived yet) — the hang detector's clock."""
        base = self.last_hb_t if self.last_hb_t is not None \
            else self.admitted_t
        return max(0.0, time.monotonic() - base)

    # -- reader / sweeper --------------------------------------------------

    def _read_loop(self) -> None:
        while True:
            try:
                m = self.ch.recv(timeout=0.1)
            except socket.timeout:
                self._sweep_deadlines()
                continue
            except Exception as e:
                # ChannelClosed — or a frame that would not decode (a
                # corrupted peer IS a broken peer): either way the
                # replica is out, its futures fail honestly, and the
                # reader must never die unhandled
                with self._lock:
                    self.broken = True
                self.fail_pending(ReplicaDeadError(
                    f"replica {self.idx} channel closed (process "
                    f"died, was killed, or sent garbage: "
                    f"{type(e).__name__})"
                ))
                return
            if "hb" in m:
                hb = m["hb"]
                snap = hb.pop("metrics", None)
                if snap is not None:
                    self.last_metrics = snap
                    self.last_metrics_t = time.monotonic()
                self.last_hb = hb
                self.last_hb_t = time.monotonic()
                continue
            with self._lock:
                rpc = self._pending.pop(m.get("id"), None)
            if rpc is None:
                continue  # deadline-failed earlier; late reply dropped
            obs.observe(
                "serve.procfleet.rpc_latency_s",
                time.perf_counter() - rpc.t0, op=rpc.op,
            )
            if rpc.trace is not None:
                # stitch + commit BEFORE the future settles: a caller
                # woken by result() must find its trace already in the
                # log (the attach-before-poppable precedent)
                self._stitch_reply(rpc.trace, m)
            if m.get("ok"):
                settle(rpc.future, result=m.get("result"))
            else:
                settle(rpc.future, exc=_rebuild_exc(m))
            self._sweep_deadlines()

    def _stitch_reply(self, trace, m: dict) -> None:
        """Fold the child's shipped stage marks into the router-side
        trace as ONE stitched record: ``route`` + ``ipc_send`` (marked
        at send), then the window since ``ipc_send`` split into
        ``ipc_wait`` (router-observed wait not accounted by the child)
        + the child's own queue_wait/assemble/execute/scatter marks,
        closed by ``ipc_recv`` — so ``sum(stages) == wall_s`` holds
        across two processes.  The two clocks never compare absolute
        values: the child contributes DURATIONS, scaled down if its
        reported total somehow exceeds the router-observed window
        (clock skew must not break the telescoping invariant)."""
        now = time.perf_counter()
        cw = max(now - trace._last, 0.0)
        child = m.get("trace")
        stages = (child or {}).get("stages") or []
        dt = sum(max(float(s["s"]), 0.0) for s in stages)
        scale = 1.0 if dt <= cw or dt <= 0.0 else cw / dt
        trace.stages.append(["ipc_wait", max(cw - dt * scale, 0.0)])
        for s in stages:
            trace.stages.append(
                [str(s["stage"]), max(float(s["s"]), 0.0) * scale]
            )
        trace._last = now
        trace.annotate(replica=self.idx)
        trace.finish(
            status="ok" if m.get("ok") else "error", stage="ipc_recv"
        )

    def _sweep_deadlines(self) -> None:
        now = time.monotonic()
        expired = []
        with self._lock:
            for rid, rpc in list(self._pending.items()):
                if now >= rpc.deadline:
                    expired.append(rpc)
                    del self._pending[rid]
        for rpc in expired:
            self.ipc_timeouts += 1
            obs.count("serve.procfleet.ipc_timeouts", op=rpc.op)
            obs.count("serve.ipc.deadline_missed", replica=self.idx)
            if rpc.trace is not None:
                rpc.trace.annotate(replica=self.idx)
                rpc.trace.finish(status="timeout", stage="ipc_wait")
            settle(rpc.future, exc=IpcTimeoutError(
                f"replica {self.idx} did not answer {rpc.op!r} "
                f"within its IPC deadline (hung or overloaded)"
            ))

    def fail_pending(self, exc: Exception) -> int:
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for rpc in pending:
            if rpc.trace is not None:
                rpc.trace.annotate(replica=self.idx)
                rpc.trace.finish(status="error", stage="ipc_wait")
            settle(rpc.future, exc=exc)
        return len(pending)

    # -- lifecycle ---------------------------------------------------------

    def signal(self, sig: int) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(sig)

    def quarantine(self, exc: Exception) -> int:
        """Take a dead/hung replica out of service: refuse new RPCs,
        fail every in-flight future honestly, SIGKILL the process
        (works on a SIGSTOPped one too — a wedged crash domain is
        collapsed, not negotiated with) and close the channel."""
        with self._lock:
            if self.quarantined:
                return 0
            self.quarantined = True
        n = self.fail_pending(exc)
        try:
            self.signal(signal.SIGKILL)
        except OSError:
            pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self.ch.close()
        obs.count("serve.procfleet.quarantined", replica=self.idx)
        return n

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful shutdown: ask the child to drain and exit; fall
        back to SIGKILL when it cannot answer."""
        try:
            self.call("close", {"drain": drain, "timeout": timeout},
                      timeout_s=timeout)
        except Exception:
            pass  # dead/hung child: collapse it below
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(Exception):
                    self.signal(signal.SIGKILL)
                    self.proc.wait(timeout=10)
        self.ch.close()
        self.fail_pending(RuntimeError(
            f"replica {self.idx} closed"
        ))


class ProcessFleet(ReplicaFleetBase):
    """Front door over N subprocess replicas (module docstring)."""

    _OBS = "serve.procfleet"

    #: Per-request IPC deadline (reads add their own timeout on top),
    #: the boot / promotion deadline, and the respawn backoff: the
    #: first retry after a failed respawn, doubling up to the cap.
    IPC_TIMEOUT_S = 60.0
    BOOT_TIMEOUT_S = 300.0
    RESPAWN_BACKOFF_S = 0.5
    RESPAWN_BACKOFF_MAX_S = 30.0

    def __init__(self, *, grid_shape, kinds, config: ServeConfig,
                 wal_dir: str, workdir: str, boot_ckpt: str,
                 device="cuda",
                 hb_interval_s: float = 0.25,
                 hb_timeout_s: float = 5.0,
                 metrics_interval_s: float | None = None):
        self.grid_shape = tuple(grid_shape)
        self.kinds = tuple(kinds) if kinds else None
        self.config = config
        self.wal_dir = os.path.abspath(wal_dir)
        self.workdir = os.path.abspath(workdir)
        self.spool_dir = os.path.join(self.workdir, "spool")
        os.makedirs(self.spool_dir, exist_ok=True)
        self.boot_ckpt = boot_ckpt
        #: the device every child builds its grid on
        self.device = str(torch.device(device))
        self.hb_interval_s = float(hb_interval_s)
        self.hb_timeout_s = float(hb_timeout_s)
        self.home = 0
        #: Deterministic process-level chaos (SIGKILL/SIGSTOP rules),
        #: polled once per routed submit.
        self.proc_faults = ProcessFaultPlan()
        self.sigkills = 0
        self.sigstops = 0
        self.respawn_failures = 0
        self._respawn_backoff: dict[int, float] = {}
        self._respawn_next: dict[int, float] = {}
        self._fan_lock = threading.Lock()
        # fan-out runs OFF the reader threads: a merge reply callback
        # that blocked on further RPCs to the same replica would
        # deadlock its own reader
        self._fan_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="combblas-procfan"
        )
        self._closing = False
        self.replicas: list[ReplicaProc] = []
        # -- the fleet observability plane ----------------------------------
        #: heartbeat-snapshot cadence the children piggyback registry
        #: snapshots at (knob: COMBBLAS_OBS_HB_METRICS_S)
        self.metrics_interval_s = tuner_config.obs_hb_metrics_interval(
            metrics_interval_s
        )
        #: supervision timeline — constructed EAGERLY (event() from
        #: supervisor/reader threads must never race a lazy init); the
        #: file itself appears only on the first event, and events are
        #: only emitted when obs is enabled (_fleet_event's gate)
        self.fleetlog = FleetLog(
            tuner_config.fleetlog_path()
            or os.path.join(self.workdir, "fleetlog.jsonl"),
            tenant="procfleet",
        )
        #: post-mortem ring, dumped on every quarantine/promotion
        self.recorder = FlightRecorder(
            out_dir=os.path.join(self.workdir, "flightrec"),
            tenant="procfleet",
        )
        #: stitched-trace rid source: crosses the IPC boundary in the
        #: frame header, so child and router halves correlate
        self._trace_rid = itertools.count(1)
        self._scrape = None  # serve_metrics() parity with Server

    # -- construction ------------------------------------------------------

    @staticmethod
    def build(grid_shape, rows, cols, nrows: int, *,
              replicas: int = 2, kinds=("bfs",),
              config: ServeConfig | None = None,
              wal_dir: str, workdir: str | None = None,
              device="cuda", from_coo_kw: dict | None = None,
              **fleet_kw) -> "ProcessFleet":
        """Build the boot checkpoint from one COO on the PARENT's
        device (the only device work the router ever does: the engine
        is dropped and the cache emptied once the file is written),
        then spawn ``replicas`` children from it.  ``wal_dir`` is
        required: a process fleet's whole point is that replicas die
        for real, and respawn/promotion recover from checkpoint+WAL."""
        from .api import device_scope
        from .engine import GraphEngine
        from ..parallel.grid import Grid
        from ..utils import checkpoint

        if wal_dir is None:
            raise ValueError(
                "ProcessFleet requires a durability dir (wal_dir=): "
                "process replicas die for real, and respawn/promotion "
                "recover from checkpoint+WAL"
            )
        workdir = workdir or os.path.join(
            os.path.abspath(wal_dir), os.pardir, "procfleet"
        )
        os.makedirs(workdir, exist_ok=True)
        grid = Grid.make(*grid_shape, device=device)
        boot_ckpt = os.path.join(workdir, "boot.npz")
        with device_scope(grid.device):
            eng = GraphEngine.from_coo(
                grid, rows, cols, nrows, kinds=kinds, keep_coo=True,
                **(from_coo_kw or {}),
            )
            checkpoint.save_version(boot_ckpt, eng.version)
        del eng
        if grid.device.type == "cuda":
            torch.cuda.empty_cache()
        fleet = ProcessFleet(
            grid_shape=grid_shape, kinds=kinds,
            config=config or ServeConfig(),
            wal_dir=wal_dir, workdir=workdir, boot_ckpt=boot_ckpt,
            device=device, **fleet_kw,
        )
        fleet._boot_all(replicas)
        return fleet

    @staticmethod
    def from_checkpoint(path: str, grid_shape, *,
                        replicas: int = 2, kinds=("bfs",),
                        config: ServeConfig | None = None,
                        wal_dir: str, workdir: str | None = None,
                        **fleet_kw) -> "ProcessFleet":
        """Spawn the fleet from a pre-staged ``save_version``
        checkpoint — the parent never builds a graph at all (the
        tier-1 test path, and the production ship-a-snapshot path)."""
        if wal_dir is None:
            raise ValueError("ProcessFleet requires wal_dir=")
        workdir = workdir or os.path.join(
            os.path.abspath(wal_dir), os.pardir, "procfleet"
        )
        os.makedirs(workdir, exist_ok=True)
        fleet = ProcessFleet(
            grid_shape=grid_shape, kinds=kinds,
            config=config or ServeConfig(),
            wal_dir=wal_dir, workdir=workdir, boot_ckpt=path,
            **fleet_kw,
        )
        fleet._boot_all(replicas)
        return fleet

    def _boot_all(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"a process fleet needs a replica; got {n}")
        try:
            # launch every child FIRST, then collect the boot replies:
            # the expensive parts (torch import, context creation,
            # checkpoint load, warmup) run concurrently across the
            # replicas instead of paying N serial boots
            self.replicas = [self._launch(i) for i in range(n)]
            futs = [
                rp.rpc(
                    "boot",
                    self._boot_msg(i, recover=False,
                                   home=(i == self.home)),
                    timeout_s=self.BOOT_TIMEOUT_S,
                )
                for i, rp in enumerate(self.replicas)
            ]
            for rp, f in zip(self.replicas, futs):
                boot = f.result(timeout=self.BOOT_TIMEOUT_S + 5)
                self._admit_boot(rp, boot)
        except Exception:
            # a failed boot must not leak the siblings already spawned
            for rp in self.replicas:
                rp.quarantine(ReplicaDeadError("fleet boot failed"))
            self._fan_pool.shutdown(wait=False)
            raise
        self._init_policy()
        obs.gauge("serve.procfleet.replicas", len(self.replicas))

    def _child_env(self) -> dict:
        import combblas_tpu_torch

        env = dict(os.environ)
        # the child must import THIS package wherever the parent found
        # it — a parent that path-hacked sys.path (or runs from another
        # cwd) would otherwise spawn children that die on import
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(combblas_tpu_torch.__file__)
        ))
        pp = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (
            pkg_root if not pp else pkg_root + os.pathsep + pp
        )
        # hermetic durability: only the boot message's wal_dir attaches
        # a log, never ambient env
        env[tuner_config.ENV_WAL] = "0"
        # the child's telemetry arms with the ROUTER's current state,
        # not whatever the operator's shell had: a fleet whose parent
        # enabled obs at runtime still federates
        env["COMBBLAS_OBS"] = "1" if obs.ENABLED else "0"
        return env

    def _launch(self, i: int) -> ReplicaProc:
        """Start one replica child (socketpair + Popen of a fresh
        interpreter) — cheap; the expensive initialization happens when
        its ``boot`` RPC runs."""
        parent_sock, child_sock = socket.socketpair()
        log = open(
            os.path.join(self.workdir, f"replica{i}.log"), "ab"
        )
        try:
            proc = subprocess.Popen(
                [
                    sys.executable, "-m",
                    "combblas_tpu_torch.serve._procworker",
                    "--fd", str(child_sock.fileno()),
                ],
                pass_fds=(child_sock.fileno(),),
                env=self._child_env(),
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True,  # chaos signals hit the
                # replica, never the router's process group
            )
        finally:
            log.close()
            child_sock.close()
        self._fleet_event("spawn", replica=i, pid=proc.pid)
        return ReplicaProc(
            i, proc, Channel(parent_sock, peer=f"replica{i}"),
            tenant=f"proc{i}",
            max_inflight=self.config.max_queue,
            ipc_timeout_s=self.IPC_TIMEOUT_S,
        )

    def _boot_msg(self, i: int, recover: bool, home: bool) -> dict:
        return {
            "grid": list(self.grid_shape),
            "device": self.device,
            "ckpt": self.boot_ckpt,
            "kinds": list(self.kinds) if self.kinds else None,
            "config": dataclasses.asdict(self.config),
            "home": home,
            "wal_dir": self.wal_dir,
            "recover": recover,
            "tenant": f"proc{i}",
            "hb_interval_s": self.hb_interval_s,
            "metrics_interval_s": self.metrics_interval_s,
        }

    @staticmethod
    def _admit_boot(rp: ReplicaProc, boot: dict) -> None:
        rp.boot = dict(boot)
        rp.last_hb = {"depth": 0, "serving": True,
                      "pid": boot.get("pid")}
        rp.last_hb_t = time.monotonic()

    def _spawn(self, i: int, recover: bool, home: bool) -> ReplicaProc:
        """Start + synchronously boot one replica (the respawn path —
        load checkpoint / recover, start server, warm from the shared
        plan store): the replica is serving when this returns."""
        rp = self._launch(i)
        try:
            boot = rp.call(
                "boot", self._boot_msg(i, recover, home),
                timeout_s=self.BOOT_TIMEOUT_S,
            )
        except Exception:
            rp.quarantine(ReplicaDeadError(
                f"replica {i} failed to boot"
            ))
            raise
        self._admit_boot(rp, boot)
        return rp

    # -- read path: the shared policy + scripted process chaos -------------

    def submit(self, kind: str, root, timeout_s: float | None = None,
               trace=None):
        for signame, rep in self.proc_faults.step():
            self._apply_fault(signame, rep)
        # cross-process trace stitching: one deterministic sampling
        # decision at the FRONT DOOR (obs.request_trace gates on
        # ENABLED + sample rate), handed to the routed replica via
        # thread-local; the child traces unconditionally under this
        # rid, so both halves of the stitched record correlate.
        # When the NET frontend already opened (and holds) a trace at
        # the socket, adopt it — the sampler rolled once at the
        # outermost door, and the child's marks stitch into the same
        # record that carries net_accept/net_read/net_write.
        tr = (
            trace if trace is not None
            else obs.request_trace(next(self._trace_rid), kind=kind)
        )
        if tr is None:
            return super().submit(kind, root, timeout_s=timeout_s)
        tr.annotate(fleet="process")
        _stitch.trace = tr
        try:
            return super().submit(kind, root, timeout_s=timeout_s)
        except Exception:
            if getattr(_stitch, "trace", None) is not None:
                # every replica refused: the request never left the
                # router — the trace is pure routing time
                tr.finish(status="rejected", stage="route")
            raise
        finally:
            _stitch.trace = None

    def _apply_fault(self, signame: str, rep) -> None:
        i = self.home if rep == "home" else int(rep)
        if not (0 <= i < len(self.replicas)):
            return
        sig = {
            "SIGKILL": signal.SIGKILL,
            "SIGSTOP": signal.SIGSTOP,
            "SIGCONT": signal.SIGCONT,
        }[signame]
        try:
            self.replicas[i].signal(sig)
        except OSError:
            return
        if sig == signal.SIGKILL:
            self.sigkills += 1
            obs.count("serve.procfleet.sigkills", replica=i)
            self._fleet_event("sigkill", replica=i)
        elif sig == signal.SIGSTOP:
            self.sigstops += 1
            obs.count("serve.procfleet.sigstops", replica=i)
            self._fleet_event("sigstop", replica=i)

    # -- write path --------------------------------------------------------

    def submit_update(self, ops):
        """Route a mutation batch to the HOME child (WAL-before-ack
        unchanged — the child's ``submit_update`` appends before the
        reply exists); once its merge lands, fan the new version out
        as a spooled checkpoint.  The future resolves with the merge
        payload plus ``fanned_out``/``lagging``, exactly the thread
        fleet's contract."""
        home = self.replicas[self.home]
        inner = home.rpc(
            "submit_update", {"ops": [list(o) for o in ops]},
            timeout_s=self.IPC_TIMEOUT_S,
        )
        outer: Future = Future()

        def _after_merge(f):
            exc = f.exception()
            if exc is not None:
                settle(outer, exc=exc)
                return
            payload = dict(f.result())

            def _settle_unfanned():
                # a close-drain write: the merge is durable and
                # applied on the home, and the fleet is coming down —
                # settle honestly with no fan-out rather than strand
                # the future against a shut-down executor
                payload["fanned_out"] = 0
                payload["lagging"] = self.lagging()
                settle(outer, result=payload)

            def _fan():
                try:
                    payload["fanned_out"] = self.fan_out()
                    payload["lagging"] = self.lagging()
                except Exception as e:
                    settle(outer, exc=e)
                    return
                settle(outer, result=payload)

            if self._closing:
                _settle_unfanned()
                return
            try:
                # off the reader thread: fan-out blocks on further RPCs
                self._fan_pool.submit(_fan)
            except RuntimeError:
                # close() shut the pool between the check above and
                # here: same drain race, same honest settle
                _settle_unfanned()

        inner.add_done_callback(_after_merge)
        return outer

    def fan_out(self) -> int:
        """Propagate the home's CURRENT version: the home spools one
        ``save_version`` checkpoint and every other serving replica
        swaps from the FILE — version payloads never ride the socket.
        Per-replica failures lag visibly (``versions_behind``,
        degraded health) and are retried next fan-out."""
        with self._fan_lock:
            self._fan_gen += 1
            gen = self._fan_gen
            t0 = time.perf_counter()
            path = os.path.join(self.spool_dir, f"fan-{gen:08d}.npz")
            if any(
                i != self.home and i not in self._draining
                and rp.is_serving()
                for i, rp in enumerate(self.replicas)
            ):
                # a spool only where a serving replica will swap from
                # it (module docstring)
                self.replicas[self.home].call(
                    "spool_version", {"path": path},
                    timeout_s=self.IPC_TIMEOUT_S,
                )
            n = 0
            for i, rp in enumerate(self.replicas):
                if i == self.home:
                    self._replica_gen[i] = gen
                    continue
                if i in self._draining or not rp.is_serving():
                    continue
                prev = self._replica_gen[i]
                try:
                    rp.call("swap_from_checkpoint", {"path": path},
                            timeout_s=self.IPC_TIMEOUT_S)
                    self._replica_gen[i] = gen
                    n += 1
                    if prev < gen - 1:
                        # a replica that had fallen MORE than one
                        # generation behind just caught up
                        self._fleet_event(
                            "fanout_heal", replica=i, gen=gen, was=prev
                        )
                except Exception:
                    obs.count("serve.procfleet.fanout_failed",
                              replica=i)
                    self._fleet_event("fanout_lag", replica=i, gen=gen)
            self.fanouts += 1
            obs.count("serve.procfleet.fanout")
            obs.observe("serve.procfleet.fanout_s",
                        time.perf_counter() - t0)
            for i in range(len(self.replicas)):
                obs.gauge(
                    "serve.procfleet.versions_behind",
                    gen - self._replica_gen[i], replica=i,
                )
            # spool retention: the current fan file plus its
            # predecessor (a replica mid-swap may still be reading it)
            keep = {f"fan-{g:08d}.npz" for g in (gen, gen - 1)}
            for nm in os.listdir(self.spool_dir):
                if nm.startswith("fan-") and nm not in keep:
                    with contextlib.suppress(OSError):
                        os.unlink(os.path.join(self.spool_dir, nm))
            return n

    # -- supervision hooks (policy.py drives these) ------------------------

    def _depth(self, i: int) -> int:
        return self.replicas[i].depth()

    def _dead(self, i: int) -> bool:
        """Process-level death: exited (``poll()``), broken pipe, a
        child whose ``Server`` reports it stopped serving (a CUDA error
        on its own context, or a dead worker: module docstring), or —
        the hang case a thread fleet cannot have — a live process
        whose heartbeats stopped (``SIGSTOP``, wedged runtime) past
        ``hb_timeout_s``."""
        rp = self.replicas[i]
        if rp.quarantined:
            return False  # already out; _needs_rebuild drives the heal
        if rp.proc is not None and rp.proc.poll() is not None:
            return True
        if rp.broken or rp.last_hb.get("serving", True) is False:
            return True
        return rp.heartbeat_age() > self.hb_timeout_s

    def _replace_allowed(self, i: int) -> bool:
        return time.monotonic() >= self._respawn_next.get(i, 0.0)

    def _replace_failed(self, i: int) -> None:
        """Capped-backoff respawn retry: the fleet keeps serving
        degraded on the survivors; the slot is re-attempted at the
        backed-off deadline, never in a hot loop, and the router
        never crashes."""
        self.respawn_failures += 1
        b = self._respawn_backoff.get(i, self.RESPAWN_BACKOFF_S)
        self._respawn_next[i] = time.monotonic() + b
        self._respawn_backoff[i] = min(2 * b, self.RESPAWN_BACKOFF_MAX_S)
        obs.count("serve.procfleet.respawn_failed", replica=i)

    def _replace_ok(self, i: int) -> None:
        self._respawn_backoff.pop(i, None)
        self._respawn_next.pop(i, None)

    # -- the fleet observability plane -------------------------------------

    def _observe_fleet(self) -> None:
        """Supervisor-tick gauges: heartbeat age per replica is the
        hang detector's number, and a scrape must see it WITHOUT
        anyone calling ``health()`` (the autoscaler's sensors read
        /metrics, not the stats RPC)."""
        if not obs.ENABLED:
            return
        obs.gauge("serve.procfleet.replicas", len(self.replicas))
        for i, rp in enumerate(self.replicas):
            obs.gauge("serve.procfleet.heartbeat_age_s",
                      rp.heartbeat_age(), replica=i)

    def _fleet_event(self, name: str, **fields) -> None:
        """Append one supervision event to the fleetlog + the flight
        recorder ring; quarantine/promotion additionally dump the ring
        so the post-mortem snapshot sits next to the timeline entry.
        Gated on obs.ENABLED (the zero-cost contract: disabled obs
        leaves no fleetlog file and no recorder traffic)."""
        if not obs.ENABLED:
            return
        if name == "replica_dead":
            i = fields.get("replica")
            rp = self.replicas[i] if i is not None else None
            if rp is not None:
                # enrich with the CAUSE the supervisor saw, so the
                # timeline distinguishes a SIGKILL'd corpse from a
                # SIGSTOP'd zombie post-mortem
                code = rp.proc.poll() if rp.proc is not None else None
                if code is not None:
                    fields["cause"] = "exited"
                    fields["exit_code"] = code
                elif rp.broken:
                    fields["cause"] = "channel_broken"
                elif rp.quarantined:
                    fields["cause"] = "rebuild_pending"
                elif rp.last_hb.get("serving", True) is False:
                    fields["cause"] = "not_serving"
                    fields["device_error"] = rp.last_hb.get(
                        "device_error"
                    )
                else:
                    fields["cause"] = "heartbeat_miss"
                    fields["heartbeat_age_s"] = round(
                        rp.heartbeat_age(), 4
                    )
        self.fleetlog.event(name, **fields)
        self.recorder.record(f"fleet.{name}", **fields)
        if name in ("quarantine", "promotion"):
            self.recorder.dump(reason=name, force=True)

    def metrics_records(self) -> list[dict]:
        """The federated fleet registry view the ``/metrics`` scrape
        renders: the router's own snapshot plus every replica's last
        heartbeat-piggybacked child snapshot, relabeled ``replica=i``
        — one scrape sees the whole fleet."""
        recs = list(obs.metrics_snapshot())
        for i, rp in enumerate(self.replicas):
            for r in rp.last_metrics or ():
                r2 = dict(r)
                labels = dict(r2.get("labels") or {})
                labels["replica"] = i
                r2["labels"] = labels
                recs.append(r2)
        return recs

    def serve_metrics(self, port: int = 0,
                      host: str = "127.0.0.1") -> int:
        """Start the fleet-wide Prometheus scrape surface
        (``/metrics`` + ``/healthz`` + ``/statz``) — the one scrape
        covering router AND child-process series (via
        ``metrics_records``).  ``port=0`` binds an ephemeral port; the
        bound port is returned.  Stopped by ``close()``."""
        from ..obs import export

        return export.attach_scrape(self, port=port, host=host)

    def promote(self) -> int:
        """Dead-home failover over IPC: quarantine the dead home
        (in-flight futures fail honestly; acknowledged writes are in
        the WAL), then one ``promote`` RPC brings the least-loaded
        serving survivor to the WAL frontier (recover + swap +
        ``attach_durability`` + re-warm, all inside ITS process) — same
        single-lineage guarantee as the thread fleet, held by the same
        files."""
        with self._sup_lock:
            old = self.home
            self.replicas[old].quarantine(ReplicaDeadError(
                f"home replica {old} died; promoting at the WAL "
                "frontier (acknowledged writes are durable and "
                "replayed there)"
            ))
            self._fleet_event(
                "quarantine", replica=old, reason="dead_home"
            )
            cands = [
                i for i in self._route_order()
                if i != old and self.replicas[i].is_serving()
            ]
            if not cands:
                raise RuntimeError(
                    "no serving replica available to promote"
                )
            new_home = cands[0]
            try:
                self.replicas[new_home].call(
                    "promote", {"wal_dir": self.wal_dir},
                    timeout_s=self.BOOT_TIMEOUT_S,
                )
            except Exception as e:
                # the survivor's state is UNKNOWN — a lost/late reply
                # may mean it ALREADY attached the WAL.  Two processes
                # must never own one log (their checkpoint truncations
                # would orphan each other's fds and lose acknowledged
                # writes), so collapse the candidate too: quarantine's
                # SIGKILL releases any attach, and the replace loop
                # rebuilds both slots from the durable files.
                self.replicas[new_home].quarantine(ReplicaDeadError(
                    f"replica {new_home} promotion state unknown "
                    f"({type(e).__name__}); collapsed to preserve "
                    "single WAL ownership"
                ))
                self._needs_rebuild.add(new_home)
                self._fleet_event(
                    "quarantine", replica=new_home,
                    reason="promote_unknown",
                )
                raise RuntimeError(
                    f"promotion of replica {new_home} failed: {e}"
                ) from e
            self.home = new_home
            self._replica_gen[new_home] = self._fan_gen
            self.promotions += 1
            obs.count("serve.procfleet.promotions")
            self._fleet_event(
                "promotion", old_home=old, new_home=new_home
            )
            # surviving replicas may be missing acknowledged writes
            # the dead home never fanned out: propagate the recovered
            # frontier now (best-effort; failures lag visibly)
            try:
                self.fan_out()
            except Exception:
                obs.count(self._OBS + ".supervisor",
                          action="fanout_error")
            return new_home

    def _replace_replica(self, i: int) -> None:
        """Respawn a dead slot warm from checkpoint+WAL: quarantine
        (SIGKILL — also the answer to a SIGSTOPped zombie and to a
        child whose context holds a CUDA error), then a fresh
        subprocess boots via recovery and warms from the shared plan
        store before re-admission."""
        old = self.replicas[i]
        if not old.quarantined:
            old.quarantine(ReplicaDeadError(
                f"replica {i} process died; the fleet supervisor is "
                "respawning a replacement"
            ))
            self._fleet_event("quarantine", replica=i, reason="respawn")
        rp = self._spawn(i, recover=True, home=(i == self.home))
        self.replicas[i] = rp
        self._replica_gen[i] = self._fan_gen
        self._needs_rebuild.discard(i)
        self.replacements += 1
        obs.count("serve.procfleet.respawns", replica=i)
        self._fleet_event(
            "respawn", replica=i,
            pid=(rp.proc.pid if rp.proc is not None else None),
            home=(i == self.home),
        )

    # -- lifecycle / introspection -----------------------------------------

    def trace_marks(self) -> dict:
        """Per-replica engine trace marks over IPC — the zero-retrace
        assertion's first half (``retraces_since`` is the second)."""
        return {
            i: rp.call("trace_mark")["mark"]
            for i, rp in enumerate(self.replicas) if rp.is_serving()
        }

    def retraces_since(self, marks: dict) -> int:
        return sum(
            self.replicas[i].call(
                "retraces_since", {"mark": m}
            )["retraces"]
            for i, m in marks.items()
            if self.replicas[i].is_serving()
        )

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        # flag BEFORE the pool shutdown: a write merging during the
        # home's close-drain settles un-fanned instead of racing a
        # shut-down executor (its future must never strand)
        self._closing = True
        if self._scrape is not None:
            from ..obs import export

            export.detach_scrape(self)
        self.stop_supervisor(timeout)
        self._fan_pool.shutdown(wait=True)
        order = [
            i for i in range(len(self.replicas)) if i != self.home
        ] + [self.home]
        for i in order:
            self.replicas[i].close(drain=drain, timeout=timeout)

    def stats(self) -> dict:
        return {
            "replicas": len(self.replicas),
            "home": self.home,
            "device": self.device,
            "routed": list(self.submitted),
            "spillovers": self.spillovers,
            "fanouts": self.fanouts,
            "lagging": self.lagging(),
            "promotions": self.promotions,
            "replacements": self.replacements,
            "respawn_failures": self.respawn_failures,
            "read_retries": self.read_retries,
            "sigkills": self.sigkills,
            "sigstops": self.sigstops,
            "draining": sorted(self._draining),
            "supervisor_alive": self._supervisor_alive(),
            "wal_dir": self.wal_dir,
            "fleetlog": self.fleetlog.describe(),
            "flightrec": self.recorder.describe(),
            "per_replica": {
                i: {
                    "pid": (rp.proc.pid if rp.proc is not None
                            else None),
                    "alive": rp.is_serving(),
                    "quarantined": rp.quarantined,
                    "rpcs": rp.rpcs,
                    "ipc_timeouts": rp.ipc_timeouts,
                    "heartbeat_age_s": round(rp.heartbeat_age(), 4),
                    "device_bytes": rp.boot.get("device_bytes"),
                    "last_hb": dict(rp.last_hb),
                }
                for i, rp in enumerate(self.replicas)
            },
        }

    def health(self) -> dict:
        """Pollable fleet health: per-replica status derived from
        process liveness + heartbeat freshness (``heartbeat_age_s``
        is the hang detector's number, gauged per replica), folded
        with the shared policy's ok/degraded/down rule."""
        per = {}
        for i, rp in enumerate(self.replicas):
            age = rp.heartbeat_age()
            obs.gauge("serve.procfleet.heartbeat_age_s", age,
                      replica=i)
            if not rp.is_serving():
                status = "down"
            elif age > self.hb_timeout_s:
                status = "down"  # alive but silent: wedged
            elif rp.last_hb.get("worker_errors", 0) > 0:
                status = "degraded"
            else:
                status = "ok"
            per[i] = {
                "status": status,
                "heartbeat_age_s": round(age, 4),
                "pid": rp.proc.pid if rp.proc is not None else None,
                "depth": rp.depth(),
                "graph_version": rp.last_hb.get("graph_version"),
                "wal_frontier": rp.last_hb.get("wal_frontier"),
                "device_error": rp.last_hb.get("device_error"),
                "ipc_timeouts": rp.ipc_timeouts,
            }
        statuses = {h["status"] for h in per.values()}
        lagging = self.lagging()
        err = self.device_error()
        return {
            "status": self._fold_status(statuses, lagging),
            "device_error": repr(err) if err is not None else None,
            "replicas": per,
            "home": self.home,
            "lagging": lagging,
            "draining": sorted(self._draining),
            "supervisor_alive": self._supervisor_alive(),
            "durable": True,
        }
