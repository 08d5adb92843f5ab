"""Server — the worker loop tying engine + scheduler + batcher together;
counterpart of ``combblas_tpu/serve/api.py``.

``submit()`` returns a ``concurrent.futures.Future`` immediately; a
single background worker thread owns ALL device execution (one
execution stream, like one card), waking on submissions and flush
deadlines, popping ready batches, padding them into lane buckets, and
scattering lane results back to futures. ``submit_many`` is the bulk
front door; ``stats()`` surfaces queue depth, batch occupancy, plan
cache and trace counts without needing obs enabled.

The worker path is the resilience ladder (docs/serving.md
"Resilience"): expired requests are dropped before they occupy a lane,
a failed batch is bisected and retried under a bounded per-request
budget (one poison request fails alone, lane-mates survive),
top-level batch outcomes feed per-kind circuit breakers, the loop
backs off exponentially on scheduler-level errors, and
``swap_graph()`` atomically replaces the served graph version under
load with the plan cache surviving. ``health()`` is the pollable
liveness surface; ``Server.faults`` the deterministic fault-injection
hook every recovery path is tested through.

Usage::

    engine = GraphEngine.from_coo(grid, rows, cols, n)
    with engine.serve(ServeConfig(lane_widths=(1, 4, 16))) as srv:
        srv.warmup()                      # build every lane bucket's plan
        f = srv.submit("bfs", root=7)
        print(f.result()["levels"][:10])

On the card. The worker, the mutation thread and the checkpointer run
with the grid's card as their current CUDA device (torch keeps it per
thread), so nothing they create lands on another card; all three use
the default stream. ``engine.execute`` returns host numpy, so a batch's
readback is its only synchronisation and an asynchronous kernel error
surfaces inside the batch that caused it.

Deviations from the reference, kept on purpose:

* "Zero retraces after warm-up" is zero plan builds after warm-up: the
  engine compiles nothing (``serve/engine.py``).
* A CUDA error (an illegal address, a device-side assert) poisons the
  card's context, not one request. The worker does not bisect it: it
  fails the batch's futures with it, keeps it as ``device_error``, and
  ``health()`` reports ``"down"`` from then on. One met by the mutation
  thread fails its merge's futures, one met by the checkpointer fails
  that snapshot, and both are kept as ``device_error`` the same way.
  Nothing carries on on the CPU.
* An engine whose device work runs in other processes
  (``ShardedEngine`` in process mode, ``shares_context`` False) reports
  a child's CUDA error as text; the ``Server`` over it treats that as a
  failed batch (or merge, or snapshot), never as a loss of its own
  context. The worker threads of a ``Server`` over an engine without a
  grid (the sharded router) run on the device the engine names.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future

import torch

from .. import obs
from ..obs.recorder import FlightRecorder
from . import batcher
from .faults import FaultInjector, InjectedFault
from .scheduler import BackpressureError, Scheduler, ServeConfig, _bump
from .slo import ErrorBudget


def device_scope(device):
    """A context in which ``device`` is the current CUDA device (torch
    keeps the current device per thread, and a new thread starts on
    device 0); a no-op for a CPU device. Every thread of ``serve/`` that
    launches kernels or uploads tensors runs its work in one, naming
    the grid's card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _engine_device(engine):
    """The device an engine's work runs on: its grid's, or, for the
    sharded router (no grid), the one it names (``ShardedEngine.device``:
    the slices' card in local mode, the CPU in process mode)."""
    grid = getattr(engine, "grid", None)
    return grid.device if grid is not None else engine.device


def _is_device_error(exc: BaseException) -> bool:
    """True for a CUDA error, which poisons the card's context (every
    later call on it fails too), as against a failure of one batch."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and (
        "CUDA error" in msg or "device-side assert" in msg
    )


class Server:
    """In-process query server over one ``GraphEngine``."""

    def __init__(self, engine, config: ServeConfig | None = None,
                 tenant: str | None = None):
        self.engine = engine
        self.config = config or ServeConfig()
        #: Owning tenant (round 14, the multi-tenant pool): named in
        #: backpressure errors, threaded through the scheduler's and
        #: breakers' obs labels, and surfaced by stats()/health().
        #: ``None`` (single-tenant) keeps every label set unchanged.
        self.tenant = tenant
        self.scheduler = Scheduler(
            self.config, engine.nrows, engine.kinds(), tenant=tenant
        )
        # deterministic fault injection (serve/faults.py): unarmed by
        # default (one attribute read per check); chaos tests and the
        # chaos bench arm rules on this instance
        self.faults = FaultInjector()
        # -- production observability (round 15). The flight recorder
        # is ALWAYS ON by default (one ring append per batch, next to a
        # device launch; config.flight_recorder=False = one attribute
        # read); the SLO error budget exists only when a deadline SLO
        # is configured.  The scheduler shares the budget so rejection
        # and queue-sweep dispositions land in the same window.
        self._recorder = (
            FlightRecorder(
                capacity=self.config.flight_recorder_events,
                out_dir=self.config.flight_recorder_dir,
                min_interval_s=(
                    self.config.flight_recorder_min_interval_s
                ),
                tenant=tenant,
            )
            if self.config.flight_recorder else None
        )
        self.slo = (
            ErrorBudget(
                self.config.slo_target, self.config.slo_window_s,
                tenant=tenant,
            )
            if self.config.slo_deadline_s is not None else None
        )
        self.scheduler.slo = self.slo
        # scheduler-side bad records (rejections, queue sweeps) can be
        # the ones that burn through the budget — the breach dump must
        # fire no matter which side the crossing lands on
        self.scheduler.slo_breach = (
            lambda kind: self._flight_dump("slo_breach", query=kind)
        )
        self._scrape = None  # obs.export.ScrapeServer (serve_metrics)
        self._wake = threading.Condition()
        self._stop = False
        self._worker: threading.Thread | None = None
        self.batches = 0  # TOP-LEVEL batches (retries counted apart)
        self.retry_batches = 0  # bisection-recovery sub-batches
        self.completed = 0
        self.worker_errors = 0
        self.last_worker_error: Exception | None = None
        self.last_worker_error_at: float | None = None  # time.time()
        #: the CUDA error that poisoned the card's context, if one did:
        #: health() reports "down" from then on
        self.device_error: Exception | None = None
        self._backoff_s = self.config.worker_backoff_s
        self._occupancy_sum = 0.0
        # per-kind execution-side disposition counters (queue-side
        # twins live on the scheduler); bumped only by the executing
        # thread, read by stats()
        self._timeout_exec: dict[str, int] = {}
        self._poisoned: dict[str, int] = {}
        self._retried: dict[str, int] = {}
        # -- write lane (docs/dynamic.md): the delta buffer, its
        # dedicated mutation thread, and the futures awaiting a merge.
        # _merge_mutex serializes whole merge cycles (drain -> apply ->
        # swap) so a pump_updates() call can never interleave with the
        # mutator and apply a batch against a stale parent version.
        self._upd_cond = threading.Condition()
        self._upd_buffer = None  # lazy dynamic.DeltaBuffer
        # (last_seq, Future, RequestTrace | None) per admitted batch
        self._upd_futs: deque = deque()
        self._upd_stop = False
        self._mutator: threading.Thread | None = None
        self._merge_mutex = threading.Lock()
        self.updates_submitted = 0
        self.update_merges = 0
        self.update_failures = 0
        self.updates_invalid = 0
        self._merge_modes: dict[str, int] = {}
        self._merge_s: dict[str, float] = {}
        # -- durability (round 16; docs/serving.md "Durability &
        # self-healing"): the write-ahead log every acknowledged
        # submit_update appends to BEFORE its future exists, and the
        # background checkpointer that snapshots the served version
        # (atomic tmp+rename, off the exec lock) and truncates the
        # replayed WAL prefix.  ``_wal is None`` (the default — no
        # ServeConfig.wal_dir / COMBBLAS_WAL) keeps every hot path at
        # one attribute read.
        self._wal = None
        self._wal_frontier = -1  # highest seq APPENDED (acknowledged)
        self._wal_applied = -1   # highest seq MERGED into the served
        #                          version (external hot-swap versions
        #                          are stamped here: pending appended
        #                          ops merge on top of them later)
        self._ckpt_dir: str | None = None
        self._ckpt_cond = threading.Condition()
        self._ckpt_lock = threading.Lock()  # one snapshot at a time
        self._ckpt_thread: threading.Thread | None = None
        self._ckpt_stop = False
        self._merges_since_ckpt = 0
        self.checkpoints = 0
        self.checkpoint_failures = 0
        self._attach_durability()

    # -- lifecycle ---------------------------------------------------------

    def _on_device(self, fn) -> None:
        """Run a thread's loop with the grid's card as its current CUDA
        device (``device_scope``)."""
        with device_scope(_engine_device(self.engine)):
            fn()

    def _own_device_error(self, exc: BaseException) -> bool:
        """A CUDA error on this process's context. An engine whose
        device work runs in child processes (``shares_context`` False)
        reports a child's error, which is that child's, not ours."""
        return getattr(self.engine, "shares_context", True) and (
            _is_device_error(exc)
        )

    def warmup(self, kinds=None, widths=None) -> dict:
        """Warm every (kind, lane width) plan the configured buckets can
        produce — after this, steady-state serving builds no plan."""
        return self.engine.warmup(
            kinds=kinds,
            widths=tuple(widths or self.config.lane_widths),
        )

    def start(self) -> "Server":
        if self.scheduler.closed:
            # close() is final (admissions are refused forever); a
            # restarted worker could never receive work
            raise RuntimeError(
                "serve.Server is closed; build a new one via "
                "engine.serve()"
            )
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._worker = threading.Thread(
                target=self._on_device, args=(self._loop,),
                name="combblas-serve", daemon=True,
            )
            self._worker.start()
        self._start_checkpointer()
        return self

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Close the front door (subsequent submits raise — a closed
        server must never strand a future) and stop the worker;
        ``drain=True`` executes everything still queued first (in the
        CALLER's thread, after the worker has joined — so it also
        drains a server whose worker was never started), else pending
        requests fail with a shutdown error."""
        self.scheduler.close()  # admissions refused from here on
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                # the engine has ONE execution thread; draining from
                # this thread while the worker still runs would race
                # it — surface the stuck worker instead
                raise TimeoutError(
                    f"serve worker did not stop within {timeout}s; "
                    "queue not drained (call close() again later)"
                )
            self._worker = None
        if drain:
            while self.scheduler.depth():
                self.pump(force=True)
        else:
            self.scheduler.fail_pending(
                RuntimeError("serve.Server closed without drain")
            )
        # the write lane stops LAST: its final merges may swap the
        # graph, and the read drain above must run on one consistent
        # execution stream either way (the engine lock serializes)
        self._stop_mutator(drain, timeout)
        # durability teardown (round 16): stop the checkpointer, take
        # one final snapshot when merges landed since the last (a
        # clean close leaves recovery with zero WAL to replay), and
        # release the log handle
        self._stop_checkpointer(timeout)
        if drain and self._ckpt_dir is not None:
            with self._ckpt_cond:
                dirty = self._merges_since_ckpt > 0
            if dirty:
                self.checkpoint_now(reason="close")
        if self._wal is not None:
            self._wal.close()
        if self._scrape is not None:
            from ..obs import export

            export.detach_scrape(self)

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"
                      ) -> int:
        """Attach the live scrape surface (round 15): a stdlib-HTTP
        daemon thread serving ``/metrics`` (Prometheus text rendered
        from the obs registry), ``/healthz`` and ``/statz`` for this
        server.  ``port=0`` binds an ephemeral port; the bound port is
        returned.  Stopped by ``close()``."""
        from ..obs import export

        return export.attach_scrape(self, port=port, host=host)

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- front door --------------------------------------------------------

    def submit(self, kind: str, root, timeout_s: float | None = None,
               trace_rid: int | str | None = None, trace=None) -> Future:
        """Admit one single-root query. Raises ``BackpressureError``
        when the bounded queue is full (reject + retry-after, never
        unbounded blocking); malformed roots come back as failed
        futures (error isolation — see scheduler.submit).
        ``trace_rid`` adopts an upstream trace-sampling decision
        (process-fleet stitching); ``trace`` adopts a live trace
        object (net-frontend stitching) — see scheduler.submit."""
        self.faults.check("scheduler.admit", kind=kind, root=root)
        fut = self.scheduler.submit(
            kind, root, timeout_s=timeout_s, trace_rid=trace_rid,
            trace=trace,
        )
        with self._wake:
            self._wake.notify_all()
        return fut

    def submit_many(self, kind: str, roots, timeout_s: float | None = None
                    ) -> list[Future]:
        """Bulk submit; stops at the first backpressure rejection and
        fails the REMAINING requests' futures with it (the caller sees
        exactly which prefix was admitted — one future per root, in
        order, generators included)."""
        roots = list(roots)  # single materialization: generator-safe
        out: list[Future] = []
        for i, r in enumerate(roots):
            try:
                self.faults.check("scheduler.admit", kind=kind, root=r)
                out.append(
                    self.scheduler.submit(kind, r, timeout_s=timeout_s)
                )
            except (BackpressureError, RuntimeError) as e:
                # backpressure, breaker fast-fail, a concurrent
                # close(), or an injected admission fault: either way
                # the caller must still get one future per root — the
                # admitted prefix's results stay reachable
                for _ in roots[i:]:
                    f = Future()
                    f.set_exception(e)
                    out.append(f)
                break
        with self._wake:
            self._wake.notify_all()
        return out

    # -- write lane (the mutation lane; docs/dynamic.md) -------------------

    def _make_update_buffer(self):
        from ..dynamic import DeltaBuffer

        return DeltaBuffer(
            capacity=self.config.update_buffer,
            nrows=self.engine.nrows,
            ncols=int(self.engine.version.ncols),
            retry_after_s=self.config.update_max_delay_s,
            # a durable server continues the WAL's seqno lineage —
            # replay dedup and snapshot stamps need ONE monotone
            # sequence line across process lives (round 16; the
            # frontier also covers non-durable merges made before an
            # attach_durability)
            start_seq=(
                self._wal_frontier + 1
                if (self._wal is not None
                    or getattr(self.engine, "owns_durability", False))
                else 0
            ),
        )

    # -- durability: WAL + background checkpointer (round 16) --------------

    def attach_durability(self, dirpath: str) -> None:
        """Attach the WAL + checkpointer to a RUNNING server built
        without durability; the log starts at the seqno frontier.
        Idempotent for the same dir; a different dir raises (one log,
        one lineage)."""
        import os

        # the WHOLE attach runs under the write-admission lock: a
        # submit_update racing the attach would otherwise re-create
        # the buffer at seq 0 and acknowledge a write with no WAL
        # record in the window between the depth check and the log
        # opening (TOCTOU)
        with self._upd_cond:
            if self._wal is not None:
                if self._ckpt_dir == os.path.abspath(dirpath):
                    return
                raise RuntimeError(
                    f"server already durable at {self._ckpt_dir!r}; "
                    f"refusing to switch to {dirpath!r}"
                )
            if (
                self._upd_buffer is not None
                and self._upd_buffer.depth()
            ) or self._upd_futs:
                # pre-attach buffered ops (and drained batches whose
                # merge is still in flight — _merge_once runs outside
                # this lock) carry non-lineage seqs: they would
                # collide with the WAL's frontier numbering
                raise RuntimeError(
                    "cannot attach durability with un-merged buffered "
                    "writes pending; drain them first"
                )
            self._upd_buffer = None  # recreate at the WAL frontier
            self._attach_durability(dirpath)
        if self._worker is not None and self._worker.is_alive():
            self._start_checkpointer()

    def _attach_durability(self, d: str | None = None) -> None:
        """Attach the write-ahead log + checkpoint directory when
        configured (``ServeConfig.wal_dir`` > ``COMBBLAS_WAL`` > off).
        A server that was NOT booted from recovery writes a bootstrap
        snapshot at the current WAL frontier — recovery is always
        "latest snapshot + WAL suffix", so a base snapshot must exist
        before the first write is acknowledged."""
        import os

        from ..tuner import config as tuner_config

        if d is None:
            d = tuner_config.wal_dir(self.config.wal_dir)
        else:
            d = os.path.abspath(d)  # idempotence compares abspaths
        if getattr(self.engine, "owns_durability", False):
            # engine-owned durability (the sharded engine): writes are
            # logged PER-SLICE inside the engine's own two-phase
            # protocol — a server-level scalar WAL stacked on top would
            # double-log every write on a second lineage and re-apply
            # it at recovery.  The seqno frontier still seeds from the
            # engine's (vector-min) stamp so the delta buffer continues
            # the shared sequence line.
            if d is not None:
                raise ValueError(
                    f"wal_dir {d!r} configured, but the engine owns "
                    "its own durability (per-slice WALs); remove "
                    "wal_dir / COMBBLAS_WAL for sharded serving"
                )
            self._wal_frontier = int(self.engine.version.wal_seq)
            self._wal_applied = self._wal_frontier
            return
        if d is None:
            return
        if self.engine.version.host_coo is None:
            raise ValueError(
                "durability (wal_dir) needs the host edge list: build "
                "the engine with GraphEngine.from_coo(keep_coo=True) "
                "or boot via Server.from_recovery"
            )
        from ..dynamic import wal as dyn_wal
        from ..utils import checkpoint as ckpt

        os.makedirs(d, exist_ok=True)
        v = self.engine.version
        wal = dyn_wal.open_wal(d, fsync=self.config.wal_fsync)
        if getattr(v, "recovered_from", None) is None:
            # boot-from-COO: the bootstrap snapshot below would
            # truncate the WAL at the new frontier — REFUSE if that
            # would destroy acknowledged writes no snapshot holds
            # ("no acknowledged write is lost" is the whole contract)
            snaps = ckpt.list_snapshots(d)
            covered = ckpt.snapshot_seq(snaps[-1]) if snaps else -1
            unreplayed = wal.replay(after_seq=covered)
            if unreplayed:
                wal.close()
                raise RuntimeError(
                    f"durability dir {d!r} holds "
                    f"{sum(len(b) for b in unreplayed)} acknowledged "
                    "write op(s) no snapshot covers; booting from a "
                    "fresh COO here would silently destroy them — "
                    "recover them (Server.from_recovery / "
                    "FleetRouter.from_recovery) or point wal_dir at "
                    "a fresh directory"
                )
        self._ckpt_dir = d
        self._wal = wal
        # the seqno frontier is the max over BOTH the log's position
        # and the version's own stamp: a server that merged writes
        # non-durably before attach_durability() must not restart
        # sequence numbers below its snapshot stamp (later snapshots
        # would sort before the bootstrap one and recovery would skip
        # every post-attach record)
        self._wal_frontier = max(self._wal.position(), int(v.wal_seq))
        if v.wal_seq < self._wal_frontier:
            # boot over an exhausted (fully snapshotted/replayed) log:
            # this version DEFINES a fresh lineage at the frontier
            v.wal_seq = self._wal_frontier
        self._wal_applied = v.wal_seq
        snaps = ckpt.list_snapshots(d)
        covered = ckpt.snapshot_seq(snaps[-1]) if snaps else None
        if covered is None or covered < v.wal_seq or (
            getattr(v, "recovered_from", None) is None
        ):
            # the attached state must be recoverable NOW as "snapshot
            # + suffix": fresh-COO boots always snapshot (they define
            # the lineage), and a recovered version snapshots exactly
            # when its replayed suffix outruns the newest snapshot
            # (compacting the WAL as a side effect).  A bootstrap
            # failure raises: durability was promised.
            self.checkpoint_now(reason="bootstrap", _raise=True)

    @property
    def durable(self) -> bool:
        return self._wal is not None or getattr(
            self.engine, "owns_durability", False
        )

    def checkpoint_now(self, reason: str = "manual",
                       _raise: bool = False) -> dict | None:
        """Snapshot the CURRENT served version (atomic tmp+rename,
        off the execution lock — versions are immutable, so reading
        one concurrently with serving is safe), truncate the WAL
        prefix the snapshot now covers, and prune snapshots beyond the
        retention depth.  Returns ``{"path", "wal_seq", "reason"}`` or
        ``None`` (disabled / failed — a failed auto-checkpoint leaves
        the previous snapshot and the un-truncated WAL intact and
        retries on the next trigger)."""
        import os

        if self._ckpt_dir is None:
            if getattr(self.engine, "owns_durability", False):
                # delegate: the sharded engine snapshots every slice
                # at its own frontier and re-writes the manifest
                try:
                    return self.engine.checkpoint_now(reason=reason)
                except Exception as e:
                    self.checkpoint_failures += 1
                    if self._own_device_error(e):
                        self._device_lost(e)
                    if _raise:
                        raise
                    return None
            return None
        from ..tuner import config as tuner_config
        from ..utils import checkpoint as ckpt

        v = self.engine.version
        with self._ckpt_lock:
            try:
                self.faults.check(
                    "checkpoint.save", seq=v.wal_seq, reason=reason
                )
                path = os.path.join(
                    self._ckpt_dir, ckpt.snapshot_name(v.wal_seq)
                )
                ckpt.save_version(path, v)
                with self._ckpt_cond:
                    self._merges_since_ckpt = 0
                self.checkpoints += 1
                obs.count("serve.checkpoint.auto", reason=reason)
                retain = tuner_config.checkpoint_retain(
                    self.config.checkpoint_retain
                )
                for old in ckpt.list_snapshots(self._ckpt_dir)[:-retain]:
                    try:
                        os.unlink(old)
                    except OSError:
                        pass  # racing pruner / readonly: retried next
                if self._wal is not None:
                    # truncate only through the OLDEST retained
                    # snapshot: the corrupt-newest fallback
                    # (checkpoint_retain's whole purpose) needs the
                    # WAL to still cover the predecessor→newest gap,
                    # or falling back would silently lose that span
                    snaps = ckpt.list_snapshots(self._ckpt_dir)
                    self._wal.truncate(
                        ckpt.snapshot_seq(snaps[0]) if snaps
                        else v.wal_seq
                    )
                return {
                    "path": path, "wal_seq": int(v.wal_seq),
                    "reason": reason,
                }
            except Exception as e:
                self.checkpoint_failures += 1
                obs.count(
                    "serve.checkpoint.failed",
                    exc_type=type(e).__name__,
                )
                if self._own_device_error(e):
                    self._device_lost(e)
                else:
                    self._flight_dump("checkpoint_failed", error=repr(e))
                if _raise:
                    raise
                return None

    def _ckpt_note_merge(self) -> None:
        if self._ckpt_dir is None:
            return
        with self._ckpt_cond:
            self._merges_since_ckpt += 1
            self._ckpt_cond.notify_all()

    def _start_checkpointer(self) -> None:
        if self._ckpt_dir is None:
            return
        if self._ckpt_thread is None or not self._ckpt_thread.is_alive():
            self._ckpt_stop = False
            self._ckpt_thread = threading.Thread(
                target=self._on_device, args=(self._ckpt_loop,),
                name="combblas-serve-ckpt", daemon=True,
            )
            self._ckpt_thread.start()

    def _ckpt_loop(self) -> None:
        from ..tuner import config as tuner_config

        every = tuner_config.checkpoint_every(
            self.config.checkpoint_every
        )
        interval = self.config.checkpoint_interval_s
        last_t = time.monotonic()
        backoff = self.config.worker_backoff_s
        while True:
            with self._ckpt_cond:
                while not self._ckpt_stop:
                    now = time.monotonic()
                    if self._merges_since_ckpt >= every or (
                        interval is not None
                        and self._merges_since_ckpt > 0
                        and now - last_t >= interval
                    ):
                        break
                    if interval is None or self._merges_since_ckpt == 0:
                        # nothing to snapshot until a merge lands —
                        # block until _ckpt_note_merge (or stop)
                        # notifies, never poll an idle server
                        self._ckpt_cond.wait()
                    else:
                        self._ckpt_cond.wait(
                            max(0.005, interval - (now - last_t))
                        )
                if self._ckpt_stop:
                    break  # the final snapshot is close()'s call
            ok = self.checkpoint_now(reason="auto") is not None
            last_t = time.monotonic()
            if ok:
                backoff = self.config.worker_backoff_s
            else:
                # a failed snapshot leaves _merges_since_ckpt set, so
                # the wait loop would re-trigger IMMEDIATELY: back off
                # (capped exponential, stop-notify still wakes us)
                # instead of re-serializing the version in a tight
                # loop against a broken disk
                with self._ckpt_cond:
                    if not self._ckpt_stop:
                        self._ckpt_cond.wait(backoff)
                backoff = min(2 * backoff,
                              self.config.worker_backoff_max_s)

    def _stop_checkpointer(self, timeout: float) -> None:
        if self._ckpt_thread is None:
            return
        with self._ckpt_cond:
            self._ckpt_stop = True
            self._ckpt_cond.notify_all()
        self._ckpt_thread.join(timeout)
        if self._ckpt_thread.is_alive():
            raise TimeoutError(
                f"serve checkpointer did not stop within {timeout}s"
            )
        self._ckpt_thread = None

    @staticmethod
    def from_recovery(grid, config: ServeConfig | None = None, *,
                      kinds=None, tenant: str | None = None,
                      combine: str | None = None) -> "Server":
        """Boot a server from crash recovery: latest valid snapshot in
        the durability dir + WAL-suffix replay
        (``dynamic.wal.recover_version`` — bit-exact with the engine
        that crashed, acknowledged writes included), with the WAL
        re-attached at the seqno frontier so the write lane resumes
        the same lineage.  The version lands on ``grid``'s device: the
        card unless the grid was made on the CPU.  Run ``warmup()``
        before serving — with the shared plan store populated it
        replays the remembered lanes: zero plan builds after it, zero
        re-measurement."""
        from ..dynamic import wal as dyn_wal
        from ..tuner import config as tuner_config
        from .engine import GraphEngine

        cfg = config or ServeConfig()
        d = tuner_config.wal_dir(cfg.wal_dir)
        if d is None:
            raise ValueError(
                "from_recovery needs a durability dir "
                "(ServeConfig.wal_dir or COMBBLAS_WAL)"
            )
        # the Server attaches its own log handle afterwards
        version = dyn_wal.recover(
            d, grid, kinds=kinds, combine=combine, fsync=cfg.wal_fsync
        )
        engine = GraphEngine(grid, version=version, kinds=kinds)
        return Server(engine, cfg, tenant=tenant)

    def submit_update(self, ops) -> Future:
        """Admit a batch of edge mutations — ``ops`` is a sequence of
        ``("insert" | "delete" | "upsert", row, col[, weight])`` tuples
        admitted ATOMICALLY into the bounded delta buffer.  Returns a
        Future that resolves (``{"version", "nnz", "mode", "ops",
        "merge_s"}``) once the merge CONTAINING these ops has been
        applied and atomically swapped in; reads submitted after that
        point see the mutated graph.

        Mirrors the read lane's contracts: a full buffer raises
        ``BackpressureError`` (reject + retry-after, never unbounded
        buffering), malformed ops come back as failed futures (error
        isolation — lane-mates in the same call are rejected with
        them, since admission is atomic), and a closed server raises.
        Writes COALESCE: the merge runs off the execution lock on the
        mutation thread while reads keep executing; only the version
        swap itself takes the lock."""
        from ..dynamic import DeltaOverflowError

        if self.scheduler.closed:
            raise RuntimeError(
                "serve.Server is closed; no further admissions"
            )
        if not getattr(
            self.engine, "supports_updates",
            self.engine.version.host_coo is not None,
        ):
            raise ValueError(
                "the mutation lane needs the host edge list: build "
                "the engine with GraphEngine.from_coo(keep_coo=True)"
            )
        ops = list(ops)
        self.faults.check("update.submit", nops=len(ops))
        fut: Future = Future()
        with self._upd_cond:
            if self.scheduler.closed or self._upd_stop:
                # RE-checked under the lock: a close racing the
                # unlocked check above has already failed/cleared
                # _upd_futs — admitting here would append a future
                # nothing will ever settle
                raise RuntimeError(
                    "serve.Server is closed; no further admissions"
                )
            if self._upd_buffer is None:
                self._upd_buffer = self._make_update_buffer()
            try:
                last = self._upd_buffer.add_many(ops)
            except DeltaOverflowError as e:
                raise BackpressureError(
                    self._upd_buffer.depth(), e.retry_after_s,
                    tenant=self.tenant,
                ) from e
            except ValueError as e:
                # malformed op: fail THIS future, poison nothing
                self.updates_invalid += 1
                obs.count("serve.update.invalid")
                fut.set_exception(e)
                return fut
            if self._wal is not None:
                # durability: the record hits disk BEFORE the caller
                # holds a future — "acknowledged" and "durable" are
                # the same event.  A failed append REJECTS the write
                # (tail rollback un-admits the ops; nothing else
                # could touch the buffer: every mutator holds
                # _upd_cond): the caller retries, and a write that
                # was never acknowledged was never promised.
                from ..dynamic.delta import _OP_CODE

                first = last - len(ops) + 1
                try:
                    self.faults.check("wal.append", nops=len(ops))
                    self._wal.append(
                        first,
                        [o[1] for o in ops],
                        [o[2] for o in ops],
                        [o[3] if len(o) > 3 else 1.0 for o in ops],
                        [_OP_CODE[o[0]] for o in ops],
                    )
                    self._wal_frontier = last
                except Exception as e:
                    self._upd_buffer.rollback(first)
                    obs.count("serve.wal.append_failed")
                    try:
                        # the line may have reached disk before the
                        # failure (fsync raised): tombstone the range
                        # so a crash cannot resurrect a write this
                        # caller is being told FAILED.  Positional —
                        # a later retry reusing the seqs is
                        # untouched.  Best-effort: if even this write
                        # fails, recovery may conservatively re-apply
                        # the range.
                        self._wal.append_drop(first, last)
                    except Exception:
                        pass
                    self._flight_dump("wal_append_failed",
                                      error=repr(e))
                    raise RuntimeError(
                        f"write NOT acknowledged: WAL append failed "
                        f"({e!r}); retry"
                    ) from e
            # write-lane trace (round 15): buffer wait -> merge ->
            # [fanout ->] swap -> settle; rid keyed by the batch's last
            # sequence number, so sampling is deterministic per op set
            tr = obs.update_trace(f"upd-{last}", tenant=self.tenant)
            if tr is not None:
                # the fleet's fan-out callback marks its stage through
                # this handle (it only ever sees the future)
                fut._combblas_trace = tr
            self._upd_futs.append((last, fut, tr))
            self.updates_submitted += 1
            obs.count("serve.update.submitted")
            if self.config.update_autostart:
                self._ensure_mutator()
            self._upd_cond.notify_all()
        return fut

    def _ensure_mutator(self) -> None:
        # called under _upd_cond
        if self._mutator is None or not self._mutator.is_alive():
            self._upd_stop = False
            self._mutator = threading.Thread(
                target=self._on_device, args=(self._mutate_loop,),
                name="combblas-serve-mutate", daemon=True,
            )
            self._mutator.start()

    def _updates_due(self, now: float) -> bool:
        b = self._upd_buffer
        if b is None:
            return False
        d = b.depth()
        if d == 0:
            return False
        if d >= self.config.update_flush:
            return True
        age = b.oldest_age(now)
        return age is not None and age >= self.config.update_max_delay_s

    def pump_updates(self, force: bool = False) -> int:
        """One synchronous write-lane step (the mutation thread's body,
        callable directly for deterministic tests / worker-less
        embedding): merge + swap the pending delta batch if one is due
        (or unconditionally under ``force``).  Returns ops merged."""
        if not force and not self._updates_due(time.monotonic()):
            return 0
        return self._merge_once()

    def _merge_once(self) -> int:
        """Drain -> apply_delta -> swap -> settle one batch's futures.
        Serialized on ``_merge_mutex`` so concurrent callers can never
        apply a batch against a stale parent version (which would
        silently drop the other batch's mutations)."""
        with self._merge_mutex:
            with self._upd_cond:
                b = self._upd_buffer
                batch = b.drain() if b is not None else None
                futs = []
                if batch is not None:
                    while (
                        self._upd_futs
                        and self._upd_futs[0][0] <= batch.last_seq
                    ):
                        _seq, f, tr = self._upd_futs.popleft()
                        futs.append((f, tr))
            if batch is None:
                return 0
            traces = [tr for _f, tr in futs if tr is not None]
            t_drain = time.perf_counter()
            for tr in traces:
                tr.mark("buffer_wait", now=t_drain)
            rec = self._recorder
            try:
                self.faults.check("update.merge", nops=len(batch))
                version = self.engine.apply_delta(batch)
                # the version now contains every op through this seq:
                # snapshot meta stamps it, recovery replays past it
                version.wal_seq = batch.last_seq
                t_merge = time.perf_counter()
                for tr in traces:
                    tr.mark("merge", now=t_merge)
                res = self.swap_graph(version)
                self._wal_applied = batch.last_seq
                t_swap = time.perf_counter()
                st = version.dyn.last_stats
                for tr in traces:
                    tr.mark("swap", now=t_swap)
                    tr.annotate(
                        mode=st.mode, ops=len(batch),
                        version=res["version"],
                    )
                self.update_merges += 1
                self._merge_modes[st.mode] = (
                    self._merge_modes.get(st.mode, 0) + 1
                )
                self._merge_s[st.mode] = (
                    self._merge_s.get(st.mode, 0.0) + st.latency_s
                )
                obs.count("serve.update.merges", mode=st.mode)
                obs.observe("serve.update.coalesced", len(batch))
                if rec is not None:
                    rec.record(
                        "serve.merge", ops=len(batch), mode=st.mode,
                        outcome="ok", version=res["version"],
                        merge_s=round(t_merge - t_drain, 6),
                        swap_s=round(t_swap - t_merge, 6),
                    )
                payload = {
                    "version": res["version"],
                    "nnz": res["nnz"],
                    "mode": st.mode,
                    "ops": len(batch),
                    "merge_s": st.latency_s,
                }
                # settle BEFORE finishing the traces: done-callbacks
                # run synchronously inside settle, and the fleet's
                # fan-out callback marks its stage through the trace
                # handle stashed on the future — finishing afterwards
                # lets that mark land inside the committed record
                for f, _tr in futs:
                    batcher.settle(f, result=payload)
                for tr in traces:
                    tr.finish(status="ok", stage="settle")
                self._ckpt_note_merge()  # checkpoint trigger (rnd 16)
            except Exception as e:  # failure touches THIS batch only:
                # the old version keeps serving, later merges proceed
                self.update_failures += 1
                obs.count(
                    "serve.update.failed", exc_type=type(e).__name__
                )
                if self._wal is not None:
                    # the live lineage REJECTED these ops (their
                    # futures fail below): tombstone the range so a
                    # crash-recovery replay cannot resurrect writes
                    # the callers were told failed.  Best-effort — if
                    # even the tombstone cannot be written, recovery
                    # may re-apply the range (the conservative side).
                    try:
                        self._wal.append_drop(
                            batch.first_seq, batch.last_seq
                        )
                        self._wal_applied = batch.last_seq
                    except Exception:
                        obs.count("serve.wal.append_failed")
                if rec is not None:
                    rec.record(
                        "serve.merge", ops=len(batch),
                        outcome="error", error=repr(e),
                    )
                if self._own_device_error(e):
                    self._device_lost(e)
                else:
                    self._flight_dump(
                        "merge_failed", ops=len(batch), error=repr(e)
                    )
                for f, _tr in futs:
                    batcher.settle(f, exc=e)
                for tr in traces:
                    tr.finish(status="error", stage="settle")
            return len(batch)

    def _mutate_loop(self) -> None:
        while True:
            with self._upd_cond:
                while not self._upd_stop and not self._updates_due(
                    time.monotonic()
                ):
                    b = self._upd_buffer
                    age = b.oldest_age() if b is not None else None
                    self._upd_cond.wait(
                        None if age is None else max(
                            0.001,
                            self.config.update_max_delay_s - age,
                        )
                    )
                if self._upd_stop and (
                    self._upd_buffer is None
                    or self._upd_buffer.depth() == 0
                ):
                    break
            # stopping with pending ops falls through: the final
            # merge(s) run before the thread exits (close() drains)
            self._merge_once()

    def _stop_mutator(self, drain: bool, timeout: float,
                      abort_exc: Exception | None = None) -> None:
        futs: list = []
        with self._upd_cond:
            self._upd_stop = True
            if not drain:
                # abort BEFORE waking the mutator: its stop path merges
                # whatever is still buffered, and a no-drain close must
                # abandon those writes (matching the read lane), not
                # apply-and-swap them behind the caller's back.  An
                # IN-FLIGHT merge already popped its futures, so what
                # remains here maps exactly to the drained-away ops.
                b = self._upd_buffer
                if b is not None:
                    b.drain()
                futs = [(f, t) for _s, f, t in self._upd_futs]
                self._upd_futs.clear()
            self._upd_cond.notify_all()
        if not drain:
            exc = abort_exc if abort_exc is not None else RuntimeError(
                "serve.Server closed without drain"
            )
            for f, tr in futs:
                batcher.settle(f, exc=exc)
                if tr is not None:  # abandoned writes still close
                    # their sampled trace (status tells the story)
                    tr.finish(status="aborted", stage="settle")
        if self._mutator is not None:
            self._mutator.join(timeout)
            if self._mutator.is_alive():
                raise TimeoutError(
                    f"serve mutation thread did not stop within "
                    f"{timeout}s"
                )
            self._mutator = None
        # a never-started mutator (update_autostart=False) may still
        # hold pending ops on a draining close: merge them here
        if drain and (
            self._upd_buffer is not None and self._upd_buffer.depth()
        ):
            while self._merge_once():
                pass

    # -- worker ------------------------------------------------------------

    def _flight_dump(self, reason: str, **extra):
        """Snapshot the flight-recorder ring (no-op when disabled;
        rate-limited inside the recorder)."""
        rec = self._recorder
        if rec is None:
            return None
        return rec.dump(reason, **extra)

    def _slo_bad(self, kind: str) -> None:
        """One bad SLO disposition; a budget-burn crossing dumps the
        flight recorder (the post-mortem is cheapest NOW, while the
        ring still holds the window that burned the budget)."""
        if self.slo is not None and self.slo.record(False, kind=kind):
            self._flight_dump("slo_breach", query=kind)

    def _slo_ok(self, req) -> None:
        if self.slo is not None:
            self.slo.record(True, kind=req.kind)

    def _on_exec_timeout(self, req) -> None:
        _bump(self._timeout_exec, req.kind)
        self._slo_bad(req.kind)

    def _on_lane_error(self, req) -> None:
        self._slo_bad(req.kind)

    def _drop_dead(self, reqs, now: float | None = None) -> list:
        """Deadline enforcement at EXECUTION time: a request that is
        already settled (client cancel) or already past its deadline is
        dropped here, before it occupies a device lane — the queue
        sweep in ``pop_ready`` catches most, but a request can expire
        between pop and execute (or during a failing batch's bisection
        retries). Returns the live remainder."""
        now = time.monotonic() if now is None else now
        live = []
        for r in reqs:
            if r.future.done():
                continue
            if r.expired(now):
                batcher.expire(
                    r, "expired before execution", self._on_exec_timeout
                )
            else:
                live.append(r)
        return live

    def _run_batch(self, reqs, *, toplevel: bool = True) -> None:
        """Execute one batch with the full recovery ladder: drop dead
        requests, run, and on failure hand the survivors to the
        bisection retrier. Top-level outcomes (not bisection
        sub-batches) feed the kind's circuit breaker, so one poisoned
        request cannot open it.

        Observability (round 15): sampled requests' traces MARK each
        stage transition here (queue wait / retry wait -> assemble ->
        execute -> scatter; the marks telescope to the e2e latency),
        and the always-on flight recorder takes one per-batch event
        with the same stage decomposition — per batch, not per
        request, so it can afford to run unconditionally."""
        live = self._drop_dead(reqs)
        if not live:
            return
        kind = live[0].kind
        breaker = self.scheduler.breakers.get(kind)
        rec = self._recorder
        t_pop = time.perf_counter()
        # oldest request's wait at pop time (monotonic base, matching
        # Request.submitted_at) — the recorder's queue-wait fact
        wait_s = time.monotonic() - live[0].submitted_at
        # the wait a request pays BEFORE the worker picks it up:
        # queue/flush wait at top level (in a pool, this includes the
        # WFQ credit wait — one number, by design), sibling-bisection
        # wait on retry sub-batches
        stage0 = "queue_wait" if toplevel else "retry_wait"
        for r in live:
            if r.trace is not None:
                r.trace.mark(stage0, now=t_pop)
        t_asm = t_exec = None
        try:
            self.faults.check("batch.assemble", kind=kind,
                              width=len(live))
            sources = batcher.assemble(
                live, self.config.lane_widths, record=toplevel
            )
            if toplevel:
                # occupancy/batch accounting measures COALESCING, so
                # retry sub-batches stay out of it (they are visible
                # as retry_batches / per_kind retried instead)
                self.batches += 1
                self._occupancy_sum += len(live) / len(sources)
            else:
                self.retry_batches += 1
            t_asm = time.perf_counter()
            for r in live:
                if r.trace is not None:
                    r.trace.mark("assemble", now=t_asm)
            self.faults.check(
                "engine.execute", kind=kind,
                roots=tuple(r.root for r in live),
            )
            pm = self.engine.plan_misses
            result = self.engine.execute(kind, sources)
            t_exec = time.perf_counter()
            plan_src = "cold" if self.engine.plan_misses > pm else "warm"
            for r in live:
                if r.trace is not None:
                    r.trace.mark("execute", now=t_exec)
                    r.trace.annotate(
                        width=len(sources), plan=plan_src,
                        version=self.engine.version_id,
                    )
            self.faults.check("batch.scatter", kind=kind)
            self.completed += batcher.scatter(
                live, result,
                on_timeout=self._on_exec_timeout,
                on_ok=self._slo_ok if self.slo is not None else None,
                on_error=(
                    self._on_lane_error
                    if self.slo is not None else None
                ),
            )
            if rec is not None:
                now = time.perf_counter()
                rec.record(
                    "serve.batch", query=kind, width=len(sources),
                    requests=len(live), toplevel=toplevel,
                    outcome="ok", plan=plan_src,
                    version=self.engine.version_id,
                    queue_wait_s=round(wait_s, 6),
                    assemble_s=round(t_asm - t_pop, 6),
                    execute_s=round(t_exec - t_asm, 6),
                    scatter_s=round(now - t_exec, 6),
                    rids=[r.rid for r in live],
                )
            if breaker is not None and toplevel:
                breaker.record_success(time.monotonic(), kind)
        except Exception as e:  # failure touches THIS batch only
            now = time.perf_counter()
            for r in live:
                if r.trace is not None:
                    # however far the batch got, the elapsed time was
                    # execution-side work: charge it there so retry
                    # marks stay telescoping
                    r.trace.mark("execute", now=now)
            if rec is not None:
                rec.record(
                    "serve.batch", query=kind, requests=len(live),
                    toplevel=toplevel, outcome="error",
                    error=repr(e),
                    elapsed_s=round(now - t_pop, 6),
                    rids=[r.rid for r in live],
                )
            if breaker is not None and toplevel:
                if breaker.record_failure(time.monotonic(), kind):
                    self._flight_dump(
                        "breaker_open", query=kind, error=repr(e)
                    )
            if self._own_device_error(e):
                self._device_failed(live, e)
                return
            self._recover(live, e)

    def _device_failed(self, reqs, exc: Exception) -> None:
        """A CUDA error: bisection would only meet it again, so the
        batch's futures fail with it at once, the error is retained for
        ``health()`` (status ``"down"``) and the flight recorder dumps.
        Nothing is retried on the CPU."""
        for r in reqs:
            if batcher.settle(r.future, exc=exc):
                obs.count("serve.requests", kind=r.kind, status="error")
                if r.trace is not None:
                    r.trace.finish(status="error", stage="settle")
        self._device_lost(exc)

    def _device_lost(self, exc: Exception) -> None:
        """Retain a CUDA error for ``health()`` (status ``"down"``) and
        dump the flight recorder, whichever thread met it: the worker,
        the mutation thread (``apply_delta``'s uploads, the swap) or
        the checkpointer (``save_version``'s device reads)."""
        if self.device_error is None:
            self.device_error = exc
        self._flight_dump("device_error", error=repr(exc))

    def _recover(self, reqs, exc: Exception) -> None:
        """Poisoned-batch isolation: a failed batch is bisected and
        retried so one poison request fails ALONE instead of taking
        its lane-mates with it. Each request rides at most
        ``retry_budget`` failing executions (budget 5 = a full
        16→8→4→2→1 bisection), then its future fails with the last
        error — bounded work, no stranded futures."""
        kind = reqs[0].kind
        budget = self.config.retry_budget
        retry = []
        poisoned = []
        for r in reqs:
            r.attempts += 1
            if r.attempts >= budget:
                if batcher.settle(r.future, exc=exc):
                    _bump(self._poisoned, kind)
                    obs.count("serve.requests", kind=kind,
                              status="error")
                    obs.count("serve.poison.isolated", kind=kind)
                    if r.trace is not None:
                        r.trace.finish(status="poisoned",
                                       stage="settle")
                    poisoned.append(r.rid)
            else:
                retry.append(r)
        if poisoned:
            # the poisoned batch's stage events are still in the ring:
            # snapshot NOW so the post-mortem holds them (one dump per
            # recover call, rate-limited inside the recorder) — and
            # BEFORE the SLO accounting, whose own breach dump would
            # otherwise rate-limit this one away
            self._flight_dump(
                "poisoned", query=kind, rids=poisoned, error=repr(exc)
            )
            for _rid in poisoned:
                self._slo_bad(kind)
        if not retry:
            return
        _bump(self._retried, kind, len(retry))
        obs.count("serve.retry.requests", len(retry), kind=kind)
        if len(retry) == 1:
            self._run_batch(retry, toplevel=False)
            return
        mid = (len(retry) + 1) // 2
        self._run_batch(retry[:mid], toplevel=False)
        self._run_batch(retry[mid:], toplevel=False)

    def _execute_batches(self, ready) -> None:
        for reqs in ready:
            # whole-batch guard: these requests are already popped, so
            # ANY failure (assemble, engine, scatter) must settle their
            # futures (possibly after bisection retries) — a stranded
            # future blocks its caller forever
            self._run_batch(reqs)

    def pump(self, force: bool = False) -> int:
        """One synchronous scheduling step (the worker's body, callable
        directly for deterministic tests / worker-less embedding):
        execute every batch currently due. Returns batches executed."""
        ready = self.scheduler.pop_ready(force=force)
        self._execute_batches(ready)
        return len(ready)

    def _loop(self) -> None:
        while True:
            with self._wake:
                if self._stop:
                    break
            # replica.death (round 16): OUTSIDE the recovery ladder by
            # design — when this fires the worker thread DIES
            # (health() flips "down"; chaos tests kill the worker
            # through this point).  The thread
            # exits without settling anything — a crash settles
            # nothing either.
            try:
                self.faults.check("replica.death")
            except InjectedFault:
                return
            # pump BEFORE sleeping: requests that arrived while the
            # previous batch executed (their notify found no waiter)
            # may already fill a lane bucket — flush-on-full must not
            # wait out the deadline
            try:
                pumped = self.pump()
                if self._backoff_s != self.config.worker_backoff_s:
                    # reset on success — and bring the gauge back down
                    # with it (a one-time write: steady state is free)
                    self._backoff_s = self.config.worker_backoff_s
                    obs.gauge("serve.worker.backoff_s", self._backoff_s)
                if pumped:
                    continue
            except Exception as e:  # the worker must outlive any one
                # pump: a dead worker with an open front door would
                # admit requests whose futures never complete. The
                # error is RETAINED and printed — an obs counter alone
                # would vanish with telemetry off (the default). Batch
                # failures never reach here (the recovery ladder
                # settles them); this is the scheduler-bug backstop,
                # so it backs off exponentially (capped, reset on
                # success) instead of spinning at a fixed 50 ms
                self.worker_errors += 1
                self.last_worker_error = e
                self.last_worker_error_at = time.time()
                obs.count(
                    "serve.worker.errors", exc_type=type(e).__name__
                )
                obs.gauge("serve.worker.backoff_s", self._backoff_s)
                self._flight_dump("worker_error", error=repr(e))
                traceback.print_exc(file=sys.stderr)
                time.sleep(self._backoff_s)
                self._backoff_s = min(
                    2 * self._backoff_s, self.config.worker_backoff_max_s
                )
                continue
            with self._wake:
                if self._stop:
                    break
                if self.scheduler.has_ready():
                    # a burst landed between pump() returning and this
                    # lock acquire (its notify found no waiter): flush
                    # now instead of sleeping out the deadline. Checked
                    # under _wake, so later submits cannot be missed —
                    # their notify blocks until wait() releases it.
                    continue
                deadline = self.scheduler.next_deadline()
                if deadline is None:
                    # idle: block until a submit/close notifies (no
                    # polling — notify cannot be missed, it needs this
                    # lock, held until wait() releases it)
                    self._wake.wait()
                else:
                    delay = deadline - time.monotonic()
                    if delay > 0:
                        self._wake.wait(delay)
        # drain happens in close(), after this thread has joined — one
        # executor at a time, and a never-started worker drains too

    # -- graph hot-swap ----------------------------------------------------

    def swap_graph(self, version=None, *, rows=None, cols=None,
                   weights=None, **build_kw) -> dict:
        """Atomically replace the served graph while the server keeps
        running: in-flight batches finish on the OLD version (the swap
        waits on the engine's execution lock), queued and future
        requests execute on the new one, and the plan cache survives
        (same-shape versions: zero plan builds). Pass either a prebuilt
        ``GraphVersion`` (``engine.build_version(...)`` — build it
        BEFORE calling, off the serving path) or a COO
        (``rows=``/``cols=``/``weights=``), which is built here, also
        outside the execution lock. Returns
        ``{"version", "swap_s", "nnz"}``."""
        if version is None:
            if rows is None or cols is None:
                raise ValueError(
                    "swap_graph needs a GraphVersion or rows=/cols="
                )
            version = self.engine.build_version(
                rows, cols, weights=weights, **build_kw
            )
        if self._wal is not None and version.wal_seq < 0:
            # an externally built version (hot-swap) carries no merge
            # lineage stamp: it supersedes everything MERGED so far,
            # while appended-but-unmerged ops still apply on top later
            version.wal_seq = self._wal_applied
        self.faults.check("engine.swap", version=version)
        swap_s = self.engine.swap(version)
        return {
            "version": self.engine.version_id,
            "swap_s": swap_s,
            "nnz": version.nnz,
        }

    # -- introspection -----------------------------------------------------

    def _last_error(self) -> dict | None:
        """The retained worker error as {repr, at} (shared by stats()
        and health())."""
        if self.last_worker_error is None:
            return None
        return {
            "repr": repr(self.last_worker_error),
            "at": self.last_worker_error_at,
        }

    def stats(self) -> dict:
        s = self.engine.stats()
        sch = self.scheduler
        now = time.monotonic()
        per_kind = {
            k: {
                "rejected": sch.rejected_kind.get(k, 0),
                "invalid": sch.invalid_kind.get(k, 0),
                "timeout": (
                    sch.timeout_kind.get(k, 0)
                    + self._timeout_exec.get(k, 0)
                ),
                "breaker_rejected": sch.breaker_rejected_kind.get(k, 0),
                "poisoned": self._poisoned.get(k, 0),
                "retried": self._retried.get(k, 0),
                **(
                    {"breaker": sch.breakers[k].describe(now)}
                    if k in sch.breakers else {}
                ),
            }
            for k in sch.kinds
        }
        s.update(
            tenant=self.tenant,
            queue_depth=sch.depth(),
            submitted=sch.submitted,
            rejected=sch.rejected,
            batches=self.batches,
            retry_batches=self.retry_batches,
            completed=self.completed,
            worker_errors=self.worker_errors,
            last_worker_error=self._last_error(),
            per_kind=per_kind,
            faults=self.faults.stats(),
            mean_occupancy=(
                self._occupancy_sum / self.batches if self.batches else None
            ),
            lane_widths=list(self.config.lane_widths),
            max_queue=self.config.max_queue,
            updates=self._update_stats(),
            durability=self._durability_stats(),
            slo=self.slo.describe() if self.slo is not None else None,
            flightrec=(
                self._recorder.describe()
                if self._recorder is not None else None
            ),
        )
        obs.gauge("serve.batches", self.batches)
        return s

    def _update_stats(self) -> dict:
        """Write-lane disposition: merge counts/mode split (the
        rebuild-amortization surface the mutate bench gates on)."""
        with self._upd_cond:
            pending = (
                self._upd_buffer.depth()
                if self._upd_buffer is not None else 0
            )
            buf = (
                self._upd_buffer.stats()
                if self._upd_buffer is not None else None
            )
        return {
            "submitted": self.updates_submitted,
            "invalid": self.updates_invalid,
            "merges": self.update_merges,
            "failed": self.update_failures,
            "pending": pending,
            "by_mode": dict(self._merge_modes),
            "merge_s_by_mode": {
                k: round(v, 6) for k, v in self._merge_s.items()
            },
            "buffer": buf,
        }

    def is_serving(self) -> bool:
        """Cheap routing-time liveness (round 16): an open front door
        whose worker (if ever started) is alive.  A never-started
        server counts as serving — the worker-less pump()-driven
        embedding.  Two attribute reads, not a full ``health()`` dict
        build."""
        if self.scheduler.closed or self.device_error is not None:
            return False
        w = self._worker
        return w is None or w.is_alive()

    def quarantine(self, exc: Exception, timeout: float = 10.0) -> int:
        """Take a DEAD replica out of service (the fleet supervisor's
        cleanup): refuse new admissions, fail every pending read and
        buffered write future with ``exc`` — honest failure, never a
        silent drop; with a WAL attached the acknowledged writes
        themselves are NOT lost (they are on disk, and recovery or
        promotion replays them) — and stop the mutation and
        checkpointer threads.  Unlike ``close(drain=True)`` this never
        executes anything: the worker is presumed dead and the engine's
        state untrustworthy to drive.  Returns futures failed."""
        self.scheduler.close()
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        n = self.scheduler.fail_pending(exc)
        with self._upd_cond:
            pending = len(self._upd_futs)
        self._stop_mutator(drain=False, timeout=timeout, abort_exc=exc)
        self._stop_checkpointer(timeout)
        if self._wal is not None:
            self._wal.close()
        obs.count("serve.fleet.quarantined")
        return n + pending

    def _durability_stats(self) -> dict | None:
        """WAL + checkpointer disposition (None when durability is
        off — the common case pays one attribute read)."""
        if self._wal is None:
            return None
        with self._ckpt_cond:
            since = self._merges_since_ckpt
        return {
            "dir": self._ckpt_dir,
            "wal": self._wal.stats(),
            "checkpoints": self.checkpoints,
            "checkpoint_failures": self.checkpoint_failures,
            "merges_since_checkpoint": since,
            "wal_frontier": self._wal_frontier,
        }

    def health(self) -> dict:
        """Liveness/readiness introspection, cheap enough to poll: the
        worker thread's state, per-kind breaker states, the retained
        last error, and the current graph version. ``status`` is
        ``"ok"`` (serving normally — including worker-less pump()-
        driven embedding, see ``worker_alive``), ``"degraded"`` (some
        kind's breaker is open or half-open — other kinds still
        serve), ``"down"`` (a started worker thread died: the front
        door is open but nothing drains; or a CUDA error poisoned the
        card, ``device_error``), or ``"closed"``."""
        now = time.monotonic()
        breakers = {
            k: b.describe(now)
            for k, b in self.scheduler.breakers.items()
        }
        worker_alive = (
            self._worker is not None and self._worker.is_alive()
        )
        slo = self.slo.describe(now) if self.slo is not None else None
        closed = self.scheduler.closed
        if closed:
            status = "closed"
        elif self.device_error is not None:
            status = "down"  # the card's context is poisoned
        elif self._worker is not None and not self._worker.is_alive():
            status = "down"  # started once, died/joined: door open,
            # nothing drains
        elif any(b["state"] != "closed" for b in breakers.values()):
            status = "degraded"
        elif slo is not None and slo["breached"]:
            # the SLO budget is burned through: everything still
            # serves, but the tenant's contract is being violated
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "tenant": self.tenant,
            "slo": slo,
            "flightrec_last_dump": (
                self._recorder.last_dump
                if self._recorder is not None else None
            ),
            "worker_alive": worker_alive,
            "closed": closed,
            "queue_depth": self.scheduler.depth(),
            "worker_errors": self.worker_errors,
            "worker_backoff_s": self._backoff_s,
            "last_worker_error": self._last_error(),
            "device_error": (
                repr(self.device_error)
                if self.device_error is not None else None
            ),
            "breakers": breakers,
            "graph_version": self.engine.version_id,
            "swaps": self.engine.swaps,
            "updates_pending": (
                self._upd_buffer.depth()
                if self._upd_buffer is not None else 0
            ),
            "mutator_alive": (
                self._mutator is not None and self._mutator.is_alive()
            ),
            "durable": self._wal is not None,
            "wal_frontier": (
                self._wal_frontier if self._wal is not None else None
            ),
            "checkpoints": self.checkpoints,
        }
