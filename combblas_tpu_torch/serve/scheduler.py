"""Admission control + flush policy: the backpressured front door.

A bounded pending queue with reject-with-retry-after admission (a full
queue REFUSES work instead of buffering unboundedly — the load-shedding
half of a serving stack), per-kind deadline-driven flushing (a batch
goes out when it fills its widest lane bucket OR its oldest request has
waited ``max_wait_s``), per-request timeouts, and error isolation: a
malformed root fails ITS future at admission and never contaminates a
batch.

Thread-safe; the api-layer worker loop drives ``pop_ready`` /
``next_deadline``. Everything here is host-side bookkeeping, touching no
device — counterpart of ``combblas_tpu/serve/scheduler.py``, kept as the
reference has it.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

from .. import obs
from ..obs.trace import RequestTrace
from .batcher import Request, expire, settle


def _bump(d: dict, kind: str, n: int = 1) -> None:
    """Per-kind counter bump (shared by Scheduler and Server)."""
    d[kind] = d.get(kind, 0) + n


class BackpressureError(RuntimeError):
    """Queue full: the caller should back off and retry.

    ``retry_after_s`` is the server's hint — one flush deadline, i.e.
    when capacity is next expected to free up.  ``tenant`` (round 14)
    NAMES the rejected tenant when the error came out of a
    multi-tenant pool — a fleet client must know WHOSE budget it blew,
    not just that some queue somewhere was full.
    """

    def __init__(self, depth: int, retry_after_s: float,
                 tenant: str | None = None):
        who = f"tenant {tenant!r}: " if tenant else ""
        super().__init__(
            f"{who}serve queue full ({depth} pending); retry after "
            f"{retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s
        self.tenant = tenant


class CircuitBreakerOpen(BackpressureError):
    """This kind's breaker is open: recent executions failed
    consecutively, so submits fast-fail instead of queueing work the
    engine will predictably burn a device lane on. A subclass of
    ``BackpressureError`` — retry-after semantics are identical, so
    callers with a backoff loop need no new handling."""

    def __init__(self, kind: str, retry_after_s: float,
                 tenant: str | None = None):
        who = f"tenant {tenant!r}: " if tenant else ""
        RuntimeError.__init__(
            self,
            f"{who}circuit breaker open for kind {kind!r}; retry after "
            f"{retry_after_s:.3f}s",
        )
        self.kind = kind
        self.retry_after_s = retry_after_s
        self.tenant = tenant


#: Circuit-breaker states (also the ``serve.breaker.state`` gauge
#: values: closed=0, half_open=1, open=2).
BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"
_BREAKER_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker for one query kind.

    CLOSED counts consecutive top-level batch failures; at
    ``threshold`` it OPENs: admissions fast-fail with
    ``CircuitBreakerOpen`` until ``cooldown_s`` elapses, then the next
    admission flips it HALF_OPEN (a probe is let through). The probe
    batch's outcome decides: success re-CLOSEs (cooldown resets),
    failure re-OPENs with the cooldown doubled (capped at
    ``cooldown_max_s``) — a persistently broken kind backs off
    exponentially instead of retrying at a fixed cadence.

    Failures are recorded at TOP-LEVEL batch granularity by the api
    worker (bisection-recovery sub-batches are not counted), so one
    poisoned request in an otherwise healthy engine cannot open the
    breaker. All methods take an explicit ``now`` for deterministic
    tests; thread-safe.
    """

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0,
                 cooldown_max_s: float = 30.0,
                 tenant: str | None = None):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_max_s = float(cooldown_max_s)
        #: Owning tenant (round 14): rides every obs label this breaker
        #: emits, so a pool dashboard separates tenants' breaker state.
        #: ``None`` (the single-tenant default) adds no label — the
        #: pre-pool series names are unchanged.
        self.tenant = tenant
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self.failures = 0  # consecutive, while CLOSED
        self.opened_at: float | None = None
        self._cooldown = self.cooldown_s
        self._probe_at: float | None = None  # half-open probe admitted
        self.opened_total = 0
        self.fast_fails = 0

    def _lab(self, kind: str) -> dict:
        """obs labels: ``kind`` always, ``tenant`` only when owned by a
        pool tenant (single-tenant series stay label-compatible)."""
        if self.tenant is None:
            return {"kind": kind}
        return {"kind": kind, "tenant": self.tenant}

    def admit(self, now: float, kind: str = "") -> bool:
        """May a submit of this kind be admitted right now? An OPEN
        breaker whose cooldown has elapsed flips HALF_OPEN here — the
        admitted request IS the probe, and it is the ONLY one: further
        submits fast-fail until the probe's batch outcome decides (or
        a full cooldown passes without an outcome — a probe that
        expired in queue must not wedge the breaker half-open
        forever)."""
        with self._lock:
            if self.state == BREAKER_OPEN:
                if now - self.opened_at >= self._cooldown:
                    self.state = BREAKER_HALF_OPEN
                    self._probe_at = now
                    obs.gauge("serve.breaker.state",
                              _BREAKER_GAUGE[self.state],
                              **self._lab(kind))
                    return True
                self.fast_fails += 1
                return False
            if self.state == BREAKER_HALF_OPEN:
                if (
                    self._probe_at is None
                    or now - self._probe_at >= self._cooldown
                ):
                    self._probe_at = now  # stale probe: re-probe
                    return True
                self.fast_fails += 1
                return False
            return True  # CLOSED

    def release_probe(self) -> None:
        """Give back a half-open probe slot whose request never made
        it into the queue (queue-full or close() raced the admit) —
        otherwise the kind stays fast-failing for a full cooldown with
        no probe actually in flight."""
        with self._lock:
            if self.state == BREAKER_HALF_OPEN:
                self._probe_at = None

    def retry_after(self, now: float) -> float:
        with self._lock:
            if self.state == BREAKER_OPEN and self.opened_at is not None:
                return max(0.0, self.opened_at + self._cooldown - now)
            if (
                self.state == BREAKER_HALF_OPEN
                and self._probe_at is not None
            ):
                # waiting on the outstanding probe's outcome
                return max(0.0, self._probe_at + self._cooldown - now)
            return 0.0

    def record_success(self, now: float, kind: str = "") -> None:
        closed_now = False
        with self._lock:
            self.failures = 0
            self._probe_at = None
            if self.state != BREAKER_CLOSED:
                self.state = BREAKER_CLOSED
                self._cooldown = self.cooldown_s
                closed_now = True
        if closed_now:  # gauge only on TRANSITION: the steady-state
            # healthy path (one record_success per batch) stays free
            obs.gauge("serve.breaker.state", 0, **self._lab(kind))

    def record_failure(self, now: float, kind: str = "") -> bool:
        """Record one top-level batch failure.  Returns True exactly
        when THIS call transitioned the breaker to OPEN — the flight
        recorder's ``breaker_open`` dump trigger."""
        opened = False  # did THIS call transition to OPEN?
        with self._lock:
            if self.state == BREAKER_HALF_OPEN:
                # the probe failed: back off harder
                self.state = BREAKER_OPEN
                self.opened_at = now
                self._probe_at = None
                self._cooldown = min(2 * self._cooldown,
                                     self.cooldown_max_s)
                self.opened_total += 1
                opened = True
            elif self.state == BREAKER_CLOSED:
                self.failures += 1
                if self.failures >= self.threshold:
                    self.state = BREAKER_OPEN
                    self.opened_at = now
                    self._cooldown = self.cooldown_s
                    self.opened_total += 1
                    opened = True
            else:  # OPEN: a straggler batch admitted pre-open failed —
                # refresh the clock, but it is NOT a new open transition
                self.opened_at = now
            state = self.state
        obs.gauge("serve.breaker.state", _BREAKER_GAUGE[state],
                  **self._lab(kind))
        if opened:
            obs.count("serve.breaker.opened", **self._lab(kind))
        return opened

    def describe(self, now: float) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.failures,
                "opened_total": self.opened_total,
                "fast_fails": self.fast_fails,
                "cooldown_s": self._cooldown,
                "retry_after_s": (
                    max(0.0, self.opened_at + self._cooldown - now)
                    if self.state == BREAKER_OPEN else 0.0
                ),
            }


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Policy knobs for one server instance.

    ``lane_widths``: ascending shape buckets a flush may execute under
    (every width here should be covered by ``warmup()`` so steady-state
    serving never builds a plan). ``max_wait_s``: flush deadline —
    the latency a lonely request pays waiting for lane-mates;
    ``per_kind_max_wait`` overrides it per query kind. ``max_queue``
    bounds TOTAL pending requests across kinds (admission control).

    Resilience knobs: ``retry_budget`` is the number of FAILING
    executions one request may ride before its future fails. The
    default (``None``) is computed from the widest lane bucket as
    ``1 + ceil(log2(w_max))`` — exactly a full bisection (width 16:
    16→8→4→2→1 = 5), so one poison request always fails ALONE and its
    lane-mates survive regardless of configured widths. An explicit
    smaller value is the operator's bounded-work/fail-fast choice: a
    batch that exhausts it above width 1 fails innocents alongside the
    poison. ``breaker_threshold`` consecutive
    top-level batch failures open a kind's circuit breaker
    (``None``/0 disables breakers); an open breaker fast-fails submits
    for ``breaker_cooldown_s``, then a half-open probe decides —
    failure doubles the cooldown up to ``breaker_cooldown_max_s``.
    ``worker_backoff_s``/``worker_backoff_max_s`` bound the api
    worker's exponential error backoff (reset on success).
    """

    lane_widths: tuple[int, ...] = (1, 2, 4, 8, 16)
    max_queue: int = 1024
    max_wait_s: float = 0.01
    per_kind_max_wait: dict | None = None
    default_timeout_s: float | None = None
    retry_budget: int | None = None  # None -> 1 + ceil(log2(w_max))
    breaker_threshold: int | None = 5
    breaker_cooldown_s: float = 1.0
    breaker_cooldown_max_s: float = 30.0
    worker_backoff_s: float = 0.05
    worker_backoff_max_s: float = 2.0
    # -- write lane (docs/dynamic.md "Serving writes"): submit_update
    # admits edge mutations into a bounded DeltaBuffer (capacity
    # ``update_buffer``; full = reject with BackpressureError) and a
    # dedicated mutation thread merges a batch when ``update_flush``
    # ops have coalesced OR the oldest has waited ``update_max_delay_s``
    # — reads stay hot on the current version during the whole merge,
    # only the atomic swap takes the execution lock.
    # ``update_autostart=False`` disables the thread (deterministic
    # tests drive ``Server.pump_updates()`` instead).
    update_buffer: int = 4096
    update_flush: int = 64
    update_max_delay_s: float = 0.05
    update_autostart: bool = True
    # -- per-tenant SLO admission (round 14; docs/serving.md
    # "Multi-tenant pool & fleet").  ``slo_queue_budget`` rejects a
    # submit once THIS scheduler holds that many pending requests
    # (tighter than ``max_queue`` — the tenant's share of the pool, not
    # the pool's physical bound); ``slo_deadline_s`` caps every
    # admitted request's timeout at the tenant's deadline budget, so a
    # request that cannot be served inside the SLO expires instead of
    # occupying a lane late.  Both ``None`` (default) = disabled.
    slo_queue_budget: int | None = None
    slo_deadline_s: float | None = None
    # -- production observability (round 15; docs/observability.md
    # "Serving observability").  ``slo_target``/``slo_window_s``
    # parameterize the rolling-window error budget built whenever
    # ``slo_deadline_s`` is set (``serve/slo.py``).
    # ``flight_recorder`` keeps a bounded always-on ring of per-batch
    # stage events (``obs/recorder.py``) dumped as a schema-versioned
    # JSONL snapshot on worker error / breaker open / poisoned batch /
    # merge failure / SLO breach; False = the zero-cost opt-out (one
    # attribute read on the batch path).
    slo_target: float = 0.999
    slo_window_s: float = 60.0
    flight_recorder: bool = True
    flight_recorder_events: int = 256
    flight_recorder_dir: str | None = None
    flight_recorder_min_interval_s: float = 1.0
    # -- durability (round 16; docs/serving.md "Durability &
    # self-healing").  ``wal_dir`` names the directory holding the
    # write-ahead log + checkpoints (None resolves ``COMBBLAS_WAL``;
    # both unset = no durability, the zero-cost default: one attribute
    # read per write).  Every acknowledged ``submit_update`` appends to
    # the WAL before its future exists (``wal_fsync``:
    # arg > ``COMBBLAS_WAL_FSYNC`` > "always"), a background
    # checkpointer snapshots the served version every
    # ``checkpoint_every`` merges (arg > ``COMBBLAS_CHECKPOINT_EVERY``
    # > 8) or ``checkpoint_interval_s`` seconds (None = merge-count
    # only), atomically, OFF the execution lock, truncating the
    # replayed WAL prefix and retaining ``checkpoint_retain``
    # snapshots (arg > ``COMBBLAS_CHECKPOINT_RETAIN`` > 2).
    wal_dir: str | None = None
    wal_fsync: str | None = None
    checkpoint_every: int | None = None
    checkpoint_interval_s: float | None = None
    checkpoint_retain: int | None = None

    def __post_init__(self):
        if (
            not self.lane_widths
            or tuple(sorted(self.lane_widths)) != tuple(self.lane_widths)
            or self.lane_widths[0] < 1
        ):
            raise ValueError(
                "lane_widths must be ascending positive ints"
            )
        if self.retry_budget is None:
            # full-bisection budget for the widest configured bucket
            # (frozen dataclass: assign via object.__setattr__)
            object.__setattr__(
                self, "retry_budget",
                1 + max(0, int(self.lane_widths[-1]) - 1).bit_length(),
            )
        if self.retry_budget < 1:
            raise ValueError("retry_budget must be >= 1")
        if not (0 < self.worker_backoff_s <= self.worker_backoff_max_s):
            raise ValueError(
                "need 0 < worker_backoff_s <= worker_backoff_max_s"
            )
        if self.update_buffer < 1 or self.update_flush < 1:
            raise ValueError(
                "update_buffer and update_flush must be >= 1"
            )
        if self.update_max_delay_s <= 0:
            raise ValueError("update_max_delay_s must be > 0")
        if self.slo_queue_budget is not None and self.slo_queue_budget < 1:
            raise ValueError("slo_queue_budget must be >= 1")
        if self.slo_deadline_s is not None and self.slo_deadline_s <= 0:
            raise ValueError("slo_deadline_s must be > 0")
        if not (0.0 < self.slo_target < 1.0):
            raise ValueError("slo_target must be in (0, 1)")
        if self.slo_window_s <= 0:
            raise ValueError("slo_window_s must be > 0")
        if self.flight_recorder_events < 1:
            raise ValueError("flight_recorder_events must be >= 1")
        if self.flight_recorder_min_interval_s < 0:
            raise ValueError(
                "flight_recorder_min_interval_s must be >= 0"
            )
        if (
            self.checkpoint_every is not None
            and self.checkpoint_every < 1
        ):
            raise ValueError("checkpoint_every must be >= 1")
        if (
            self.checkpoint_interval_s is not None
            and self.checkpoint_interval_s <= 0
        ):
            raise ValueError("checkpoint_interval_s must be > 0")
        if (
            self.checkpoint_retain is not None
            and self.checkpoint_retain < 1
        ):
            raise ValueError("checkpoint_retain must be >= 1")

    def wait_for(self, kind: str) -> float:
        if self.per_kind_max_wait and kind in self.per_kind_max_wait:
            return self.per_kind_max_wait[kind]
        return self.max_wait_s


class Scheduler:
    """Pending-request store with admission control and flush policy."""

    def __init__(self, config: ServeConfig, nrows: int,
                 kinds: tuple[str, ...], tenant: str | None = None):
        self.config = config
        self.nrows = nrows
        self.kinds = kinds
        #: Owning tenant (round 14): named in every backpressure error
        #: and threaded through the obs labels below; ``None`` keeps
        #: the single-tenant label sets unchanged.
        self.tenant = tenant
        self._pending: dict[str, deque[Request]] = {
            k: deque() for k in kinds
        }
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._closed = False
        #: Shared ``serve.slo.ErrorBudget`` (assigned by the owning
        #: Server when ``config.slo_deadline_s`` is set): the queue
        #: sweep and the rejection paths record BAD dispositions here
        #: so the budget sees every user-visible failure, not just the
        #: executed ones.  None = no SLO accounting (one attribute
        #: read per site).
        self.slo = None
        #: Breach hook (assigned alongside ``slo``): called with the
        #: kind when a scheduler-side bad record BURNS THROUGH the
        #: budget — record() fires the transition exactly once per
        #: breach episode, so dropping its return here would swallow
        #: the flight-recorder dump whenever the crossing lands on a
        #: rejection/sweep instead of an execution failure.
        self.slo_breach = None
        self.rejected = 0  # backpressure only; breakers count separately
        self.submitted = 0
        # per-kind disposition counters (Server.stats()'s per_kind
        # table) — plain dicts bumped under _lock
        self.rejected_kind: dict[str, int] = {}
        self.invalid_kind: dict[str, int] = {}
        self.timeout_kind: dict[str, int] = {}
        self.breaker_rejected_kind: dict[str, int] = {}
        # per-kind circuit breakers (execution health -> admission
        # fast-fail); the api worker records batch outcomes into these
        self.breakers: dict[str, CircuitBreaker] = (
            {
                k: CircuitBreaker(
                    config.breaker_threshold,
                    config.breaker_cooldown_s,
                    config.breaker_cooldown_max_s,
                    tenant=tenant,
                )
                for k in kinds
            }
            if config.breaker_threshold else {}
        )

    def _lab(self, **labels) -> dict:
        """obs labels with the tenant attached when one owns this
        scheduler (see ``CircuitBreaker._lab``)."""
        if self.tenant is not None:
            labels["tenant"] = self.tenant
        return labels

    def _slo_bad(self, kind: str) -> None:
        """One scheduler-side bad SLO disposition; a budget-burn
        crossing fires the owning Server's breach hook (the
        flight-recorder dump — record() returns the transition exactly
        once per episode, so it must not be dropped here)."""
        if self.slo is not None and self.slo.record(False, kind=kind):
            if self.slo_breach is not None:
                self.slo_breach(kind)

    def close(self) -> None:
        """Refuse all further admissions, PERMANENTLY (set under the
        admission lock, so a submit racing ``Server.close`` either
        lands before the drain or raises — it can never be silently
        stranded)."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    # -- admission ---------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._pending.values())

    def submit(self, kind: str, root, timeout_s: float | None = None,
               now: float | None = None,
               trace_rid: int | str | None = None,
               trace=None) -> Future:
        """Admit one single-root query; returns its Future.

        Raises ``BackpressureError`` when the queue is full and
        ``ValueError`` for an unknown kind (caller bugs, not load). A
        MALFORMED ROOT is isolated instead: its future carries the
        ValueError and the request never enters a batch.

        ``trace_rid`` adopts an upstream sampling decision (round 18):
        a process-fleet router that already sampled a request forwards
        its rid over IPC, and the child-side scheduler traces it
        UNCONDITIONALLY under that rid — re-rolling the local sampler
        here would decorrelate the stitched trace's two halves.  The
        trace rides the Future as ``_combblas_trace`` so the IPC reply
        path can ship its stage marks home.

        ``trace`` adopts an upstream trace OBJECT (round 19): the net
        frontend opens (and holds) the trace at the socket, charges
        its ``net_accept``/``net_read`` stages, and hands the same
        object down so the scheduler's queue/assemble/execute/scatter
        marks land in one record — same-process stitching, no rid
        forwarding needed.  Mutually exclusive with ``trace_rid``.
        """
        if kind not in self._pending:
            raise ValueError(
                f"unknown query kind {kind!r}; engine serves {self.kinds}"
            )
        with self._lock:  # closed check FIRST: close semantics must not
            # depend on whether the root happened to be malformed
            if self._closed:
                raise RuntimeError(
                    "serve.Server is closed; no further admissions"
                )
        now = time.monotonic() if now is None else now
        fut: Future = Future()
        timeout_s = (
            timeout_s if timeout_s is not None
            else self.config.default_timeout_s
        )
        slo = self.config.slo_deadline_s
        if slo is not None:
            # SLO deadline budget: a request may never outlive the
            # tenant's deadline, whatever timeout it asked for — late
            # answers are as bad as no answers under an SLO
            timeout_s = slo if timeout_s is None else min(timeout_s, slo)
        deadline = None if timeout_s is None else now + timeout_s
        # error isolation: a bad root fails its OWN request, not a batch
        try:
            root_i = int(root)
            if root_i != root or not (0 <= root_i < self.nrows):
                raise ValueError(
                    f"root {root!r} outside [0, {self.nrows})"
                )
        except (TypeError, ValueError) as e:
            fut.set_exception(
                e if isinstance(e, ValueError) else ValueError(str(e))
            )
            with self._lock:
                _bump(self.invalid_kind, kind)
            obs.count(
                "serve.requests", **self._lab(kind=kind, status="invalid")
            )
            return fut
        breaker = self.breakers.get(kind)
        if breaker is not None and not breaker.admit(now, kind):
            # fast-fail OUTSIDE the queue lock: an open breaker is an
            # execution-health fact, not a queue-depth one
            with self._lock:
                _bump(self.breaker_rejected_kind, kind)
            obs.count("serve.breaker.fast_fail", **self._lab(kind=kind))
            # a fast-failed request is a user-visible failure under an
            # SLO (breach transitions reach the recorder via the hook)
            self._slo_bad(kind)
            raise CircuitBreakerOpen(
                kind, breaker.retry_after(now), tenant=self.tenant
            )
        try:
            with self._lock:
                if self._closed:  # re-check: close() may have raced
                    # the host-side validation above
                    raise RuntimeError(
                        "serve.Server is closed; no further admissions"
                    )
                d = sum(len(q) for q in self._pending.values())
                budget = self.config.max_queue
                if self.config.slo_queue_budget is not None:
                    # the tenant's queue-depth budget: its share of the
                    # pool, enforced tighter than the physical bound
                    budget = min(budget, self.config.slo_queue_budget)
                if d >= budget:
                    self.rejected += 1
                    _bump(self.rejected_kind, kind)
                    obs.count("serve.queue.rejected", **self._lab(kind=kind))
                    raise BackpressureError(
                        d, self.config.wait_for(kind), tenant=self.tenant
                    )
                req = Request(
                    rid=next(self._rid), kind=kind, root=root_i,
                    future=fut, submitted_at=now, deadline=deadline,
                )
                # deterministic-sampled per-request trace (round 15):
                # attached BEFORE the request becomes poppable — a
                # post-append attach could race the worker, whose pop
                # would then miss the early stage marks (or finish
                # before the trace exists, leaking it uncommitted).
                # Inside the admission lock only on success, so a
                # rejected submit never allocates one; obs.request_
                # trace is host-dict work (the queue-depth gauge below
                # sets the in-lock precedent), disabled obs = one call
                # + flag check.
                if trace is not None:
                    # round 19: adopt the transport's live trace —
                    # the frontend already rolled the sampler and
                    # charged its ingress stages; ride the future so
                    # worker/sweep settle paths find it as usual
                    req.trace = trace
                    fut._combblas_trace = trace
                elif trace_rid is None:
                    req.trace = obs.request_trace(
                        req.rid, kind=kind, tenant=self.tenant
                    )
                else:
                    # adopted upstream decision: trace unconditionally
                    # (the router already rolled the sampler) under the
                    # ROUTER's rid, so the stitched halves correlate
                    req.trace = RequestTrace(
                        trace_rid, "serve.request",
                        {
                            k: v
                            for k, v in (
                                ("kind", kind), ("tenant", self.tenant),
                            )
                            if v is not None
                        },
                    )
                    fut._combblas_trace = req.trace
                self._pending[kind].append(req)
                self.submitted += 1
                obs.gauge("serve.queue.depth", d + 1, **self._lab())
        except (BackpressureError, RuntimeError) as e:
            if breaker is not None:
                # this submit may have claimed the half-open probe
                # slot in admit() above; it never entered the queue,
                # so give the slot back (no-op unless half-open)
                breaker.release_probe()
            if isinstance(e, BackpressureError):
                self._slo_bad(kind)
            raise
        return fut

    # -- flush policy ------------------------------------------------------

    def _dispatch_by(self, kind: str, r: Request) -> float:
        """Latest time ``r`` should enter a batch: its kind's flush
        deadline, tightened for short per-request timeouts — a request
        whose timeout is under 2x the kind's max-wait dispatches at
        HALF its timeout budget (half for queueing, half for
        execution), instead of being slept past and expired in queue."""
        wait = self.config.wait_for(kind)
        if r.deadline is None:
            return r.submitted_at + wait
        budget = (r.deadline - r.submitted_at) / 2
        return r.submitted_at + min(wait, budget)

    def _kind_deadline(self, kind: str, q) -> float:
        """When this kind must flush: the earliest dispatch-by time of
        any queued request. An O(queue-depth) scan, bounded by
        ``max_queue`` (default 1024 — microseconds of host arithmetic
        next to a device batch); track incrementally if max_queue ever
        grows by orders of magnitude."""
        return min(self._dispatch_by(kind, r) for r in q)

    def next_deadline(self) -> float | None:
        """Absolute time of the earliest pending flush, or None when
        idle (see ``_kind_deadline`` for what counts as a deadline)."""
        with self._lock:
            deadlines = [
                self._kind_deadline(k, q)
                for k, q in self._pending.items() if q
            ]
        return min(deadlines) if deadlines else None

    def has_ready(self, now: float | None = None) -> bool:
        """True when some kind is flushable RIGHT NOW (full widest
        bucket or dispatch deadline reached) — the worker checks this
        under its wake lock before sleeping, closing the window where a
        burst's notify lands while no one is waiting."""
        now = time.monotonic() if now is None else now
        wmax = self.config.lane_widths[-1]
        with self._lock:
            return any(
                q and (
                    len(q) >= wmax or now >= self._kind_deadline(k, q)
                )
                for k, q in self._pending.items()
            )

    def pop_ready(self, now: float | None = None,
                  force: bool = False,
                  max_batches: int | None = None) -> list[list[Request]]:
        """Batches due for execution: a kind flushes when it can fill
        the widest lane bucket, when its oldest request has aged past
        the kind's flush deadline, or unconditionally under ``force``
        (drain/close). Expired requests are timed out here, before
        batching. Returns a list of per-kind request lists (each at most
        the widest bucket — a deep backlog flushes over several calls).

        ``max_batches`` (round 14) bounds how many batches one call may
        pop — the weighted-fair-queueing pump pops ONE batch per
        deficit charge so a saturated tenant drains in weighted shares
        instead of monopolizing the worker for its whole backlog; the
        dead-request sweep still covers every kind regardless.
        """
        now = time.monotonic() if now is None else now
        wmax = self.config.lane_widths[-1]
        out: list[list[Request]] = []
        timed_out: list[Request] = []
        with self._lock:
            for kind, q in self._pending.items():
                # full-queue sweep for DEAD requests — expired (even
                # BEHIND a fresh head) or client-cancelled: neither may
                # ride into a batch and waste a device lane or trigger
                # a premature flush; any() guards the rebuild off the
                # common all-live path. Expired requests are only
                # COLLECTED here — settling runs done-callbacks
                # synchronously, and a callback that re-enters submit()
                # would deadlock on this non-reentrant lock
                def dead(r):
                    return r.expired(now) or r.future.done()

                if any(dead(r) for r in q):
                    live = [r for r in q if not dead(r)]
                    for req in q:
                        if req.future.done():  # client cancel/settle
                            obs.count(
                                "serve.requests",
                                **self._lab(kind=kind, status="cancelled"),
                            )
                        elif req.expired(now):
                            timed_out.append(req)
                    q.clear()
                    q.extend(live)
                while q and (
                    force
                    or len(q) >= wmax
                    or now >= self._kind_deadline(kind, q)
                ):
                    if (
                        max_batches is not None
                        and len(out) >= max_batches
                    ):
                        break
                    take = min(len(q), wmax)
                    out.append([q.popleft() for _ in range(take)])
            obs.gauge(
                "serve.queue.depth",
                sum(len(q) for q in self._pending.values()),
                **self._lab(),
            )
        if timed_out:
            with self._lock:
                for req in timed_out:
                    _bump(self.timeout_kind, req.kind)
        for req in timed_out:  # settle OUTSIDE the lock (see above;
            # the per-kind bump already happened under it)
            if expire(req, "expired in queue"):
                self._slo_bad(req.kind)
        return out

    def drain(self) -> list[list[Request]]:
        """Everything still pending, as batches (close/shutdown path)."""
        return self.pop_ready(force=True)

    def fail_pending(self, exc: Exception) -> int:
        """Fail every queued request (server shutdown without drain).
        Settlement happens after the lock is released — done-callbacks
        run synchronously and may re-enter the scheduler.  Returns
        requests failed."""
        drained: list[Request] = []
        with self._lock:
            for q in self._pending.values():
                while q:
                    drained.append(q.popleft())
        for req in drained:
            settle(req.future, exc=exc)
            if req.trace is not None:  # abandoned reads still close
                # their sampled trace (the write lane's _stop_mutator
                # convention) — sampled==committed+dropped must hold
                req.trace.finish(status="aborted", stage="settle")
        return len(drained)


class DeficitRoundRobin:
    """Weighted fair queueing across tenants (round 14): classic
    deficit round robin over the tenants' own bounded queues.

    Each scheduling ROUND grants every backlogged tenant
    ``quantum x weight`` deficit credit and yields the tenants in
    rotation order (the start position advances per round, so no
    tenant enjoys a systematic first-mover advantage); the pump then
    serves a tenant while its ``balance`` stays positive, CHARGING the
    actual request count of each executed batch (post-charge: a batch
    may overdraw the balance by at most one bucket width — the
    overdraft carries into the next round, so long-run served shares
    converge to the weights).  A tenant whose backlog EMPTIES has its
    deficit reset (no banking: an idle tenant cannot hoard credit and
    later burst past its weight — the textbook DRR rule).

    Write-lane fairness rides the same meter: the pool pump charges a
    tenant's merge cost (ops folded) against the same deficit, so a
    mutation-heavy tenant spends its share on writes instead of
    starving everyone else's reads.

    Deterministic (no clocks, no randomness) and thread-safe; the obs
    series are ``serve.wfq.rounds``, ``serve.wfq.served{tenant}`` and
    ``serve.wfq.deficit{tenant}``.
    """

    def __init__(self, quantum: int | None = None):
        from ..tuner import config as tuner_config

        self.quantum = tuner_config.pool_quantum(quantum)
        self._lock = threading.Lock()
        self._weights: dict[str, float] = {}
        self._deficit: dict[str, float] = {}
        self._cursor = 0
        self.rounds = 0
        self.served: dict[str, int] = {}

    def add(self, tenant: str, weight: float = 1.0) -> None:
        if weight <= 0:
            raise ValueError(
                f"tenant {tenant!r} needs a positive WFQ weight, "
                f"got {weight}"
            )
        with self._lock:
            self._weights[tenant] = float(weight)
            self._deficit.setdefault(tenant, 0.0)

    def remove(self, tenant: str) -> None:
        with self._lock:
            self._weights.pop(tenant, None)
            self._deficit.pop(tenant, None)
            self.served.pop(tenant, None)

    def prune(self, live) -> list[str]:
        """Drop every tenant NOT in ``live`` (the pool pump calls this
        with the current tenant list): add/remove churn must not leak
        weights/deficit/served entries — or their obs label space —
        for dead tenant names forever.  Returns the pruned names so
        the caller can prune the metrics registry's ``tenant=`` label
        space in the same breath (``obs.prune_labels``)."""
        live = set(live)
        removed = []
        with self._lock:
            for t in [x for x in self._weights if x not in live]:
                self._weights.pop(t, None)
                self._deficit.pop(t, None)
                self.served.pop(t, None)
                removed.append(t)
        return removed

    def set_weight(self, tenant: str, weight: float) -> None:
        self.add(tenant, weight)

    def balance(self, tenant: str) -> float:
        with self._lock:
            return self._deficit.get(tenant, 0.0)

    def round(self, backlogged) -> list[str]:
        """One DRR round: grant ``quantum x weight`` to every
        backlogged tenant, reset idle tenants' deficit, and return the
        backlogged tenants in this round's rotation order."""
        with self._lock:
            names = list(self._weights)
            live = {t for t in backlogged if t in self._weights}
            for t in names:
                if t in live:
                    self._deficit[t] += self.quantum * self._weights[t]
                else:
                    self._deficit[t] = 0.0  # no banking while idle
            if not names:
                return []
            start = self._cursor % len(names)
            self._cursor += 1
            order = [
                t for t in names[start:] + names[:start] if t in live
            ]
            self.rounds += 1
            # deficit SNAPSHOT under the lock: a concurrent remove()
            # between release and the gauge loop must not KeyError
            snap = {t: self._deficit[t] for t in order}
        if obs.ENABLED:
            obs.count("serve.wfq.rounds")
            for t, v in snap.items():
                obs.gauge("serve.wfq.deficit", v, tenant=t)
        return order

    def charge(self, tenant: str, cost: float) -> None:
        """Spend ``cost`` (requests served or write ops merged) from
        the tenant's balance — may overdraw (see class docstring)."""
        with self._lock:
            if tenant in self._deficit:
                self._deficit[tenant] -= cost
            self.served[tenant] = (
                self.served.get(tenant, 0) + int(cost)
            )
        if obs.ENABLED:
            obs.count("serve.wfq.served", cost, tenant=tenant)

    def describe(self) -> dict:
        with self._lock:
            return {
                "quantum": self.quantum,
                "rounds": self.rounds,
                "weights": dict(self._weights),
                "deficit": {
                    k: round(v, 3) for k, v in self._deficit.items()
                },
                "served": dict(self.served),
            }
