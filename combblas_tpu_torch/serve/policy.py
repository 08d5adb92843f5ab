"""Shared fleet policy: routing, read retry, supervision; counterpart of
``combblas_tpu/serve/policy.py``.

A replica fleet is one SERVICE over several replicas of one graph:
least-loaded read routing with spillover, bounded read retry on the
next-best replica, one HOME write lane, supervision that detects dead
replicas, promotes a dead home and rebuilds replacements.
:class:`ReplicaFleetBase` holds that policy; ``FleetRouter``
(``fleet.py``, thread-hosted replicas) and ``ProcessFleet``
(``procfleet.py``, subprocess replicas) subclass it and supply the
LIVENESS and HEAL verbs:

* ``_depth(i)`` / ``_serving(i)`` — routing-time load and liveness;
* ``_dead(i)`` — supervision-time death;
* ``promote()`` / ``_replace_replica(i)`` — the heal actions;
* ``_replace_allowed`` / ``_replace_failed`` / ``_replace_ok`` — the
  heal backoff (the process fleet's capped-backoff respawn retry);
* ``_observe_fleet()`` — a per-tick liveness gauge;
* ``_fleet_event`` — the supervision timeline.

Obs series are emitted under the subclass's ``_OBS`` prefix
(``serve.fleet`` / ``serve.procfleet``); the series shapes are the
``serve.fleet.*`` rows of the obs/metrics.py catalog.

Deviation from the reference, kept on purpose: where every replica runs
in this process it shares the card's CUDA context, so a CUDA error is
the card's, not one replica's. That rule sits behind one hook,
``_SHARED_CONTEXT``, which only ``FleetRouter`` sets. There, one met in
a replica's batch or merge is kept by its ``Server`` as
``device_error``; one met by the fleet's own work (a fan-out's rebuild
or swap, a promotion, a replacement, a warm-up) is kept on the fleet and
raised. A read that failed with one is not retried on another replica
(it would meet the same poisoned context), and a supervision pass while
either holds one detects, promotes and replaces nothing: a rebuild on
the broken context would fail, or be quarantined again, on every tick.
The front end's ``health()`` reports ``down`` and carries the error.
A fleet whose replicas each own a context (``ProcessFleet``) keeps the
reference's rule: a replica's CUDA error is that replica's, its reads
are retried on the others, and supervision replaces it.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future

from .. import obs
from .api import _is_device_error
from .batcher import settle
from .scheduler import BackpressureError

#: Execution-side re-submits of one routed read (``submit``).
READ_RETRY = 1


class ReplicaDeadError(RuntimeError):
    """A replica died (worker thread or OS process) and the supervisor
    took it out of service: its pending futures fail with this.  With
    a WAL attached the ACKNOWLEDGED writes themselves are durable
    (recovery / promotion replays them) — only the futures fail,
    honestly."""


class StaleEpochError(RuntimeError):
    """A slice was asked to advance a batch epoch it holds no resident
    loop state for (it respawned or restarted mid-batch).  This is a
    healthy slice reporting a protocol fact, NOT a death: the router
    replays the whole batch under a fresh epoch (re-seeding every
    slice) without quarantining anyone — the round-21 slice-resident
    hop-state contract."""


class ReplicaFleetBase:
    """Routing + supervision policy over ``self.replicas`` (anything
    with ``submit(kind, root, timeout_s=)`` returning a Future).

    Subclasses call :meth:`_init_policy` after populating
    ``self.replicas`` and ``self.home``, and implement the liveness /
    heal hooks (module docstring).
    """

    #: Obs series prefix — ``serve.fleet`` (threads) or
    #: ``serve.procfleet`` (processes); the series shapes match.
    _OBS = "serve.fleet"

    #: True where every replica runs on this process's CUDA context, so
    #: that a CUDA error any replica meets is the card's (module
    #: docstring): ``FleetRouter``. A fleet whose replicas each own a
    #: context leaves it False, and its own ``_device_error`` is one met
    #: by the router's own device work.
    _SHARED_CONTEXT = False

    def _init_policy(self) -> None:
        self._rr = itertools.count()
        self.submitted: list[int] = [0] * len(self.replicas)
        self.spillovers = 0
        self.fanouts = 0
        self.promotions = 0
        self.replacements = 0
        self.read_retries = 0
        # fan-out generation accounting: versions_behind[i] =
        # _fan_gen - _replica_gen[i] (0 = replica serves the home's
        # latest fanned-out version)
        self._fan_gen = 0
        self._replica_gen = [0] * len(self.replicas)
        self._draining: set[int] = set()
        self._drain_gen: dict[int, int] = {}  # fan gen at drain time
        # slots whose quarantined replica still awaits a replacement:
        # STICKY until the heal succeeds — _dead() can go False the
        # moment quarantine closes admissions, so without this a
        # transient rebuild failure would be forgotten forever
        self._needs_rebuild: set[int] = set()
        self._sup_lock = threading.RLock()  # serializes heal actions
        self._sup_thread: threading.Thread | None = None
        self._sup_stop = threading.Event()
        self._sup_interval = 0.05
        #: A CUDA error the fleet's own work met (module docstring).
        self._device_error: Exception | None = None

    # -- liveness / heal hooks (subclass responsibility) -------------------

    def _depth(self, i: int) -> int:
        """Routing-time load of replica ``i``."""
        return self.replicas[i].scheduler.depth()

    def _serving(self, i: int) -> bool:
        """Routing-time liveness of replica ``i`` (cheap; called per
        submit)."""
        return self.replicas[i].is_serving()

    def _dead(self, i: int) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def device_error(self) -> Exception | None:
        """The CUDA error that stops the whole fleet, if one was met: one
        the fleet's own work met, or, with ``_SHARED_CONTEXT``, one a
        replica met (module docstring)."""
        if self._device_error is not None or not self._SHARED_CONTEXT:
            return self._device_error
        for srv in self.replicas:
            if srv.device_error is not None:
                return srv.device_error
        return None

    def _keep_device_error(self, exc: BaseException) -> bool:
        """Keep ``exc`` on the fleet if it is a CUDA error on the shared
        context (the first one wins); True when it is, so the caller
        re-raises or stops instead of counting it as one replica's
        failure. Without ``_SHARED_CONTEXT`` nothing is kept: the error
        is the replica's."""
        if not self._SHARED_CONTEXT or not _is_device_error(exc):
            return False
        if self._device_error is None:
            self._device_error = exc
        return True

    def promote(self) -> int:
        raise NotImplementedError  # pragma: no cover - abstract

    def _replace_replica(self, i: int) -> None:
        raise NotImplementedError  # pragma: no cover - abstract

    def _replace_allowed(self, i: int) -> bool:
        """Gate one heal attempt (ProcessFleet: capped-backoff retry
        after repeated respawn failures — the fleet keeps serving
        degraded on survivors instead of respawn-storming)."""
        return True

    def _replace_failed(self, i: int) -> None:
        """Heal-attempt failure hook (backoff bookkeeping)."""

    def _replace_ok(self, i: int) -> None:
        """Heal-success hook (backoff reset)."""

    # -- observability hooks -----------------------------------------------

    def _observe_fleet(self) -> None:
        """Per-supervisor-tick telemetry hook: subclasses gauge their
        continuously-scrape-visible liveness series here (ProcessFleet:
        ``serve.procfleet.heartbeat_age_s{replica=}``) so a scrape sees
        freshness without anyone calling ``health()``.  Default: none —
        the base class has no liveness signal of its own."""

    def _fleet_event(self, name: str, **fields) -> None:
        """Supervision-timeline hook: the policy layer narrates, a front
        end with an event log appends ``name`` + fields; here the events
        are dropped."""

    # -- read path ---------------------------------------------------------

    def _route_order(self) -> list[int]:
        """SERVING replica indices, least queue depth first; ties
        broken by a rotating offset so equal-depth replicas share
        evenly.  Dead, closed, and draining replicas are SKIPPED —
        a dead replica must not attract traffic purely by its empty
        queue depth."""
        alive = [
            i for i in range(len(self.replicas))
            if i not in self._draining and self._serving(i)
        ]
        if not alive:
            # nothing serves: route everywhere so the caller sees the
            # real rejection instead of an empty-fleet IndexError
            alive = list(range(len(self.replicas)))
        depths = {i: self._depth(i) for i in alive}
        off = next(self._rr) % len(self.replicas)
        return sorted(
            alive,
            key=lambda i: (depths[i], (i - off) % len(self.replicas)),
        )

    def submit(self, kind: str, root, timeout_s: float | None = None,
               trace=None):
        """Route one query to the least-loaded serving replica,
        spilling to the next on backpressure/breaker rejection; raises
        the LAST rejection only when every replica refused.

        ``READ_RETRY`` bounds execution-side retries: a future that
        fails with a replica-level error (worker death, injected fault,
        poison-exhausted batch — NOT backpressure, malformed-root,
        deadline or CUDA errors) is re-submitted once per budget unit
        to the next-best OTHER replica before the caller sees the
        failure.  Reads only — writes have exactly one home lineage
        and never retry implicitly.

        ``trace`` forwards the net frontend's live trace object to the
        replica that ADMITS the request (spillover attempts carry it
        along; read-retries do not — the trace narrates the original
        execution).  Passed as a conditional keyword so replica classes
        with the narrower signature (ReplicaProc, which stitches by rid
        instead) stay untouched when no trace rides."""
        tr_kw = {} if trace is None else {"trace": trace}
        last_exc: Exception | None = None
        for i in self._route_order():
            try:
                fut = self.replicas[i].submit(
                    kind, root, timeout_s=timeout_s, **tr_kw
                )
            except (BackpressureError, RuntimeError) as e:
                # backpressure/breaker — or a replica quarantined/
                # closed between _route_order's liveness check and
                # this submit: spill to the next replica either way,
                # matching the retry path's exception taxonomy
                self.spillovers += 1
                obs.count(self._OBS + ".spillover", replica=i)
                last_exc = e
                continue
            self.submitted[i] += 1
            obs.count(self._OBS + ".submitted", replica=i)
            return self._with_read_retry(
                fut, kind, root, timeout_s, i, READ_RETRY
            )
        raise last_exc  # every replica rejected

    def _with_read_retry(self, fut, kind, root, timeout_s,
                         replica: int, budget: int) -> Future:
        """Wrap a submitted read's future: on an execution-side
        failure, re-submit to the next-best OTHER serving replica
        (bounded by ``budget``); the outer future sees the retried
        outcome.  Admission-level rejections (backpressure/breaker),
        malformed roots (ValueError), expired deadlines (TimeoutError)
        and, with ``_SHARED_CONTEXT``, CUDA errors (the card's, module
        docstring) are NOT retried — they would fail identically or lie
        about the deadline."""
        outer: Future = Future()

        def _done(f):
            exc = f.exception()
            if exc is None:
                settle(outer, result=f.result())
                return
            if budget <= 0 or isinstance(
                exc, (BackpressureError, ValueError, TimeoutError)
            ) or (self._SHARED_CONTEXT and _is_device_error(exc)):
                settle(outer, exc=exc)
                return
            for j in self._route_order():
                if j == replica:
                    continue
                try:
                    f2 = self.replicas[j].submit(
                        kind, root, timeout_s=timeout_s
                    )
                except (BackpressureError, RuntimeError):
                    continue
                self.read_retries += 1
                self.submitted[j] += 1
                obs.count(self._OBS + ".read_retry", replica=j)
                inner = self._with_read_retry(
                    f2, kind, root, timeout_s, j, budget - 1
                )
                inner.add_done_callback(
                    lambda g: settle(
                        outer,
                        result=(
                            g.result() if g.exception() is None
                            else None
                        ),
                        exc=g.exception(),
                    )
                )
                return
            settle(outer, exc=exc)  # nowhere to retry

        fut.add_done_callback(_done)
        return outer

    def submit_many(self, kind: str, roots,
                    timeout_s: float | None = None) -> list:
        """Bulk submit through the router. Unlike a single server's
        prefix semantics, spillover means a LATER root can still land
        after one was rejected fleet-wide — so each rejected root fails
        its OWN future and admission continues."""
        out = []
        for r in roots:
            try:
                out.append(self.submit(kind, r, timeout_s=timeout_s))
            except BackpressureError as e:
                f: Future = Future()
                f.set_exception(e)
                out.append(f)
        return out

    def lagging(self) -> list[int]:
        """Replica indices serving an older version than the home's
        latest fan-out (failed/skipped rebuilds — retried next
        fan-out; degraded ``health()`` while non-empty)."""
        return [
            i for i in range(len(self.replicas))
            if i != self.home
            and self._replica_gen[i] < self._fan_gen
        ]

    # -- supervision -------------------------------------------------------

    def start_supervisor(self, interval_s: float = 0.05):
        """Start the liveness supervisor thread: every ``interval_s``
        it runs ``supervise_once()`` — dead-replica detection,
        replacement rebuilds, home promotion.  Idempotent; stopped by
        ``close()`` / ``stop_supervisor()``."""
        with self._sup_lock:
            if self._sup_thread is None or not self._sup_thread.is_alive():
                self._sup_stop.clear()
                self._sup_interval = float(interval_s)
                self._sup_thread = threading.Thread(
                    target=self._sup_loop, name="combblas-fleet-sup",
                    daemon=True,
                )
                self._sup_thread.start()
        return self

    def stop_supervisor(self, timeout: float = 10.0) -> None:
        t = self._sup_thread
        if t is None:
            return
        self._sup_stop.set()
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(
                f"fleet supervisor did not stop within {timeout}s"
            )
        self._sup_thread = None

    def _sup_loop(self) -> None:
        while not self._sup_stop.is_set():
            try:
                self.supervise_once()
            except Exception as e:  # the supervisor must outlive any
                # one heal attempt: a failed rebuild is retried on the
                # next tick, visible in the counter — a dead
                # supervisor would silently stop all self-healing
                obs.count(
                    self._OBS + ".supervisor",
                    action="error", exc_type=type(e).__name__,
                )
            self._sup_stop.wait(self._sup_interval)

    def supervise_once(self) -> dict:
        """One supervision pass (the supervisor thread's body, callable
        directly for deterministic tests): detect dead replicas,
        promote a new home first if the HOME died, then rebuild every
        dead replica and re-admit it.  Returns ``{"detected": [...],
        "promoted": new_home | None, "replaced": [...]}``; nothing is
        detected while ``device_error()`` holds a CUDA error, and one
        met here on the shared context ends the pass (module
        docstring). A slot whose heal is backing off
        (``_replace_allowed``) waits for a later tick."""
        with self._sup_lock:
            self._observe_fleet()
            out = {"detected": [], "promoted": None, "replaced": []}
            if self.device_error() is not None:
                return out
            dead = [
                i for i in range(len(self.replicas))
                if i not in self._draining
                and (self._dead(i) or i in self._needs_rebuild)
            ]
            out["detected"] = dead
            if not dead:
                return out
            for i in dead:
                if i not in self._needs_rebuild:
                    obs.count(
                        self._OBS + ".supervisor", action="detected"
                    )
                    self._fleet_event(
                        "replica_dead", replica=i, home=(i == self.home)
                    )
                # sticky until the heal succeeds: a transient rebuild
                # failure below must be RETRIED on the next tick, not
                # forgotten (quarantine flips _dead() false)
                self._needs_rebuild.add(i)
            if self.home in dead:
                try:
                    out["promoted"] = self.promote()
                except RuntimeError as e:
                    if self._keep_device_error(e):
                        return out
                    # no WAL to promote from (or no surviving
                    # replica, or a transient recovery failure):
                    # promote() already quarantined the home — its
                    # buffered futures failed honestly — and the
                    # replace loop below still rebuilds the slot,
                    # so the write lane comes back instead of
                    # staying down
                    obs.count(
                        self._OBS + ".supervisor",
                        action="promotion_failed",
                    )
                    self._fleet_event(
                        "promotion_failed", replica=self.home
                    )
            for i in dead:
                if not self._replace_allowed(i):
                    continue  # backing off: retried on a later tick
                try:
                    self._replace_replica(i)
                except Exception as e:
                    if self._keep_device_error(e):
                        return out  # the card's: heal nothing more
                    # stays in _needs_rebuild: retried next tick
                    self._replace_failed(i)
                    obs.count(
                        self._OBS + ".supervisor",
                        action="replace_error",
                    )
                    self._fleet_event("respawn_failed", replica=i)
                    continue
                self._replace_ok(i)
                out["replaced"].append(i)
                obs.count(self._OBS + ".supervisor", action="replaced")
            return out

    # -- health folding ----------------------------------------------------

    def _fold_status(self, statuses: set, lagging: list) -> str:
        """Fleet status from per-replica statuses: a CUDA error on the
        fleet or any replica = down (the card's); everything ok and nothing lagging
        = ok; anything still serving = degraded; else down."""
        if self.device_error() is not None:
            return "down"
        if statuses <= {"ok"} and not lagging:
            return "ok"
        if "ok" in statuses or "degraded" in statuses:
            return "degraded"  # something still serves
        return "down"

    def _supervisor_alive(self) -> bool:
        return (
            self._sup_thread is not None
            and self._sup_thread.is_alive()
        )
