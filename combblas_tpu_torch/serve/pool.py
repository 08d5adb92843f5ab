"""EnginePool — many resident graphs behind one device; counterpart of
``combblas_tpu/serve/pool.py``.

A ``Server`` is ONE graph and ONE worker thread. The pool takes the lane
horizontal: many tenants' graphs resident behind one device, one worker
thread arbitrated by weighted fair queueing, per-tenant everything
(queues, SLOs, plan caches, circuit breakers, fault injectors), and a
byte-accounted LRU that evicts cold tenants' DEVICE state while
retaining the host inputs — a re-admitted tenant is a REBUILD, not a
reload from nowhere.

Three layers:

* **EnginePool** — tenant → ``GraphEngine`` routing plus residency.
  ``add_tenant`` registers the host COO (and every ``from_coo`` knob)
  and builds the engine; ``admit``/``evict`` move a tenant's device
  state in and out under the ``byte_budget``
  (``COMBBLAS_POOL_BYTE_BUDGET``; 0 = unbounded). Eviction drops the
  engine (its ELL buckets, twins, feature table — everything
  ``GraphVersion.device_bytes`` counts) but keeps the tenant's
  ``Server`` shell alive: queues, breakers, fault rules, write buffers
  and counters all survive, and a later admit rebuilds the engine
  BIT-EXACTLY from the retained host arrays (``from_coo`` is
  deterministic — ``to_host_coo()`` round-trips equal, the tested
  contract; eviction refreshes the rebuild source from the CURRENT
  version's host COO, so acknowledged writes survive the cycle). A
  rebuilt engine's plan cache is cold: re-admission pays its warmup
  again, which is exactly the rebuild-not-reload trade.
* **Per-tenant serving state** — each tenant wraps its engine in a
  WORKER-LESS ``Server`` (the PR-6/PR-9 machinery generalizes per
  tenant for free): its own bounded queue + SLO admission
  (``ServeConfig.slo_queue_budget`` / ``slo_deadline_s`` — rejections
  NAME the tenant), its own per-kind circuit breakers (tenant A's
  poison can never trip tenant B's breaker), its own ``FaultInjector``
  and its own write-lane ``DeltaBuffer``.
* **PoolServer** — the one worker thread that owns the device,
  arbitrating across tenants with ``scheduler.DeficitRoundRobin``:
  each round grants ``quantum x weight`` credit, read batches and
  write merges CHARGE the same meter (write-lane fairness — a
  mutation-heavy tenant spends its own share, it cannot starve other
  tenants' reads), and ``pop_ready(max_batches=1)`` keeps a saturated
  tenant from monopolizing the worker for its whole backlog.

Usage::

    pool = EnginePool(grid, byte_budget=512 << 20)
    pool.add_tenant("acme", rows_a, cols_a, n, weight=3.0)
    pool.add_tenant("bob", rows_b, cols_b, n)
    with pool.serve() as psrv:
        psrv.warmup()
        f = psrv.submit("acme", "bfs", root=7)
        print(f.result()["levels"][:10])

On the card. The pool worker and every off-lock engine build run with
the grid's card as their current CUDA device (``api.device_scope``).
Every tenant's engine shares ONE execution lock: the tenants' batches
run on the card's default stream, one at a time, which is what the
reference's semantics and per-batch timings assume. Uploads stay off
the lock, on the same default stream, so no tensor crosses streams. An
evicted tenant's device memory returns to torch's caching allocator
once nothing holds its version: the engine (plans, analytics) and the
version are dropped with it, and ``gc.collect()`` breaks the cycles of
the plan closures.

Deviations from the reference, kept on purpose:

* "Zero retraces after warm-up" is zero plan builds after warm-up; a
  rebuilt tenant's plans are cold, as in the reference.
* A CUDA error is the card's, not one tenant's: a tenant's ``Server``
  keeps one met in its batch or merge as ``device_error``, and one met
  by the pool worker outside a batch (an admit's rebuild) is kept as the
  pool server's ``device_error``. ``PoolServer.health()`` then reports
  ``down`` and carries the error.
"""

from __future__ import annotations

import threading
import time
import traceback
import sys

from .. import obs
from .api import _is_device_error, device_scope
from .scheduler import DeficitRoundRobin, ServeConfig

#: Fixed wake-poll ceiling of the pool worker when only update-lane
#: deadlines are pending (their exact due time is cheap to compute, so
#: this is a backstop, not a cadence).
_IDLE_WAIT_S = 0.25


class _Tenant:
    """One tenant's registration: host build inputs (retained — the
    rebuild side of evict/admit), the resident engine (or None while
    evicted), and the always-alive Server shell."""

    def __init__(self, name: str, weight: float, build_args: dict,
                 config: ServeConfig):
        self.name = name
        self.weight = float(weight)
        self.build_args = build_args  # host arrays + from_coo knobs
        self.config = config
        self.engine = None            # resident GraphEngine or None
        self.server = None            # worker-less Server (persistent)
        self.busy = False             # a batch of this tenant is on
        #                               the device right now (evict
        #                               must not pull state mid-batch)
        self.admits = 0
        self.evictions = 0
        self.last_used = 0.0          # LRU clock (monotonic)
        self.device_bytes = 0         # accounted at admit/swap
        #: Serializes this tenant's engine BUILD (held outside the
        #: pool lock — one tenant's rebuild must not stall the pool's
        #: whole front door).
        self.build_lock = threading.Lock()


class EnginePool:
    """Tenant → engine routing with byte-accounted LRU residency."""

    def __init__(self, grid, byte_budget: int | None = None):
        from ..tuner import config as tuner_config

        self.grid = grid
        #: Resident-device-byte budget (0 = unbounded). Admitting past
        #: it evicts least-recently-used idle tenants first.
        self.byte_budget = tuner_config.pool_byte_budget(byte_budget)
        self._lock = threading.RLock()
        self._tenants: dict[str, _Tenant] = {}
        self.over_budget = 0  # admits that could not evict under budget
        # ONE execution stream across tenants: every tenant engine
        # shares this lock (installed at admit), so a caller-thread
        # warmup() never interleaves its launches with the pool
        # worker's batch — the tenants share the card's default
        # stream, and one batch at a time is what per-batch timings
        # and the reference's semantics assume.
        self._device_lock = threading.RLock()

    # -- registration ------------------------------------------------------

    def add_tenant(self, name: str, rows, cols, nrows: int, *,
                   weight: float = 1.0,
                   config: ServeConfig | None = None,
                   **from_coo_kw) -> None:
        """Register a tenant graph and admit it. The host arrays (and
        every ``GraphEngine.from_coo`` keyword) are RETAINED for the
        eviction/re-admission cycle."""
        if weight <= 0:
            raise ValueError(
                f"tenant {name!r} needs a positive weight, got {weight}"
            )
        config = config or ServeConfig()
        if config.update_autostart or config.wal_dir is None:
            # the POOL worker owns every tenant's write lane (merges
            # charge the WFQ meter); a per-tenant mutation thread
            # would merge outside the fairness arbiter.  An UNSET
            # wal_dir is pinned to "off" (round 16): N tenants each
            # resolving one ambient COMBBLAS_WAL would fight over a
            # single log/snapshot lineage — pool durability must be
            # an EXPLICIT per-tenant dir on the tenant's config
            import dataclasses

            config = dataclasses.replace(
                config, update_autostart=False,
                wal_dir="off" if config.wal_dir is None
                else config.wal_dir,
            )
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            t = _Tenant(
                name, weight,
                dict(rows=rows, cols=cols, nrows=int(nrows),
                     **from_coo_kw),
                config,
            )
            self._tenants[name] = t
        self.admit(name)

    def remove_tenant(self, name: str) -> None:
        """Drop a tenant entirely (device AND host state). Its server
        shell refuses further admissions, and pending READS and
        buffered WRITES both fail (a removed tenant must never strand
        a future)."""
        with self._lock:
            t = self._tenants.pop(name, None)
        if t is not None and t.server is not None:
            t.server.scheduler.close()
            t.server.scheduler.fail_pending(
                RuntimeError(f"tenant {name!r} removed from pool")
            )
            # abort the write lane too: buffered ops + their futures
            # (the never-started-mutator path of the server's close)
            t.server._stop_mutator(drain=False, timeout=5.0)
            t.engine = None
            t.server.engine = None
        if t is not None:
            # label-space hygiene (round 15): the removed tenant's
            # labeled registry series (queue depth, requests, breaker,
            # WFQ, pool counters) must not live — in memory AND on the
            # scrape surface — forever; the WFQ state prunes in the
            # pump, the registry prunes here, at the churn point
            obs.prune_labels(tenant=name)
        self._gauge_residency()

    def tenant_names(self) -> list[str]:
        with self._lock:
            return list(self._tenants)

    def _get(self, name: str) -> _Tenant:
        with self._lock:
            t = self._tenants.get(name)
        if t is None:
            raise ValueError(
                f"unknown tenant {name!r}; pool serves "
                f"{sorted(self._tenants)}"
            )
        return t

    def _peek(self, name: str) -> "_Tenant | None":
        """Tolerant lookup for callers iterating a NAME SNAPSHOT
        (pump / deadline scans / stats): a tenant removed between the
        snapshot and the lookup is skipped, never raised on — a
        ``remove_tenant`` racing the worker's idle path must not kill
        the worker thread."""
        with self._lock:
            return self._tenants.get(name)

    # -- residency ---------------------------------------------------------

    def engine(self, name: str):
        """The tenant's resident engine (admitting it if evicted) —
        the tenant → GraphEngine route. Touches the LRU clock."""
        return self.admit(name)

    def server(self, name: str):
        """The tenant's worker-less ``Server`` shell (queues, breaker,
        faults, write buffer). Exists from first admit onward, engine
        resident or not."""
        t = self._get(name)
        with self._lock:
            if t.server is not None:
                return t.server
        self.admit(name)
        return t.server

    def admit(self, name: str):
        """Ensure the tenant's device state is resident: build the
        engine from the retained host inputs if evicted, evicting
        least-recently-used idle tenants while the pool sits over its
        byte budget. Returns the engine."""
        t = self._get(name)
        with self._lock:
            t.last_used = time.monotonic()
            if t.engine is not None:
                return t.engine
        return self._build_and_install(t)

    def claim(self, name: str):
        """Admit AND mark busy in one atomic step (the pump's
        pre-batch claim): once this returns, the LRU sweep cannot pull
        the engine out from under the caller's device work — a plain
        ``admit`` followed by ``busy = True`` leaves a window where a
        concurrent admit's budget sweep sees an idle tenant and
        evicts the engine mid-dereference. Pair with ``release``."""
        t = self._get(name)
        while True:
            with self._lock:
                if t.engine is not None:
                    t.busy = True
                    t.last_used = time.monotonic()
                    return t.engine
            self._build_and_install(t)

    def release(self, name: str) -> None:
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                t.busy = False

    def _build_and_install(self, t: _Tenant):
        """(Re)build the tenant's engine OUTSIDE the pool lock — one
        tenant's seconds-long rebuild must not stall every other
        tenant's admission/stats path — then install and account under
        it. ``build_lock`` serializes racing builds of the SAME
        tenant (the loser returns the winner's engine)."""
        from .api import Server
        from .engine import GraphEngine

        with t.build_lock:
            with self._lock:
                if t.engine is not None:  # a racing admit built it
                    return t.engine
            # host bucket pass + device uploads, pool lock NOT held:
            # uploads concurrent with the worker's execution are safe
            # (the dynamic lane's off-lock merge precedent: the same
            # default stream orders them) — only batch launches take
            # the shared lock
            t0 = time.perf_counter()
            with device_scope(self.grid.device):
                engine = GraphEngine.from_coo(self.grid, **t.build_args)
            engine._exec_lock = self._device_lock  # one device stream
            nbytes = engine.version.device_bytes()
            with self._lock:
                t.engine = engine
                t.device_bytes = nbytes
                t.admits += 1
                t.last_used = time.monotonic()
                if t.server is None:
                    t.server = Server(engine, t.config, tenant=t.name)
                else:
                    # the shell survives eviction: reattach the rebuilt
                    # engine under its queues/breakers/fault rules
                    t.server.engine = engine
                obs.count("serve.pool.admits", tenant=t.name)
                obs.observe(
                    "serve.pool.rebuild_s", time.perf_counter() - t0
                )
                self._evict_to_budget(protect=t)
            self._gauge_residency()
            return engine

    def evict(self, name: str, force: bool = False) -> bool:
        """Drop one tenant's device state (host inputs + server shell
        retained). Refuses (returns False) when the tenant is busy or
        has pending work, unless ``force=True`` — forced eviction of a
        tenant with queued requests just means its next pump pays a
        rebuild first."""
        t = self._get(name)
        with self._lock:
            return self._evict_locked(t, force)

    def _idle(self, t: _Tenant) -> bool:
        """No batch on the device, no queued reads, no buffered
        writes — the only tenants the LRU sweep may cold-evict."""
        if t.busy:
            return False
        if t.server is None:
            return True
        if t.server.scheduler.depth() > 0:
            return False
        b = t.server._upd_buffer
        return b is None or b.depth() == 0

    def _evict_locked(self, t: _Tenant, force: bool = False) -> bool:
        if t.engine is None:
            return False
        if t.busy:
            return False  # never pull device state mid-batch
        if not force and not self._idle(t):
            return False
        v = t.engine.version
        if v.host_coo is not None:
            # merged mutations must survive the evict/re-admit cycle:
            # the rebuild source becomes the CURRENT version's retained
            # host COO (deduped — from_coo's re-dedup is the identity
            # on it), not the registration-time arrays, or every
            # acknowledged write would silently vanish at re-admission
            rows, cols, _nc = v.host_coo
            t.build_args["rows"] = rows
            t.build_args["cols"] = cols
            if v.host_weights is not None or "weights" in t.build_args:
                t.build_args["weights"] = v.host_weights
        t.engine = None
        if t.server is not None:
            t.server.engine = None
        t.device_bytes = 0
        t.evictions += 1
        obs.count("serve.pool.evictions", tenant=t.name)
        self._gauge_residency()
        return True

    def _evict_to_budget(self, protect: _Tenant) -> None:
        """LRU sweep (caller holds the lock): evict idle tenants,
        coldest first, until resident bytes fit the budget. The tenant
        being admitted is never a victim; if nothing else is evictable
        the pool runs over budget (counted) rather than refusing to
        serve."""
        if not self.byte_budget:
            return
        while self._resident_bytes_locked() > self.byte_budget:
            victims = sorted(
                (
                    x for x in self._tenants.values()
                    if x is not protect and x.engine is not None
                    and self._idle(x)
                ),
                key=lambda x: x.last_used,
            )
            if not victims:
                self.over_budget += 1
                obs.count("serve.pool.over_budget")
                return
            self._evict_locked(victims[0])

    def _resident_bytes_locked(self) -> int:
        return sum(
            t.device_bytes for t in self._tenants.values()
            if t.engine is not None
        )

    def resident_bytes(self) -> int:
        """Total device bytes of resident tenant versions (the
        ``serve.pool.resident_bytes`` gauge)."""
        with self._lock:
            return self._resident_bytes_locked()

    def _gauge_residency(self) -> None:
        if obs.ENABLED:
            with self._lock:
                obs.gauge(
                    "serve.pool.resident_bytes",
                    self._resident_bytes_locked(),
                )
                obs.gauge(
                    "serve.pool.resident_tenants",
                    sum(
                        1 for t in self._tenants.values()
                        if t.engine is not None
                    ),
                )

    def refresh_bytes(self, name: str) -> int:
        """Re-account one tenant's resident bytes (after a swap/merge
        changed its version) and re-run the budget sweep."""
        t = self._get(name)
        with self._lock:
            if t.engine is not None:
                t.device_bytes = t.engine.version.device_bytes()
                self._evict_to_budget(protect=t)
            self._gauge_residency()
            return t.device_bytes

    # -- front ends --------------------------------------------------------

    def serve(self, quantum: int | None = None) -> "PoolServer":
        return PoolServer(self, quantum=quantum)

    def stats(self) -> dict:
        with self._lock:
            tenants = {
                name: {
                    "resident": t.engine is not None,
                    "device_bytes": t.device_bytes,
                    "admits": t.admits,
                    "evictions": t.evictions,
                    "weight": t.weight,
                    "queue_depth": (
                        t.server.scheduler.depth()
                        if t.server is not None else 0
                    ),
                    "rejected": (
                        t.server.scheduler.rejected
                        if t.server is not None else 0
                    ),
                }
                for name, t in self._tenants.items()
            }
            return {
                "tenants": tenants,
                "resident_bytes": self._resident_bytes_locked(),
                "byte_budget": self.byte_budget,
                "resident_tenants": sum(
                    1 for t in self._tenants.values()
                    if t.engine is not None
                ),
                "over_budget": self.over_budget,
            }


class PoolServer:
    """One worker thread serving every pool tenant under weighted
    fair queueing (see module docstring). The multi-tenant analog of
    ``api.Server``: ``submit``/``submit_update`` route by tenant name,
    ``pump()`` is the deterministic worker body, ``stats()``/
    ``health()`` aggregate per tenant."""

    def __init__(self, pool: EnginePool, quantum: int | None = None):
        self.pool = pool
        self.wfq = DeficitRoundRobin(quantum)
        self._wake = threading.Condition()
        self._stop = False
        self._worker: threading.Thread | None = None
        self._closed = False
        self.worker_errors = 0
        self.last_worker_error: Exception | None = None
        #: a CUDA error the worker met outside a tenant's batch (an
        #: admit's rebuild): health() reports "down" from then on
        self.device_error: Exception | None = None
        self._scrape = None  # obs.export.ScrapeServer (serve_metrics)

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"
                      ) -> int:
        """Attach the pool's live scrape surface (/metrics, /healthz,
        /statz — see ``Server.serve_metrics``); stopped by close()."""
        from ..obs import export

        return export.attach_scrape(self, port=port, host=host)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "PoolServer":
        if self._closed:
            raise RuntimeError(
                "serve.PoolServer is closed; build a new one via "
                "pool.serve()"
            )
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._worker = threading.Thread(
                target=self._run_loop, name="combblas-serve-pool",
                daemon=True,
            )
            self._worker.start()
        return self

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Refuse all tenants' admissions, stop the worker, then drain
        (reads AND pending write merges, in the caller's thread) or
        fail whatever is left."""
        self._closed = True
        for name in self.pool.tenant_names():
            t = self.pool._peek(name)
            if t is not None and t.server is not None:
                t.server.scheduler.close()
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                raise TimeoutError(
                    f"pool worker did not stop within {timeout}s"
                )
            self._worker = None
        if drain:
            while self.pump(force=True):
                pass
        # per-tenant shutdown: queues are empty after the drain; a
        # no-drain close fails pending reads and aborts buffered writes
        # through each tenant server's own close path
        for name in self.pool.tenant_names():
            t = self.pool._peek(name)
            if t is not None and t.server is not None:
                t.server.close(drain=False, timeout=timeout)
        if self._scrape is not None:
            from ..obs import export

            export.detach_scrape(self)

    def __enter__(self) -> "PoolServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- front door --------------------------------------------------------

    def submit(self, tenant: str, kind: str, root,
               timeout_s: float | None = None, trace=None):
        """Admit one query for ``tenant`` — the tenant's own bounded
        queue, SLO budget, breaker and fault injector decide
        (rejections name the tenant); no device work happens here.
        ``trace`` adopts the net frontend's live trace object (round
        19 — see scheduler.submit)."""
        t = self.pool._get(tenant)
        srv = self.pool.server(tenant)
        fut = srv.submit(kind, root, timeout_s=timeout_s, trace=trace)
        t.last_used = time.monotonic()
        with self._wake:
            self._wake.notify_all()
        return fut

    def submit_many(self, tenant: str, kind: str, roots,
                    timeout_s: float | None = None) -> list:
        srv = self.pool.server(tenant)
        out = srv.submit_many(kind, roots, timeout_s=timeout_s)
        with self._wake:
            self._wake.notify_all()
        return out

    def submit_update(self, tenant: str, ops):
        """Admit edge mutations for ``tenant``'s graph. The merge runs
        on the POOL worker under the same WFQ meter as reads (write-
        lane fairness); admission needs the engine resident for the
        version check, so an evicted tenant re-admits here —
        claim/release, so a concurrent budget sweep cannot evict it
        between the admit and the version check."""
        self.pool.claim(tenant)
        try:
            srv = self.pool.server(tenant)
            fut = srv.submit_update(ops)
        finally:
            self.pool.release(tenant)
        with self._wake:
            self._wake.notify_all()
        return fut

    def faults(self, tenant: str):
        """The tenant's own ``FaultInjector`` — per-tenant by
        construction, so one tenant's chaos rules never fire in
        another's execution path."""
        return self.pool.server(tenant).faults

    def warmup(self, tenant: str | None = None, **kw) -> dict:
        """Warm one tenant's plans (or every registered tenant's).
        Admits as needed — warming IS a residency claim."""
        names = (
            [tenant] if tenant is not None
            else self.pool.tenant_names()
        )
        out = {}
        for name in names:
            self.pool.admit(name)
            out[name] = self.pool.server(name).warmup(**kw)
        return out

    # -- the WFQ pump ------------------------------------------------------

    def _updates_due(self, srv, now: float, force: bool) -> bool:
        if force:
            b = srv._upd_buffer
            return b is not None and b.depth() > 0
        return srv._updates_due(now)

    def pump(self, force: bool = False) -> int:
        """One deficit-round-robin scheduling round across every
        backlogged tenant (the worker's body; callable directly for
        deterministic tests). Writes flush FIRST when due (they carry
        their own deadline), then reads while the tenant's balance
        lasts — both charge the same per-tenant meter. Returns
        read-batches + write-merges executed."""
        pool = self.pool
        now = time.monotonic()
        names = pool.tenant_names()
        # tenant churn must not leak WFQ state — nor the dead names'
        # obs label space (prune() returns what it dropped)
        for gone in self.wfq.prune(names):
            obs.prune_labels(tenant=gone)
        backlogged = []
        for name in names:
            t = pool._peek(name)
            if t is None:
                continue  # removed since the snapshot
            self.wfq.add(name, t.weight)  # keeps weight current
            srv = t.server
            if srv is None:
                continue
            if (
                srv.scheduler.has_ready(now)
                or (force and srv.scheduler.depth() > 0)
                or self._updates_due(srv, now, force)
            ):
                backlogged.append(name)
        if not backlogged:
            return 0
        executed = 0
        for name in self.wfq.round(backlogged):
            t = pool._peek(name)
            if t is None or t.server is None:
                continue  # removed mid-round
            srv = t.server
            # write lane first when due: merges have their own
            # deadline (update_max_delay_s) and spend the tenant's
            # share like any read batch would.  claim() admits + marks
            # busy ATOMICALLY — a plain admit-then-busy leaves a
            # window where another thread's budget sweep sees an idle
            # tenant and evicts the engine mid-batch
            if self._updates_due(srv, now, force):
                pool.claim(name)
                try:
                    ops = srv.pump_updates(force=True)
                finally:
                    pool.release(name)
                if ops:
                    self.wfq.charge(name, ops)
                    pool.refresh_bytes(name)
                    executed += 1
            while self.wfq.balance(name) > 0:
                batches = srv.scheduler.pop_ready(
                    force=force, max_batches=1
                )
                if not batches:
                    break
                pool.claim(name)
                try:
                    for reqs in batches:
                        srv._run_batch(reqs)
                        self.wfq.charge(name, len(reqs))
                        executed += 1
                finally:
                    pool.release(name)
        return executed

    # -- worker ------------------------------------------------------------

    def _next_deadline(self) -> float | None:
        deadlines = []
        for name in self.pool.tenant_names():
            t = self.pool._peek(name)
            srv = t.server if t is not None else None
            if srv is None:
                continue
            d = srv.scheduler.next_deadline()
            if d is not None:
                deadlines.append(d)
            b = srv._upd_buffer
            if b is not None:
                age = b.oldest_age()
                if age is not None:
                    deadlines.append(
                        time.monotonic()
                        + max(srv.config.update_max_delay_s - age, 0.0)
                    )
        return min(deadlines) if deadlines else None

    def _has_ready(self) -> bool:
        now = time.monotonic()
        for name in self.pool.tenant_names():
            t = self.pool._peek(name)
            srv = t.server if t is not None else None
            if srv is None:
                continue
            if srv.scheduler.has_ready(now) or srv._updates_due(now):
                return True
        return False

    def _run_loop(self) -> None:
        with device_scope(self.pool.grid.device):
            self._loop()

    def _loop(self) -> None:
        while True:
            with self._wake:
                if self._stop:
                    break
            try:
                pumped = self.pump()
                if pumped:
                    continue
            except Exception as e:  # scheduler-bug backstop, like the
                # single-tenant worker: the pool must outlive any one
                # pump — settle nothing here (the recovery ladder
                # already settled batch failures), back off briefly
                self.worker_errors += 1
                self.last_worker_error = e
                if _is_device_error(e) and self.device_error is None:
                    self.device_error = e
                obs.count(
                    "serve.worker.errors", exc_type=type(e).__name__,
                    pool=1,
                )
                traceback.print_exc(file=sys.stderr)
                time.sleep(0.05)
                continue
            with self._wake:
                if self._stop:
                    break
                if self._has_ready():
                    continue
                deadline = self._next_deadline()
                if deadline is None:
                    self._wake.wait(_IDLE_WAIT_S)
                else:
                    delay = deadline - time.monotonic()
                    if delay > 0:
                        self._wake.wait(min(delay, _IDLE_WAIT_S))

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Pool + per-tenant serving stats: residency/bytes from the
        pool, queue/breaker/disposition from each tenant's server
        (labeled by tenant), WFQ shares from the arbiter."""
        out = self.pool.stats()
        out["wfq"] = self.wfq.describe()
        per_tenant = {}
        for name in self.pool.tenant_names():
            t = self.pool._peek(name)
            if t is None or t.server is None:
                continue
            if t.engine is not None:
                per_tenant[name] = t.server.stats()
            else:  # evicted: engine-side stats unavailable, the
                # scheduler side still reports
                sch = t.server.scheduler
                per_tenant[name] = {
                    "tenant": name,
                    "resident": False,
                    "queue_depth": sch.depth(),
                    "submitted": sch.submitted,
                    "rejected": sch.rejected,
                }
        out["servers"] = per_tenant
        out["worker_errors"] = self.worker_errors
        return out

    def health(self) -> dict:
        """Pool liveness: ``ok`` / ``degraded`` (some tenant's breaker
        not closed) / ``down`` (started worker died, or a CUDA error
        poisoned the card: ``device_error``) / ``closed``, with each
        tenant's breaker states labeled by tenant."""
        now = time.monotonic()
        breakers = {}
        slo_burn = {}
        degraded = False
        device_error = self.device_error
        for name in self.pool.tenant_names():
            t = self.pool._peek(name)
            srv = t.server if t is not None else None
            if srv is None:
                continue
            if device_error is None:
                device_error = srv.device_error
            b = {
                k: br.describe(now)
                for k, br in srv.scheduler.breakers.items()
            }
            breakers[name] = b
            if any(x["state"] != "closed" for x in b.values()):
                degraded = True
            if srv.slo is not None:
                d = srv.slo.describe(now)
                slo_burn[name] = d["burn"]
                if d["breached"]:
                    degraded = True
        if self._closed:
            status = "closed"
        elif device_error is not None:
            status = "down"  # the card's context is poisoned
        elif self._worker is not None and not self._worker.is_alive():
            status = "down"
        elif degraded:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "worker_alive": (
                self._worker is not None and self._worker.is_alive()
            ),
            "closed": self._closed,
            "breakers": breakers,
            # per-tenant SLO budget burn (round 15) — the one number a
            # pool dashboard pages on, worst tenant first
            "slo_burn": slo_burn,
            "slo_burn_worst": max(slo_burn.values()) if slo_burn else None,
            "resident_bytes": self.pool.resident_bytes(),
            "byte_budget": self.pool.byte_budget,
            "worker_errors": self.worker_errors,
            "device_error": (
                repr(device_error) if device_error is not None else None
            ),
        }
