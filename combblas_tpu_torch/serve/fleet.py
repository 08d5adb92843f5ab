"""FleetRouter — N replica servers behind one front door; counterpart of
``combblas_tpu/serve/fleet.py``.

The horizontal half of the serving story: the pool multiplexes many
GRAPHS behind one device; the fleet multiplexes many REPLICAS of one
graph behind one router, the shape a real service scales reads with.
Properties that make it more than a load balancer:

* **One warm plan store.** Every replica resolves routing and records
  serve warmup lanes through the SAME ``tuner.store`` JSONL (already
  multi-process-safe, append-only, torn-write tolerant) — the first
  replica's traffic teaches the store which (kind, width) lanes the mix
  uses, and every later replica's ``warmup()`` replays them to
  zero-retrace steady state without re-discovering anything
  (docs/autotuning.md "Shipping plans to a fleet", now code).
* **Warm starts from snapshots.** ``FleetRouter.from_checkpoint``
  boots every replica from one ``utils.checkpoint.save_version``
  GraphVersion snapshot: bucket arrays re-upload bit-identically
  (``EllParMat.from_host_buckets`` — no dedup sort, no bucket pass), so
  a cold replica reaches the same zero-retrace state as the donor
  without ever seeing the COO.
* **Writes route HOME, versions fan OUT.** ``submit_update`` goes to
  one home replica (a single merge lineage — no cross-replica merge
  conflicts to resolve); once its merge lands, ``fan_out`` rebuilds
  each other replica's version OFF its execution lock from the home
  version's retained host COO and applies it through the existing
  atomic ``swap_graph`` — readers on every replica keep serving the old
  version mid-build and flip in one pointer swap (incremental merges
  preserve operand shapes, so the warm plans survive fleet-wide).
* **Durability + self-healing (round 16, docs/serving.md "Durability
  & self-healing").** With a durability dir configured (``wal_dir`` /
  ``COMBBLAS_WAL``), the HOME replica owns the write-ahead log and the
  background checkpointer — acknowledged writes survive any process
  crash.  A ``start_supervisor()`` thread (or deterministic
  ``supervise_once()`` calls) detects replicas whose worker thread
  died, QUARANTINES them (pending futures failed honestly — never
  silently dropped), rebuilds replacements OFF-lock from
  checkpoint+WAL (or the home's retained COO when not durable) and
  re-admits them warm; a dead HOME is first replaced by PROMOTING a
  surviving replica to the WAL's seqno frontier — the single merge
  lineage is preserved because the frontier is exactly "every
  acknowledged write".  ``drain()``/``restore()``/``rolling_restart()``
  make upgrades a first-class operation, and reads that fail
  execution-side are retried (bounded, reads only) on the next-best
  replica.

The routing / read-retry / supervision policy lives in
``serve/policy.py`` (:class:`ReplicaFleetBase`).  This class keeps the
thread-hosted specifics: worker-thread death detection, in-process
rebuild/promotion, the shared exec lock.

Thread-hosted replicas: each ``Server`` owns its own engine, queue,
breakers and worker thread inside this process, all on one card.
"Replica death" is worker-thread death (the ``replica.death`` fault
point).

On the card. The fan-out (run inside the home's write callback on its
mutation thread), the promotion and the supervisor's replacements build
and upload with the grid's card as the current CUDA device
(``api.device_scope``). Every replica's engine shares ONE execution
lock: the replicas' batches run on the card's default stream one at a
time, which is what the reference's semantics and per-batch timings
assume; uploads stay off it, on the same stream. An old version freed
after ``swap_graph`` is safe to reuse for the same reason: the default
stream orders the worker's kernels before any later use of its memory.

Deviations from the reference, kept on purpose:

* "Zero retraces after warm-up" is zero plan builds after warm-up.
* A CUDA error is the card's, not one replica's (``policy.py``): it is
  not retried on another replica; one met by a fan-out, a promotion, a
  replacement or a warm-up is kept on the fleet and raised (a write
  whose fan-out meets one fails); supervision heals nothing while the
  fleet or a replica holds one, and ``health()`` reports ``down`` with
  the error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from .. import obs
from .api import device_scope
from .batcher import settle
from .faults import FaultInjector
from .policy import ReplicaDeadError, ReplicaFleetBase
from .scheduler import ServeConfig

__all__ = ["FleetRouter", "ReplicaDeadError"]


def _strip_wal(cfg: ServeConfig, keep: str | None) -> ServeConfig:
    """Per-replica durability config: the home replica gets the
    resolved dir, every other replica gets an EXPLICIT "off" — an
    ambient ``COMBBLAS_WAL`` must not make N replicas fight over one
    log file with N bootstrap snapshots."""
    return dataclasses.replace(
        cfg, wal_dir=(keep if keep is not None else "off")
    )


class FleetRouter(ReplicaFleetBase):
    """Front door over N replica ``Server``s sharing one plan store."""

    #: Every replica runs on this process's CUDA context: a CUDA error
    #: is the card's (``policy.py``).
    _SHARED_CONTEXT = True

    def __init__(self, servers, build_kw: dict | None = None):
        if not servers:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas = list(servers)
        #: Index of the replica all writes route to (one merge lineage):
        #: the first, until a promotion moves it.
        self.home = 0
        #: ``build_version`` keywords fan-out rebuilds with (symmetric=
        #: etc. — must match how the replicas were built).
        self.build_kw = dict(build_kw or {})
        # ONE execution stream across replicas: thread-hosted replicas
        # share the card and its default stream, so every replica
        # engine's exec lock is replaced with one shared lock — their
        # batches run one at a time, as the reference's semantics and
        # per-batch timings assume.
        self._device_lock = threading.RLock()
        for s in self.replicas:
            s.engine._exec_lock = self._device_lock
        self._fan_lock = threading.Lock()  # one fan-out at a time
        self._scrape = None  # obs.export.ScrapeServer (serve_metrics)
        #: Fleet-level fault injection (the ``fleet.fanout`` point).
        self.faults = FaultInjector()
        #: Durability dir (the home's) — promotion / replacement source.
        self.wal_dir = self.replicas[self.home]._ckpt_dir
        self._init_policy()  # routing/supervision state (policy.py)
        obs.gauge("serve.fleet.replicas", len(self.replicas))

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"
                      ) -> int:
        """Attach the fleet's live scrape surface (/metrics, /healthz,
        /statz — see ``Server.serve_metrics``); stopped by close()."""
        from ..obs import export

        return export.attach_scrape(self, port=port, host=host)

    # -- construction ------------------------------------------------------

    @staticmethod
    def _resolved_wal(wal_dir, config) -> str | None:
        from ..tuner import config as tuner_config

        return tuner_config.wal_dir(
            wal_dir if wal_dir is not None
            else (config.wal_dir if config is not None else None)
        )

    @staticmethod
    def build(grid, rows, cols, nrows: int, *,
              replicas: int | None = None,
              config: ServeConfig | None = None,
              start: bool = True,
              wal_dir: str | None = None,
              **from_coo_kw) -> "FleetRouter":
        """Build N replicas from one COO (``COMBBLAS_FLEET_REPLICAS``
        defaults the count). The home replica (the first) keeps the host
        edge list
        (``keep_coo=True`` forced) — it feeds both the write lane and
        the fan-out rebuilds.  ``wal_dir`` (argument > config >
        ``COMBBLAS_WAL``) attaches the durability layer to the HOME
        replica: write-ahead log + background checkpointer."""
        from .api import Server
        from .engine import GraphEngine
        from ..tuner import config as tuner_config

        n = tuner_config.fleet_replicas(replicas)
        resolved = FleetRouter._resolved_wal(wal_dir, config)
        servers = []
        for i in range(n):
            kw = dict(from_coo_kw)
            if i == 0:
                kw["keep_coo"] = True
            eng = GraphEngine.from_coo(grid, rows, cols, nrows, **kw)
            servers.append(
                Server(
                    eng,
                    _strip_wal(
                        config or ServeConfig(),
                        resolved if i == 0 else None,
                    ),
                    tenant=f"replica{i}",
                )
            )
        build_kw = {
            k: from_coo_kw[k] for k in ("symmetric",)
            if k in from_coo_kw
        }
        router = FleetRouter(servers, build_kw=build_kw)
        if start:
            for s in servers:
                s.start()
        return router

    @staticmethod
    def from_checkpoint(path: str, grid, *,
                        replicas: int | None = None,
                        config: ServeConfig | None = None,
                        kinds=None, start: bool = True,
                        wal_dir: str | None = None) -> "FleetRouter":
        """Boot N replicas from one ``save_version`` snapshot — the
        cold-replica warm start: every replica's version re-uploads the
        donor's exact bucket shapes (zero retraces once warmed; the
        checkpoint round-trip regression test in
        tests/test_serve_fleet.py pins this).  ``kinds=None`` derives
        the servable kinds from the snapshot's artifacts.  Fan-outs
        rebuild the graph as symmetric."""
        from .api import Server
        from .engine import GraphEngine
        from ..tuner import config as tuner_config
        from ..utils import checkpoint

        n = tuner_config.fleet_replicas(replicas)
        resolved = FleetRouter._resolved_wal(wal_dir, config)
        servers = []
        for i in range(n):
            # one independent version per replica: engines swap and
            # version-stamp independently, so sharing one GraphVersion
            # object would cross-wire their lineages.  Only the HOME
            # loads writable — read replicas must not each pin an
            # O(nnz) host copy of the merge-state source
            v = checkpoint.load_version(
                path, grid, writable=(i == 0)
            )
            eng = GraphEngine(grid, version=v, kinds=kinds)
            servers.append(
                Server(
                    eng,
                    _strip_wal(
                        config or ServeConfig(),
                        resolved if i == 0 else None,
                    ),
                    tenant=f"replica{i}",
                )
            )
        router = FleetRouter(servers)
        if start:
            for s in servers:
                s.start()
        return router

    @staticmethod
    def from_recovery(grid, *, replicas: int | None = None,
                      config: ServeConfig | None = None,
                      kinds=None, start: bool = True,
                      wal_dir: str | None = None) -> "FleetRouter":
        """Boot a whole fleet from crash recovery (round 16): every
        replica's version = latest valid snapshot + WAL-suffix replay
        (``dynamic.wal.recover_version`` — bit-exact with the fleet
        that crashed, every acknowledged write included), the home
        re-attached to the WAL at the seqno frontier.  With the shared
        plan store populated, ``warmup()`` replays the remembered
        lanes — warm plans, zero retraces, zero re-measurement.
        Fan-outs rebuild the graph as symmetric."""
        from .api import Server
        from .engine import GraphEngine
        from ..dynamic import wal as dyn_wal
        from ..tuner import config as tuner_config

        resolved = FleetRouter._resolved_wal(wal_dir, config)
        if resolved is None:
            raise ValueError(
                "FleetRouter.from_recovery needs a durability dir "
                "(wal_dir=, ServeConfig.wal_dir or COMBBLAS_WAL)"
            )
        n = tuner_config.fleet_replicas(replicas)
        servers = []
        for i in range(n):
            cfg_i = _strip_wal(
                config or ServeConfig(), resolved if i == 0 else None
            )
            if i == 0:
                servers.append(Server.from_recovery(
                    grid, cfg_i, kinds=kinds, tenant=f"replica{i}"
                ))
                continue
            v = dyn_wal.recover(resolved, grid, kinds=kinds)
            eng = GraphEngine(grid, version=v, kinds=kinds)
            servers.append(
                Server(eng, cfg_i, tenant=f"replica{i}")
            )
        router = FleetRouter(servers)
        if start:
            for s in servers:
                s.start()
        return router

    # -- read path: routing/spillover/read-retry live in policy.py ---------

    # -- write path --------------------------------------------------------

    def submit_update(self, ops):
        """Route a mutation batch to the HOME replica; once its merge
        lands, fan the new version out to every other replica through
        the atomic swap. The returned future resolves (with the home
        merge payload plus ``fanned_out``) after the serving fleet
        runs the new version — a replica whose rebuild failed mid-fan
        LAGS visibly (``versions_behind``, degraded health, retried on
        the next fan-out) instead of failing the write."""
        from concurrent.futures import Future

        inner = self.replicas[self.home].submit_update(ops)
        outer: Future = Future()

        def _after_merge(f):
            exc = f.exception()
            if exc is not None:
                settle(outer, exc=exc)
                return
            payload = dict(f.result())
            # the home server's write-lane trace rides on the inner
            # future; this callback runs INSIDE its settle (before the
            # trace is finished), so a fan-out mark lands in the
            # committed record between the swap and settle stages
            tr = getattr(f, "_combblas_trace", None)
            try:
                payload["fanned_out"] = self.fan_out()
                payload["lagging"] = self.lagging()
                if tr is not None:
                    tr.mark("fanout")
            except Exception as e:  # fan_out itself tolerates
                # per-replica failures; reaching here means the fan
                # could not run at all (e.g. the home lost its COO) —
                # a divergence the caller must see
                settle(outer, exc=e)
                return
            settle(outer, result=payload)

        inner.add_done_callback(_after_merge)
        return outer

    def fan_out(self) -> int:
        """Propagate the home replica's CURRENT version to every other
        serving replica: rebuild each replica's own version from the
        home version's retained host COO (off that replica's execution
        lock — its readers keep serving) and swap atomically.

        Round 16: a replica whose rebuild/swap FAILS (or that is
        dead/draining) no longer aborts the fleet — it stays on its
        old version, counted and gauged per replica
        (``serve.fleet.versions_behind``), degrades fleet ``health()``
        and is RETRIED on the next fan-out (every fan-out rebuilds all
        lagging replicas from the current home version).  Returns
        replicas updated this call."""
        with self._fan_lock, device_scope(
            self.replicas[self.home].engine.grid.device
        ):
            v = self.replicas[self.home].engine.version
            if v.host_coo is None:
                raise ValueError(
                    "fan_out needs the home replica's host edge list: "
                    "build the fleet via FleetRouter.build (or "
                    "from_coo(keep_coo=True))"
                )
            rows, cols, _nc = v.host_coo
            weights = v.host_weights
            self._fan_gen += 1
            gen = self._fan_gen
            t0 = time.perf_counter()
            n = 0
            for i, srv in enumerate(self.replicas):
                if i == self.home:
                    self._replica_gen[i] = gen
                    continue
                if i in self._draining or not srv.is_serving():
                    # dead/draining replicas lag on purpose — the
                    # supervisor (or restore()) rebuilds them at the
                    # frontier, where they catch up in one step
                    continue
                try:
                    self.faults.check("fleet.fanout", replica=i)
                    nv = srv.engine.build_version(
                        rows, cols, weights=weights, keep_coo=False,
                        **self.build_kw,
                    )
                    srv.swap_graph(nv)
                    self._replica_gen[i] = gen
                    n += 1
                except Exception as e:
                    if self._keep_device_error(e):
                        raise  # the card's, not this replica's
                    obs.count("serve.fleet.fanout_failed", replica=i)
            self.fanouts += 1
            obs.count("serve.fleet.fanout")
            obs.observe(
                "serve.fleet.fanout_s", time.perf_counter() - t0
            )
            for i in range(len(self.replicas)):
                obs.gauge(
                    "serve.fleet.versions_behind",
                    gen - self._replica_gen[i], replica=i,
                )
            return n

    # -- self-healing: thread-fleet liveness + heal verbs ------------------

    def _dead(self, i: int) -> bool:
        """Worker-thread death: started once, no longer running, and
        not closed by us (closed = deliberate)."""
        s = self.replicas[i]
        w = s._worker
        return (
            w is not None and not w.is_alive()
            and not s._stop and not s.scheduler.closed
        )

    def promote(self) -> int:
        """Promote a surviving replica to HOME (round 16) — the
        dead-home failover.  The single merge lineage is preserved by
        promoting AT THE WAL'S SEQNO FRONTIER: the new home's version
        is ``recover_version`` (latest snapshot + full WAL-suffix
        replay), which contains exactly every ACKNOWLEDGED write —
        including writes the dead home had buffered but not merged.
        Those buffered writes' futures are failed honestly
        (``ReplicaDeadError``; the data itself is durable and present
        at the frontier — the futures' callers just never got their
        merge confirmation).  The WAL and checkpointer re-attach to
        the new home; the dead ex-home becomes a regular replica slot
        for ``_replace_replica``.  The least-loaded serving survivor
        becomes the new home.  Returns the new home index."""
        grid = self.replicas[self.home].engine.grid
        with self._sup_lock, device_scope(grid.device):
            old = self.home
            old_srv = self.replicas[old]
            if self.wal_dir is None:
                # no WAL: the un-merged buffered writes died with the
                # home (there is no durable record to promote from) —
                # fail them honestly and surface the degraded fleet;
                # reads keep serving on the other replicas
                old_srv.quarantine(ReplicaDeadError(
                    f"home replica {old} died without a WAL; buffered "
                    "writes are lost (configure wal_dir for durable "
                    "failover)"
                ))
                raise RuntimeError(
                    "home promotion needs fleet durability (wal_dir / "
                    "COMBBLAS_WAL): without a write-ahead log the "
                    "write lineage died with the home replica"
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
            # 1. fail the dead home's pending futures honestly (reads
            #    AND buffered writes; acknowledged writes are in the
            #    WAL and reappear at the recovered frontier below)
            old_srv.quarantine(ReplicaDeadError(
                f"home replica {old} died; promoting replica "
                f"{new_home} at the WAL frontier (acknowledged "
                "writes are durable and replayed there)"
            ))
            # 2. bring the new home to the frontier: snapshot + full
            #    WAL-suffix replay = every acknowledged write
            from ..dynamic import wal as dyn_wal

            ns = self.replicas[new_home]
            v = dyn_wal.recover(
                self.wal_dir, ns.engine.grid, kinds=ns.engine.kinds()
            )
            ns.swap_graph(v)
            # 3. the write lane follows the lineage: WAL + background
            #    checkpointer re-attach to the new home
            ns.attach_durability(self.wal_dir)
            # the recovered version's bucket shapes (the donor's
            # sticky layout) may differ from the fan-out-rebuilt ones
            # this replica served: re-warm so steady state stays
            # zero-retrace after the promotion
            try:
                ns.warmup()
            except Exception as e:
                if self._keep_device_error(e):
                    raise
                obs.count(
                    "serve.fleet.supervisor", action="warmup_error"
                )
            self.home = new_home
            self._replica_gen[new_home] = self._fan_gen
            self.promotions += 1
            obs.count("serve.fleet.promotions")
            # propagate the recovered frontier to the SURVIVING
            # replicas NOW: the recovery may contain acknowledged
            # writes the dead home never fanned out, and waiting for
            # the next write (possibly never, on a read-heavy
            # service) would serve split-brain reads while health()
            # reports ok.  Best-effort: a failed rebuild lags visibly
            # (versions_behind / degraded health) as usual.
            try:
                self.fan_out()
            except Exception as e:
                if self._keep_device_error(e):
                    raise
                obs.count(
                    "serve.fleet.supervisor", action="fanout_error"
                )
            return new_home

    def _spawn_replica(self, i: int, engine, started: bool) -> None:
        """Install a fresh ``Server`` shell around ``engine`` at slot
        ``i`` (shared exec lock, same tenant label), warmed from the
        shared plan store before it takes traffic."""
        from .api import Server

        cfg = _strip_wal(
            self.replicas[i].config,
            self.wal_dir if i == self.home else None,
        )
        engine._exec_lock = self._device_lock
        new = Server(engine, cfg, tenant=f"replica{i}")
        if started:
            new.start()
        # warm BEFORE admitting traffic: the shared store replays the
        # fleet's remembered lanes, so the replacement reaches
        # zero-retrace steady state off the routing path
        try:
            new.warmup()
        except Exception as e:
            if self._keep_device_error(e):
                # the shell is never installed: stop its worker, then
                # raise the card's error
                with contextlib.suppress(Exception):
                    new.close(drain=False)
                raise
            obs.count("serve.fleet.supervisor", action="warmup_error")
        self.replicas[i] = new
        self._replica_gen[i] = self._fan_gen
        self._needs_rebuild.discard(i)  # the slot is healed

    def _replace_replica(self, i: int) -> None:
        """Rebuild a DEAD replica off-lock and re-admit it: from
        checkpoint+WAL when durable (the crash-consistent source),
        else from the home version's retained host COO (the fan-out
        recipe).  The dead server's pending futures were already
        failed by ``promote``/``quarantine`` — or are failed here."""
        from .engine import GraphEngine

        old = self.replicas[i]
        if not old.scheduler.closed:  # promote() may have quarantined
            old.quarantine(ReplicaDeadError(
                f"replica {i} worker died; the fleet supervisor is "
                "rebuilding a replacement"
            ))
        grid = old.engine.grid
        kinds = old.engine.kinds()
        with device_scope(grid.device):
            if self.wal_dir is not None:
                from ..dynamic import wal as dyn_wal

                v = dyn_wal.recover(self.wal_dir, grid, kinds=kinds)
                engine = GraphEngine(grid, version=v, kinds=kinds)
            else:
                hv = self.replicas[self.home].engine.version
                if hv.host_coo is None:
                    raise RuntimeError(
                        "cannot rebuild a dead replica: no durability "
                        "dir and the home retained no host COO"
                    )
                rows, cols, _nc = hv.host_coo
                engine = GraphEngine.from_coo(
                    grid, rows, cols, int(hv.nrows),
                    weights=hv.host_weights, kinds=kinds,
                    # a rebuilt HOME must keep feeding the write lane
                    # and the fan-out rebuilds (the non-durable fresh
                    # lineage)
                    keep_coo=(i == self.home),
                    **self.build_kw,
                )
            self._spawn_replica(i, engine, started=True)
        self.replacements += 1
        obs.count("serve.fleet.replaced", replica=i)

    def drain(self, i: int, timeout: float = 30.0) -> None:
        """Take replica ``i`` out of rotation and close it CLEANLY —
        queued reads execute, buffered writes merge (and, on a durable
        home, checkpoint), then the worker stops.  The first half of a
        rolling restart; ``restore()`` re-admits the slot.  Draining
        the HOME makes writes reject until it is restored (one write
        lineage — by design)."""
        with self._sup_lock:
            if not (0 <= i < len(self.replicas)):
                raise ValueError(f"no replica {i}")
            self._draining.add(i)
            self._drain_gen[i] = self._fan_gen
        obs.count("serve.fleet.drained", replica=i)
        self._fleet_event("drain", replica=i, home=(i == self.home))
        self.replicas[i].close(drain=True, timeout=timeout)

    def restore(self, i: int) -> None:
        """Re-admit a drained replica: a fresh ``Server`` shell around
        the SAME (healthy, warm) engine — plan cache intact, zero
        rebuild, zero retraces.  A durable home re-attaches the WAL at
        the frontier it drained to.  A replica that missed fan-outs
        while draining is healed with one immediate fan-out instead of
        silently serving stale versions."""
        with self._sup_lock:
            if i not in self._draining:
                raise ValueError(
                    f"replica {i} is not draining (drain() first)"
                )
            self._spawn_replica(i, self.replicas[i].engine,
                                started=True)
            if i != self.home:
                # the engine's content is whatever it drained at —
                # fan-outs during the drain skipped it on purpose
                self._replica_gen[i] = self._drain_gen.pop(
                    i, self._fan_gen
                )
            else:
                self._drain_gen.pop(i, None)
            self._draining.discard(i)
        obs.count("serve.fleet.restored", replica=i)
        self._fleet_event("restore", replica=i, home=(i == self.home))
        if (
            self._replica_gen[i] < self._fan_gen
            and self.replicas[self.home].engine.version.host_coo
            is not None
        ):
            self.fan_out()  # catch the restored replica up NOW

    def rolling_restart(self, timeout: float = 30.0) -> int:
        """Upgrade-style rolling restart: drain + restore each replica
        in turn, non-home replicas first, the home LAST (its drain
        flushes the write lane through merge + checkpoint, so the
        restarted home resumes at a clean frontier).  At most one
        replica is out of rotation at a time; reads keep serving
        throughout.  Returns replicas restarted."""
        order = [
            i for i in range(len(self.replicas)) if i != self.home
        ] + [self.home]
        n = 0
        for i in order:
            self.drain(i, timeout=timeout)
            self.restore(i)
            n += 1
        obs.count("serve.fleet.rolling_restarts")
        self._fleet_event("rolling_restart", replicas=n)
        return n

    # -- lifecycle / introspection -----------------------------------------

    def warmup(self, **kw) -> dict:
        """Warm every replica. With the shared plan store populated
        (a prior replica's traffic), each replica pre-traces the
        remembered lanes — the fleet-wide zero-retrace claim."""
        return {
            i: srv.warmup(**kw) for i, srv in enumerate(self.replicas)
        }

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        self.stop_supervisor(timeout)
        # non-home replicas first, the home LAST: its close flushes
        # pending write merges (drain=True), and a fan-out callback
        # running inside those merges' settle can still swap the
        # already-stopped replicas' engines consistently
        order = [
            i for i in range(len(self.replicas)) if i != self.home
        ] + [self.home]
        for i in order:
            self.replicas[i].close(drain=drain, timeout=timeout)
        if self._scrape is not None:
            from ..obs import export

            export.detach_scrape(self)

    def __enter__(self) -> "FleetRouter":
        for srv in self.replicas:
            srv.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        return {
            "replicas": len(self.replicas),
            "home": self.home,
            "routed": list(self.submitted),
            "spillovers": self.spillovers,
            "fanouts": self.fanouts,
            "lagging": self.lagging(),
            "promotions": self.promotions,
            "replacements": self.replacements,
            "read_retries": self.read_retries,
            "draining": sorted(self._draining),
            "supervisor_alive": self._supervisor_alive(),
            "wal_dir": self.wal_dir,
            "per_replica": {
                i: srv.stats() for i, srv in enumerate(self.replicas)
            },
        }

    def health(self) -> dict:
        per = {i: srv.health() for i, srv in enumerate(self.replicas)}
        statuses = {h["status"] for h in per.values()}
        lagging = self.lagging()
        burns = {
            i: h["slo"]["burn"]
            for i, h in per.items() if h.get("slo") is not None
        }
        err = self.device_error()
        return {
            "status": self._fold_status(statuses, lagging),
            "device_error": repr(err) if err is not None else None,
            "replicas": per,
            "home": self.home,
            # round 16: replicas behind the home's latest fan-out
            # (failed rebuilds / dead replicas) degrade the fleet
            # until the next fan-out or the supervisor heals them
            "lagging": lagging,
            "draining": sorted(self._draining),
            "supervisor_alive": self._supervisor_alive(),
            "durable": self.wal_dir is not None,
            # fleet-wide SLO budget burn (round 15): worst replica —
            # the pageable number when replicas share one SLO
            "slo_burn": burns,
            "slo_burn_worst": max(burns.values()) if burns else None,
        }
