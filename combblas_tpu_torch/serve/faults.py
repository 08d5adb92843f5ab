"""Deterministic fault injection: the testable half of resilience —
counterpart of ``combblas_tpu/serve/faults.py``, host only, kept as the
reference has it (a ``rate`` rule with a seed fires at the same call
indices in both packages).

Every recovery path in the serve stack (poisoned-batch bisection,
circuit breakers, worker backoff, hot-swap rollback) is only as real as
the failures it has been exercised against. This module provides the
failures: a ``FaultInjector`` holding named **failure points** that the
api worker threads through its execution path, armed with deterministic
rules so a chaos test replays bit-for-bit.

Failure points (``FAULT_POINTS``):

* ``scheduler.admit``  — inside ``Server.submit``'s admission call (the
  ``submit_many`` prefix-semantics probe);
* ``batch.assemble``   — before the lane vector is built;
* ``engine.execute``   — before the device launch (the main chaos knob);
* ``batch.scatter``    — after execution, before results reach futures;
* ``engine.swap``      — inside ``Server.swap_graph``, before the
  atomic pointer flip (a failed build/validate must leave the old
  version serving);
* ``update.submit``    — inside ``Server.submit_update``'s admission
  (the write lane's front door);
* ``update.merge``     — in the mutation thread, before
  ``engine.apply_delta`` runs (a failed merge must fail exactly the
  updates it carried and leave the current version serving);
* ``wal.append`` / ``checkpoint.save`` / ``replica.death`` /
  ``fleet.fanout`` — the round-16 durability & self-healing points
  (see the ``FAULT_POINTS`` comment below for each one's contract).

Rules, all deterministic:

* ``script(point, at=(3, 7))``       — fire on exact call indices
  (0-based per point);
* ``rate(point, 0.05, seed=42)``     — seeded Bernoulli per call
  (``numpy.random.default_rng``: same seed + same call order = same
  schedule);
* ``when(point, predicate)``         — fire when ``predicate(ctx)`` is
  true (e.g. "the batch contains root 13" — the poison-request shape).

An unarmed injector (``FaultInjector()`` with no rules) costs one
attribute read per check — servers carry one by default, so production
paths pay nothing. Fired faults raise ``InjectedFault`` (a
``RuntimeError``) and count ``serve.faults.injected{point=...}`` in obs.

Usage::

    srv = engine.serve(cfg)
    srv.faults.rate("engine.execute", 0.05, seed=7)
    srv.faults.script("batch.scatter", at=(2,))
    srv.faults.when("engine.execute",
                    lambda ctx: 13 in ctx.get("roots", ()))
"""

from __future__ import annotations

import threading

from .. import obs

#: Named failure points the serve stack threads through the injector.
#: Round 16 adds the durability / self-healing points:
#: ``wal.append`` (inside ``submit_update``, before the write is
#: acknowledged — a failed append must reject the write, never
#: acknowledge an undurable one), ``checkpoint.save`` (the background
#: checkpointer — a failed snapshot must leave the previous one and
#: the un-truncated WAL intact), ``replica.death`` (checked at the top
#: of the api worker loop OUTSIDE its recovery ladder, so firing it
#: kills the worker thread — the fleet supervisor's detection target),
#: and ``fleet.fanout`` (per-replica inside ``FleetRouter.fan_out`` —
#: a failed replica rebuild must lag visibly, not abort the fleet).
FAULT_POINTS = (
    "scheduler.admit",
    "batch.assemble",
    "engine.execute",
    "batch.scatter",
    "engine.swap",
    "update.submit",
    "update.merge",
    "wal.append",
    "checkpoint.save",
    "replica.death",
    "fleet.fanout",
)


class InjectedFault(RuntimeError):
    """A failure produced by the injection framework (never by real
    code) — recovery paths treat it like any other execution error;
    tests and the chaos bench match on this type to separate injected
    damage from genuine regressions."""

    def __init__(self, point: str, call: int, rule: str):
        super().__init__(
            f"injected fault at {point!r} (call #{call}, rule {rule})"
        )
        self.point = point
        self.call = call
        self.rule = rule


class _Rule:
    """One armed failure rule; ``fires(call, ctx)`` must be
    deterministic given the call index and context."""

    kind = "rule"

    def fires(self, call: int, ctx: dict) -> bool:  # pragma: no cover
        raise NotImplementedError


class _Script(_Rule):
    kind = "script"

    def __init__(self, at):
        self.at = frozenset(int(i) for i in at)

    def fires(self, call, ctx):
        return call in self.at


class _Rate(_Rule):
    kind = "rate"

    def __init__(self, p: float, seed: int):
        import numpy as np

        if not (0.0 <= p <= 1.0):
            raise ValueError(f"fault rate must be in [0, 1], got {p}")
        self.p = float(p)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)

    def fires(self, call, ctx):
        # one draw per call, in call order: the schedule is a pure
        # function of (seed, call sequence) — replayable
        return bool(self._rng.random() < self.p)


class _When(_Rule):
    kind = "when"

    def __init__(self, predicate):
        self.predicate = predicate

    def fires(self, call, ctx):
        return bool(self.predicate(ctx))


class FaultInjector:
    """Per-server registry of armed failure rules.

    Thread-safe; ``check(point, **ctx)`` is the only call sites ever
    make. With no rules armed it returns after one attribute read.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: dict[str, list[_Rule]] = {}
        self._armed = False  # fast-path guard, see check()
        self.calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    # -- arming --------------------------------------------------------------

    def _add(self, point: str, rule: _Rule) -> "FaultInjector":
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {FAULT_POINTS}"
            )
        with self._lock:
            self._rules.setdefault(point, []).append(rule)
            self._armed = True
        return self

    def script(self, point: str, at) -> "FaultInjector":
        """Fire on exact 0-based call indices of ``point``."""
        return self._add(point, _Script(at))

    def rate(self, point: str, p: float, seed: int = 0) -> "FaultInjector":
        """Fire each call with probability ``p``, drawn from a seeded
        generator — deterministic given the call order."""
        return self._add(point, _Rate(p, seed))

    def when(self, point: str, predicate) -> "FaultInjector":
        """Fire whenever ``predicate(ctx)`` is true (the poisoned-
        request shape: e.g. ``lambda ctx: 13 in ctx["roots"]``)."""
        return self._add(point, _When(predicate))

    def clear(self, point: str | None = None) -> None:
        """Disarm one point (or all); counters are retained."""
        with self._lock:
            if point is None:
                self._rules.clear()
            else:
                self._rules.pop(point, None)
            self._armed = bool(self._rules)

    # -- the failure points call this ---------------------------------------

    def check(self, point: str, **ctx) -> None:
        """Raise ``InjectedFault`` when an armed rule fires for this
        call of ``point``; otherwise a near-no-op. Call indices advance
        only while the point is armed, so a script's indices refer to
        calls under injection, not the server's whole lifetime."""
        if not self._armed:
            return
        with self._lock:
            rules = self._rules.get(point)
            if not rules:
                return
            call = self.calls.get(point, 0)
            self.calls[point] = call + 1
            hit = None
            for rule in rules:
                if rule.fires(call, ctx):
                    hit = rule
                    break
            if hit is None:
                return
            self.fired[point] = self.fired.get(point, 0) + 1
        obs.count("serve.faults.injected", point=point, rule=hit.kind)
        raise InjectedFault(point, call, hit.kind)

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "armed": sorted(self._rules),
                "calls": dict(self.calls),
                "fired": dict(self.fired),
            }


class ProcessFaultPlan:
    """Deterministic PROCESS-level chaos (round 17, the process
    fleet): scripted real signals against replica subprocesses,
    keyed by the fleet's routed-submit call index so a chaos run
    replays bit-for-bit — the ``FaultInjector`` philosophy lifted to
    OS crash domains.

    Two failure modes, because they fail DIFFERENTLY:

    * ``sigkill(at, replica)`` — instant crash: the process exits,
      the channel breaks, ``Popen.poll()`` reports it; supervision
      sees it within one tick.
    * ``sigstop(at, replica)`` — a HANG, not a death: the process
      stays alive and the socket stays open, but heartbeats stop and
      in-flight RPCs run out their deadlines; only the heartbeat
      timeout can catch it.  ``sigcont(at, replica)`` un-wedges (for
      tests that assert a stalled replica is routed around and then
      recovers — though quarantine's SIGKILL usually collapses it
      first).

    ``replica`` is an index or ``"home"`` (resolved at FIRE time —
    after a promotion, "home" tracks the lineage, which is what a
    kill-the-home chaos scenario means).  ``ProcessFleet.submit``
    calls :meth:`step` once per routed query and applies what is due.

    Unarmed cost: one attribute read per routed submit.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: list[tuple[int, str, object]] = []  # (at, sig, replica)
        self._armed = False
        self.calls = 0
        self.fired: list[tuple[int, str, object]] = []

    def _add(self, at: int, sig: str, replica) -> "ProcessFaultPlan":
        with self._lock:
            self._rules.append((int(at), sig, replica))
            self._armed = True
        return self

    def sigkill(self, at: int, replica="home") -> "ProcessFaultPlan":
        """SIGKILL ``replica`` at routed-submit call index ``at``."""
        return self._add(at, "SIGKILL", replica)

    def sigstop(self, at: int, replica="home") -> "ProcessFaultPlan":
        """SIGSTOP (wedge, do not kill) ``replica`` at call ``at``."""
        return self._add(at, "SIGSTOP", replica)

    def sigcont(self, at: int, replica="home") -> "ProcessFaultPlan":
        return self._add(at, "SIGCONT", replica)

    def step(self) -> list[tuple[str, object]]:
        """Advance one routed-submit call; returns the ``(signal,
        replica)`` actions due at this index, in arming order."""
        if not self._armed:
            return []
        with self._lock:
            call = self.calls
            self.calls += 1
            due = [
                (sig, rep) for at, sig, rep in self._rules
                if at == call
            ]
            for d in due:
                self.fired.append((call, *d))
            return due

    def stats(self) -> dict:
        with self._lock:
            return {
                "rules": list(self._rules),
                "calls": self.calls,
                "fired": list(self.fired),
            }
