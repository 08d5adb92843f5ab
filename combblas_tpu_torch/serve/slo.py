"""Per-tenant SLO error budgets: rolling-window good/bad accounting
(round 15) — counterpart of ``combblas_tpu/serve/slo.py``, host clock
only, kept as the reference has it.

A serving SLO ("99.9% of requests answer inside ``slo_deadline_s``")
is operated through its ERROR BUDGET: over a rolling window, the
tenant may blow the deadline on at most ``(1 - target)`` of its
requests; ``burn = bad / budget`` is the one number a dashboard pages
on (burn >= 1: the budget is exhausted, the SLO is breached for this
window).  This module is the accounting: second-granularity buckets in
a bounded deque, O(1) per record, window sums maintained
incrementally — cheap enough to run on every request disposition.

GOOD = a request settled ok within its deadline.  BAD = timeout
(queue-sweep, pre-execution drop, or during-execution), execution
error / poisoned, or an admission rejection (backpressure, breaker,
SLO queue budget) — a rejected request is a user-visible failure under
an SLO even though it never touched the device.

Wired by ``api.Server`` when ``ServeConfig.slo_deadline_s`` is set
(per tenant by construction in the pool — each tenant's Server owns
its own budget), surfaced through ``stats()``/``health()`` on
``Server``, ``PoolServer`` and ``FleetRouter``, and exported as
``serve.slo.good`` / ``serve.slo.bad`` counters plus the
``serve.slo.budget_burn`` gauge.  A burn crossing 1.0 triggers a
flight-recorder dump (``reason="slo_breach"``).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .. import obs


class ErrorBudget:
    """Rolling-window good/bad accounting against one SLO target."""

    def __init__(self, target: float = 0.999, window_s: float = 60.0,
                 tenant: str | None = None, clock=time.monotonic):
        if not (0.0 < target < 1.0):
            raise ValueError(
                f"SLO target must be in (0, 1), got {target}"
            )
        if window_s <= 0:
            raise ValueError("SLO window_s must be > 0")
        self.target = float(target)
        self.window_s = float(window_s)
        self.tenant = tenant
        self._clock = clock
        self._lock = threading.Lock()
        # (second-bucket, good, bad), oldest first; window sums kept
        # incrementally so record() never rescans the deque
        self._buckets: deque[list] = deque()
        self._wgood = 0
        self._wbad = 0
        self.good_total = 0
        self.bad_total = 0
        self._breached = False

    def _lab(self, **labels) -> dict:
        if self.tenant is not None:
            labels["tenant"] = self.tenant
        return labels

    def _expire(self, now: float) -> None:
        # caller holds the lock
        horizon = now - self.window_s
        while self._buckets and self._buckets[0][0] < horizon:
            _b, g, bd = self._buckets.popleft()
            self._wgood -= g
            self._wbad -= bd

    def record(self, ok: bool, kind: str = "",
               now: float | None = None) -> bool:
        """Account one request disposition.  Returns True exactly when
        this record BURNS THROUGH the budget (burn crosses >= 1.0) —
        the flight-recorder trigger; repeated bad records while
        already breached return False (one dump per breach episode)."""
        now = self._clock() if now is None else now
        b = int(now)
        with self._lock:
            self._expire(now)
            if self._buckets and self._buckets[-1][0] == b:
                bucket = self._buckets[-1]
            else:
                bucket = [b, 0, 0]
                self._buckets.append(bucket)
            if ok:
                bucket[1] += 1
                self._wgood += 1
                self.good_total += 1
            else:
                bucket[2] += 1
                self._wbad += 1
                self.bad_total += 1
            burn = self._burn_locked()
            breached_now = burn >= 1.0
            transition = breached_now and not self._breached
            self._breached = breached_now
        if obs.ENABLED:
            if ok:
                obs.count("serve.slo.good", **self._lab(kind=kind))
            else:
                obs.count("serve.slo.bad", **self._lab(kind=kind))
            obs.gauge("serve.slo.budget_burn", burn, **self._lab())
        return transition

    def _burn_locked(self) -> float:
        total = self._wgood + self._wbad
        if total == 0:
            return 0.0
        # budget > 0 always holds: total > 0 and 0 < target < 1 — a
        # small window just yields a very large burn
        return self._wbad / ((1.0 - self.target) * total)

    def _refresh_locked(self) -> float:
        """Recompute burn after an expiry pass and let a
        breached-then-idle budget RECOVER: once the bad buckets age
        out of the window, ``breached`` must clear even though no new
        record() arrived — otherwise an idle tenant pages as degraded
        forever (and a later breach would not re-fire the recorder)."""
        burn = self._burn_locked()
        if burn < 1.0:
            self._breached = False
        return burn

    def _regauge(self, burn: float) -> None:
        """Re-export the burn gauge on READ-side recomputes too: an
        idle tenant whose bad buckets expired must stop scraping as
        breached — the gauge written at the last record() would
        otherwise page forever."""
        if obs.ENABLED:
            obs.gauge("serve.slo.budget_burn", burn, **self._lab())

    def burn(self, now: float | None = None) -> float:
        now = self._clock() if now is None else now
        with self._lock:
            self._expire(now)
            b = self._refresh_locked()
        self._regauge(b)
        return b

    def describe(self, now: float | None = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            self._expire(now)
            burn = self._refresh_locked()
            out = {
                "target": self.target,
                "window_s": self.window_s,
                "window_good": self._wgood,
                "window_bad": self._wbad,
                "good_total": self.good_total,
                "bad_total": self.bad_total,
                "burn": round(burn, 4),
                "breached": self._breached,
            }
        self._regauge(burn)
        return out
