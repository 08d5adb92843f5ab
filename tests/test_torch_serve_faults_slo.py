"""Parity of the port's host-side serving policy (``serve/faults.py``,
``serve/slo.py``, the breaker, ``ServeConfig`` and the fair queue of
``serve/scheduler.py``) with ``combblas_tpu.serve`` on the CPU.

Mirrors ``tests/test_serve_resilience.py``'s injector cases (script,
rate, unknown points: a seeded ``rate`` rule fires at the same call
indices in both packages), its retry-budget and breaker state-machine
cases, ``tests/test_obs_serve.py``'s ``ErrorBudget`` case, and runs
``DeficitRoundRobin`` rounds and ``ProcessFaultPlan`` steps against the
reference's. Everything here is deterministic host Python, compared
exactly: schedules, states, retry hints, ``describe()`` dicts, series.
"""

import math

import pytest

from torch_serve_parity import NAMES, PKG, isolated  # noqa: F401
from torch_obs_parity import series


# --- fault injector ------------------------------------------------------------


def test_fault_points_are_the_reference_s():
    assert PKG["torch"].FAULT_POINTS == PKG["jax"].FAULT_POINTS
    assert issubclass(PKG["torch"].InjectedFault, RuntimeError)


@pytest.mark.parametrize("name", NAMES)
def test_injector_script_fires_at_exact_indices(name):
    inj = PKG[name].FaultInjector()
    inj.script("engine.execute", at=(1, 3))
    fired = []
    for i in range(5):
        try:
            inj.check("engine.execute")
        except PKG[name].InjectedFault as e:
            fired.append((i, e.call, e.point, e.rule))
    assert fired == [(1, 1, "engine.execute", "script"), (3, 3, "engine.execute", "script")]
    st = inj.stats()
    assert st["calls"]["engine.execute"] == 5
    assert st["fired"]["engine.execute"] == 2


def _schedule(name, p, seed, calls=200):
    inj = PKG[name].FaultInjector()
    inj.rate("engine.execute", p, seed=seed)
    out = []
    for _ in range(calls):
        try:
            inj.check("engine.execute", roots=(1, 2))
            out.append(0)
        except PKG[name].InjectedFault:
            out.append(1)
    return out


@pytest.mark.parametrize("p,seed", [(0.3, 42), (0.3, 7), (0.05, 11), (0.05, 99), (0.5, 0),
                                    (1.0, 0), (0.0, 3)])
def test_injector_rate_fires_at_the_reference_s_indices(p, seed):
    """Same seed, same call order: the same schedule in both packages
    (numpy's ``default_rng`` draws), and the reference test's
    properties."""
    want = _schedule("jax", p, seed)
    assert _schedule("torch", p, seed) == want
    assert _schedule("torch", p, seed) == want  # replayable
    if 0 < p < 1:
        assert 0 < sum(want) < len(want)
    with pytest.raises(ValueError, match="fault rate"):
        PKG["torch"].FaultInjector().rate("engine.execute", 1.5)


@pytest.mark.parametrize("name", NAMES)
def test_injector_unknown_point_and_unarmed_noop(name):
    P = PKG[name]
    inj = P.FaultInjector()
    with pytest.raises(ValueError, match="unknown fault point"):
        inj.script("not.a.point", at=(0,))
    inj.check("engine.execute")  # unarmed: no-op, no counters
    assert inj.stats() == {"armed": [], "calls": {}, "fired": {}}
    inj.when("batch.scatter", lambda ctx: ctx.get("kind") == "bfs")
    with pytest.raises(P.InjectedFault):
        inj.check("batch.scatter", kind="bfs")
    inj.check("batch.scatter", kind="pagerank")  # predicate false
    inj.clear()
    inj.check("batch.scatter", kind="bfs")  # disarmed again
    assert inj.stats() == {"armed": [], "calls": {"batch.scatter": 2},
                           "fired": {"batch.scatter": 1}}


def test_injected_fault_series_match_reference():
    out = {}
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        inj = P.FaultInjector().rate("engine.execute", 0.4, seed=5)
        inj.script("batch.scatter", at=(0, 2))
        for _ in range(30):
            for point in ("engine.execute", "batch.scatter"):
                try:
                    inj.check(point)
                except P.InjectedFault:
                    pass
        out[name] = (series(P.obs), inj.stats())
        P.obs.disable()
    assert out["torch"] == out["jax"]


def test_process_fault_plan_steps_match_reference():
    out = {}
    for name in NAMES:
        plan = PKG[name].ProcessFaultPlan()
        assert plan.step() == []  # unarmed: no call counted
        plan.sigkill(2).sigstop(4, replica=1).sigcont(4, replica=1).sigkill(7, replica="home")
        out[name] = ([plan.step() for _ in range(9)], plan.stats())
    assert out["torch"] == out["jax"]
    assert out["torch"][0][4] == [("SIGSTOP", 1), ("SIGCONT", 1)]


# --- ServeConfig and the breaker ---------------------------------------------


def test_retry_budget_defaults_to_full_bisection():
    for name in NAMES:
        C = PKG[name].ServeConfig
        assert C().retry_budget == 5  # widths (1..16)
        assert C(lane_widths=(1, 2, 4, 8, 16, 32)).retry_budget == 6
        assert C(lane_widths=(1,)).retry_budget == 1
        assert C(lane_widths=(4,), retry_budget=2).retry_budget == 2
        with pytest.raises(ValueError, match="retry_budget"):
            C(retry_budget=0)


BAD_CONFIGS = [
    {"lane_widths": ()}, {"lane_widths": (4, 2)}, {"lane_widths": (0, 2)},
    {"max_queue": 0}, {"max_wait_s": -1.0}, {"retry_budget": 0},
    {"breaker_threshold": -1}, {"breaker_cooldown_s": 0.0},
    {"breaker_cooldown_s": 2.0, "breaker_cooldown_max_s": 1.0},
    {"worker_backoff_s": 0.0}, {"update_buffer": 0}, {"update_flush": 0},
    {"slo_target": 1.0}, {"slo_deadline_s": 0.0}, {"default_timeout_s": -1.0},
    {"per_kind_max_wait": {"bfs": -1.0}}, {"slo_queue_budget": 0},
    {"checkpoint_interval_s": 0.0}, {"flight_recorder_events": 0},
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_serve_config_checks_match_reference(kw):
    """``ServeConfig.__post_init__``: the same configurations are refused
    with the same message, or accepted with the same fields."""
    res = {}
    for name in NAMES:
        try:
            cfg = PKG[name].ServeConfig(**kw)
            res[name] = ("ok", {f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        except (ValueError, TypeError) as e:
            res[name] = (type(e).__name__, str(e))
    assert res["torch"] == res["jax"]


def test_serve_config_defaults_match_reference():
    j, t = PKG["jax"].ServeConfig(), PKG["torch"].ServeConfig()
    assert list(t.__dataclass_fields__) == list(j.__dataclass_fields__)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in j.__dataclass_fields__}
    for kind in ("bfs", "sssp", "pagerank"):
        cfg = {n: PKG[n].ServeConfig(per_kind_max_wait={"bfs": 0.5}) for n in NAMES}
        assert cfg["torch"].wait_for(kind) == cfg["jax"].wait_for(kind)


def _breaker_trace(name):
    """The reference's state-machine cycle with an injected clock, every
    reading kept."""
    br = PKG[name].CircuitBreaker(threshold=3, cooldown_s=1.0, cooldown_max_s=3.0)
    t = 100.0
    out = []

    def rd(now):
        out.append((br.state, br.retry_after(now), br.describe(now)))

    for _ in range(2):
        out.append(br.record_failure(t))
    rd(t)
    out.append(br.record_failure(t))
    rd(t)
    out.append(br.admit(t + 0.5))
    rd(t + 0.5)
    out.append(br.admit(t + 1.0))
    out.append(br.admit(t + 1.05))
    rd(t + 1.05)
    out.append(br.admit(t + 2.0))
    out.append(br.record_failure(t + 1.1))
    rd(t)
    out.append(br.admit(t + 2.0))
    out.append(br.admit(t + 1.1 + 2.0))
    br.record_success(t + 3.2)
    rd(t)
    # a failed probe at the cap keeps the cap
    for _ in range(3):
        br.record_failure(t + 10)
    out.append(br.admit(t + 11.1))
    br.record_failure(t + 11.2)
    out.append(br.admit(t + 13.3))
    br.record_failure(t + 13.4)
    rd(t + 13.4)
    br.release_probe()
    rd(t + 20)
    out.append((br.opened_total, br.fast_fails))
    return br, out


def test_breaker_state_machine_matches_reference():
    """Closed -> open at the threshold -> fast-fail during cooldown ->
    half-open probe -> close on success; a failed probe doubles the
    cooldown (capped): every reading equal to the reference's."""
    br, got = _breaker_trace("torch")
    _, want = _breaker_trace("jax")
    assert got == want
    fresh = PKG["torch"].CircuitBreaker(threshold=3, cooldown_s=1.0, cooldown_max_s=3.0)
    t = 100.0
    for _ in range(3):
        fresh.record_failure(t)
    assert fresh.state == "open" and fresh.opened_total == 1
    assert not fresh.admit(t + 0.5)
    assert fresh.retry_after(t + 0.5) == pytest.approx(0.5)
    assert fresh.admit(t + 1.0) and fresh.state == "half_open"


def test_breaker_series_match_reference():
    out = {}
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        _breaker_trace(name)
        out[name] = series(P.obs)
        P.obs.disable()
    assert out["torch"] == out["jax"]
    assert any(k[1] == "serve.breaker.opened" for k in out["torch"])


# --- SLO error budget ------------------------------------------------------------


def _budget_trace(name):
    clock = [100.0]
    P = PKG[name]
    eb = P.ErrorBudget(target=0.9, window_s=10.0, tenant="t0", clock=lambda: clock[0])
    out = [eb.record(True) for _ in range(9)]
    out.append(eb.record(False))  # the transition returns True
    out.append(eb.record(False))  # already breached: no re-fire
    out.append(eb.describe())
    clock[0] += 11.0
    out.append(eb.describe())  # a breached-then-idle budget recovers
    out += [eb.record(True, kind="bfs") for _ in range(20)]
    clock[0] += 0.5
    out.append(eb.record(False, kind="bfs"))
    out.append((eb.burn(), eb.describe()))
    return out


def test_error_budget_window_and_breach_match_reference():
    got, want = _budget_trace("torch"), _budget_trace("jax")
    assert got == want
    assert got[9] is True and got[10] is False
    d = got[11]
    assert d["breached"] and d["burn"] >= 1.0
    assert d["window_good"] == 9 and d["window_bad"] == 2
    assert got[12]["window_bad"] == 0 and not got[12]["breached"]
    assert got[-1][1]["bad_total"] == 3  # lifetime totals survive the window
    for name in NAMES:
        with pytest.raises(ValueError, match="SLO target"):
            PKG[name].ErrorBudget(target=1.0)
        with pytest.raises(ValueError, match="window_s"):
            PKG[name].ErrorBudget(window_s=0)


def test_error_budget_series_match_reference():
    out = {}
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        _budget_trace(name)
        out[name] = series(P.obs)
        P.obs.disable()
    assert out["torch"] == out["jax"]
    assert {k[1] for k in out["torch"]} == {"serve.slo.good", "serve.slo.bad",
                                            "serve.slo.budget_burn"}


# --- the fair queue --------------------------------------------------------------


def _drr_trace(name, quantum, weights, backlog_rounds):
    P = PKG[name]
    drr = P.DeficitRoundRobin(quantum)
    for t, w in weights.items():
        drr.add(t, w)
    out = []
    for k, backlogged in enumerate(backlog_rounds):
        order = drr.round(backlogged)
        for i, t in enumerate(order):
            # serve while the balance stays positive, charging batches
            while drr.balance(t) > 0:
                drr.charge(t, 1 + (k + i) % 4)
        out.append((order, drr.describe()))
    drr.set_weight("b", 3.0)
    out.append((drr.round(["a", "b"]), drr.prune(["a", "b"]), drr.describe()))
    drr.remove("a")
    out.append(drr.describe())
    return out


@pytest.mark.parametrize("quantum", [None, 1, 5])
def test_deficit_round_robin_rounds_match_reference(monkeypatch, quantum):
    """Rounds, rotation order, deficits (overdraft carried, no banking
    while idle), served counts, pruning: equal to the reference's, and
    the default quantum comes from ``COMBBLAS_POOL_QUANTUM``."""
    monkeypatch.setenv("COMBBLAS_POOL_QUANTUM", "4")
    weights = {"a": 1.0, "b": 2.0, "c": 0.5}
    rounds = [["a", "b", "c"], ["a", "b"], ["c"], [], ["a", "b", "c", "zz"], ["b", "c"]] * 3
    out = {}
    for name in NAMES:
        P = PKG[name]
        P.obs.enable(install_hooks=False)
        out[name] = (_drr_trace(name, quantum, weights, rounds), series(P.obs))
        P.obs.disable()
    assert out["torch"] == out["jax"]
    first = out["torch"][0][0][1]
    assert first["quantum"] == (4 if quantum is None else quantum)
    served = out["torch"][0][-3][1]["served"]
    assert math.isclose(served["b"] / served["a"], 2.0, rel_tol=0.35)
    with pytest.raises(ValueError, match="positive WFQ weight"):
        PKG["torch"].DeficitRoundRobin().add("x", 0.0)
