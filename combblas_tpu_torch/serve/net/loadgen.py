"""Open-loop load generator for the network front door (r19);
counterpart of ``combblas_tpu/serve/net/loadgen.py``.

The closed-loop ``serve_bench`` scenarios submit, wait, submit again —
so when the server slows down, the BENCH slows its arrival rate with
it and the recorded latencies silently exclude the queueing the real
world would have seen (COORDINATED OMISSION).  This harness is the
open-loop antidote, and the capstone serving bench later PRs cite:

* arrivals are a SEEDED POISSON PROCESS at a target rate — the full
  schedule (exponential inter-arrival gaps, connection choice, root
  choice) is drawn up front from one ``numpy`` RNG, so a run replays
  exactly;
* send time is driven by the SCHEDULE, never by completions — the
  pacer thread sleeps to each arrival's offset and fires
  ``NetClient.submit_nowait`` regardless of what is still in flight;
* latency is measured from the SCHEDULED arrival time, so any send
  lag or server queueing is charged to the request, exactly as a real
  user would experience it;
* hundreds of concurrent connections against a 2+-replica
  ``ProcessFleet``, optionally under scripted ``ProcessFaultPlan``
  chaos (``BENCH_NET_CHAOS=1`` SIGKILLs a non-home replica mid-run
  with the supervisor healing around it).

Reported per run: offered vs achieved rate, p50/p99 latency,
availability, every rejection bucketed by its TYPED protocol status
(an untyped failure fails the gate), stranded-future and post-warmup
retrace counts (both must be zero), SLO burn when a deadline rides
the wire, and the stitched ``net -> router -> ipc -> child`` stage
decomposition folded from the same schema-``trace`` records the rest
of the observability plane uses.

Knobs (tuner/config.py): ``BENCH_NET_RATE`` (req/s),
``BENCH_NET_CONNS``, ``BENCH_NET_SECONDS``.  Entry:
``python -m combblas_tpu_torch.serve.net.loadgen [--device cuda|cpu]``,
emitting the standard ``{summary, metric, value, median, warning, rc}``
headline contract — ``warning`` is ``None`` here (an open loop has no
coordinated omission to caveat).

The port's own: ``run(device=)`` names the device of the process fleet
it builds when given no backend — the card by default, ``"cpu"`` where
a caller asks (the tests); with no card and the default there is no
CPU fallback, the fleet's build raises.  ``run(roots=)`` names the
vertices the schedule draws its roots from, for a caller that passes a
backend serving another graph than loadgen's own R-MAT (by default the
live vertices of that R-MAT, as in the reference).  Everything else
(the schedule, the classification, the decomposition, the gate) is the
reference's.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from ... import obs
from ...obs import trace as obs_trace
from ...tuner import config as tuner_config
from ..policy import ReplicaDeadError
from ..scheduler import BackpressureError, CircuitBreakerOpen
from .client import NetClient
from .frontend import NetFrontend

#: Trace stages charged to each tier of the stitched decomposition;
#: anything not listed is CHILD time (queue/assemble/execute/scatter —
#: the replica's own stage names, whatever they are).
_NET_STAGES = ("net_accept", "net_read", "net_write")
_ROUTER_STAGES = ("route", "ipc_recv")
_IPC_STAGES = ("ipc_send", "ipc_wait")


def _classify(exc: BaseException | None) -> str:
    """The harness-side status bucket for one settled future — the
    wire taxonomy's exception types, plus ``untyped:*`` for anything
    the protocol failed to map (which fails the gate)."""
    if exc is None:
        return "ok"
    if isinstance(exc, CircuitBreakerOpen):
        return "breaker_open"
    if isinstance(exc, BackpressureError):
        return "backpressure"
    if isinstance(exc, ReplicaDeadError):
        return "replica_dead"
    if isinstance(exc, TimeoutError):
        return "timeout"
    if isinstance(exc, ValueError):
        return "invalid"
    if isinstance(exc, ConnectionError):
        return "conn_error"
    if isinstance(exc, RuntimeError):
        return "unavailable"
    return f"untyped:{type(exc).__name__}"


def _decompose(records) -> dict:
    """Fold net-transport trace records into mean per-tier
    milliseconds (net/router/ipc/child + wall)."""
    tiers = {"net_ms": 0.0, "router_ms": 0.0, "ipc_ms": 0.0,
             "child_ms": 0.0}
    wall = 0.0
    n = 0
    for rec in records:
        if rec["labels"].get("transport") != "net":
            continue
        n += 1
        wall += rec["wall_s"]
        for st in rec["stages"]:
            s = st["stage"]
            if s in _NET_STAGES:
                tiers["net_ms"] += st["s"]
            elif s in _ROUTER_STAGES:
                tiers["router_ms"] += st["s"]
            elif s in _IPC_STAGES:
                tiers["ipc_ms"] += st["s"]
            else:
                tiers["child_ms"] += st["s"]
    if n == 0:
        return {"traced": 0}
    out = {k: round(v / n * 1e3, 4) for k, v in tiers.items()}
    out["wall_ms"] = round(wall / n * 1e3, 4)
    out["traced"] = n
    return out


def run(rate: float | None = None, conns: int | None = None,
        seconds: float | None = None, *, scale: int = 8,
        edgefactor: int = 8, replicas: int = 2, chaos: bool = False,
        seed: int = 7, kind: str = "bfs",
        deadline_s: float | None = 2.0, trace_rate: float = 1.0,
        backend=None, device="cuda", roots=None) -> dict:
    """One open-loop run; returns the result dict (``main`` wraps it
    in the headline contract).  ``backend=None`` builds (and owns) a
    ``ProcessFleet`` whose children serve on ``device``; passing a
    backend reuses it (tests, ``chip_smoke.py``).  ``roots`` is the
    root pool (default: the live vertices of the R-MAT at ``scale``)."""
    from ...utils.rmat import rmat_symmetric_coo_host

    rate = tuner_config.bench_net_rate(rate)
    conns = tuner_config.bench_net_conns(conns)
    seconds = tuner_config.bench_net_seconds(seconds)

    was_enabled = obs.ENABLED
    if not was_enabled:
        obs.enable(install_hooks=False)
    prev_rate = obs_trace.sample_rate()
    obs_trace.set_sample_rate(trace_rate)

    n = 1 << scale
    if roots is None or backend is None:
        rows, cols = rmat_symmetric_coo_host(42, scale, edgefactor)
        if roots is None:
            deg = np.bincount(rows, minlength=n)
            roots = np.flatnonzero(deg > 0)
    roots = np.asarray(roots, np.int64)

    own_fleet = backend is None
    work = None
    if own_fleet:
        from .. import ProcessFleet, ServeConfig

        work = tempfile.mkdtemp(prefix="net_loadgen_")
        backend = ProcessFleet.build(
            (1, 1), rows, cols, n, replicas=replicas, kinds=(kind,),
            config=ServeConfig(
                lane_widths=(1, 2, 4, 8), slo_deadline_s=deadline_s,
            ),
            wal_dir=os.path.join(work, "wal"),
            workdir=os.path.join(work, "proc"),
            hb_interval_s=0.2, device=device,
        )
        backend.start_supervisor(0.2)
    fe = NetFrontend(backend, max_conns=conns + 16)
    clients: list[NetClient] = []
    try:
        clients = [
            NetClient("127.0.0.1", fe.port) for _ in range(conns)
        ]
        # warmup: a few blocking requests round-robin so every lane
        # plan is traced before measurement starts, then snapshot the
        # retrace marks and the trace log length
        for i in range(8):
            clients[i % len(clients)].submit(
                kind, int(roots[i % len(roots)]), timeout_s=300.0
            )
        marks = (
            backend.trace_marks()
            if hasattr(backend, "trace_marks") else None
        )
        n_traces0 = len(obs_trace.records())

        if chaos and hasattr(backend, "proc_faults"):
            from .. import ProcessFaultPlan

            n_arr_est = max(int(rate * seconds), 1)
            plan = ProcessFaultPlan()
            # kill a non-home replica a third of the way in; the
            # supervisor heals it while the stream keeps flowing
            victim = (backend.home + 1) % len(backend.replicas)
            plan.sigkill(at=max(n_arr_est // 3, 1), replica=victim)
            backend.proc_faults = plan

        # the precomputed seeded schedule: everything random is drawn
        # here, before the clock starts
        rng = np.random.default_rng(seed)
        n_arr = max(int(rate * seconds), 1)
        offsets = np.cumsum(rng.exponential(1.0 / rate, n_arr))
        conn_of = rng.integers(0, len(clients), n_arr)
        root_of = roots[rng.integers(0, len(roots), n_arr)]

        recs: list = [None] * n_arr
        left = [n_arr]
        lk = threading.Lock()
        all_done = threading.Event()

        def _settle(k: int, sched_t: float, f) -> None:
            # latency from the SCHEDULED arrival: send lag and queue
            # wait are charged to the request — no coordinated omission
            lat = time.perf_counter() - sched_t
            recs[k] = (lat, _classify(f.exception()))
            with lk:
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()

        t_start = time.perf_counter()
        send_lag_max = 0.0
        for k in range(n_arr):
            tgt = t_start + offsets[k]
            now = time.perf_counter()
            if tgt > now:
                time.sleep(tgt - now)
            else:
                send_lag_max = max(send_lag_max, now - tgt)
            try:
                fut = clients[conn_of[k]].submit_nowait(
                    kind, int(root_of[k]), deadline_s=deadline_s
                )
            except ConnectionError:
                recs[k] = (time.perf_counter() - tgt, "conn_error")
                with lk:
                    left[0] -= 1
                    if left[0] == 0:
                        all_done.set()
                continue
            fut.add_done_callback(
                lambda f, k=k, tgt=tgt: _settle(k, tgt, f)
            )
        sent_wall = time.perf_counter() - t_start
        all_done.wait(timeout=seconds + 120.0)
        total_wall = time.perf_counter() - t_start
        stranded = left[0]

        status_counts: dict[str, int] = {}
        lats_ok = []
        for r in recs:
            if r is None:
                continue
            lat, st = r
            status_counts[st] = status_counts.get(st, 0) + 1
            if st == "ok":
                lats_ok.append(lat)
        n_ok = len(lats_ok)
        availability = n_ok / n_arr
        lats_ms = np.asarray(lats_ok) * 1e3
        p50 = float(np.percentile(lats_ms, 50)) if n_ok else 0.0
        p99 = float(np.percentile(lats_ms, 99)) if n_ok else 0.0
        untyped = sum(
            v for k2, v in status_counts.items()
            if k2.startswith("untyped:")
        )
        retraces = (
            backend.retraces_since(marks) if marks is not None else 0
        )
        client_pending = sum(c.pending for c in clients)
        slo = None
        if deadline_s is not None and n_ok:
            miss = int(np.sum(lats_ms > deadline_s * 1e3))
            bad = miss + (n_arr - n_ok)
            slo = {
                "deadline_s": deadline_s,
                "bad": bad,
                "burn": round(bad / max(n_arr * 0.01, 1.0), 4),
                # burn vs a 99%-availability budget: >= 1.0 means the
                # run spent the whole 1% error budget
            }
        decomposition = _decompose(obs_trace.records()[n_traces0:])

        ok = (
            availability >= 0.99 and stranded == 0
            and client_pending == 0 and untyped == 0 and retraces == 0
        )
        return {
            "metric": "serve.net.open_loop",
            "unit": "req/s",
            "value": round(n_ok / total_wall, 2),
            "offered_qps": round(n_arr / offsets[-1], 2),
            "achieved_qps": round(n_ok / total_wall, 2),
            "requests": n_arr,
            "conns": len(clients),
            "replicas": (
                len(backend.replicas)
                if hasattr(backend, "replicas") else 1
            ),
            "seconds": seconds,
            "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3),
            "availability": round(availability, 5),
            "status_counts": status_counts,
            "untyped_failures": untyped,
            "stranded_futures": stranded + client_pending,
            "retraces_after_warmup": retraces,
            "send_lag_max_ms": round(send_lag_max * 1e3, 3),
            "sent_wall_s": round(sent_wall, 3),
            "wall_s": round(total_wall, 3),
            "chaos": bool(chaos),
            "slo": slo,
            "decomposition": decomposition,
            "warning": None,  # open loop: nothing to caveat
            "ok": ok,
        }
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        fe.close()
        if own_fleet:
            backend.close(drain=False)
        obs_trace.set_sample_rate(prev_rate)


def main(argv=None) -> int:
    """The CLI entry: run, print the detail dict, then emit the
    headline ``{summary, metric, value, median, warning, rc}`` line +
    BENCH_SUMMARY.json (suppressed with BENCH_EMIT_SUMMARY=0, where the
    detail line must stay last).  ``--device`` names the fleet's
    device (the card by default)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m combblas_tpu_torch.serve.net.loadgen",
        description="open-loop Poisson load over the net front door",
    )
    ap.add_argument("--device", default="cuda",
                    help="the process fleet's device (default: cuda)")
    args = ap.parse_args(argv)
    chaos = os.environ.get("BENCH_NET_CHAOS", "0") not in ("", "0")
    scale = int(os.environ.get("BENCH_SERVE_SCALE", "8") or 8)
    replicas = int(os.environ.get("BENCH_NET_REPLICAS", "2") or 2)
    out = run(chaos=chaos, scale=scale, replicas=replicas,
              device=args.device)
    print(json.dumps(out), flush=True)
    if os.environ.get("BENCH_EMIT_SUMMARY", "1") == "0":
        return 0
    rc = 0 if out.get("ok") else 1
    s = {
        "summary": 1,
        "metric": out.get("metric"),
        "value": out.get("value", 0.0),
        "median": out.get("p50_ms", 0.0),
        "warning": out.get("warning"),
        "rc": rc,
        "offered_qps": out.get("offered_qps"),
        "achieved_qps": out.get("achieved_qps"),
        "availability": out.get("availability"),
        "decomposition": out.get("decomposition"),
    }
    path = os.environ.get("BENCH_SUMMARY_PATH", "BENCH_SUMMARY.json")
    try:
        with open(path, "w") as f:
            json.dump(s, f)
            f.write("\n")
    except OSError as e:
        s["summary_write_error"] = f"{path}: {e}"
    print(json.dumps(s), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
