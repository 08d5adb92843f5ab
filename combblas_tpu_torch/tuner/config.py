"""The one parser of the ``COMBBLAS_*`` knobs — counterpart of
``combblas_tpu/tuner/config.py``, with the same names, defaults, vetting
and error messages.

Resolution precedence, documented once, here:

    explicit argument  >  plan store  >  env var  >  probe  >  heuristic

* **argument** — a caller passing ``tier=`` / ``backend=`` /
  ``block_rows=`` etc. always wins (tests and forced runs).
* **plan store** — a measured plan persisted by the micro-probe pass
  (``combblas_tpu_torch.tuner.store``); this is what makes tier choice
  reproducible across processes.  Disable with ``COMBBLAS_PLAN_STORE=0``.
* **env var** — the fleet-wide override knobs below.
* **probe** — the opt-in micro-probe pass (``COMBBLAS_TUNER_PROBE=1``):
  on a store miss with no arg/env override it MEASURES the admissible
  rungs and writes the winner back.
* **heuristic** — ``choose_spgemm_tier``'s ladder, the fallback when
  nothing above decided.

Env-var conventions shared by every knob: unset or empty means
"default"; for the integer knobs ``"0"`` also means default.  Every knob
is read at each call, never at import.  Every knob of the reference is
here, with its parser.
"""

from __future__ import annotations

import os

#: SpGEMM routing / geometry knobs (round-6/7/9 compatible names).
ENV_TIER = "COMBBLAS_SPGEMM_TIER"
ENV_BACKEND = "COMBBLAS_SPGEMM_BACKEND"
ENV_BLOCK_ROWS = "COMBBLAS_SPGEMM_BLOCK_ROWS"
ENV_BLOCK_COLS = "COMBBLAS_SPGEMM_BLOCK_COLS"
ENV_TIER3D = "COMBBLAS_SPGEMM3D_TIER"
#: Windowed multi-device dispatch: fused | blocked | auto (default).
ENV_DISPATCH = "COMBBLAS_SPGEMM_DISPATCH"
#: Pow2-bucket the per-block plan capacities ("0" disables).
ENV_BUCKET_CAPS = "COMBBLAS_SPGEMM_BUCKET_CAPS"

#: Plan-store knobs (round 10).
ENV_PLAN_STORE = "COMBBLAS_PLAN_STORE"      # dir | "0"/"off" disables
ENV_PROBE = "COMBBLAS_TUNER_PROBE"          # "1" enables the probe pass
ENV_PROBE_BUDGET = "COMBBLAS_TUNER_PROBE_BUDGET_S"
ENV_PROBE_MAX_DIM = "COMBBLAS_TUNER_PROBE_MAX_DIM"

#: Plan-store aging knobs (round 11): long-lived fleet stores grow one
#: appended line per superseded plan and one per new serve lane; these
#: bound the file and the loaded set.
ENV_STORE_MAX = "COMBBLAS_PLAN_STORE_MAX"             # entries cap
ENV_STORE_COMPACT = "COMBBLAS_PLAN_STORE_COMPACT_MIN"  # superseded-line
#                                                     # rewrite trigger

#: Round-12 knobs: the batched-SpMM backend override (the op="spmm"
#: analog of COMBBLAS_SPGEMM_TIER) and headroom-aware bucket sizing —
#: the slack fraction of padding slots every ELL bucket class reserves
#: at build so high-churn dynamic graphs re-bucket instead of spilling
#: (docs/dynamic.md; counter ``dynamic.merge.headroom_used``).
ENV_SPMM_BACKEND = "COMBBLAS_SPMM_BACKEND"
ENV_DYNAMIC_HEADROOM = "COMBBLAS_DYNAMIC_HEADROOM"

#: Dynamic-graph mutation knobs (round 11, docs/dynamic.md).
ENV_DYNAMIC_SPILL = "COMBBLAS_DYNAMIC_SPILL_FRAC"

#: Round-16 knobs, read by ``serve.Server`` (docs/serving.md "Durability &
#: self-healing"): ``COMBBLAS_WAL`` the durability directory (WAL +
#: checkpoints; unset/``0``/``off`` disables), ``COMBBLAS_WAL_FSYNC`` the
#: write-ahead log's append fsync policy (``always`` — every acknowledged
#: write is on disk before its future exists — or ``off``, the OS-buffered
#: throughput mode), ``COMBBLAS_CHECKPOINT_EVERY`` the merge count between
#: automatic background snapshots, ``COMBBLAS_CHECKPOINT_RETAIN`` how many
#: snapshots are retained (the corrupt-snapshot fallback depth).
ENV_WAL = "COMBBLAS_WAL"
ENV_WAL_FSYNC = "COMBBLAS_WAL_FSYNC"
ENV_CHECKPOINT_EVERY = "COMBBLAS_CHECKPOINT_EVERY"
ENV_CHECKPOINT_RETAIN = "COMBBLAS_CHECKPOINT_RETAIN"

#: Valid WAL fsync policies (vetted at the knob, the MERGE precedent).
WAL_FSYNC_POLICIES = ("always", "off")

#: Round-13 knob: the SpGEMM combine-merge tier (sort | runs | hash) —
#: how partial-product pieces (3D fiber pieces, 2D ESC stage chunks)
#: fold into one compacted tile.  Resolution: arg > plan-store record
#: > this env > the L/collision heuristic (docs/spgemm.md "merge
#: tiers").
ENV_MERGE = "COMBBLAS_SPGEMM_MERGE"

#: Round-15 knob: deterministic per-request trace sampling rate for the
#: serve path (``obs/trace.py``).  A request is traced iff obs is
#: enabled AND ``crc32(request id) mod 1e6 < rate * 1e6`` — same ids +
#: same rate = same sampled set on every replica.  Unset/empty/0 = no
#: tracing (the zero-cost default).
ENV_OBS_TRACE_SAMPLE = "COMBBLAS_OBS_TRACE_SAMPLE"

#: Round-14 knobs: ``COMBBLAS_POOL_BYTE_BUDGET`` caps a serve
#: ``EnginePool``'s resident device bytes (LRU eviction past it; 0/unset
#: = unbounded), ``COMBBLAS_POOL_QUANTUM`` is the weighted-fair-queueing
#: deficit quantum of ``serve.DeficitRoundRobin`` (requests per round
#: per unit weight), and ``COMBBLAS_FLEET_REPLICAS`` the default
#: ``FleetRouter`` replica count.
ENV_POOL_BYTE_BUDGET = "COMBBLAS_POOL_BYTE_BUDGET"
ENV_POOL_QUANTUM = "COMBBLAS_POOL_QUANTUM"
ENV_FLEET_REPLICAS = "COMBBLAS_FLEET_REPLICAS"

#: Round-18 knobs: the fleet observability plane (docs/observability.md
#: "Process-fleet observability").  ``COMBBLAS_FLEETLOG`` overrides the
#: supervision-timeline JSONL path the process fleet appends to
#: (default: ``fleetlog.jsonl`` under the fleet's workdir; unset/``0``/
#: ``off`` fall through to that default).  ``COMBBLAS_OBS_HB_METRICS_S``
#: is the minimum seconds between child registry snapshots piggybacked
#: on replica heartbeats (metrics federation — the fleet-scrape wire
#: cadence; unset/``0`` = default).
ENV_FLEETLOG = "COMBBLAS_FLEETLOG"
ENV_OBS_HB_METRICS_S = "COMBBLAS_OBS_HB_METRICS_S"

#: Round-19 knobs: the network front door (docs/serving.md "Network
#: front door").  ``COMBBLAS_NET_PORT`` is the TCP listen port
#: (unset/``0`` = OS-assigned ephemeral — read the bound port back
#: from ``NetFrontend.port``); ``COMBBLAS_NET_MAX_CONNS`` caps open
#: connections (past it a hello gets a typed ``backpressure`` wire
#: reply, never a silent close); ``COMBBLAS_NET_ACCEPT_BACKLOG`` is
#: the kernel ``listen()`` queue depth.  The ``BENCH_NET_*`` knobs
#: parameterize the open-loop load generator
#: (``serve/net/loadgen.py``): target arrival rate (req/s),
#: concurrent connections, and run length — parsed HERE (not inline
#: in the bench) so the vetting and "0 means default" semantics match
#: every other knob.
ENV_NET_PORT = "COMBBLAS_NET_PORT"
ENV_NET_MAX_CONNS = "COMBBLAS_NET_MAX_CONNS"
ENV_NET_ACCEPT_BACKLOG = "COMBBLAS_NET_ACCEPT_BACKLOG"
ENV_BENCH_NET_RATE = "BENCH_NET_RATE"
ENV_BENCH_NET_CONNS = "BENCH_NET_CONNS"
ENV_BENCH_NET_SECONDS = "BENCH_NET_SECONDS"

#: Round-21 knobs: the sharded hop wire protocol (docs/serving.md
#: "Sharded hop wire protocol").  ``COMBBLAS_SHARD_FRONTIER`` picks
#: the frontier encoding the router stamps on each bulk-synchronous
#: hop: ``sparse`` (COO triples of the live frontier), ``dense`` (the
#: r20 ``[n, W]`` operand), or ``auto`` (sparse until the frontier
#: crosses the density threshold, then dense per hop — the diropt
#: regime switch applied at the wire).  ``COMBBLAS_SHARD_DENSITY`` is
#: that threshold as a frontier-nnz fraction of ``n*W`` (auto mode
#: only).  ``COMBBLAS_SHARD_WIRE`` opts propagate's inherently-dense
#: ``q`` into bf16 wire encoding (``f32`` | ``bf16``; the router
#: obs-tracks the quantization error as
#: ``serve.shard.wire_quant_err``).
ENV_SHARD_FRONTIER = "COMBBLAS_SHARD_FRONTIER"
ENV_SHARD_DENSITY = "COMBBLAS_SHARD_DENSITY"
ENV_SHARD_WIRE = "COMBBLAS_SHARD_WIRE"

#: Valid sharded frontier encodings / wire dtypes (vetted at the knob,
#: the MERGE/WAL_FSYNC precedent).
SHARD_FRONTIER_MODES = ("auto", "sparse", "dense")
SHARD_WIRE_MODES = ("f32", "bf16")

#: Valid merge-tier names (parallel/mesh3d re-exports this as
#: MERGE_TIERS — one definition, vetting and kernel asserts agree).
MERGE_TIER_NAMES = ("sort", "runs", "hash")

#: Default probe budget: total measured seconds across all candidate
#: rungs for ONE store miss (compiles excluded from the budget check
#: only insofar as the first candidate always completes).
DEFAULT_PROBE_BUDGET_S = 30.0
#: Proxy dimension cap for the downsampled probe operands.
DEFAULT_PROBE_MAX_DIM = 2048
#: Plan-store entry cap (oldest-cost eviction past it) and the
#: superseded-line count that triggers a load-time compaction rewrite.
DEFAULT_STORE_MAX_ENTRIES = 4096
DEFAULT_STORE_COMPACT_MIN = 32
#: Default bucket-slot headroom: none (static graphs pay no padding
#: tax; dynamic engines opt in via from_coo(headroom=) or the env).
DEFAULT_DYNAMIC_HEADROOM = 0.0
#: Default structural-change fraction past which a merge rebuilds.
DEFAULT_DYNAMIC_SPILL_FRAC = 0.10
#: Default WAL policy: fsync every acknowledged append.
DEFAULT_WAL_FSYNC = "always"
#: Pool and fleet defaults: unbounded resident bytes (an operator opts
#: into eviction by setting a budget), a 16-request deficit quantum per
#: unit weight per round, two replicas.
DEFAULT_POOL_BYTE_BUDGET = 0
DEFAULT_POOL_QUANTUM = 16
DEFAULT_FLEET_REPLICAS = 2
#: Default seconds between heartbeat-piggybacked child registry
#: snapshots (metrics federation).
DEFAULT_OBS_HB_METRICS_S = 1.0
#: Default merges between background snapshots, and snapshots retained.
DEFAULT_CHECKPOINT_EVERY = 8
DEFAULT_CHECKPOINT_RETAIN = 2
#: Net front-door defaults (round 19): ephemeral port, 512 connection
#: slots (a thread apiece — thread-per-connection's practical ceiling,
#: not a protocol limit), a 128-deep kernel accept queue.
DEFAULT_NET_PORT = 0
DEFAULT_NET_MAX_CONNS = 512
DEFAULT_NET_ACCEPT_BACKLOG = 128
#: Open-loop load-generator defaults (round 19): 200 req/s offered
#: over 128 connections for 8 seconds — small enough for a laptop,
#: large enough that coordinated omission would be visible if the
#: harness had it.
DEFAULT_BENCH_NET_RATE = 200.0
DEFAULT_BENCH_NET_CONNS = 128
DEFAULT_BENCH_NET_SECONDS = 8.0
#: Sharded-wire defaults (round 21): adaptive frontier encoding with
#: dense fallback once the live frontier fills a quarter of the
#: ``[n, W]`` operand (past ~0.25 the per-entry triple overhead —
#: 5-9 B vs 4 B — plus scatter work loses to the dense memcpy), and
#: f32 on the wire (bf16 is the explicit opt-in: it halves propagate's
#: hop bytes but trades bit-exactness for allclose).
DEFAULT_SHARD_FRONTIER = "auto"
DEFAULT_SHARD_DENSITY = 0.25
DEFAULT_SHARD_WIRE = "f32"

def _str_env(name: str) -> str | None:
    v = os.environ.get(name)
    return v if v else None


def _int_env(name: str) -> int | None:
    """Unset, empty, and "0" all mean "use the default" (the bench
    knob convention: BENCH_BLOCK_ROWS=0 falls through)."""
    v = os.environ.get(name)
    if not v:
        return None
    return int(v) or None


def env_tier() -> str | None:
    return _str_env(ENV_TIER)


def env_backend() -> str | None:
    return _str_env(ENV_BACKEND)


def env_block_rows() -> int | None:
    return _int_env(ENV_BLOCK_ROWS)


def env_block_cols() -> int | None:
    return _int_env(ENV_BLOCK_COLS)


def env_tier3d() -> str | None:
    return _str_env(ENV_TIER3D)


def env_dispatch() -> str | None:
    return _str_env(ENV_DISPATCH)


def bucket_caps_enabled() -> bool:
    """Pow2 cap bucketing is ON by default: the windowed plan's
    capacities round up to powers of two, as the reference's do (they are
    part of the output layout)."""
    return os.environ.get(ENV_BUCKET_CAPS, "1") not in ("", "0")


def resolve_dispatch(dispatch: str | None = None) -> str:
    """Windowed-tier dispatch: argument > env > ``"auto"``.

    ``auto`` routes multi-tile scatter products with more than one
    occupied row block through the blocked form
    (``summa_spgemm_windowed_blocked``); ``fused`` forces the fused form
    (the carousel stage order lives there); ``blocked`` forces the
    blocked form.  An unknown value raises ``ValueError`` (the reference
    asserts)."""
    if dispatch is None:
        dispatch = env_dispatch()
    if dispatch is None:
        dispatch = "auto"
    if dispatch not in ("auto", "fused", "blocked"):
        raise ValueError(
            f"dispatch must be 'auto', 'fused' or 'blocked', got {dispatch!r}"
        )
    return dispatch


def store_dir() -> str | None:
    """The plan-store directory, or ``None`` when the store is disabled.

    ``COMBBLAS_PLAN_STORE``: a path uses that dir; ``0``/``off``
    disables the store entirely.  Unset: the sibling of the kernel build
    cache dir (``utils/compile_cache.plan_store_dir()``, ``.plan_store``
    next to it), so whoever ships the build cache ships the plans with
    it."""
    v = os.environ.get(ENV_PLAN_STORE)
    if v is not None:
        if v.strip().lower() in ("", "0", "off", "none"):
            return None
        return os.path.abspath(v)
    from ..utils import compile_cache

    return compile_cache.plan_store_dir()


def probe_enabled() -> bool:
    return os.environ.get(ENV_PROBE, "0") not in ("", "0")


def probe_budget_s() -> float:
    v = os.environ.get(ENV_PROBE_BUDGET)
    return float(v) if v else DEFAULT_PROBE_BUDGET_S


def probe_max_dim() -> int:
    v = os.environ.get(ENV_PROBE_MAX_DIM)
    return int(v) if v else DEFAULT_PROBE_MAX_DIM


def store_max_entries() -> int:
    """Plan-store entry cap: past it the loader evicts oldest-cost
    entries (``tuner.store.evicted``).  ``0``/unset = the default."""
    v = _int_env(ENV_STORE_MAX)
    return DEFAULT_STORE_MAX_ENTRIES if v is None else v


def store_compact_min() -> int:
    """Superseded (last-wins-shadowed) line count that triggers the
    load-time compaction rewrite (``tuner.store.compacted``)."""
    v = _int_env(ENV_STORE_COMPACT)
    return DEFAULT_STORE_COMPACT_MIN if v is None else v


def env_merge() -> str | None:
    """Fleet-wide SpGEMM merge-tier override.  A bogus value raises
    here, naming the knob, instead of deep inside a merge."""
    v = _str_env(ENV_MERGE)
    if v is not None and v not in MERGE_TIER_NAMES:
        raise ValueError(
            f"{ENV_MERGE} must be one of {'|'.join(MERGE_TIER_NAMES)}; "
            f"got {v!r}"
        )
    return v


def env_spmm_backend() -> str | None:
    """Fleet-wide SpMM backend override (``mxu_gather``/``scatter``) —
    the op="spmm" rung ``tuner.resolve.resolve_tier`` walks."""
    return _str_env(ENV_SPMM_BACKEND)


def dynamic_headroom(given: float | None = None) -> float:
    """Bucket-slot headroom fraction: explicit argument >
    ``COMBBLAS_DYNAMIC_HEADROOM`` > 0.  Clamped to >= 0 (a negative
    headroom would under-allocate the real rows)."""
    if given is not None:
        return max(float(given), 0.0)
    v = os.environ.get(ENV_DYNAMIC_HEADROOM)
    return max(float(v), 0.0) if v else DEFAULT_DYNAMIC_HEADROOM



def obs_enabled() -> bool:
    """``COMBBLAS_OBS``: telemetry on (any value but unset, empty, "0").
    ``obs/__init__.py`` reads it once, at its import, as the reference's
    does (whose ``obs`` reads the variable itself)."""
    return os.environ.get("COMBBLAS_OBS", "0") not in ("", "0")


def obs_device_sync() -> bool:
    """``COMBBLAS_OBS_SYNC``: the metrics that read device scalars back
    on, read once at ``obs``'s import."""
    return os.environ.get("COMBBLAS_OBS_SYNC", "0") not in ("", "0")


def obs_trace_sample(given: float | None = None) -> float:
    """Per-request trace sampling rate in [0, 1]: explicit argument >
    ``COMBBLAS_OBS_TRACE_SAMPLE`` > 0 (off).  Clamped to [0, 1]."""
    if given is None:
        v = os.environ.get(ENV_OBS_TRACE_SAMPLE)
        given = float(v) if v else 0.0
    return min(max(float(given), 0.0), 1.0)


def pool_byte_budget(given: int | None = None) -> int:
    """Resident-device-byte budget of a serve ``EnginePool``: explicit
    argument > ``COMBBLAS_POOL_BYTE_BUDGET`` > unbounded.  0 (and the
    usual unset/empty) means UNBOUNDED — eviction is opt-in."""
    if given is not None:
        return max(int(given), 0)
    v = _int_env(ENV_POOL_BYTE_BUDGET)
    return DEFAULT_POOL_BYTE_BUDGET if v is None else max(v, 0)


def pool_quantum(given: int | None = None) -> int:
    """Weighted-fair-queueing deficit quantum (requests per round per
    unit weight): explicit argument > ``COMBBLAS_POOL_QUANTUM`` > 16."""
    if given is not None:
        return max(int(given), 1)
    v = _int_env(ENV_POOL_QUANTUM)
    return DEFAULT_POOL_QUANTUM if v is None else max(v, 1)


def fleet_replicas(given: int | None = None) -> int:
    """Default ``FleetRouter.build`` / ``from_checkpoint`` /
    ``from_recovery`` replica count: explicit argument >
    ``COMBBLAS_FLEET_REPLICAS`` > 2."""
    if given is not None:
        return max(int(given), 1)
    v = _int_env(ENV_FLEET_REPLICAS)
    return DEFAULT_FLEET_REPLICAS if v is None else max(v, 1)


def wal_dir(given: str | None = None) -> str | None:
    """The serve durability directory (WAL + checkpoints), or ``None``
    when durability is disabled: explicit argument >
    ``COMBBLAS_WAL`` > off.  ``0``/``off``/``none`` (argument or env)
    disable explicitly — the plan-store convention."""
    v = os.environ.get(ENV_WAL) if given is None else given
    if v is None or v.strip().lower() in ("", "0", "off", "none"):
        return None
    return os.path.abspath(v)


def fleetlog_path(given: str | None = None) -> str | None:
    """Supervision-timeline JSONL path override, or ``None`` to use the
    fleet's own default (``fleetlog.jsonl`` under its workdir):
    explicit argument > ``COMBBLAS_FLEETLOG`` > fleet default.
    ``0``/``off``/``none``/empty fall through to the default — the
    wal_dir convention."""
    v = os.environ.get(ENV_FLEETLOG) if given is None else given
    if v is None or v.strip().lower() in ("", "0", "off", "none"):
        return None
    return os.path.abspath(v)


def obs_hb_metrics_interval(given: float | None = None) -> float:
    """Minimum seconds between child registry snapshots piggybacked on
    replica heartbeats (metrics federation): explicit argument >
    ``COMBBLAS_OBS_HB_METRICS_S`` > 1.0.  Clamped >= 0.05 so a typo
    cannot turn every heartbeat into a full registry serialization."""
    if given is None:
        v = os.environ.get(ENV_OBS_HB_METRICS_S)
        given = float(v) if v else 0.0
    given = float(given)
    if given <= 0.0:
        return DEFAULT_OBS_HB_METRICS_S
    return max(given, 0.05)


def _vet_int(name: str, v, what: str) -> int:
    """Integer-knob vetting shared by the round-19 net knobs: a bogus
    value raises NAMING the knob (the WAL_FSYNC/MERGE precedent)
    instead of surfacing as a bare ``int()`` traceback from deep
    inside socket setup."""
    try:
        return int(v)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be {what}; got {v!r}"
        ) from None


def net_port(given: int | str | None = None) -> int:
    """The front door's TCP listen port: explicit argument >
    ``COMBBLAS_NET_PORT`` > 0 (OS-assigned ephemeral).  Vetted to
    [0, 65535], raising naming the knob."""
    v = os.environ.get(ENV_NET_PORT) if given is None else given
    if v is None or v == "":
        return DEFAULT_NET_PORT
    p = _vet_int(ENV_NET_PORT, v, "an integer port (0 = ephemeral)")
    if not (0 <= p <= 65535):
        raise ValueError(
            f"{ENV_NET_PORT} must be in [0, 65535]; got {v!r}"
        )
    return p


def net_max_conns(given: int | str | None = None) -> int:
    """Open-connection cap of the net frontend: explicit argument >
    ``COMBBLAS_NET_MAX_CONNS`` > 512.  ``0``/unset = default; clamped
    >= 1 (a zero-slot front door would reject its own hello)."""
    v = os.environ.get(ENV_NET_MAX_CONNS) if given is None else given
    if v is None or v == "":
        return DEFAULT_NET_MAX_CONNS
    n = _vet_int(ENV_NET_MAX_CONNS, v, "an integer connection cap")
    return DEFAULT_NET_MAX_CONNS if n == 0 else max(n, 1)


def net_accept_backlog(given: int | str | None = None) -> int:
    """Kernel ``listen()`` backlog: explicit argument >
    ``COMBBLAS_NET_ACCEPT_BACKLOG`` > 128.  ``0``/unset = default;
    clamped >= 1."""
    v = (
        os.environ.get(ENV_NET_ACCEPT_BACKLOG)
        if given is None else given
    )
    if v is None or v == "":
        return DEFAULT_NET_ACCEPT_BACKLOG
    n = _vet_int(ENV_NET_ACCEPT_BACKLOG, v, "an integer backlog")
    return DEFAULT_NET_ACCEPT_BACKLOG if n == 0 else max(n, 1)


def bench_net_rate(given: float | str | None = None) -> float:
    """Open-loop offered arrival rate (req/s): explicit argument >
    ``BENCH_NET_RATE`` > 200.  ``0``/unset = default; a bogus value
    raises naming the knob."""
    v = os.environ.get(ENV_BENCH_NET_RATE) if given is None else given
    if v is None or v == "":
        return DEFAULT_BENCH_NET_RATE
    try:
        r = float(v)
    except (TypeError, ValueError):
        raise ValueError(
            f"{ENV_BENCH_NET_RATE} must be a request rate in req/s; "
            f"got {v!r}"
        ) from None
    return DEFAULT_BENCH_NET_RATE if r == 0 else max(r, 0.1)


def bench_net_conns(given: int | str | None = None) -> int:
    """Open-loop concurrent connection count: explicit argument >
    ``BENCH_NET_CONNS`` > 128.  ``0``/unset = default; clamped >= 1."""
    v = os.environ.get(ENV_BENCH_NET_CONNS) if given is None else given
    if v is None or v == "":
        return DEFAULT_BENCH_NET_CONNS
    n = _vet_int(ENV_BENCH_NET_CONNS, v, "an integer connection count")
    return DEFAULT_BENCH_NET_CONNS if n == 0 else max(n, 1)


def bench_net_seconds(given: float | str | None = None) -> float:
    """Open-loop run length in seconds: explicit argument >
    ``BENCH_NET_SECONDS`` > 8.  ``0``/unset = default."""
    v = (
        os.environ.get(ENV_BENCH_NET_SECONDS)
        if given is None else given
    )
    if v is None or v == "":
        return DEFAULT_BENCH_NET_SECONDS
    try:
        s = float(v)
    except (TypeError, ValueError):
        raise ValueError(
            f"{ENV_BENCH_NET_SECONDS} must be a duration in seconds; "
            f"got {v!r}"
        ) from None
    return DEFAULT_BENCH_NET_SECONDS if s == 0 else max(s, 0.1)


def shard_frontier(given: str | None = None) -> str:
    """Sharded hop frontier encoding: explicit argument >
    ``COMBBLAS_SHARD_FRONTIER`` > ``auto``.  A bogus value raises
    naming the knob (the WAL_FSYNC/MERGE vetting precedent) instead of
    surfacing as a silently-dense wire."""
    v = _str_env(ENV_SHARD_FRONTIER) if given is None else given
    if v is None:
        return DEFAULT_SHARD_FRONTIER
    if v not in SHARD_FRONTIER_MODES:
        raise ValueError(
            f"{ENV_SHARD_FRONTIER} must be one of "
            f"{'|'.join(SHARD_FRONTIER_MODES)}; got {v!r}"
        )
    return v


def shard_density(given: float | str | None = None) -> float:
    """Auto-mode dense-fallback threshold as a frontier-nnz fraction
    of ``n*W``: explicit argument > ``COMBBLAS_SHARD_DENSITY`` > 0.25.
    ``0``/unset = default; vetted to (0, 1] — a fraction above 1 can
    never trigger and reads as a typo'd percentage."""
    v = os.environ.get(ENV_SHARD_DENSITY) if given is None else given
    if v is None or v == "":
        return DEFAULT_SHARD_DENSITY
    try:
        f = float(v)
    except (TypeError, ValueError):
        raise ValueError(
            f"{ENV_SHARD_DENSITY} must be a fraction in (0, 1]; "
            f"got {v!r}"
        ) from None
    if f == 0:
        return DEFAULT_SHARD_DENSITY
    if not (0.0 < f <= 1.0):
        raise ValueError(
            f"{ENV_SHARD_DENSITY} must be a fraction in (0, 1]; "
            f"got {v!r}"
        )
    return f


def shard_wire(given: str | None = None) -> str:
    """Sharded dense-payload wire dtype (propagate's ``q``): explicit
    argument > ``COMBBLAS_SHARD_WIRE`` > ``f32``.  A bogus value
    raises naming the knob instead of surfacing as a silent precision
    downgrade."""
    v = _str_env(ENV_SHARD_WIRE) if given is None else given
    if v is None:
        return DEFAULT_SHARD_WIRE
    if v not in SHARD_WIRE_MODES:
        raise ValueError(
            f"{ENV_SHARD_WIRE} must be one of "
            f"{'|'.join(SHARD_WIRE_MODES)}; got {v!r}"
        )
    return v


def checkpoint_every(given: int | None = None) -> int:
    """Merges between automatic background snapshots: explicit
    argument > ``COMBBLAS_CHECKPOINT_EVERY`` > 8."""
    if given is not None:
        return max(int(given), 1)
    v = _int_env(ENV_CHECKPOINT_EVERY)
    return DEFAULT_CHECKPOINT_EVERY if v is None else max(v, 1)


def checkpoint_retain(given: int | None = None) -> int:
    """Snapshots retained after an automatic checkpoint: explicit
    argument > ``COMBBLAS_CHECKPOINT_RETAIN`` > 2.  Clamped >= 1 —
    retaining zero snapshots would delete the one recovery just
    needs.

    Disk cost: the port's ``save_version`` writes uncompressed
    (``np.savez``), about 4.2x the bytes of the reference's compressed
    snapshot of the same version (277 MB against 66 MB for an R-MAT
    scale-18 graph on 2x2), so a durability directory holds about
    ``retain`` times that, plus the WAL tail the oldest retained
    snapshot does not cover."""
    if given is not None:
        return max(int(given), 1)
    v = _int_env(ENV_CHECKPOINT_RETAIN)
    return DEFAULT_CHECKPOINT_RETAIN if v is None else max(v, 1)


def wal_fsync(given: str | None = None) -> str:
    """WAL append fsync policy: explicit argument >
    ``COMBBLAS_WAL_FSYNC`` > ``always``.  A bogus value raises naming
    the knob (the MERGE/SPMM_BACKEND vetting precedent) instead of
    surfacing as a silent durability downgrade."""
    v = _str_env(ENV_WAL_FSYNC) if given is None else given
    if v is None:
        return DEFAULT_WAL_FSYNC
    if v not in WAL_FSYNC_POLICIES:
        raise ValueError(
            f"{ENV_WAL_FSYNC} must be one of "
            f"{'|'.join(WAL_FSYNC_POLICIES)}; got {v!r}"
        )
    return v


def dynamic_spill_frac() -> float:
    """Structural-change fraction above which the incremental merge
    spills to a full rebuild (``dynamic.merge.spill{reason=threshold}``).
    """
    v = os.environ.get(ENV_DYNAMIC_SPILL)
    return float(v) if v else DEFAULT_DYNAMIC_SPILL_FRAC
