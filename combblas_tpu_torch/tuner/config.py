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
is read at each call, never at import.  The knobs here are the ones the
port's modules read; the reference's pool, fleet, net, shard, WAL-directory
and checkpoint-cadence knobs come with the modules that read them.
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

#: Round-16 knob: the write-ahead log's append fsync policy (docs/serving.md
#: "Durability & self-healing"): ``always`` — every acknowledged write is
#: on disk before its future exists — or ``off``, the OS-buffered
#: throughput mode.
ENV_WAL_FSYNC = "COMBBLAS_WAL_FSYNC"

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
