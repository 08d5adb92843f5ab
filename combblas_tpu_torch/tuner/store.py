"""Measured-cost plan store — counterpart of
``combblas_tpu/tuner/store.py``: remembered SpGEMM / SpMM routing
decisions.

Plans keyed by (op, shape bucket, density band, semiring, backend, grid /
grid3, platform) hold the chosen tier, window geometry, schedule flags,
merge tier and the measured cost, persisted as schema-versioned JSONL
beside the kernel build cache, so a process routes from what an earlier
one measured.

File format — one JSON object per line, append-only (later lines win),
the reference's schema and layout, so a file one package writes loads in
the other:

    {"v": "combblas_tpu.plans/v1", "key": {...}, "plan": {...}}

Robustness contract: a corrupted, truncated or schema-mismatched line is
IGNORED (counted in ``stats()['invalid_lines']``) and routing falls back
to the next rung of the precedence chain — a bad plans file never takes
the library down.  Writes append a fully formed line (one ``write``
call under a shared ``flock``), so a torn write from a dying process
truncates to an invalid LAST line, not a poisoned store.

The key's ``platform`` is the device type of the operands (``"cuda"`` on
the card, ``"cpu"`` on the CPU), so a plan measured on the card is never
replayed on the CPU.  The store also remembers serve warm-up lanes
(``add_serve_lane`` / ``serve_lanes``) for the serving engine.

Host counters (``stats()``) are plain ints and always live; the obs
mirrors (``tuner.store.{hits,misses,entries,invalid,evicted,compacted,
compact_skipped,append_unfenced,write_errors}``) cost nothing when
telemetry is disabled.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import math
import os
import threading
import time

from .. import obs
from . import config

#: JSONL schema tag — bump on any incompatible key/plan layout change;
#: records carrying another tag are ignored at load (never guessed at).
SCHEMA = "combblas_tpu.plans/v1"

_TIERS = (
    "mxu", "windowed", "scan", "esc", "windowed3d", "serve",
    # op="spmm" backends: the gather-contract lane and its
    # exact-everywhere scatter/fold fallback
    "mxu_gather", "scatter",
)


def shape_bucket(dim: int) -> int:
    """Pow2 shape bucket: ceil(log2(dim)).  Two products whose global
    dims round to the same pow2 share plans."""
    return max(int(dim) - 1, 0).bit_length()


def density_band(nnz: int, dim: int) -> int:
    """Log2 band of the average degree (nnz per row): the density axis
    of the plan key.  Clamped so pathological inputs can't mint
    unbounded key cardinality."""
    deg = max(int(nnz), 1) / max(int(dim), 1)
    return int(min(max(round(math.log2(max(deg, 2.0 ** -8))), -8), 48))


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """What a plan is keyed by.  ``op`` distinguishes the 2D router
    ("spgemm"), the 3D entry ("spgemm3d"), the SpMM lane ("spmm") and
    serve warm-up lane sets ("serve"); ``grid3`` is "" for 2D products;
    ``platform`` is the operands' device type."""

    op: str
    shape: tuple[int, int, int]   # shape buckets of (m, k, n)
    band: tuple[int, int]         # density bands of (A, B)
    sr: str
    backend: str
    grid: str                     # "pr x pc", e.g. "2x2"
    grid3: str = ""               # "L x pr x pc" for 3D, else ""
    platform: str = ""            # "cuda" | "cpu"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        d["band"] = list(self.band)
        return d

    @staticmethod
    def from_json(d: dict) -> "PlanKey":
        return PlanKey(
            op=str(d["op"]),
            shape=tuple(int(x) for x in d["shape"]),
            band=tuple(int(x) for x in d["band"]),
            sr=str(d["sr"]),
            backend=str(d["backend"]),
            grid=str(d["grid"]),
            grid3=str(d.get("grid3", "")),
            platform=str(d.get("platform", "")),
        )


@dataclasses.dataclass
class PlanRecord:
    """One remembered decision: the winning tier plus the knobs it was
    measured with and the measured cost.  ``block_rows``/``block_cols``
    of ``None`` mean "the kernel default for this shape".  ``lanes`` is
    the serve-warm-up variant's payload ((kind, width) pairs); spgemm
    records leave it empty."""

    tier: str
    block_rows: int | None = None
    block_cols: int | None = None
    ring: bool = False
    pipeline: bool = True
    dispatch: str | None = None
    mode: str | None = None
    #: Combine-merge tier (sort | runs | hash); ``None`` means "whatever
    #: the entry's env/heuristic resolves".
    merge: str | None = None
    cost_s: float | None = None
    source: str = "probe"          # probe | manual | bench
    probe_dim: int | None = None   # proxy dimension the cost came from
    lanes: tuple = ()
    #: Measurement wall-clock (``time.time()``): the aging policy's
    #: eviction order — records without one age out first.  Excluded
    #: from equality (bookkeeping, not part of the decision).
    ts: float | None = dataclasses.field(default=None, compare=False)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["lanes"] = [list(x) for x in self.lanes]
        return d

    @staticmethod
    def from_json(d: dict) -> "PlanRecord":
        tier = str(d["tier"])
        if tier not in _TIERS:
            raise ValueError(f"unknown tier {tier!r}")
        disp = d.get("dispatch")
        if disp is not None and disp not in ("auto", "fused", "blocked"):
            # vetted at LOAD time so a schema-valid but hand-mangled
            # line is skipped as invalid, never trusted at routing
            raise ValueError(f"unknown dispatch {disp!r}")
        merge = d.get("merge")
        if merge is not None and merge not in config.MERGE_TIER_NAMES:
            raise ValueError(f"unknown merge tier {merge!r}")
        br = d.get("block_rows")
        bc = d.get("block_cols")
        return PlanRecord(
            tier=tier,
            block_rows=None if br is None else int(br),
            block_cols=None if bc is None else int(bc),
            ring=bool(d.get("ring", False)),
            pipeline=bool(d.get("pipeline", True)),
            dispatch=d.get("dispatch"),
            mode=d.get("mode"),
            merge=merge,
            cost_s=(
                None if d.get("cost_s") is None else float(d["cost_s"])
            ),
            source=str(d.get("source", "probe")),
            probe_dim=(
                None if d.get("probe_dim") is None
                else int(d["probe_dim"])
            ),
            lanes=tuple(
                (str(k), int(w)) for k, w in d.get("lanes", ())
            ),
            ts=None if d.get("ts") is None else float(d["ts"]),
        )


def _line(key: PlanKey, rec: PlanRecord) -> str:
    return json.dumps(
        {"v": SCHEMA, "key": key.to_json(), "plan": rec.to_json()}
    ) + "\n"


class PlanStore:
    """Load-once, append-on-write JSONL plan store (threadsafe)."""

    def __init__(self, path: str):
        #: Directory holding ``plans.jsonl``.
        self.path = os.path.abspath(path)
        self.file = os.path.join(self.path, "plans.jsonl")
        self._lock = threading.Lock()
        self._plans: dict[PlanKey, PlanRecord] = {}
        self._hits = 0
        self._misses = 0
        self._invalid = 0
        self._probe_runs = 0
        self._probe_seconds = 0.0
        self._compacted = 0
        self._evicted = 0
        self._loaded_size = -1
        self._load()
        if obs.ENABLED:
            obs.gauge("tuner.store.entries", len(self._plans), dir=self.path)

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self.file, encoding="utf-8") as f:
                lines = f.readlines()
                # size of what was read: the compaction rewrite refuses
                # to replace a file another process appended to since
                self._loaded_size = os.fstat(f.fileno()).st_size
        except OSError:
            return  # no store yet: every lookup is a miss
        valid_lines = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                if d.get("v") != SCHEMA:
                    raise ValueError(f"schema {d.get('v')!r}")
                key = PlanKey.from_json(d["key"])
                rec = PlanRecord.from_json(d["plan"])
            except (ValueError, KeyError, TypeError, AttributeError):
                # corrupted / truncated / wrong-schema line: count it,
                # skip it, keep loading — the robustness contract
                self._invalid += 1
                if obs.ENABLED:
                    obs.count("tuner.store.invalid")
                continue
            valid_lines += 1
            self._plans[key] = rec  # append-only log: later lines win
        # aging: bound the loaded set (max-entries cap, oldest-cost
        # eviction) and the file (compaction of shadowed lines)
        superseded = valid_lines - len(self._plans)
        evicted = self._evict_to_cap(config.store_max_entries())
        if superseded + evicted >= max(config.store_compact_min(), 1):
            self._compact(superseded + evicted)

    def _evict_to_cap(self, cap: int, protect: "PlanKey | None" = None
                      ) -> int:
        """Drop OLDEST-COST entries (the ``ts`` stamped when the cost
        was measured; records without one age out first, insertion
        order breaking ties) until at most ``cap`` remain."""
        cap = max(cap, 1)
        if len(self._plans) <= cap:
            return 0
        order = {k: i for i, k in enumerate(self._plans)}
        victims = sorted(
            (k for k in self._plans if k != protect),
            key=lambda k: ((self._plans[k].ts or 0.0), order[k]),
        )
        n = 0
        for k in victims:
            if len(self._plans) <= cap:
                break
            del self._plans[k]
            n += 1
        if n:
            self._evicted += n
            if obs.ENABLED:
                obs.count("tuner.store.evicted", n)
        return n

    def _lock_file(self) -> str:
        """Sidecar advisory-lock path — the data file itself is
        ``os.replace``d by compaction, so flocking it would pin the OLD
        inode while a sibling locks the new one."""
        return self.file + ".lock"

    def _compact(self, removed_lines: int) -> None:
        """Rewrite ``plans.jsonl`` as exactly the surviving entries
        (insertion order kept), atomically, under an EXCLUSIVE
        non-blocking ``flock`` on the sidecar: a sibling holding the lock
        skips the compaction, and a file that grew since the load is left
        alone (the next loader compacts instead)."""
        tmp = self.file + ".tmp"
        lf = None
        try:
            os.makedirs(self.path, exist_ok=True)
            lf = os.open(
                self._lock_file(), os.O_CREAT | os.O_RDWR, 0o644
            )
            try:
                fcntl.flock(lf, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                # a sibling holds the lock: skip
                if obs.ENABLED:
                    obs.count("tuner.store.compact_skipped")
                return
            if os.path.getsize(self.file) != self._loaded_size:
                return  # sibling appended since we read: leave it
            with open(tmp, "w", encoding="utf-8") as f:
                for key, rec in self._plans.items():
                    f.write(_line(key, rec))
            os.replace(tmp, self.file)
        except OSError:
            # read-only store: the in-memory view is compact anyway
            if obs.ENABLED:
                obs.count("tuner.store.write_errors")
            return
        finally:
            if lf is not None:
                try:
                    fcntl.flock(lf, fcntl.LOCK_UN)
                except OSError:
                    pass
                os.close(lf)
        self._compacted += removed_lines
        if obs.ENABLED:
            obs.count("tuner.store.compacted", removed_lines)

    def _append(self, key: PlanKey, rec: PlanRecord) -> None:
        """One O_APPEND ``write`` of a whole line under a SHARED
        ``flock`` (concurrent with other appenders, excluded only from a
        compaction rewrite).  The lock is tried non-blocking a few times;
        after that the append proceeds unfenced rather than wait on a
        wedged holder."""
        line = _line(key, rec)
        lf = None
        try:
            os.makedirs(self.path, exist_ok=True)
            lf = os.open(
                self._lock_file(), os.O_CREAT | os.O_RDWR, 0o644
            )
            locked = False
            for _ in range(10):
                try:
                    fcntl.flock(lf, fcntl.LOCK_SH | fcntl.LOCK_NB)
                    locked = True
                    break
                except OSError:
                    time.sleep(0.005)  # a rewrite lasts ~ms
            if not locked:
                os.close(lf)
                lf = None
                if obs.ENABLED:
                    obs.count("tuner.store.append_unfenced")
            fd = os.open(
                self.file, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                0o644,
            )
            try:
                os.write(fd, line.encode("utf-8"))
            finally:
                os.close(fd)
        except OSError:
            # read-only store: the in-memory plan still routes
            if obs.ENABLED:
                obs.count("tuner.store.write_errors")
        finally:
            if lf is not None:
                try:
                    fcntl.flock(lf, fcntl.LOCK_UN)
                except OSError:
                    pass
                os.close(lf)

    # -- lookup / record ---------------------------------------------------

    def lookup(self, key: PlanKey) -> PlanRecord | None:
        with self._lock:
            rec = self._plans.get(key)
            if rec is None:
                self._misses += 1
            else:
                self._hits += 1
        if obs.ENABLED:
            obs.count("tuner.store.misses" if rec is None else "tuner.store.hits", op=key.op)
        return rec

    def peek(self, key: PlanKey) -> PlanRecord | None:
        """Lookup WITHOUT hit/miss accounting — for store maintenance,
        not routing."""
        with self._lock:
            return self._plans.get(key)

    def put(self, key: PlanKey, rec: PlanRecord,
            persist: bool = True) -> None:
        if rec.ts is None:
            rec.ts = time.time()  # the aging policy's eviction order
        with self._lock:
            self._plans[key] = rec
            # the cap holds at put time too (the file keeps the evicted
            # line until the next load-time compaction reclaims it)
            self._evict_to_cap(config.store_max_entries(), protect=key)
        if persist:
            self._append(key, rec)
        if obs.ENABLED:
            obs.gauge("tuner.store.entries", len(self._plans), dir=self.path)

    def add_serve_lane(self, key: PlanKey, kind: str,
                       width: int) -> bool:
        """Merge one (kind, width) into the serve-lane record for
        ``key``; returns True (and persists) iff the lane is new."""
        lane = (str(kind), int(width))
        with self._lock:
            rec = self._plans.get(key)
            if rec is None:
                rec = PlanRecord(tier="serve", source="serve")
                self._plans[key] = rec
            if lane in rec.lanes:
                return False
            rec.lanes = tuple(sorted(set(rec.lanes) | {lane}))
            rec.ts = time.time()  # a serving graph's lane set stays young
        self._append(key, rec)
        return True

    def serve_lanes(self, key: PlanKey) -> tuple:
        with self._lock:
            rec = self._plans.get(key)
            return rec.lanes if rec is not None else ()

    # -- bookkeeping -------------------------------------------------------

    def record_probe(self, runs: int, seconds: float) -> None:
        with self._lock:
            self._probe_runs += runs
            self._probe_seconds += seconds

    def entries(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "entries": len(self._plans),
                "hits": self._hits,
                "misses": self._misses,
                "invalid_lines": self._invalid,
                "probe_runs": self._probe_runs,
                "probe_seconds": round(self._probe_seconds, 4),
                "compacted_lines": self._compacted,
                "evicted": self._evicted,
            }


# -- process-wide store -----------------------------------------------------

_store: PlanStore | None = None
_store_path: str | None = None
_store_lock = threading.Lock()


def get_store() -> PlanStore | None:
    """The process's plan store, or ``None`` when disabled
    (``COMBBLAS_PLAN_STORE=0``).  The dir is re-resolved per call so a
    changed ``COMBBLAS_PLAN_STORE`` takes effect; the loaded instance is
    cached per resolved path."""
    global _store, _store_path
    path = config.store_dir()
    if path is None:
        return None
    with _store_lock:
        if _store is None or _store_path != path:
            _store = PlanStore(path)
            _store_path = path
        return _store


def _reset_for_tests() -> None:
    """Drop the cached instance so the next ``get_store`` reloads from
    disk (lets a caller observe an on-disk change within one
    process)."""
    global _store, _store_path
    with _store_lock:
        _store = None
        _store_path = None


# -- key builders -----------------------------------------------------------


def _host_nnz(M) -> int:
    """Total live nnz of a distributed matrix as a host int, read back
    once per matrix and memoized on the object (the matrices are frozen
    dataclasses, hence ``object.__setattr__``)."""
    cached = getattr(M, "_host_nnz_cache", None)
    if cached is not None:
        return cached
    val = int(M.getnnz().item())
    object.__setattr__(M, "_host_nnz_cache", val)
    return val


def plan_key_from_counts(
    sr_name: str,
    m: int, k: int, n: int,
    nnz_a: int, nnz_b: int,
    backend: str,
    grid: str,
    grid3: str = "",
    op: str = "spgemm",
    platform: str | None = None,
) -> PlanKey:
    """The canonical key from host-side counts; the matrix-based builders
    below funnel through here.  ``platform`` defaults to ``"cuda"``, the
    port's default device."""
    return PlanKey(
        op=op,
        shape=(shape_bucket(m), shape_bucket(k), shape_bucket(n)),
        band=(density_band(nnz_a, m), density_band(nnz_b, k)),
        sr=sr_name,
        backend=backend,
        grid=grid,
        grid3=grid3,
        platform="cuda" if platform is None else platform,
    )


def spgemm_plan_key(sr, A, B, backend: str, grid3=None) -> PlanKey:
    """Plan key for a 2D ``spgemm_auto`` product (one memoized host
    nnz readback per operand)."""
    g3 = (
        f"{grid3.layers}x{grid3.pr}x{grid3.pc}"
        if grid3 is not None else ""
    )
    return plan_key_from_counts(
        sr.name, int(A.nrows), int(A.ncols), int(B.ncols),
        _host_nnz(A), _host_nnz(B) if B is not A else _host_nnz(A),
        backend, f"{A.grid.pr}x{A.grid.pc}", grid3=g3,
        platform=A.grid.device.type,
    )


def spgemm3d_plan_key(sr, A3, B3, backend: str) -> PlanKey:
    """Plan key for the 3D entry (``mesh3d.spgemm3d``)."""
    g = A3.grid
    return plan_key_from_counts(
        sr.name, int(A3.nrows), int(A3.ncols), int(B3.ncols),
        _host_nnz(A3), _host_nnz(B3) if B3 is not A3 else _host_nnz(A3),
        backend, f"{g.pr}x{g.pc}",
        grid3=f"{g.layers}x{g.pr}x{g.pc}", op="spgemm3d",
        platform=g.device.type,
    )


def spmm_plan_key(sr, E, feat_width: int,
                  platform: str | None = None) -> PlanKey:
    """Plan key for the batched SpMM lane: the feature-width bucket rides
    the key's third shape slot (two products over one graph at F=64 and
    F=512 can rank the backends differently), the density band comes
    from the sparse operand only.  ``platform`` defaults to the
    operand's device type."""
    return PlanKey(
        op="spmm",
        shape=(
            shape_bucket(int(E.nrows)), shape_bucket(int(E.ncols)),
            shape_bucket(int(feat_width)),
        ),
        band=(density_band(_host_nnz(E), int(E.nrows)), 0),
        sr=sr.name,
        backend="",
        grid=f"{E.grid.pr}x{E.grid.pc}",
        platform=E.grid.device.type if platform is None else platform,
    )


def serve_plan_key(engine) -> PlanKey:
    """Key for a serving engine's warm-up-lane record: the graph's shape
    bucket + density band + grid (version-independent — hot-swapped
    same-shape versions keep the same lane set).  Reads only
    ``engine.version.{nrows, ncols, nnz}`` and ``engine.grid.{pr, pc}``."""
    v = engine.version
    nnz = max(int(getattr(v, "nnz", -1)), 1)
    return PlanKey(
        op="serve",
        shape=(shape_bucket(int(v.nrows)),
               shape_bucket(int(v.ncols)), 0),
        band=(density_band(nnz, int(v.nrows)), 0),
        sr="",
        backend="",
        grid=f"{engine.grid.pr}x{engine.grid.pc}",
    )
