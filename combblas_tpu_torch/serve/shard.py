"""Sharded serving: one graph, N slices, one service; counterpart of
``combblas_tpu/serve/shard.py``.

Every replica of the fleets holds the WHOLE graph, so one card's memory
is also the serving capacity. This module partitions one graph's row
space over N slices (the 2D ``CommGrid`` distribution collapsed to the
1D row slabs the batched [n, W] serve steps consume) and serves the
union as ONE engine:

* ``plan_partition`` / ``shard_coo`` — balanced contiguous row slabs;
  slice i owns global rows ``[row0, row1)`` as a RECTANGULAR ``ls x n``
  ``EllParMat`` (``_build_version`` handles rectangles), so a slice's
  resident device bytes scale about 1/p.
* ``SliceRuntime`` — everything that lives INSIDE one slice: the slab
  ``GraphVersion``, the per-hop step plans (the step bodies of
  ``models/bfs.py`` / ``models/sssp.py`` / ``models/propagate.py``,
  re-closed over the slab operands — one program, N data), the
  per-slice WAL + slab snapshots, and slab recovery.
* ``LocalSlice`` / ``ProcSlice`` — the parent-side handles: in-process
  (every slice on this process's CUDA context) and subprocess (a fresh
  interpreter with its own CUDA context behind the framed IPC channel,
  ``serve/_shardworker.py``).
* ``ShardedEngine`` — duck-types ``GraphEngine`` for ``serve/api.py``:
  queries fan in through the batcher, each hop executes on every slice,
  the router gathers slab outputs at the owning slice and feeds the
  concatenated frontier back — a bulk-synchronous mirror of the
  single-program search loop with IDENTICAL iteration semantics (the
  step always runs at least once; continue iff any slice found new
  work and ``niter`` is under the cap), so bfs/sssp answers are
  BIT-EXACT against an unsharded engine (their per-row combines —
  SELECT2ND_MAX, min — are order-independent, so the slab bucket layout
  cannot change them).

The hop datapath is the CombBLAS SpMSpV stance applied at the wire:
slab-local loop state (bfs ``parents``/``levels``, the sssp resident
global ``d``, propagate's last slab ``q``) stays DEVICE-RESIDENT on its
slice across the hops of one batch, keyed by a per-batch epoch token the
router mints, and only the live frontier crosses the wire — as
dtype-minimized ``SparseFrontier`` triples when it is sparse, falling
back to the dense ``[n, W]`` operand per hop when it crosses the density
threshold (decided by the ROUTER and stamped in the payload;
``COMBBLAS_SHARD_FRONTIER`` forces either encoding). The sparse frontier
scatters into the dense operand on the device, and the final gather
fetches slab state ONCE at batch end (``collect``). Replay stays
idempotent: a slice that dies mid-batch fails the hop future, the router
heals it and replays the whole batch under a FRESH epoch (re-seeding
resident state everywhere); a respawned slice asked to advance an epoch
it never saw answers ``StaleEpochError`` — a protocol fact, not a death
— and the router replays without quarantining it. Propagate's dense
``q`` can opt into bf16 wire encoding (``COMBBLAS_SHARD_WIRE=bf16``).

Durability is ENGINE-OWNED (``owns_durability``): writes route through
per-slice WALs with a coordinated two-phase protocol — phase 1 appends
the FULL batch (global coordinates, contiguous sequence numbers) to
every slice's log (any failure tombstones the appended slices and fails
the write); phase 2 applies the row-filtered, slab-translated sub-batch
on every live slice (idempotent: a commit at or below a slice's frontier
is a no-op, so post-heal re-commits and recovery replay compose). The
scalar ``GraphVersion.wal_seq`` stamp becomes a VECTOR frontier: each
slab snapshot carries its own scalar stamp on the SHARED sequence line,
and the service manifest (``shard_manifest.json``) records the
per-slice vector.

Slice recovery reuses the process fleet's sticky quarantine/respawn
stance at slice granularity: ``supervise_once`` collapses a dead or hung
slice (SIGKILL), respawns it from its slab snapshot + WAL suffix with
capped-backoff retry, and the OTHER slices keep serving throughout.

Obs series live under ``serve.shard.*`` (cataloged in
``obs/metrics.py``).

On the card. Each slice's tensors live on its grid's device (the card
by default, ``device="cpu"`` where a caller asks), and every slice op
runs under ``api.device_scope``. A local slice shares this process's
CUDA context; a process slice is a child with a context of its own and
the router does no device work at all (its ``device`` is the CPU).

Deviations from the reference, kept on purpose:

* **Plans.** The reference jits one hop program per (kind, width) and
  one scatter prologue per pow2 capacity bucket. The port runs eager
  torch: a plan is the same step body as a closure, ``traces`` counts
  its builds (one per (kind, width)), so ``warmup`` builds every plan
  and ``retraces_since(mark) == 0`` after it. There are no capacity
  buckets: the live triples scatter as they are (bfs's unique-index set
  is an ``index_put_``, sssp's scatter-min a ``scatter_reduce_`` on the
  int32 order keys of ``ops/spgemm.py:fold_keys``), and the
  ``trace.serve.shard`` counter is left out, as the port's other
  ``trace.*`` counters are.
* ``device=`` names the slices' device in ``build`` and ``recover``
  (the reference's local factories take the default device, its
  process slices a count of virtual CPU devices).
* **CUDA errors, by mode.** Local slices share this process's context,
  so a CUDA error one meets is the card's: the engine keeps it as
  ``device_error`` and raises it at once; it quarantines nothing,
  ``supervise_once`` heals nothing while it is held, and a ``Server``
  over the engine reports ``down``. A process slice's error is its own:
  the slice is quarantined (SIGKILL) and respawned with a fresh context,
  the batch replays, and ``shares_context`` (False) tells a ``Server``
  over the engine that the error text it may see is a child's, not its
  own context's.
* The slice handles have no ``pid`` or ``signal`` (no caller);
  ``kill`` is the SIGKILL.
* Process slices boot concurrently (every child is launched before the
  first boot reply is awaited), and a boot that fails quarantines its
  child (and, in ``build``/``recover``, the siblings already started).
* A process slice's first-boot slab travels as a file in its home
  (``SLAB_COO_NAME``), not inside the boot message: a frame is capped at
  64 MB in both packages, and a scale-18 slab passes it (77 MB). The
  hops still cross the socket, so a dense ``[n, W]`` hop must fit a
  frame (``n * W * 4`` bytes: n = 2**20 at W = 16 does not).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import torch

from .. import obs
from ..dynamic import wal as dyn_wal
from ..dynamic.delta import DeltaBatch
from ..tuner import config as tuner_config
from ..utils import checkpoint as ckpt
from .api import _is_device_error, device_scope
from .frame import SparseFrontier, pack_bf16, unpack_bf16
from .ipc import Channel
from .policy import ReplicaDeadError, StaleEpochError
from .procfleet import IpcTimeoutError, ReplicaProc

#: Manifest schema tag (refused at recovery when mismatched — the
#: plan-store convention: never guess at an incompatible layout). The
#: reference's tag, so that either package reads a home the other wrote.
MANIFEST_SCHEMA = "combblas_tpu.shard_manifest/v1"
MANIFEST_NAME = "shard_manifest.json"

#: Per-slice feature-table slab file (features are edge-independent,
#: so they are persisted ONCE at build, not per snapshot).
FEATURES_NAME = "features.npy"

#: A process slice's first-boot slab (COO, weights, feature slab), written
#: into its home by the router and removed by the child once built: the
#: frame codec caps a message at ``frame.MAX_FRAME`` (64 MB), which one
#: slab of a scale-18 R-MAT graph already passes.
SLAB_COO_NAME = "slab_coo.npz"

#: Kinds the sharded router can execute.  pagerank/bc need whole-graph
#: normalization / backward sweeps that do not decompose into the
#: stateless row-slab hop protocol — they stay on unsharded engines.
SHARDED_KINDS = ("bfs", "sssp", "propagate")

#: The lane widths ``warmup`` covers by default (the batcher's buckets).
WARMUP_WIDTHS = (1, 2, 4, 8, 16)


def _payload_nbytes(obj) -> int:
    """Logical wire bytes of a hop payload/reply: the array payloads
    that dominate the frame (JSON header overhead excluded — it is
    O(100 B) against KB..MB of state)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, SparseFrontier):
        return obj.nbytes()
    if isinstance(obj, dict):
        return sum(_payload_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_payload_nbytes(v) for v in obj)
    return 0


def _pack_q_wire(q: np.ndarray, wire: str | None) -> dict:
    """Encode a dense float payload for the wire: raw f32, or bf16
    halved-width uint16 when the router stamped ``wire=bf16``."""
    if wire == "bf16":
        return {"q": pack_bf16(q), "wire": "bf16"}
    return {"q": np.asarray(q, np.float32), "wire": "f32"}


def _unpack_q(m: dict) -> np.ndarray:
    q = m["q"]
    if m.get("wire") == "bf16":
        return unpack_bf16(q)
    return np.asarray(q, np.float32)


def _build_kinds(kinds) -> tuple:
    """The matrices a slab version needs: the structural / weighted
    slab (propagate's hop reuses E — symmetric graphs only — and its
    feature slab is attached apart)."""
    return tuple(k for k in kinds if k in ("bfs", "sssp")) or ("bfs",)


# --------------------------------------------------------------------------
# partition planning
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """A contiguous row-slab partition of ``[0, nrows)``."""

    nrows: int
    ncols: int
    bounds: tuple  # tuple[(row0, row1), ...] — slice i owns [row0, row1)

    @property
    def nslices(self) -> int:
        return len(self.bounds)

    def owner_of(self, row: int) -> int:
        for i, (a, z) in enumerate(self.bounds):
            if a <= row < z:
                return i
        raise ValueError(f"row {row} outside [0, {self.nrows})")


def plan_partition(nrows: int, nslices: int,
                   ncols: int | None = None) -> ShardSpec:
    """Balanced contiguous row slabs: the first ``nrows % nslices``
    slices get one extra row — every slice within one row of ideal,
    and slab membership is one integer compare (no owner table)."""
    n = int(nrows)
    p = int(nslices)
    if not 1 <= p <= n:
        raise ValueError(f"need 1 <= nslices <= nrows, got {p} / {n}")
    base, extra = divmod(n, p)
    bounds = []
    r0 = 0
    for i in range(p):
        r1 = r0 + base + (1 if i < extra else 0)
        bounds.append((r0, r1))
        r0 = r1
    return ShardSpec(nrows=n, ncols=int(ncols if ncols is not None
                                         else n), bounds=tuple(bounds))


def shard_coo(spec: ShardSpec, i: int, rows, cols, weights=None):
    """Slice ``i``'s slab of a global COO: rows TRANSLATED to slab
    coordinates (``- row0``), columns kept global (the slab matrix is
    ``ls x ncols`` — hops read the full frontier)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    r0, r1 = spec.bounds[i]
    m = (rows >= r0) & (rows < r1)
    w = None if weights is None else np.asarray(weights)[m]
    return rows[m] - r0, cols[m], w


# --------------------------------------------------------------------------
# the slice runtime (lives inside the owning process)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _SlicePlan:
    kind: str
    width: int
    fn: object
    scatter: object = None   # sparse-frontier scatter prologue
    traces: int = 0          # plan builds (the reference counts traces)
    executions: int = 0


class SliceRuntime:
    """One slice's resident state + hop plans + durability.

    Hosted either in-process (``LocalSlice``) or inside a
    ``_shardworker`` subprocess (``ProcSlice``); either way the op
    surface is :func:`dispatch_slice_op` — one protocol, two
    transports, the ``frame.py`` precedent.
    """

    def __init__(self, grid, idx: int, row0: int, row1: int,
                 nrows: int, ncols: int, version, kinds, *,
                 home: str | None = None, fsync: str | None = None,
                 features=None, max_iters: int | None = None,
                 propagate_hops: int = 2,
                 checkpoint_every: int = 0,
                 checkpoint_retain: int = 2):
        self.grid = grid
        self.idx = int(idx)
        self.row0 = int(row0)
        self.row1 = int(row1)
        self.ls = self.row1 - self.row0
        self.nrows = int(nrows)    # GLOBAL row count
        self.ncols = int(ncols)    # global column space
        self.version = version     # slab GraphVersion (nrows == ls)
        self.kinds = tuple(kinds)
        self.max_iters = max_iters
        self.propagate_hops = int(propagate_hops)
        self.home = home
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_retain = max(1, int(checkpoint_retain))
        self._commits_since_ckpt = 0
        self.wal = dyn_wal.open_wal(home, fsync=fsync) \
            if home is not None else None
        self._plans: dict = {}
        # per-kind slice-resident loop state, keyed by the router's
        # batch epoch: parents/levels slabs (bfs), the global d operand
        # (sssp), the last hop's q slab (propagate)
        self._resident: dict = {}
        self._lock = threading.Lock()
        self.plan_hits = 0
        self.plan_misses = 0
        self.swaps = 0
        self.worker_errors = 0
        # the slab feature table (propagate): rows [row0, row1) of the
        # global [n, F] table, pow2-padded, device-resident — kept OFF
        # the slab GraphVersion and re-attached from ``features.npy``
        # at recovery
        self.X = None
        self.feat_dim = 0
        if features is not None:
            self.attach_features(features)
        self._row_gids = None  # lazy [1, ls] global row-id operand

    @property
    def device(self) -> torch.device:
        return self.grid.device

    # -- construction / recovery ------------------------------------------

    @classmethod
    def build(cls, grid, idx: int, row0: int, row1: int, nrows: int,
              ncols: int, rows, cols, weights, kinds, *,
              features=None, headroom=None, home: str | None = None,
              fsync: str | None = None, max_iters=None,
              propagate_hops: int = 2, checkpoint_every: int = 0,
              checkpoint_retain: int = 2,
              bootstrap_checkpoint: bool = True) -> "SliceRuntime":
        """Build one slice from its slab COO (rows ALREADY translated
        to slab coordinates — see ``shard_coo``)."""
        from .engine import _build_version

        ls = int(row1) - int(row0)
        version = _build_version(
            grid, np.asarray(rows), np.asarray(cols), ls, int(ncols),
            weights, _build_kinds(kinds), False, True, features=None,
            headroom=headroom,
        )
        feats_slab = None
        if features is not None:
            feats_slab = np.asarray(
                features, np.float32
            )[int(row0):int(row1)]
        rt = cls(
            grid, idx, row0, row1, nrows, ncols, version, kinds,
            home=home, fsync=fsync, features=feats_slab,
            max_iters=max_iters, propagate_hops=propagate_hops,
            checkpoint_every=checkpoint_every,
            checkpoint_retain=checkpoint_retain,
        )
        if home is not None:
            if feats_slab is not None:
                np.save(os.path.join(home, FEATURES_NAME), feats_slab)
            if bootstrap_checkpoint:
                # durability floor: recovery needs at least one
                # snapshot to anchor the WAL-suffix replay
                rt.checkpoint_now(reason="bootstrap")
        return rt

    @classmethod
    def recover(cls, grid, idx: int, home: str, kinds, *,
                fsync: str | None = None, max_iters=None,
                propagate_hops: int = 2, checkpoint_every: int = 0,
                checkpoint_retain: int = 2) -> "SliceRuntime":
        """Slab crash recovery: latest slab snapshot + per-slice WAL
        suffix, each replayed batch row-filtered to the slab and
        translated (``recover_version(batch_filter=...)``) — brings
        THIS slice to its own frontier without touching the rest."""
        wal = dyn_wal.open_wal(home, fsync=fsync)
        try:
            probe = ckpt.load_latest_version(home, grid,
                                             writable=False)[0]
            shard = (getattr(probe, "extra_meta", None) or {}).get(
                "shard"
            )
            if shard is None:
                raise dyn_wal.RecoveryError(
                    f"snapshots in {home!r} carry no shard descriptor"
                    " (not a slice home?)"
                )
            del probe
            row0, row1 = int(shard["row0"]), int(shard["row1"])
            nrows, ncols = int(shard["nrows"]), int(shard["ncols"])

            def slab_filter(batch):
                m = (batch.rows >= row0) & (batch.rows < row1)
                if not m.any():
                    return None
                return DeltaBatch(
                    rows=batch.rows[m] - row0, cols=batch.cols[m],
                    vals=batch.vals[m], ops=batch.ops[m],
                    first_seq=batch.first_seq,
                    last_seq=batch.last_seq, oldest_at=0.0,
                )

            version = dyn_wal.recover_version(
                home, wal, grid, kinds=_build_kinds(kinds),
                batch_filter=slab_filter,
            )
        except BaseException:
            wal.close()
            raise
        feats = None
        fpath = os.path.join(home, FEATURES_NAME)
        if os.path.exists(fpath):
            feats = np.load(fpath)
        rt = cls(
            grid, idx, row0, row1, nrows, ncols, version, kinds,
            home=None, fsync=fsync, features=feats,
            max_iters=max_iters, propagate_hops=propagate_hops,
            checkpoint_every=checkpoint_every,
            checkpoint_retain=checkpoint_retain,
        )
        rt.home = home
        rt.wal = wal
        obs.count("serve.shard.recoveries", slice=idx)
        return rt

    def attach_features(self, feats_slab) -> None:
        from ..parallel.spmm import pad_features
        from ..parallel.vec import DistMultiVec

        feats_slab = np.asarray(feats_slab, np.float32)
        if feats_slab.shape[0] != self.ls:
            raise ValueError(
                f"feature slab rows {feats_slab.shape[0]} != slab "
                f"height {self.ls}"
            )
        self.feat_dim = int(feats_slab.shape[1])
        self.X = DistMultiVec.from_global(
            self.grid, pad_features(feats_slab), align="row"
        )

    # -- slab step plans ---------------------------------------------------

    def _slab_row_gids(self) -> torch.Tensor:
        """[1, ls] GLOBAL row ids of this slab on the slice's device."""
        if self._row_gids is None:
            self._row_gids = torch.arange(
                self.row0, self.row1, dtype=torch.int32,
                device=self.device,
            )[None]
        return self._row_gids

    def plan(self, kind: str, width: int) -> _SlicePlan:
        if kind not in self.kinds:
            raise ValueError(
                f"slice was not built for kind {kind!r} "
                f"(kinds={self.kinds})"
            )
        key = (kind, int(width))
        with self._lock:
            p = self._plans.get(key)
        if p is not None:
            self.plan_hits += 1
            return p
        self.plan_misses += 1
        p = self._build_plan(kind, int(width))
        with self._lock:
            self._plans[key] = p
        return p

    def _build_plan(self, kind: str, width: int) -> _SlicePlan:
        """One hop plan per (kind, width) — the step body of the
        unsharded search loop (models/bfs.py / models/sssp.py /
        models/propagate.py), re-closed over the slab operands, with
        the loop state as ARGUMENTS (the router is the loop). Operands
        resolve at call time from ``self.version``, so a merge swap
        keeps every plan (no plan is built after warm-up)."""
        from ..ops.spgemm import fold_keys, from_fold_keys
        from ..operations import minimum
        from ..parallel.ellmat import (
            dist_spmv_ell_masked_multi, dist_spmv_ell_multi,
        )
        from ..parallel.spmm import dist_spmm_ell
        from ..parallel.vec import DistMultiVec
        from ..semiring import MIN_PLUS, PLUS_TIMES, SELECT2ND_MAX

        grid = self.grid
        dev = self.device
        n = self.ncols
        ls = self.ls
        row0, row1 = self.row0, self.row1
        plan = _SlicePlan(kind=kind, width=width, fn=None, traces=1)

        def mkcol(x):
            return DistMultiVec(blocks=x[None], length=n,
                                align="col", grid=grid)

        def triples(sf: SparseFrontier):
            rows = torch.from_numpy(sf.rows).to(dev)
            idx = rows.long() * width + torch.from_numpy(
                sf.lanes.astype(np.int64)).to(dev)
            return rows, idx

        if kind == "bfs":

            def impl(x, parents, levels, level):
                # x: [n, W] global frontier (v if newly visited else
                # -1); parents/levels: [ls, W] slab state; level: the
                # router's niter
                row_gids = self._slab_row_gids()
                pb, lb = parents[None], levels[None]
                unvisited = DistMultiVec(
                    blocks=pb < 0, length=ls, align="row", grid=grid
                )
                y = dist_spmv_ell_masked_multi(
                    SELECT2ND_MAX, self.version.E, mkcol(x), unvisited
                )
                new = (
                    (y.blocks >= 0) & (pb < 0)
                    & (row_gids[:, :, None] >= 0)
                )
                pb = torch.where(new, y.blocks, pb)
                lb = torch.where(new, level + 1, lb)
                x_next = torch.where(new, row_gids[:, :, None], -1)
                # no any_new output: the host derives activity from the
                # discovered nnz it extracts for the wire anyway
                return pb[0], lb[0], x_next[0]

            plan.fn = impl

            def scatter(sf: SparseFrontier):
                # sparse-frontier prologue: the live triples scattered
                # into the dense [n, W] operand the hop consumes; a
                # frontier holds each (row, lane) once and a
                # discovered entry's value is its own row
                x = torch.full((n * width,), -1, dtype=torch.int32,
                               device=dev)
                rows, idx = triples(sf)
                x[idx] = rows
                return x.view(n, width)

            plan.scatter = scatter

        elif kind == "sssp":

            def impl(d):
                # d: [n, W] global distances; the slab's rows sliced
                relaxed = dist_spmv_ell_multi(
                    MIN_PLUS, self._sssp_operand(), mkcol(d)
                )
                db = d[row0:row1]
                nb = minimum(db, relaxed.blocks[0])
                # changed MASK (not a reduced flag): the host extracts
                # exactly the relaxed entries for the sparse wire
                return nb, nb < db

            plan.fn = impl

            def scatter(d, sf: SparseFrontier):
                # scatter-MIN of inbound relaxations into the resident
                # global d (min is idempotent + commutative, so a
                # slice's own broadcast entries fold in harmlessly), on
                # the order keys the reference's float min folds by
                _, idx = triples(sf)
                keys = fold_keys(d.reshape(-1), "min")
                keys.scatter_reduce_(
                    0, idx,
                    fold_keys(torch.from_numpy(sf.vals).to(dev), "min"),
                    reduce="amin",
                )
                return from_fold_keys(keys, d.dtype).view(d.shape)

            plan.scatter = scatter

        elif kind == "propagate":
            if self.X is None:
                raise ValueError(
                    "slice was built without a feature slab "
                    "(features= opts into 'propagate')"
                )

            def hop(q):
                # one PLUS_TIMES hop of the indicator block: the slab
                # rows of A·Q (symmetric graphs only — enforced at
                # ShardedEngine.build — so the slab E IS the slab ET)
                return dist_spmm_ell(
                    PLUS_TIMES, self.version.E, mkcol(q)
                ).blocks[0]

            def fini(q_slab):
                # the feature table enters ONCE: this slice's partial
                # [Fp, W] contraction; the router sums partials in
                # slice order (the psum of the unsharded program)
                return torch.matmul(self.X.blocks[0].T, q_slab)

            plan.fn = SimpleNamespace(hop=hop, fini=fini)

        else:
            raise ValueError(f"unsupported sharded kind {kind!r}")

        return plan

    def _sssp_operand(self):
        Ew = self.version.E_weighted
        return Ew if Ew is not None else self.version.E

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- slice-resident loop state -------------------------------------------

    def _resident_for(self, kind: str, epoch: int, m: dict, W: int):
        """The resident loop state for this batch epoch.  A ``seed``
        payload (the batch's first fan, or a replay's) re-creates it
        from the payload; otherwise an epoch mismatch means this slice
        respawned mid-batch and holds nothing — a PROTOCOL fact, not a
        death, reported as :class:`StaleEpochError` so the router
        replays the whole batch without quarantining anyone."""
        if m.get("seed"):
            st = self._seed_resident(kind, epoch, m, W)
            self._resident[kind] = st
            return st
        st = self._resident.get(kind)
        if st is None or st.epoch != epoch:
            have = ("no resident state" if st is None
                    else f"epoch {st.epoch}")
            raise StaleEpochError(
                f"slice {self.idx} asked to advance {kind} epoch "
                f"{epoch} but holds {have} (respawned mid-batch?)"
            )
        return st

    def _seed_resident(self, kind: str, epoch: int, m: dict, W: int):
        if kind == "bfs":
            parents = np.full((self.ls, W), -1, np.int32)
            levels = np.full((self.ls, W), -1, np.int32)
            if "xs" in m:
                sf = m["xs"]
                rows = sf.rows.astype(np.int64)
                keep = (rows >= self.row0) & (rows < self.row1)
                rr = rows[keep] - self.row0
                ll = sf.lanes[keep].astype(np.int64)
                parents[rr, ll] = rows[keep]   # source: self-parent
                levels[rr, ll] = 0
            else:
                slab = np.asarray(m["x"],
                                  np.int32)[self.row0:self.row1]
                rr, ll = np.nonzero(slab >= 0)
                parents[rr, ll] = slab[rr, ll]
                levels[rr, ll] = 0
            return SimpleNamespace(epoch=epoch,
                                   parents=self._to_device(parents),
                                   levels=self._to_device(levels))
        if kind == "sssp":
            if "ds" in m:
                sf = m["ds"]
                d = np.full((self.ncols, W), np.inf, np.float32)
                d[sf.rows, sf.lanes.astype(np.int64)] = sf.vals
            else:
                d = np.asarray(m["d"], np.float32)
            return SimpleNamespace(epoch=epoch, d=self._to_device(d))
        return SimpleNamespace(epoch=epoch, q_slab=None)

    def _bfs_x_operand(self, plan: _SlicePlan, m: dict):
        if "x" in m:
            return self._to_device(np.asarray(m["x"], np.int32))
        return plan.scatter(m["xs"])

    # -- the hop surface (one bulk-synchronous step) ----------------------

    def hop(self, kind: str, m: dict) -> dict:
        W = int(m["width"])
        plan = self.plan(kind, W)
        epoch = int(m.get("epoch", 0))
        sparse = m.get("enc") == "sparse"
        t0 = time.perf_counter()
        if kind == "bfs":
            st = self._resident_for(kind, epoch, m, W)
            x = self._bfs_x_operand(plan, m)
            pb, lb, x_next = plan.fn(
                x, st.parents, st.levels, int(m["level"])
            )
            plan.executions += 1
            st.parents, st.levels = pb, lb
            xh = x_next.cpu().numpy()
            # outbound discovery extraction is slab-LOCAL (a readback
            # of [ls, W] then nonzero) — never shipped dense when the
            # router asked for triples
            rr, ll = np.nonzero(xh >= 0)
            out = {"any": bool(rr.size), "nnz": int(rr.size)}
            if sparse:
                out["xs"] = SparseFrontier(
                    self.ncols, W, rr.astype(np.int64) + self.row0, ll
                )
            else:
                out["x"] = xh
        elif kind == "sssp":
            st = self._resident_for(kind, epoch, m, W)
            if not m.get("seed"):
                # fold the broadcast relaxations (own included —
                # scatter-MIN is idempotent) into the resident d
                if "ds" in m:
                    sf = m["ds"]
                    if sf.nnz:
                        st.d = plan.scatter(st.d, sf)
                elif "d" in m:
                    st.d = self._to_device(np.asarray(m["d"], np.float32))
            nb, ch = plan.fn(st.d)
            plan.executions += 1
            nbh = nb.cpu().numpy()
            chh = ch.cpu().numpy()
            rr, ll = np.nonzero(chh)
            out = {"any": bool(rr.size), "nnz": int(rr.size)}
            if sparse:
                out["ds"] = SparseFrontier(
                    self.ncols, W, rr.astype(np.int64) + self.row0,
                    ll, nbh[rr, ll]
                )
            else:
                out["d"] = nbh
        elif kind == "propagate":
            st = self._resident_for(kind, epoch, m, W)
            if m.get("final"):
                if st.q_slab is None:
                    # hops==0 edge: the seed rides the final payload
                    st.q_slab = self._to_device(
                        _unpack_q(m)[self.row0:self.row1]
                    )
                part = plan.fn.fini(st.q_slab)
                plan.executions += 1
                out = {"partial": part.cpu().numpy()}
                self._resident.pop(kind, None)
            else:
                q = self._to_device(_unpack_q(m))
                qs = plan.fn.hop(q)
                plan.executions += 1
                # resident q_slab stays EXACT f32 on device for fini;
                # only the wire copy is (optionally) bf16
                st.q_slab = qs
                out = _pack_q_wire(qs.cpu().numpy(), m.get("wire"))
        else:
            raise ValueError(f"unsupported sharded kind {kind!r}")
        obs.observe("serve.shard.hop_s", time.perf_counter() - t0,
                    kind=kind, slice=self.idx)
        return out

    def collect(self, kind: str, m: dict) -> dict:
        """Fetch the batch's FINAL slab state once, after the hop loop
        converges.  Pops the resident entry: a hop under the same epoch
        afterwards is a protocol bug and correctly raises
        :class:`StaleEpochError`."""
        epoch = int(m.get("epoch", 0))
        st = self._resident.get(kind)
        if st is None or st.epoch != epoch:
            have = ("no resident state" if st is None
                    else f"epoch {st.epoch}")
            raise StaleEpochError(
                f"slice {self.idx} asked to collect {kind} epoch "
                f"{epoch} but holds {have}"
            )
        self._resident.pop(kind, None)
        if kind == "bfs":
            return {
                "parents": st.parents.cpu().numpy(),
                "levels": st.levels.cpu().numpy(),
            }
        if kind == "sssp":
            return {"d": st.d[self.row0:self.row1].cpu().numpy()}
        raise ValueError(f"kind {kind!r} holds no collectable state")

    def warmup(self, kinds=None, widths=None) -> dict:
        """Build every (kind, width) hop plan by running it on an inert
        step (empty frontier / all-inf distances / zero indicator) —
        after this, serving inside the warmed set builds no plan under
        any encoding."""
        kinds = self.kinds if kinds is None else tuple(kinds)
        widths = WARMUP_WIDTHS if widths is None else tuple(widths)
        out = {}
        for kind in kinds:
            for w in sorted(set(int(x) for x in widths)):
                t0 = time.perf_counter()
                if kind == "bfs":
                    self.hop(kind, {
                        "width": w, "epoch": 0, "seed": True,
                        "enc": "sparse", "level": 0,
                        "xs": SparseFrontier(
                            self.ncols, w, np.zeros(0, np.int32),
                            np.zeros(0, np.uint8),
                        ),
                    })
                elif kind == "sssp":
                    empty = SparseFrontier(
                        self.ncols, w, np.zeros(0, np.int32),
                        np.zeros(0, np.uint8), np.zeros(0, np.float32),
                    )
                    self.hop(kind, {"width": w, "epoch": 0, "seed": True,
                                    "enc": "sparse", "ds": empty})
                    st = self._resident[kind]
                    st.d = self.plan(kind, w).scatter(st.d, empty)
                else:
                    q = np.zeros((self.ncols, w), np.float32)
                    self.hop(kind, {"width": w, "epoch": 0,
                                    "seed": True, "q": q,
                                    "wire": "f32"})
                    self.hop(kind, {"width": w, "epoch": 0,
                                    "final": True})
                out[(kind, w)] = time.perf_counter() - t0
        self._resident.clear()
        return out

    def trace_mark(self) -> int:
        with self._lock:
            return sum(p.traces for p in self._plans.values())

    # -- the write lane (two-phase, per-slice WAL) ------------------------

    def wal_begin(self, first_seq: int, rows, cols, vals,
                  op_codes) -> dict:
        """Phase 1: durably append the FULL batch (global coordinates)
        to this slice's log — the per-slice sequence line stays
        contiguous with the global one, so the vector frontier is
        comparable across slices."""
        if self.wal is None:
            raise ValueError("slice has no WAL (built without home=)")
        off = self.wal.append(first_seq, rows, cols, vals, op_codes)
        obs.count("serve.shard.wal_appends", slice=self.idx)
        return {"offset": int(off), "wal_seq": int(self.wal.position())}

    def wal_abort(self, first_seq: int, last_seq: int) -> dict:
        """Tombstone a range whose coordinated append failed on a
        SIBLING slice — replay must not resurrect a write whose future
        was failed."""
        if self.wal is not None:
            self.wal.append_drop(first_seq, last_seq)
        obs.count("serve.shard.wal_aborts", slice=self.idx)
        return {"dropped": [int(first_seq), int(last_seq)]}

    def wal_commit(self, m: dict) -> dict:
        """Phase 2: apply the slab's sub-batch and stamp the slice
        frontier.  IDEMPOTENT: a batch at or below the current
        frontier was already folded in (recovery replay, or a re-sent
        commit after a heal) — report the current state, change
        nothing.  An empty sub-batch (no rows in this slab) still
        advances the frontier: the vector stays comparable."""
        from ..dynamic import merge as dyn_merge

        first, last = int(m["first_seq"]), int(m["last_seq"])
        if int(self.version.wal_seq) >= last:
            return self._commit_summary(applied=0)
        rows = np.asarray(m["rows"], np.int64)
        mask = (rows >= self.row0) & (rows < self.row1)
        t0 = time.perf_counter()
        if mask.any():
            sub = DeltaBatch(
                rows=rows[mask] - self.row0,
                cols=np.asarray(m["cols"], np.int64)[mask],
                vals=np.asarray(m["vals"], np.float32)[mask],
                ops=np.asarray(m["ops"], np.int8)[mask],
                first_seq=first, last_seq=last, oldest_at=0.0,
            )
            version = dyn_merge.apply_delta(
                self.version, sub, kinds=_build_kinds(self.kinds),
                grid=self.grid,
            )
            version.wal_seq = last
            version.vid = self.version.vid + 1
            self.version = version
            self.swaps += 1
            applied = int(mask.sum())
        else:
            self.version.wal_seq = last
            applied = 0
        obs.observe("serve.shard.merge_s", time.perf_counter() - t0,
                    slice=self.idx)
        obs.count("serve.shard.commits", slice=self.idx)
        self._commits_since_ckpt += 1
        if (self.checkpoint_every
                and self._commits_since_ckpt >= self.checkpoint_every):
            try:
                self.checkpoint_now(reason="auto")
            except Exception as e:
                if _is_device_error(e):
                    raise
                obs.count("serve.shard.checkpoint_failed",
                          slice=self.idx)
        return self._commit_summary(applied=applied)

    def _commit_summary(self, applied: int) -> dict:
        return {
            "wal_seq": int(self.version.wal_seq),
            "nnz": int(self.version.nnz),
            "vid": int(self.version.vid),
            "applied": int(applied),
        }

    # -- snapshots ---------------------------------------------------------

    def checkpoint_now(self, reason: str = "manual") -> dict:
        """Slab snapshot at this slice's frontier + retention prune +
        WAL truncation through the oldest retained stamp (the
        ``Server.checkpoint_now`` policy, per slice).  Features live in
        ``features.npy`` beside the snapshots, not in them."""
        if self.home is None:
            raise ValueError("slice has no durability home")
        seq = int(self.version.wal_seq)
        path = os.path.join(self.home, ckpt.snapshot_name(seq))
        v = self.version
        if v.X is not None:
            v = dataclasses.replace(v, X=None, feat_dim=0)
        ckpt.save_version(path, v, extra_meta={"shard": {
            "idx": self.idx, "row0": self.row0, "row1": self.row1,
            "nrows": self.nrows, "ncols": self.ncols,
        }})
        snaps = ckpt.list_snapshots(self.home)
        for old in snaps[:-self.checkpoint_retain]:
            try:
                os.unlink(old)
            except OSError:
                pass
        snaps = ckpt.list_snapshots(self.home)
        if self.wal is not None and snaps:
            self.wal.truncate(ckpt.snapshot_seq(snaps[0]))
        obs.count("serve.shard.checkpoints", slice=self.idx,
                  reason=reason)
        return {"path": path, "wal_seq": seq, "reason": reason}

    # -- introspection -----------------------------------------------------

    def to_host_coo(self) -> dict:
        """The slab edges in GLOBAL coordinates (rows translated back)
        — the router concatenates and key-sorts slices into the same
        (rows, cols, weights) triple an unsharded ``keep_coo=True``
        engine retains. Ids ride as int32 where they fit (the reference
        ships int64): a scale-18 slab's int64 pairs pass a frame's
        64 MB."""
        if self.version.host_coo is None:
            raise ValueError("slab was built without keep_coo")
        rows, cols, _nc = self.version.host_coo
        w = self.version.host_weights
        ids = np.int32 if max(self.nrows, self.ncols) < 2**31 else np.int64
        return {
            "rows": (np.asarray(rows, np.int64) + self.row0).astype(ids),
            "cols": np.asarray(cols).astype(ids),
            "weights": (None if w is None
                        else np.asarray(w, np.float32)),
        }

    def stats(self) -> dict:
        with self._lock:
            plans = {
                f"{k}/{w}": {"traces": p.traces,
                             "executions": p.executions}
                for (k, w), p in sorted(self._plans.items())
            }
        return {
            "slice": self.idx,
            "rows": [self.row0, self.row1],
            "nnz": int(self.version.nnz),
            "vid": int(self.version.vid),
            "wal_seq": int(self.version.wal_seq),
            "device_bytes": self.device_bytes(),
            "plans": plans,
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "swaps": self.swaps,
            "traces": self.trace_mark(),
            "wal": None if self.wal is None else self.wal.stats(),
        }

    def device_bytes(self) -> int:
        total = self.version.device_bytes()
        if self.X is not None:
            total += int(self.X.blocks.nbytes)
        return total

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()


def dispatch_slice_op(rt: SliceRuntime, op: str, m: dict):
    """The slice op surface, shared by the in-process handle and the
    subprocess worker (one protocol, two transports); each op runs with
    the slice's device as the current CUDA device."""
    with device_scope(rt.device):
        return _dispatch(rt, op, m)


def _dispatch(rt: SliceRuntime, op: str, m: dict):
    if op == "hop":
        return rt.hop(m["kind"], m)
    if op == "collect":
        return rt.collect(m["kind"], m)
    if op == "warmup":
        w = rt.warmup(kinds=m.get("kinds"), widths=m.get("widths"))
        return {f"{k}/{wd}": s for (k, wd), s in w.items()}
    if op == "wal_begin":
        return rt.wal_begin(
            int(m["first_seq"]), m["rows"], m["cols"], m["vals"],
            m["ops"],
        )
    if op == "wal_commit":
        return rt.wal_commit(m)
    if op == "wal_abort":
        return rt.wal_abort(int(m["first_seq"]), int(m["last_seq"]))
    if op == "checkpoint_now":
        return rt.checkpoint_now(reason=m.get("reason", "manual"))
    if op == "to_host_coo":
        return rt.to_host_coo()
    if op == "stats":
        return rt.stats()
    if op == "trace_mark":
        return {"mark": rt.trace_mark()}
    if op == "device_bytes":
        return {"bytes": rt.device_bytes()}
    if op == "ping":
        return {"pong": True, "slice": rt.idx}
    raise ValueError(f"unknown slice op {op!r}")


# --------------------------------------------------------------------------
# parent-side slice handles
# --------------------------------------------------------------------------


class LocalSlice:
    """In-process slice handle (no subprocess, no IPC; ``kill()``
    simulates a crash by dropping the runtime WITHOUT flushing anything,
    the analog of SIGKILL given the WAL's append-before-ack contract)."""

    def __init__(self, factory, idx: int, recover: bool = False):
        self.idx = int(idx)
        self._factory = factory
        self.rt: SliceRuntime | None = factory(recover=recover)
        self.quarantined = False

    def call(self, op: str, payload: dict | None = None,
             timeout_s: float | None = None):
        rt = self.rt
        if rt is None or self.quarantined:
            raise ReplicaDeadError(
                f"slice {self.idx} is out of service"
            )
        return dispatch_slice_op(rt, op, payload or {})

    def rpc(self, op: str, payload: dict | None = None,
            timeout_s: float | None = None) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(self.call(op, payload, timeout_s))
        except Exception as e:
            fut.set_exception(e)
        return fut

    def is_serving(self) -> bool:
        return self.rt is not None and not self.quarantined

    def heartbeat_age(self) -> float:
        return 0.0

    def kill(self) -> None:
        """Crash simulation: the runtime vanishes mid-flight; the WAL
        fd is abandoned un-flushed (appends already hit disk — the
        durability contract under test)."""
        self.rt = None

    def quarantine(self, exc: Exception) -> int:
        self.quarantined = True
        self.rt = None
        return 0

    def respawn(self) -> "LocalSlice":
        return LocalSlice(self._factory, self.idx, recover=True)

    def close(self) -> None:
        if self.rt is not None:
            self.rt.close()
            self.rt = None


class ProcSlice:
    """Subprocess slice handle: one ``_shardworker`` child with its own
    CUDA context, driven through a ``ReplicaProc`` (futures, heartbeat
    tracking, deadline sweep, quarantine — the process fleet's machinery
    pointed at a slice instead of a whole replica).

    The constructor launches the child and sends its boot; ``wait=False``
    returns at once so that several children boot concurrently, and
    ``wait_booted`` then collects the reply. A failed boot quarantines
    the child (SIGKILL) and raises."""

    def __init__(self, idx: int, boot: dict, *, workdir: str,
                 device="cuda", hb_interval_s: float = 0.25,
                 ipc_timeout_s: float = 60.0,
                 boot_timeout_s: float = 300.0, wait: bool = True):
        self.idx = int(idx)
        self.device = str(torch.device(device))
        self._boot_msg = dict(boot, device=self.device,
                              hb_interval_s=float(hb_interval_s))
        self._workdir = workdir
        self._hb_interval_s = float(hb_interval_s)
        self._ipc_timeout_s = float(ipc_timeout_s)
        self._boot_timeout_s = float(boot_timeout_s)
        self.boot_info: dict = {}
        self.rp = self._launch()
        try:
            self._boot_fut = self.rp.rpc(
                "boot", self._boot_msg, timeout_s=self._boot_timeout_s
            )
        except Exception as e:
            self.rp.quarantine(ReplicaDeadError(
                f"slice {self.idx} boot failed: {e}"
            ))
            raise
        if wait:
            self.wait_booted()

    def wait_booted(self) -> "ProcSlice":
        try:
            self.boot_info = self._boot_fut.result(
                timeout=self._boot_timeout_s + 5
            )
        except Exception as e:
            # a child whose boot failed (a CUDA error in its warm-up,
            # a bad home) never serves: collapse it here
            self.rp.quarantine(ReplicaDeadError(
                f"slice {self.idx} boot failed: {e}"
            ))
            raise
        self.rp.boot = self.boot_info
        # the boot reply is proof of life, but the child only starts
        # its heartbeat thread AFTER boot — stamp the heartbeat clock
        # here so the hang detector measures from boot completion, not
        # process launch
        self.rp.last_hb = {
            "pid": self.boot_info.get("pid"), "depth": 0,
            "serving": True, "slice": self.idx,
        }
        self.rp.last_hb_t = time.monotonic()
        return self

    def _child_env(self) -> dict:
        import combblas_tpu_torch

        env = dict(os.environ)
        # the child must import THIS package wherever the parent found
        # it
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(combblas_tpu_torch.__file__)
        ))
        pp = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (
            pkg_root if not pp else pkg_root + os.pathsep + pp
        )
        # hermetic durability: only the boot message's home attaches a
        # log, never ambient env
        env[tuner_config.ENV_WAL] = "0"
        env["COMBBLAS_OBS"] = "1" if obs.ENABLED else "0"
        return env

    def _launch(self) -> ReplicaProc:
        parent_sock, child_sock = socket.socketpair()
        log = open(
            os.path.join(self._workdir, f"slice{self.idx}.log"), "ab"
        )
        try:
            proc = subprocess.Popen(
                [
                    sys.executable, "-m",
                    "combblas_tpu_torch.serve._shardworker",
                    "--fd", str(child_sock.fileno()),
                ],
                pass_fds=(child_sock.fileno(),),
                env=self._child_env(),
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True,  # chaos signals hit the
                # slice, never the router's process group
            )
        finally:
            log.close()
            child_sock.close()
        return ReplicaProc(
            self.idx, proc,
            Channel(parent_sock, peer=f"slice{self.idx}"),
            tenant=f"slice{self.idx}",
            ipc_timeout_s=self._ipc_timeout_s,
        )

    def call(self, op: str, payload: dict | None = None,
             timeout_s: float | None = None):
        return self.rp.call(op, payload, timeout_s=timeout_s)

    def rpc(self, op: str, payload: dict | None = None,
            timeout_s: float | None = None) -> Future:
        return self.rp.rpc(op, payload, timeout_s=timeout_s)

    def is_serving(self) -> bool:
        return self.rp.is_serving()

    def heartbeat_age(self) -> float:
        return self.rp.heartbeat_age()

    def kill(self) -> None:
        self.rp.signal(signal.SIGKILL)

    def quarantine(self, exc: Exception) -> int:
        return self.rp.quarantine(exc)

    def respawn(self) -> "ProcSlice":
        boot = dict(self._boot_msg)
        # respawn recovers from the slice home (slab snapshot + WAL)
        boot.pop("coo", None)
        boot["recover"] = True
        return ProcSlice(
            self.idx, boot, workdir=self._workdir, device=self.device,
            hb_interval_s=self._hb_interval_s,
            ipc_timeout_s=self._ipc_timeout_s,
            boot_timeout_s=self._boot_timeout_s,
        )

    def close(self) -> None:
        self.rp.close()


def _boot_all(slices: list) -> list:
    """Collect the boot replies of concurrently launched process slices;
    one failure quarantines every child started."""
    try:
        for sl in slices:
            sl.wait_booted()
    except Exception:
        for sl in slices:
            sl.quarantine(ReplicaDeadError("sharded boot failed"))
        raise
    return slices


# --------------------------------------------------------------------------
# the sharded engine (router)
# --------------------------------------------------------------------------


class ShardedGraphVersion:
    """The router-side view of the CURRENT sharded generation: the
    manifest facts plus the per-slice frontier VECTOR.  Duck-types the
    ``GraphVersion`` surface ``serve/api.py`` reads (``ncols``/
    ``nnz``/``wal_seq``/``vid``/``dyn.last_stats``); the scalar
    ``wal_seq`` is the vector MINIMUM — the only safe scalar
    projection (everything at or below it is durable AND applied on
    every slice)."""

    def __init__(self, *, nrows: int, ncols: int, nnz: int,
                 bounds, frontier, device_bytes=None,
                 merge_stats=None):
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.nnz = int(nnz)
        self.bounds = tuple(tuple(b) for b in bounds)
        self.frontier = [int(s) for s in frontier]
        self.wal_seq = min(self.frontier) if self.frontier else -1
        self.device_bytes_per_slice = list(device_bytes or [])
        self.vid = 0
        self.host_coo = None  # assembled on demand via the engine
        self.dyn = SimpleNamespace(last_stats=SimpleNamespace(
            mode=(merge_stats or {}).get("mode", "sharded"),
            latency_s=(merge_stats or {}).get("latency_s", 0.0),
        ))

    @property
    def nslices(self) -> int:
        return len(self.bounds)

    def device_bytes(self) -> int:
        """MAX per-slice resident bytes — the per-card capacity number
        the ~1/p scaling claim is measured on (a sharded service is
        capacity-bound by its fullest slice, not the sum)."""
        return max(self.device_bytes_per_slice, default=0)


class ShardedEngine:
    """N slices served as ONE engine — the ``GraphEngine`` duck-type
    ``serve/api.py`` drives (module docstring).  Durability is
    engine-owned: ``Server`` skips its scalar WAL attachment
    (``owns_durability``) and routes ``apply_delta`` through the
    two-phase per-slice protocol.

    ``device`` is the device the router's own threads work on: the
    slices' card in local mode, the CPU in process mode (the children
    hold the card). ``shares_context`` is True in local mode, where a
    CUDA error any slice meets is this process's (``device_error``)."""

    owns_durability = True
    supports_updates = True

    def __init__(self, slices, spec: ShardSpec, kinds, *, home: str,
                 nnz: int, feat_dim: int = 0,
                 max_iters: int | None = None,
                 propagate_hops: int = 2,
                 hb_timeout_s: float = 3.0,
                 ipc_timeout_s: float = 60.0,
                 recover_wait_s: float = 30.0,
                 exec_retries: int = 3,
                 frontier: str | None = None,
                 density: float | None = None,
                 wire: str | None = None,
                 factories=None, mode: str = "local",
                 device="cuda"):
        self.slices = list(slices)
        self.spec = spec
        self._kinds = tuple(kinds)
        self.home = home
        self.nrows = spec.nrows
        self.max_iters = max_iters
        self.propagate_hops = int(propagate_hops)
        self.feat_dim = int(feat_dim)
        self.hb_timeout_s = float(hb_timeout_s)
        self.ipc_timeout_s = float(ipc_timeout_s)
        self.recover_wait_s = float(recover_wait_s)
        self.exec_retries = int(exec_retries)
        self.mode = mode
        self.shares_context = mode == "local"
        self.device = (torch.device(device) if self.shares_context
                       else torch.device("cpu"))
        #: the CUDA error a local slice met (this process's context);
        #: while it is held nothing executes and nothing heals
        self.device_error: Exception | None = None
        # the wire-protocol knobs: the ENCODING IS A ROUTER DECISION
        # stamped into every hop payload
        self.frontier_mode = tuner_config.shard_frontier(frontier)
        self.density_threshold = tuner_config.shard_density(density)
        self.wire = tuner_config.shard_wire(wire)
        self._epoch = 0
        self.last_exec_stats: dict = {}
        self._factories = list(factories or [])
        self._exec_lock = threading.RLock()
        self._write_lock = threading.Lock()
        self._sup_lock = threading.RLock()
        self._needs_rebuild: set[int] = set()
        self._replace_next: dict[int, float] = {}
        self._replace_backoff: dict[int, float] = {}
        self.replacements = 0
        self.respawn_failures = 0
        self.swaps = 0
        self._sup_stop = threading.Event()
        self._sup_thread = None
        # plan-build accounting across respawns: floor = a slice's
        # counter right after (re)boot warm-up, so warm-up builds never
        # count as serving builds; a dead slice's last-known delta
        # folds into the lost base so marks stay monotone
        self._trace_floor: dict[int, int] = {}
        self._last_mark: dict[int, int] = {}
        self._trace_lost = 0
        frontier, nnzs, bytes_ = self._poll_slices()
        self._version = ShardedGraphVersion(
            nrows=spec.nrows, ncols=spec.ncols,
            nnz=int(nnz if nnz >= 0 else sum(nnzs)),
            bounds=spec.bounds, frontier=frontier,
            device_bytes=bytes_,
        )
        for i, sl in enumerate(self.slices):
            self._floor_traces(i, sl)
        obs.gauge("serve.shard.slices", len(self.slices))

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, rows, cols, *, nrows: int, nslices: int = 2,
              ncols: int | None = None, weights=None, kinds=None,
              features=None, symmetric: bool = False,
              home: str | None = None, mode: str = "local",
              device="cuda",
              warmup: bool = True, warmup_widths=None,
              headroom=None, max_iters=None, propagate_hops: int = 2,
              fsync: str | None = None, checkpoint_every: int = 0,
              checkpoint_retain: int = 2,
              hb_interval_s: float = 0.25, hb_timeout_s: float = 3.0,
              ipc_timeout_s: float = 60.0,
              recover_wait_s: float = 30.0,
              frontier: str | None = None,
              density: float | None = None,
              wire: str | None = None) -> "ShardedEngine":
        """Partition a global COO over ``nslices`` row slabs and boot
        one slice per slab on ``device`` (``mode="local"`` in-process;
        ``mode="process"`` real subprocesses).  The global
        dedup/min-combine happens per slab — row slabs are key-disjoint,
        so the result is identical to the unsharded build."""
        n = int(nrows)
        nc = int(ncols) if ncols is not None else n
        if kinds is None:
            kinds = ("bfs",)
            if weights is not None:
                kinds += ("sssp",)
            if features is not None and symmetric:
                kinds += ("propagate",)
        kinds = tuple(kinds)
        bad = [k for k in kinds if k not in SHARDED_KINDS]
        if bad:
            raise ValueError(
                f"kinds {bad} do not decompose into row-slab hops "
                f"(sharded kinds: {SHARDED_KINDS})"
            )
        if "propagate" in kinds:
            if not symmetric:
                raise ValueError(
                    "sharded 'propagate' needs symmetric=True: the "
                    "hop operator must be its own transpose for the "
                    "slab matrix to serve both orientations"
                )
            if features is None:
                raise ValueError("'propagate' needs features=")
        if mode not in ("local", "process"):
            raise ValueError(f"unknown shard mode {mode!r}")
        home = home or tempfile.mkdtemp(prefix="combblas-shard-")
        os.makedirs(home, exist_ok=True)
        spec = plan_partition(n, int(nslices), ncols=nc)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        slices = []
        factories = []
        nnz_total = 0
        try:
            for i in range(spec.nslices):
                r0, r1 = spec.bounds[i]
                lrows, lcols, lw = shard_coo(spec, i, rows, cols, weights)
                shome = os.path.join(home, f"slice{i}")
                os.makedirs(shome, exist_ok=True)
                if mode == "local":
                    factory = _local_factory(
                        i, r0, r1, n, nc, lrows, lcols, lw, kinds,
                        features=features, headroom=headroom,
                        home=shome, fsync=fsync, max_iters=max_iters,
                        propagate_hops=propagate_hops,
                        checkpoint_every=checkpoint_every,
                        checkpoint_retain=checkpoint_retain,
                        warmup=warmup, warmup_widths=warmup_widths,
                        device=device,
                    )
                    sl = LocalSlice(factory, i)
                    nnz_total += int(sl.rt.version.nnz)
                else:
                    slab = {"rows": np.asarray(lrows, np.int64),
                            "cols": np.asarray(lcols, np.int64)}
                    if lw is not None:
                        slab["weights"] = np.asarray(lw, np.float32)
                    if features is not None:
                        slab["features"] = np.asarray(
                            features, np.float32)[r0:r1]
                    coo = os.path.join(shome, SLAB_COO_NAME)
                    np.savez(coo, **slab)
                    boot = {
                        "idx": i, "row0": r0, "row1": r1,
                        "nrows": n, "ncols": nc, "coo": coo,
                        "kinds": list(kinds),
                        "home": shome, "fsync": fsync,
                        "max_iters": max_iters,
                        "propagate_hops": propagate_hops,
                        "checkpoint_every": checkpoint_every,
                        "checkpoint_retain": checkpoint_retain,
                        "warmup": bool(warmup),
                        "warmup_widths": (
                            None if warmup_widths is None
                            else list(warmup_widths)
                        ),
                        "recover": False,
                    }
                    sl = ProcSlice(
                        i, boot, workdir=home, device=device,
                        hb_interval_s=hb_interval_s,
                        ipc_timeout_s=ipc_timeout_s, wait=False,
                    )
                    factory = None
                slices.append(sl)
                factories.append(factory)
            if mode == "process":
                _boot_all(slices)
                nnz_total = sum(int(sl.boot_info["nnz"]) for sl in slices)
            elif warmup:
                for sl in slices:
                    sl.call("warmup", {"widths": warmup_widths})
        except Exception:
            for sl in slices:
                try:
                    sl.quarantine(ReplicaDeadError("sharded build failed"))
                except Exception:
                    pass
            raise
        eng = cls(
            slices, spec, kinds, home=home, nnz=nnz_total,
            feat_dim=(0 if features is None
                      else int(np.asarray(features).shape[1])),
            max_iters=max_iters, propagate_hops=propagate_hops,
            hb_timeout_s=hb_timeout_s, ipc_timeout_s=ipc_timeout_s,
            recover_wait_s=recover_wait_s, frontier=frontier,
            density=density, wire=wire, factories=factories,
            mode=mode, device=device,
        )
        eng._write_manifest()
        return eng

    @classmethod
    def recover(cls, home: str, *, mode: str = "local", device="cuda",
                max_iters=None, hb_interval_s: float = 0.25,
                hb_timeout_s: float = 3.0,
                ipc_timeout_s: float = 60.0,
                recover_wait_s: float = 30.0,
                frontier: str | None = None,
                density: float | None = None,
                wire: str | None = None) -> "ShardedEngine":
        """Reboot the whole service from its home on ``device``:
        manifest → slice homes → per-slice snapshot + WAL-suffix replay.
        Each slice recovers to ITS OWN frontier (the vector semantics);
        the scalar view re-converges at the minimum."""
        with open(os.path.join(home, MANIFEST_NAME)) as f:
            man = json.load(f)
        if man.get("v") != MANIFEST_SCHEMA:
            raise dyn_wal.RecoveryError(
                f"manifest schema {man.get('v')!r} != "
                f"{MANIFEST_SCHEMA!r}"
            )
        if mode not in ("local", "process"):
            raise ValueError(f"unknown shard mode {mode!r}")
        kinds = tuple(man["kinds"])
        spec = ShardSpec(
            nrows=int(man["nrows"]), ncols=int(man["ncols"]),
            bounds=tuple(tuple(b) for b in man["bounds"]),
        )
        hops = int(man.get("propagate_hops", 2))
        slices = []
        factories = []
        try:
            for i in range(spec.nslices):
                shome = os.path.join(home, f"slice{i}")
                if mode == "local":
                    factory = _local_recover_factory(
                        i, shome, kinds, max_iters=max_iters,
                        propagate_hops=hops, device=device,
                    )
                    sl = LocalSlice(factory, i, recover=True)
                else:
                    boot = {
                        "idx": i, "home": shome, "kinds": list(kinds),
                        "recover": True, "max_iters": max_iters,
                        "propagate_hops": hops, "warmup": True,
                    }
                    sl = ProcSlice(
                        i, boot, workdir=home, device=device,
                        hb_interval_s=hb_interval_s,
                        ipc_timeout_s=ipc_timeout_s, wait=False,
                    )
                    factory = None
                slices.append(sl)
                factories.append(factory)
            if mode == "process":
                _boot_all(slices)
        except Exception:
            for sl in slices:
                try:
                    sl.quarantine(ReplicaDeadError("sharded recovery failed"))
                except Exception:
                    pass
            raise
        return cls(
            slices, spec, kinds, home=home, nnz=-1,
            feat_dim=int(man.get("feat_dim", 0)),
            max_iters=max_iters, propagate_hops=hops,
            hb_timeout_s=hb_timeout_s, ipc_timeout_s=ipc_timeout_s,
            recover_wait_s=recover_wait_s, frontier=frontier,
            density=density, wire=wire, factories=factories,
            mode=mode, device=device,
        )

    def _write_manifest(self) -> None:
        """Atomic manifest write: the service's self-description +
        the current frontier VECTOR (advisory — each slab snapshot is
        self-describing; recovery trusts the per-slice files for the
        frontier truth and the manifest for the shape)."""
        man = {
            "v": MANIFEST_SCHEMA,
            "nrows": self.spec.nrows, "ncols": self.spec.ncols,
            "nslices": self.spec.nslices,
            "bounds": [list(b) for b in self.spec.bounds],
            "kinds": list(self._kinds),
            "feat_dim": self.feat_dim,
            "propagate_hops": self.propagate_hops,
            "frontier": list(self._version.frontier),
        }
        path = os.path.join(self.home, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- GraphEngine duck-type surface ------------------------------------

    @property
    def version(self) -> ShardedGraphVersion:
        return self._version

    @property
    def version_id(self) -> int:
        return self._version.vid

    def kinds(self) -> tuple:
        return self._kinds

    @property
    def plan_misses(self) -> int:
        return 0  # slices own their plan caches; see stats()["shard"]

    def serve(self, config=None, tenant: str | None = None):
        """A ``Server`` over the slices (``serve/api.py``): the batcher
        and the scheduler unchanged, durability delegated to the
        engine's per-slice WALs."""
        from .api import Server
        from .scheduler import ServeConfig

        return Server(self, config or ServeConfig(), tenant=tenant)

    def build_version(self, *a, **kw):
        raise NotImplementedError(
            "a sharded engine rebuilds through its slices; use "
            "apply_delta (the write lane) or rebuild with "
            "ShardedEngine.build"
        )

    def swap(self, version) -> float:
        t0 = time.perf_counter()
        with self._exec_lock:
            version.vid = self._version.vid + 1
            self._version = version
            self.swaps += 1
        dt = time.perf_counter() - t0
        obs.gauge("serve.shard.frontier_min", version.wal_seq)
        return dt

    def warmup(self, kinds=None, widths=None) -> dict:
        out: dict = {}
        payload = {
            "kinds": list(kinds) if kinds else None,
            "widths": list(widths) if widths else None,
        }
        futs = [
            (sl, sl.rpc("warmup", payload,
                        timeout_s=self.ipc_timeout_s * 4))
            for sl in self.slices
        ]
        for sl, f in futs:
            for kw, s in self._result(
                f, self.ipc_timeout_s * 4 + 5
            ).items():
                k, w = kw.rsplit("/", 1)
                key = (k, int(w))
                out[key] = max(out.get(key, 0.0), float(s))
        for i, sl in enumerate(self.slices):
            self._floor_traces(i, sl)
        return out

    # -- the CUDA-error rule (module docstring) ----------------------------

    def _keep_device_error(self, exc: BaseException) -> bool:
        """True (and the error kept as ``device_error``) for a CUDA
        error a LOCAL slice met: this process's context is poisoned, so
        the error is the engine's, not one slice's. A process slice's
        error is its own (False: it is quarantined and respawned)."""
        if not self.shares_context or not _is_device_error(exc):
            return False
        if self.device_error is None:
            self.device_error = exc
        return True

    def _result(self, fut: Future, timeout: float):
        """``fut.result``, with a local slice's CUDA error kept."""
        try:
            return fut.result(timeout=timeout)
        except Exception as e:
            self._keep_device_error(e)
            raise

    # -- plan-build accounting ---------------------------------------------

    def _slice_mark(self, i: int, sl) -> int:
        try:
            m = int(sl.call("trace_mark", timeout_s=30.0)["mark"])
            self._last_mark[i] = m
            return m
        except Exception:
            return self._last_mark.get(i, self._trace_floor.get(i, 0))

    def _floor_traces(self, i: int, sl) -> None:
        m = self._slice_mark(i, sl)
        self._trace_floor[i] = m
        self._last_mark[i] = m

    def trace_mark(self) -> int:
        """Plan builds across the slices since each one's boot warm-up
        (snapshot before serving; ``retraces_since`` then counts the
        plans built after it)."""
        total = self._trace_lost
        for i, sl in enumerate(self.slices):
            m = self._slice_mark(i, sl)
            total += max(0, m - self._trace_floor.get(i, 0))
        return total

    def retraces_since(self, mark: int) -> int:
        return self.trace_mark() - mark

    # -- execution (the router hop loop) ----------------------------------

    def _mint_epoch(self) -> int:
        """A fresh batch-attempt token (under the exec lock): every
        hop of one attempt carries it, slices key their resident loop
        state on it, and a replay gets a NEW one — so state left by a
        failed attempt can never leak into its replay."""
        self._epoch += 1
        return self._epoch

    def _choose_enc(self, nnz: int, W: int) -> str:
        """The per-hop encoding decision (router-owned; slices obey
        the stamped choice): triples win while the frontier is sparse,
        the dense operand wins once triple overhead passes the density
        threshold (the diropt precedent — a DATA decision)."""
        if self.frontier_mode != "auto":
            return self.frontier_mode
        dense = self.spec.ncols * int(W)
        return ("sparse"
                if nnz <= self.density_threshold * dense else "dense")

    def _pack_q_payload(self, q: np.ndarray) -> dict:
        p = _pack_q_wire(q, self.wire)
        if self.wire == "bf16":
            err = (float(np.max(np.abs(unpack_bf16(p["q"]) - q)))
                   if q.size else 0.0)
            obs.observe("serve.shard.wire_quant_err", err)
        return p

    def execute(self, kind: str, sources) -> dict:
        """One batch, bulk-synchronously across slices; on a slice
        failure mid-batch the whole batch replays after the heal
        (replay is idempotent: a fresh epoch re-seeds every slice's
        resident state — including the respawned one's, which is how
        a StaleEpochError report is resolved). A held CUDA error (local
        mode) raises at once."""
        if self.device_error is not None:
            raise self.device_error
        last_exc = None
        for attempt in range(self.exec_retries + 1):
            if attempt:
                obs.count("serve.shard.exec_retries", kind=kind)
                self._heal()
            try:
                with self._exec_lock, obs.span(
                    "serve.shard.batch", kind=kind,
                    width=int(np.asarray(sources).shape[0]),
                ):
                    return self._execute_once(kind, sources)
            except (ReplicaDeadError, IpcTimeoutError,
                    ConnectionError, StaleEpochError) as e:
                last_exc = e
        raise RuntimeError(
            f"sharded {kind} batch failed after "
            f"{self.exec_retries + 1} attempts: {last_exc}"
        ) from last_exc

    def _fan_hop(self, kind: str, per_slice_payload, *,
                 op: str = "hop", enc: str | None = None,
                 stats: dict | None = None) -> list:
        """One bulk-synchronous fan (``hop`` or ``collect``): RPC
        every slice, gather in slice order, account the wire bytes both
        directions.  A transport/death failure quarantines the slice
        (sticky — the supervisor respawns it) and raises; a
        :class:`StaleEpochError` is a HEALTHY slice reporting lost
        resident state — re-raised for a whole-batch replay WITHOUT
        quarantining the reporter; a local slice's CUDA error is kept
        and raised as it is."""
        t0 = time.perf_counter()
        enc_label = enc if enc is not None else op
        bytes_out = 0
        futs = []
        for i, sl in enumerate(self.slices):
            payload = per_slice_payload(i)
            bytes_out += _payload_nbytes(payload)
            try:
                futs.append(sl.rpc(
                    op, payload, timeout_s=self.ipc_timeout_s,
                ))
            except Exception as e:
                if not self._keep_device_error(e):
                    self._mark_dead(i, e)
                raise
        results = []
        failed = None
        stale = None
        device = None
        for i, f in enumerate(futs):
            try:
                results.append(f.result(
                    timeout=self.ipc_timeout_s + 5
                ))
            except StaleEpochError as e:
                stale = stale or e
                results.append(None)
            except Exception as e:
                if self._keep_device_error(e):
                    device = device or e
                else:
                    self._mark_dead(i, e)
                    failed = failed or e
                results.append(None)
        if device is not None:
            raise device
        if failed is not None:
            # a real death outranks a stale report: heal first, the
            # replay re-seeds everyone anyway
            if isinstance(failed, (ReplicaDeadError, IpcTimeoutError,
                                   ConnectionError)):
                raise failed
            raise ReplicaDeadError(str(failed)) from failed
        if stale is not None:
            obs.count("serve.shard.stale_epochs", kind=kind)
            raise stale
        bytes_in = sum(_payload_nbytes(r) for r in results)
        obs.count("serve.shard.hop_bytes", bytes_out,
                  direction="out", encoding=enc_label)
        obs.count("serve.shard.hop_bytes", bytes_in,
                  direction="in", encoding=enc_label)
        if op == "hop":
            obs.count("serve.shard.hops", kind=kind)
            if enc in ("sparse", "dense"):
                obs.count("serve.shard.encoding", choice=enc)
        if stats is not None:
            stats["hops" if op == "hop" else "collects"] += 1
            stats["bytes_out"] += bytes_out
            stats["bytes_in"] += bytes_in
            by = stats["bytes_by_enc"]
            by[enc_label] = by.get(enc_label, 0) + bytes_out + bytes_in
            if op == "hop" and enc in ("sparse", "dense"):
                eh = stats["enc_hops"]
                eh[enc] = eh.get(enc, 0) + 1
            stats["hop_wall_s"] += time.perf_counter() - t0
        return results

    def _execute_once(self, kind: str, sources) -> dict:
        from ..models import PAD_ROOT

        sources = np.asarray(sources, np.int32)
        W = int(sources.shape[0])
        n = self.nrows
        nc = self.spec.ncols
        bounds = self.spec.bounds
        live = sources != PAD_ROOT
        lanes = np.arange(W)
        valid = live & (sources >= 0) & (sources < n)
        epoch = self._mint_epoch()
        stats = {
            "kind": kind, "width": W, "epoch": epoch,
            "hops": 0, "collects": 0,
            "bytes_out": 0, "bytes_in": 0,
            "bytes_by_enc": {}, "enc_hops": {},
            "frontier_nnz": [], "hop_wall_s": 0.0,
        }
        self.last_exec_stats = stats
        if kind == "bfs":
            # the router-side mirror of the batch search's init + loop:
            # the step always runs at least once (active starts True);
            # continue iff any slice discovered new vertices and the
            # level count is under the cap — identical niter semantics
            iters = self.max_iters if self.max_iters is not None \
                else n
            sf = SparseFrontier(
                nc, W, sources[valid], lanes[valid].astype(np.uint8)
            )
            niter = 0
            active = True
            seed = True
            while active and niter < iters:
                enc = self._choose_enc(sf.nnz, W)
                stats["frontier_nnz"].append(sf.nnz)
                obs.observe("serve.shard.frontier_nnz", sf.nnz,
                            kind=kind)
                base = {"kind": kind, "width": W, "epoch": epoch,
                        "level": niter, "enc": enc, "seed": seed}
                if enc == "sparse":
                    base["xs"] = sf
                else:
                    base["x"] = sf.to_dense(np.int32(-1))
                res = self._fan_hop(kind, lambda i: base, enc=enc,
                                    stats=stats)
                seed = False
                if enc == "sparse":
                    sf = SparseFrontier(
                        nc, W,
                        np.concatenate([r["xs"].rows for r in res]),
                        np.concatenate([r["xs"].lanes for r in res]),
                    )
                else:
                    # dense replies are slabs in slice order — their
                    # concatenation index IS the global row id, and a
                    # discovered entry's value is its own row
                    x = np.concatenate([r["x"] for r in res], axis=0)
                    rr, ll = np.nonzero(x >= 0)
                    sf = SparseFrontier(nc, W, rr, ll)
                active = any(r["any"] for r in res)
                niter += 1
            if niter == 0:
                # degenerate cap (max_iters=0): no hop ran, so no
                # resident state exists to collect — seed-only result
                parents = np.full((n, W), -1, np.int32)
                levels = np.full((n, W), -1, np.int32)
                parents[sources[valid], lanes[valid]] = sources[valid]
                levels[sources[valid], lanes[valid]] = 0
                return {"parents": parents, "levels": levels,
                        "batch_niter": 0}
            cres = self._fan_hop(
                kind, lambda i: {"kind": kind, "epoch": epoch},
                op="collect", stats=stats,
            )
            return {
                "parents": np.concatenate(
                    [r["parents"] for r in cres], axis=0
                ),
                "levels": np.concatenate(
                    [r["levels"] for r in cres], axis=0
                ),
                "batch_niter": int(niter),
            }
        if kind == "sssp":
            # the router keeps a host mirror of d in EVERY encoding:
            # triples fold in exactly (slabs are row-disjoint, min is
            # monotone) and the mirror is what a dense-fallback hop
            # broadcasts mid-loop
            d = np.full((nc, W), np.inf, np.float32)
            d[sources[valid], lanes[valid]] = 0.0
            sf = SparseFrontier(
                nc, W, sources[valid], lanes[valid].astype(np.uint8),
                np.zeros(int(valid.sum()), np.float32),
            )
            niter = 0
            changed = True
            seed = True
            while changed and niter < n:
                enc = self._choose_enc(sf.nnz, W)
                stats["frontier_nnz"].append(sf.nnz)
                obs.observe("serve.shard.frontier_nnz", sf.nnz,
                            kind=kind)
                base = {"kind": kind, "width": W, "epoch": epoch,
                        "enc": enc, "seed": seed}
                if enc == "sparse":
                    base["ds"] = sf
                else:
                    base["d"] = d
                res = self._fan_hop(kind, lambda i: base, enc=enc,
                                    stats=stats)
                seed = False
                rows_l, lanes_l, vals_l = [], [], []
                for (r0, r1), r in zip(bounds, res):
                    if "ds" in r:
                        s = r["ds"]
                        d[s.rows, s.lanes.astype(np.int64)] = s.vals
                        rows_l.append(s.rows)
                        lanes_l.append(s.lanes)
                        vals_l.append(s.vals)
                    else:
                        nb = r["d"]
                        chg = nb < d[r0:r1]
                        rr, ll = np.nonzero(chg)
                        rows_l.append((rr + r0).astype(np.int32))
                        lanes_l.append(ll.astype(np.uint8))
                        vals_l.append(nb[rr, ll])
                        d[r0:r1] = nb
                sf = SparseFrontier(
                    nc, W, np.concatenate(rows_l),
                    np.concatenate(lanes_l), np.concatenate(vals_l),
                )
                changed = any(r["any"] for r in res)
                niter += 1
            if niter == 0:
                return {"dist": d, "batch_niter": 0}
            cres = self._fan_hop(
                kind, lambda i: {"kind": kind, "epoch": epoch},
                op="collect", stats=stats,
            )
            dist = np.concatenate([r["d"] for r in cres], axis=0)
            return {"dist": dist, "batch_niter": int(niter)}
        if kind == "propagate":
            q = np.zeros((nc, W), np.float32)
            q[sources[valid], lanes[valid]] = 1.0
            seed = True
            for _ in range(max(self.propagate_hops, 0)):
                base = {"kind": kind, "width": W, "epoch": epoch,
                        "seed": seed, "enc": "dense"}
                base.update(self._pack_q_payload(q))
                res = self._fan_hop(kind, lambda i: base, enc="dense",
                                    stats=stats)
                seed = False
                q = np.concatenate([_unpack_q(r) for r in res],
                                   axis=0)
            # the last hop's q slab is RESIDENT (exact f32) on each
            # slice — the final fan ships no state, except the
            # hops==0 edge where the seed rides the final payload
            fin = {"kind": kind, "width": W, "epoch": epoch,
                   "final": True, "seed": seed}
            if seed:
                fin.update(self._pack_q_payload(q))
            res = self._fan_hop(kind, lambda i: fin, enc="final",
                                stats=stats)
            # fixed slice-order summation: the float partials reduce
            # deterministically (run-to-run stable; against the
            # unsharded single product it is allclose, not bit-exact)
            feats = res[0]["partial"].astype(np.float32)
            for r in res[1:]:
                feats = feats + r["partial"]
            return {"features": feats[: self.feat_dim]}
        raise ValueError(f"unsupported sharded kind {kind!r}")

    # -- the write lane (two-phase coordinated) ---------------------------

    def apply_delta(self, batch, **kw) -> ShardedGraphVersion:
        """Two-phase durable write (module docstring).  Returns the
        NEW ShardedGraphVersion (the caller — ``Server._merge_once`` —
        stamps and swaps it, the GraphEngine contract)."""
        rows = np.asarray(batch.rows, np.int64)
        cols = np.asarray(batch.cols, np.int64)
        vals = np.asarray(batch.vals, np.float32)
        ops = np.asarray(batch.ops, np.int8)
        first, last = int(batch.first_seq), int(batch.last_seq)
        t0 = time.perf_counter()
        with self._write_lock:
            self._heal(require_all=True)
            # phase 1: the batch becomes durable on EVERY slice before
            # any slice applies it (acknowledged == durable, now N logs
            # wide)
            payload = {
                "first_seq": first, "rows": rows, "cols": cols,
                "vals": vals, "ops": ops,
            }
            appended, append_exc = [], None
            futs = []
            for i, sl in enumerate(self.slices):
                try:
                    futs.append((i, sl, sl.rpc(
                        "wal_begin", payload,
                        timeout_s=self.ipc_timeout_s,
                    )))
                except Exception as e:
                    append_exc = append_exc or e
            for i, sl, f in futs:
                try:
                    f.result(timeout=self.ipc_timeout_s + 5)
                    appended.append(sl)
                except Exception as e:
                    if not self._keep_device_error(e):
                        self._mark_dead(i, e)
                    append_exc = append_exc or e
            if append_exc is not None or len(appended) != len(
                self.slices
            ):
                # the write was NOT acknowledged: tombstone the logs
                # that did append so recovery cannot resurrect it
                for sl in appended:
                    try:
                        sl.call("wal_abort", {
                            "first_seq": first, "last_seq": last,
                        }, timeout_s=self.ipc_timeout_s)
                    except Exception:
                        pass
                obs.count("serve.shard.write_aborts")
                if self.device_error is not None:
                    raise self.device_error
                raise RuntimeError(
                    f"sharded append failed on a slice: {append_exc}"
                )
            # phase 2: apply everywhere (idempotent slice-side).  The
            # exec lock serializes the data flip against in-flight
            # hop loops — a batch never sees two generations.
            commit = {
                "first_seq": first, "last_seq": last, "rows": rows,
                "cols": cols, "vals": vals, "ops": ops,
            }
            with self._exec_lock:
                results = self._commit_all(commit)
            obs.count("serve.shard.writes")
            frontier = [r["wal_seq"] for r in results]
            nnz = sum(r["nnz"] for r in results)
            bytes_ = self._device_bytes_per_slice()
        dt = time.perf_counter() - t0
        v = ShardedGraphVersion(
            nrows=self.spec.nrows, ncols=self.spec.ncols, nnz=nnz,
            bounds=self.spec.bounds, frontier=frontier,
            device_bytes=bytes_,
            merge_stats={"mode": "sharded", "latency_s": dt},
        )
        obs.gauge(
            "serve.shard.frontier_lag",
            max(frontier) - min(frontier) if frontier else 0,
        )
        return v

    def _commit_all(self, commit: dict) -> list:
        results: list = [None] * len(self.slices)
        dead = []
        futs = []
        for i, sl in enumerate(self.slices):
            try:
                futs.append((i, sl.rpc(
                    "wal_commit", commit,
                    timeout_s=self.ipc_timeout_s,
                )))
            except Exception as e:
                self._mark_dead(i, e)
                dead.append(i)
        for i, f in futs:
            try:
                results[i] = f.result(timeout=self.ipc_timeout_s + 5)
            except Exception as e:
                if self._keep_device_error(e):
                    raise
                self._mark_dead(i, e)
                dead.append(i)
        if dead:
            # the batch IS durable everywhere (phase 1 succeeded): a
            # dead slice recovers it from its own WAL during the heal,
            # and the re-sent commit is a frontier no-op
            self._heal(require_all=True)
            for i in dead:
                results[i] = self.slices[i].call(
                    "wal_commit", commit,
                    timeout_s=self.ipc_timeout_s,
                )
        return results

    # -- supervision / healing --------------------------------------------

    def _mark_dead(self, i: int, exc: Exception) -> None:
        with self._sup_lock:
            if i in self._needs_rebuild:
                return
            self._needs_rebuild.add(i)
            sl = self.slices[i]
            # fold the dying slice's build delta into the lost base:
            # marks stay monotone across the respawn
            self._trace_lost += max(
                0, self._last_mark.get(i, 0)
                - self._trace_floor.get(i, 0)
            )
            try:
                sl.quarantine(ReplicaDeadError(
                    f"slice {i} failed: {exc}"
                ))
            except Exception:
                pass
        obs.count("serve.shard.slice_deaths", slice=i)

    def supervise_once(self) -> dict:
        """One deterministic supervision tick (the policy.py stance):
        detect dead/hung slices (sticky), respawn from slab
        snapshot + WAL with capped-backoff retry.  The OTHER slices
        are untouched — the recover-ONE-slice property. While a CUDA
        error is held (local mode) it heals nothing: a respawn on the
        poisoned context would fail too."""
        detected, replaced = [], []
        if self.device_error is not None:
            return {"detected": detected, "replaced": replaced}
        with self._sup_lock:
            for i, sl in enumerate(self.slices):
                if i in self._needs_rebuild:
                    continue
                hung = (
                    self.hb_timeout_s
                    and isinstance(sl, ProcSlice)
                    and sl.heartbeat_age() > self.hb_timeout_s
                )
                if not sl.is_serving() or hung:
                    self._mark_dead(i, ReplicaDeadError(
                        f"slice {i} "
                        + ("hung (heartbeat timeout)" if hung
                           else "not serving")
                    ))
                    detected.append(i)
            now = time.monotonic()
            for i in sorted(self._needs_rebuild):
                if now < self._replace_next.get(i, 0.0):
                    continue
                try:
                    self._respawn(i)
                except Exception as e:
                    if self._keep_device_error(e):
                        break
                    self.respawn_failures += 1
                    obs.count("serve.shard.respawn_failed", slice=i)
                    b = self._replace_backoff.get(i, 0.5)
                    self._replace_next[i] = now + b
                    self._replace_backoff[i] = min(b * 2, 30.0)
                    continue
                self._needs_rebuild.discard(i)
                self._replace_backoff.pop(i, None)
                self._replace_next.pop(i, None)
                self.replacements += 1
                replaced.append(i)
                obs.count("serve.shard.replacements", slice=i)
        return {"detected": detected, "replaced": replaced}

    def _respawn(self, i: int) -> None:
        sl = self.slices[i].respawn()
        self.slices[i] = sl
        # the respawned slice warm-booted: floor its (fresh) counter
        # so its warm-up builds never read as serving builds
        self._floor_traces(i, sl)

    def _heal(self, require_all: bool = False) -> None:
        """Drive supervision until every slice serves again (bounded
        by ``recover_wait_s``); a held CUDA error raises at once."""
        t0 = time.monotonic()
        while True:
            self.supervise_once()
            if self.device_error is not None:
                raise self.device_error
            with self._sup_lock:
                pending = set(self._needs_rebuild)
            if not pending and all(
                sl.is_serving() for sl in self.slices
            ):
                if t0 != time.monotonic():
                    obs.observe("serve.shard.heal_wait_s",
                                time.monotonic() - t0)
                return
            if time.monotonic() - t0 > self.recover_wait_s:
                if require_all:
                    raise RuntimeError(
                        f"slices {sorted(pending)} did not heal "
                        f"within {self.recover_wait_s}s"
                    )
                return
            time.sleep(0.05)

    def start_supervisor(self, interval_s: float = 0.25) -> None:
        if self._sup_thread is not None:
            return
        self._sup_stop.clear()

        def loop():
            with device_scope(self.device):
                while not self._sup_stop.wait(interval_s):
                    try:
                        self.supervise_once()
                    except Exception:
                        obs.count("serve.shard.supervisor_errors")

        self._sup_thread = threading.Thread(
            target=loop, name="combblas-shard-supervisor", daemon=True
        )
        self._sup_thread.start()

    def stop_supervisor(self) -> None:
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=5.0)
            self._sup_thread = None

    # -- snapshots / introspection ----------------------------------------

    def checkpoint_now(self, reason: str = "manual") -> dict:
        futs = [
            (i, sl.rpc("checkpoint_now", {"reason": reason},
                       timeout_s=self.ipc_timeout_s * 2))
            for i, sl in enumerate(self.slices)
        ]
        out = {}
        for i, f in futs:
            out[i] = self._result(f, self.ipc_timeout_s * 2 + 5)
        self._version.frontier = [
            int(out[i]["wal_seq"]) for i in range(len(self.slices))
        ]
        self._version.wal_seq = min(self._version.frontier)
        self._write_manifest()
        return {
            "frontier": list(self._version.frontier),
            "slices": out, "reason": reason,
        }

    def _poll_slices(self):
        frontier, nnzs, bytes_ = [], [], []
        for sl in self.slices:
            s = sl.call("stats", timeout_s=self.ipc_timeout_s)
            frontier.append(int(s["wal_seq"]))
            nnzs.append(int(s["nnz"]))
            bytes_.append(int(s["device_bytes"]))
        return frontier, nnzs, bytes_

    def _device_bytes_per_slice(self) -> list:
        out = []
        for sl in self.slices:
            try:
                out.append(int(sl.call(
                    "device_bytes", timeout_s=self.ipc_timeout_s
                )["bytes"]))
            except Exception:
                out.append(0)
        return out

    def to_host_coo(self):
        """The global edge list, re-assembled and key-sorted — equal
        (np.array_equal) to what an unsharded ``keep_coo=True`` build
        of the same acknowledged writes retains (the recovery gate's
        comparison surface)."""
        parts = [
            sl.call("to_host_coo", timeout_s=self.ipc_timeout_s)
            for sl in self.slices
        ]
        rows = np.concatenate([p["rows"] for p in parts]).astype(np.int64)
        cols = np.concatenate([p["cols"] for p in parts]).astype(np.int64)
        ws = [p["weights"] for p in parts]
        weights = (
            None if any(w is None for w in ws)
            else np.concatenate(ws)
        )
        order = np.argsort(
            rows * np.int64(self.spec.ncols) + cols, kind="stable"
        )
        return (
            rows[order], cols[order],
            None if weights is None else weights[order],
        )

    def stats(self) -> dict:
        per_slice = {}
        plans: dict = {}
        hits = misses = swaps = 0
        for i, sl in enumerate(self.slices):
            try:
                s = sl.call("stats", timeout_s=self.ipc_timeout_s)
            except Exception as e:
                per_slice[i] = {"error": repr(e)}
                continue
            per_slice[i] = s
            hits += s.get("plan_hits", 0)
            misses += s.get("plan_misses", 0)
            swaps += s.get("swaps", 0)
            for kw, rec in (s.get("plans") or {}).items():
                agg = plans.setdefault(
                    kw, {"traces": 0, "executions": 0}
                )
                agg["traces"] += rec["traces"]
                agg["executions"] += rec["executions"]
        return {
            "plans": plans,
            "plan_hits": hits,
            "plan_misses": misses,
            "nrows": self.nrows,
            "kinds": list(self._kinds),
            "graph_version": self._version.vid,
            "graph_nnz": self._version.nnz,
            "swaps": self.swaps,
            "freshness": {
                "refresh_modes": {}, "repair_ratio": None,
                "versions_behind": 0,
            },
            "shard": {
                "mode": self.mode,
                "device": str(self.device),
                "device_error": (repr(self.device_error)
                                 if self.device_error is not None
                                 else None),
                "nslices": self.spec.nslices,
                "bounds": [list(b) for b in self.spec.bounds],
                "frontier_mode": self.frontier_mode,
                "density_threshold": self.density_threshold,
                "wire": self.wire,
                "last_exec": dict(self.last_exec_stats),
                "frontier": list(self._version.frontier),
                "device_bytes_per_slice":
                    list(self._version.device_bytes_per_slice),
                "replacements": self.replacements,
                "respawn_failures": self.respawn_failures,
                "needs_rebuild": sorted(self._needs_rebuild),
                "slices": per_slice,
            },
        }

    def close(self) -> None:
        self.stop_supervisor()
        for sl in self.slices:
            try:
                sl.close()
            except Exception:
                pass
        obs.gauge("serve.shard.slices", 0)


# --------------------------------------------------------------------------
# local-mode factories (kept top-level so recovery closures stay small)
# --------------------------------------------------------------------------


def _local_factory(i, r0, r1, n, nc, lrows, lcols, lw, kinds, *,
                   features, headroom, home, fsync, max_iters,
                   propagate_hops, checkpoint_every,
                   checkpoint_retain, warmup, warmup_widths, device):
    from ..parallel.grid import Grid

    def factory(recover: bool) -> SliceRuntime:
        grid = Grid.make(1, 1, device=device)
        with device_scope(grid.device):
            if recover:
                rt = SliceRuntime.recover(
                    grid, i, home, kinds, fsync=fsync,
                    max_iters=max_iters, propagate_hops=propagate_hops,
                    checkpoint_every=checkpoint_every,
                    checkpoint_retain=checkpoint_retain,
                )
                if warmup:
                    rt.warmup(widths=warmup_widths)
                return rt
            return SliceRuntime.build(
                grid, i, r0, r1, n, nc, lrows, lcols, lw, kinds,
                features=features, headroom=headroom, home=home,
                fsync=fsync, max_iters=max_iters,
                propagate_hops=propagate_hops,
                checkpoint_every=checkpoint_every,
                checkpoint_retain=checkpoint_retain,
            )

    return factory


def _local_recover_factory(i, home, kinds, *, max_iters,
                           propagate_hops, device):
    from ..parallel.grid import Grid

    def factory(recover: bool) -> SliceRuntime:
        grid = Grid.make(1, 1, device=device)
        with device_scope(grid.device):
            return SliceRuntime.recover(
                grid, i, home, kinds, max_iters=max_iters,
                propagate_hops=propagate_hops,
            )

    return factory
