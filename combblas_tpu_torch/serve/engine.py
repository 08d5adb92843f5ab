"""GraphEngine — a loaded graph plus a shape-bucketed plan cache;
counterpart of ``combblas_tpu/serve/engine.py``.

The batch searches pay off when requests share one run: W roots ride
one gather of each neighbour id. The engine owns that for one graph:

* the loaded matrices and derived artifacts: the structural
  ``EllParMat`` (BFS/BC/PageRank-structure), its weighted twin (SSSP),
  the column-normalized PageRank transition matrix + dangling vector,
  the transpose (BC / propagate on directed graphs) and the row/column
  degree vectors (``coldeg``) — built on the host once at load,
  uploaded once; the CSC companion (``csc_companion()``) builds lazily
  on first use;
* a **plan cache** keyed by (query kind, lane width), with hit and miss
  counters (``serve.plan_cache.*``) and the lane record of the plan
  store, so ``warmup()`` over the configured lane buckets makes
  steady-state requests find every plan built.

Deviations from the reference, kept on purpose:

* **Plans and traces.** The reference jits one program per plan and
  counts its traces. The port runs eager torch and compiles nothing: a
  plan is a host loop over the port's batch searches with one readback
  a level. ``_Plan.traces`` counts the builds of a plan (one per
  (kind, width)), so ``trace_mark`` / ``retraces_since`` count plan
  builds, and a swap to a version of another shape builds nothing. The
  ``trace.serve`` counter is left out, as the other ``trace.*``
  counters of the port are.
* ``warmup`` synchronises the card where the reference calls
  ``block_until_ready``; ``execute`` returns host numpy with
  ``batch_niter`` a Python int, as the reference does.
* ``serve()`` (the batched, backpressured ``Server``) comes with
  ``serve/api.py``.

The loaded state lives on a ``GraphVersion`` and plans resolve their
operands from the current version at call time, so ``swap()`` replaces
the whole graph under the execution lock while the plan cache survives;
``build_version()`` and ``apply_delta()`` construct the next generation
off-lock (double-buffered).

The engine is synchronous and thread-safe: plan building, ``warmup``
and ``execute`` serialize on one internal lock (one execution stream);
results come back as HOST numpy arrays, so ``execute`` is the
device→host sync point.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from .. import obs
from ..models import PAD_ROOT

#: Query kinds the engine can build plans for.  ``"propagate"`` is the
#: graph-ML lane: lane w of a batch answers "the k-hop propagated
#: feature row of vertex w" via the batched SpMM (models/propagate.py)
#: — it needs a feature table (``from_coo(features=...)``).
KINDS = ("bfs", "sssp", "pagerank", "bc", "propagate")


@dataclasses.dataclass
class _Plan:
    """One warm plan: (kind, width) -> callable + metadata."""

    kind: str
    width: int
    fn: object  # sources -> the kind's raw results
    traces: int = 0  # plan builds (the reference counts jit traces)
    executions: int = 0


@dataclasses.dataclass
class GraphVersion:
    """One immutable generation of loaded graph state — everything a
    plan's operands come from, bundled so the engine can swap it
    ATOMICALLY (one reference flip under the execution lock) while the
    plan cache survives.

    Plans read these matrices at call time (never closed over), so a
    swap to any version serves at once: the port builds no plan per
    operand shape.
    """

    nrows: int
    ncols: int
    nnz: int
    E: object                      # structural EllParMat
    deg: object                    # host [nrows] in-degree
    outdeg: object                 # host [ncols] out-degree
    E_weighted: object = None      # None => unit weights (falls back to E)
    P_ell: object = None           # pagerank transition matrix
    dangling: object = None        # pagerank dangling DistVec
    ET: object = None              # None => symmetric (E is its own T)
    csc: object = None             # lazy CSC companion cache
    coldeg: object = None          # lazy col-degree DistVec cache
    host_coo: tuple | None = None  # retained iff keep_coo=True
    host_weights: object = None    # deduped weights (the mutation lane)
    X: object = None               # propagate feature table (row-aligned
    #                                DistMultiVec, pow2-padded F)
    feat_dim: int = 0              # TRUE feature width (pad stripped)
    invdeg: object = None          # lazy col-aligned 1/deg DistVec (the
    #                                normalized-propagation twin; reset
    #                                on merge — degrees changed)
    headroom: float | None = None  # bucket-slot slack this version's
    #                                ELL builds reserved (merge state
    #                                must re-bucket with the same value)
    dyn: object = None             # dynamic.merge.MergeState (host
    #                                bucket structure for apply_delta)
    delta_from: tuple | None = None  # (parent vid, inserted keys,
    #                                removed keys) — refresh lineage
    vid: int = 0                   # assigned when installed/swapped in
    wal_seq: int = -1              # highest WAL sequence number folded
    #                                into this version (-1 = none) —
    #                                stamped into snapshot meta so
    #                                recovery replays exactly the
    #                                unapplied log suffix

    def device_bytes(self) -> int:
        """Resident DEVICE bytes of this version: every uploaded tensor
        a plan's operands can come from (the ELL matrices and their
        twins, the feature table, the pagerank/dangling and lazy degree
        vectors, the CSC companion), as the sum of their ``nbytes``.
        Host-side state (COO, degree tables, merge state) is not
        counted."""
        total = 0
        for M in (self.E, self.E_weighted, self.P_ell, self.ET):
            if M is not None:
                total += sum(int(a.nbytes) for b in M.buckets for a in b)
        for vec in (self.dangling, self.coldeg, self.invdeg, self.X):
            blocks = getattr(vec, "blocks", None)
            if blocks is not None:
                total += int(blocks.nbytes)
        if self.csc is not None:  # (indptr, rowidx) device pair
            total += sum(int(a.nbytes) for a in self.csc)
        return total


def _build_version(grid, rows, cols, nrows: int, ncols: int,
                   weights, kinds: tuple[str, ...], symmetric: bool,
                   keep_coo: bool, features=None,
                   headroom: float | None = None) -> GraphVersion:
    """Host-side construction of every artifact ``kinds`` need: dedup
    the COO, build the structural / weighted / normalized / transposed
    matrices and the degree tables. Runs WITHOUT any engine lock — the
    double-buffered half of hot-swap."""
    from ..parallel.ellmat import EllParMat
    from ..parallel.vec import DistVec
    from ..tuner import config as tuner_config

    # resolve the env default NOW and store the concrete value: the
    # merge state must re-bucket with the slack the build ACTUALLY used
    headroom = tuner_config.dynamic_headroom(headroom)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    n = int(nrows)
    ncols = int(ncols)
    key = rows.astype(np.int64) * np.int64(ncols) + cols
    if len(key) and (key[1:] > key[:-1]).all():
        # already sorted and unique (a CSR's or to_host_coo's order):
        # np.unique's sort would return the same keys, and each weight is
        # its own minimum
        uniq = key
        if weights is not None:
            weights = np.array(weights, np.float32)
    else:
        uniq, inv = np.unique(key, return_inverse=True)
        if weights is not None:
            w = np.full(len(uniq), np.inf, np.float32)
            np.minimum.at(w, inv, np.asarray(weights, np.float32))
            weights = w
    rows = (uniq // ncols).astype(rows.dtype)
    cols = (uniq % ncols).astype(cols.dtype)
    if "propagate" in kinds and ncols != n:
        raise ValueError(
            f"'propagate' needs a square graph (nrows={n}, "
            f"ncols={ncols}): A^k is undefined on rectangles"
        )
    if ("bc" in kinds or "propagate" in kinds) and symmetric:
        # VERIFY the symmetry claim: under symmetric=True bc and
        # propagate reuse E as its own transpose
        tkey = np.sort(cols.astype(np.int64) * np.int64(ncols) + rows)
        if ncols != n or not np.array_equal(uniq, tkey):
            raise ValueError(
                "symmetric=True but the COO is not structurally "
                "symmetric; pass symmetric=False (builds the "
                "transpose for bc) or symmetrize the graph"
            )
    with obs.span("serve.load", nrows=n, nnz=int(len(rows))):
        # E, E_weighted and P_ell share one bucket layout: host_build
        # places an entry by its row and column alone. The reference
        # builds each; here the layout is built once with entry k + 1 as
        # its value (0 on padding slots), and each twin gathers its values
        # through it: the same arrays, one host bucketing instead of three
        nnz = len(rows)
        ids = EllParMat.host_build(
            grid, rows, cols,
            np.arange(1, nnz + 1, dtype=np.int32 if nnz < 2**31 - 1 else np.int64),
            n, ncols, headroom=headroom,
        )

        def twin(vals):
            ext = np.concatenate([np.zeros(1, np.float32), np.asarray(vals, np.float32)])
            return EllParMat.from_host_buckets(
                grid, [(bc, ext[bi], br) for bc, bi, br in ids], n, ncols
            )

        E = EllParMat.from_host_buckets(
            grid, [(bc, (bi > 0).astype(np.float32), br) for bc, bi, br in ids], n, ncols
        )
        E_weighted = twin(weights) if weights is not None else None
        deg = np.bincount(rows, minlength=n).astype(np.int32)
        outdeg = np.bincount(cols, minlength=ncols).astype(np.int64)
        P_ell = dangling = None
        if "pagerank" in kinds:
            # column-stochastic normalization on the host (the
            # reference's DimApply, PageRank.cpp:97-126)
            P_ell = twin(1.0 / np.maximum(outdeg[cols], 1))
            dangling = DistVec.from_global(
                grid, (outdeg == 0).astype(np.float32), align="col"
            )
        ET = t_host = None
        if ("bc" in kinds or "propagate" in kinds) and not symmetric:
            t_host = EllParMat.host_build(grid, cols, rows, np.ones(nnz, np.float32),
                                          ncols, n, headroom=headroom)
            ET = EllParMat.from_host_buckets(grid, t_host, ncols, n)
        X = None
        feat_dim = 0
        if features is not None and "propagate" in kinds:
            from ..parallel.spmm import pad_features
            from ..parallel.vec import DistMultiVec

            features = np.asarray(features, np.float32)
            if features.shape[0] != ncols:
                raise ValueError(
                    f"features rows {features.shape[0]} != graph "
                    f"column space {ncols} (one feature row per "
                    "vertex the hops aggregate from)"
                )
            feat_dim = int(features.shape[1])
            X = DistMultiVec.from_global(
                grid, pad_features(features), align="row"
            )
            obs.gauge("serve.propagate.feature_dim", feat_dim)
    version = GraphVersion(
        nrows=n, ncols=ncols, nnz=int(len(rows)), E=E, deg=deg,
        outdeg=outdeg, E_weighted=E_weighted, P_ell=P_ell,
        dangling=dangling, ET=ET,
        host_coo=(rows, cols, ncols) if keep_coo else None,
        # the deduped (min-combined) weights ride along for the
        # mutation lane's merge-state bootstrap
        host_weights=weights if keep_coo else None,
        X=X, feat_dim=feat_dim, headroom=headroom,
    )
    if keep_coo:
        # the mutation lane's merge state comes from this build's host
        # buckets (the arrays ``bootstrap_state`` would rebuild with the
        # same host_build), derived on the first merge
        e_host = [(bc, None, br) for bc, _bi, br in ids]
        t_buckets = None if t_host is None else [(bc, None, br) for bc, _bv, br in t_host]
        host_coo, host_weights = version.host_coo, version.host_weights

        def _dyn_source():
            from ..dynamic.merge import state_from_host_buckets

            return state_from_host_buckets(grid, e_host, t_buckets, host_coo,
                                           host_weights, deg, outdeg)

        version.dyn_source = _dyn_source
    return version


class GraphEngine:
    """One graph, loaded and query-ready. See module docstring.

    Build with ``GraphEngine.from_coo`` (host COO in the usual gather
    orientation: entry (i, j) means edge j -> i; symmetrize for
    undirected graphs).
    """

    def __init__(self, grid, E=None, *, nrows: int | None = None,
                 deg: np.ndarray | None = None,
                 E_weighted=None, P_ell=None, dangling=None, ET=None,
                 csc=None, coldeg=None, kinds: tuple[str, ...] | None = None,
                 pagerank_opts: tuple = (0.85, 1e-6, 100),
                 propagate_opts: tuple = (2, False),
                 max_iters: int | None = None,
                 version: GraphVersion | None = None):
        self.grid = grid
        if version is None:
            if E is None or nrows is None or deg is None:
                raise ValueError(
                    "GraphEngine needs either version= or E/nrows/deg"
                )
            version = GraphVersion(
                nrows=int(nrows), ncols=int(getattr(E, "ncols", nrows)),
                nnz=-1, E=E, deg=np.asarray(deg), outdeg=None,
                E_weighted=E_weighted, P_ell=P_ell, dangling=dangling,
                ET=ET, csc=csc, coldeg=coldeg,
            )
        version.vid = 1
        self._version = version
        self.nrows = int(version.nrows)
        self.swaps = 0
        weighted_given = version.E_weighted is not None
        # kinds this engine was built to serve: only these get plans — a
        # kind whose artifacts were never built is rejected at the door
        if kinds is None:
            kinds = tuple(
                k for k in KINDS
                if (k != "pagerank" or version.P_ell is not None)
                and (k != "sssp" or weighted_given)
                and (k != "propagate" or version.X is not None)
            )
        self._kinds = tuple(kinds)
        self.pagerank_opts = pagerank_opts
        self.propagate_opts = propagate_opts
        self.max_iters = max_iters
        # the SpMM backend resolves ONCE per engine through the tuner
        # chain (op="spmm"; lazily on the first propagate plan build)
        self._spmm_backend: str | None = None
        self._plans: dict[tuple[str, int], _Plan] = {}
        # whole-graph analytics cache for refresh(): (kind, root) ->
        # {vid, result, niter}
        self._analytics: dict = {}
        # refresh-mode history (cached/warm/cold counts)
        self._refresh_modes: dict[str, int] = {}
        # ONE execution stream: plan building, warmup and execute all
        # serialize here
        self._exec_lock = threading.RLock()
        # plan-cache DICT mutations/snapshots only — stats() must be
        # pollable during a long batch
        self._plans_lock = threading.Lock()
        self.plan_hits = 0
        self.plan_misses = 0

    # -- version delegation ------------------------------------------------

    @property
    def version(self) -> GraphVersion:
        return self._version

    @property
    def version_id(self) -> int:
        return self._version.vid

    @property
    def E(self):
        return self._version.E

    @property
    def deg(self):
        return self._version.deg

    @property
    def E_weighted(self):
        v = self._version
        return v.E_weighted if v.E_weighted is not None else v.E

    @property
    def P_ell(self):
        return self._version.P_ell

    @property
    def dangling(self):
        return self._version.dangling

    @property
    def ET(self):
        v = self._version
        return v.ET if v.ET is not None else v.E  # symmetric default

    @property
    def csc(self):
        return self._version.csc

    @csc.setter
    def csc(self, value):
        self._version.csc = value

    @property
    def coldeg(self):
        return self._version.coldeg

    @coldeg.setter
    def coldeg(self, value):
        self._version.coldeg = value

    @property
    def _outdeg(self):
        return self._version.outdeg

    @property
    def _host_coo(self):
        return self._version.host_coo

    @_host_coo.setter
    def _host_coo(self, value):
        self._version.host_coo = value

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_coo(grid, rows, cols, nrows: int, ncols: int | None = None,
                 weights=None, kinds: tuple[str, ...] | None = None,
                 pagerank_alpha: float = 0.85, pagerank_tol: float = 1e-6,
                 pagerank_max_iters: int = 100,
                 max_iters: int | None = None,
                 symmetric: bool = True,
                 keep_coo: bool = False,
                 features=None,
                 propagate_hops: int = 2,
                 propagate_normalize: bool = False,
                 headroom: float | None = None) -> "GraphEngine":
        """Load a graph from host COO and build every derived artifact
        the requested ``kinds`` need (one host pass + one upload each).

        ``kinds`` defaults to every kind whose inputs were given:
        without ``weights``, 'sssp' is EXCLUDED (hop counts are not
        distances) — name it in ``kinds`` to serve unit-weight SSSP.
        The COO is DEDUPLICATED here; duplicate weighted edges keep the
        MINIMUM weight. ``features`` ([n, F] host array) opts into
        ``"propagate"`` (``propagate_hops`` hops;
        ``propagate_normalize=True`` serves ``(D⁻¹A)ᵏX``).
        ``headroom`` reserves a slack fraction of padding slots per ELL
        bucket class (``COMBBLAS_DYNAMIC_HEADROOM``) so the mutation
        lane re-buckets growing rows instead of spilling to a rebuild.
        """
        ncols = nrows if ncols is None else int(ncols)
        n = int(nrows)
        if kinds is None:
            kinds = tuple(
                k for k in KINDS
                if (k != "sssp" or weights is not None)
                and (k != "bc" or ncols == n)  # bc needs a square graph
                and (k != "propagate"
                     or (features is not None and ncols == n))
            )
        version = _build_version(
            grid, rows, cols, n, ncols, weights, tuple(kinds),
            symmetric, keep_coo, features=features, headroom=headroom,
        )
        return GraphEngine(
            grid, version=version, kinds=tuple(kinds),
            pagerank_opts=(pagerank_alpha, pagerank_tol,
                           pagerank_max_iters),
            propagate_opts=(int(propagate_hops),
                            bool(propagate_normalize)),
            max_iters=max_iters,
        )

    # -- graph versions / hot-swap -----------------------------------------

    def build_version(self, rows, cols, weights=None,
                      ncols: int | None = None, symmetric: bool = True,
                      keep_coo: bool = False,
                      features=None) -> GraphVersion:
        """Build the NEXT graph generation for this engine — same
        nrows, same kinds — outside the execution lock. Hand the result
        to ``swap()``."""
        t0 = time.perf_counter()
        v = _build_version(
            self.grid, rows, cols, self.nrows,
            self._version.ncols if ncols is None else int(ncols),
            weights, self._kinds, symmetric, keep_coo,
            features=features,
            # bucket shapes must round-trip the swap: reuse the
            # engine's configured headroom
            headroom=self._version.headroom,
        )
        if v.X is None and self._version.X is not None:
            # features are edge-independent: a version rebuilt without a
            # new table KEEPS the served one (same device tensors)
            v.X = self._version.X
            v.feat_dim = self._version.feat_dim
        obs.observe("serve.swap.build_s", time.perf_counter() - t0)
        return v

    def apply_delta(self, batch, **kw) -> GraphVersion:
        """Build the NEXT version by merging a delta batch into the
        CURRENT one (``combblas_tpu_torch.dynamic.merge.apply_delta``).
        Runs outside the execution lock; hand the result to ``swap()``.
        Requires the host edge list (``from_coo(..., keep_coo=True)``)."""
        from ..dynamic import merge as dyn_merge

        t0 = time.perf_counter()
        v = dyn_merge.apply_delta(
            self._version, batch, kinds=self._kinds, **kw
        )
        obs.observe("serve.swap.build_s", time.perf_counter() - t0)
        return v

    def refresh(self, kind: str, root: int | None = None,
                force_cold: bool = False) -> dict:
        """Whole-graph analytic with warm-restart recompute
        (``dynamic.refresh``): BFS levels from ``root``, CC labels, or
        the global PageRank vector — repaired from the engine's cached
        previous result when the current version's delta lineage allows
        it, recomputed cold otherwise. Returns ``{"result", "niter",
        "mode" (cached/warm/cold), "vid", ...}`` with host numpy
        results. Serialized on the execution lock."""
        from ..dynamic.refresh import refresh_analytic

        with self._exec_lock:
            return refresh_analytic(
                self, kind, root=root, force_cold=force_cold
            )

    def swap(self, version: GraphVersion) -> float:
        """Atomically install ``version`` as the current graph. Blocks
        on the execution lock, so an in-flight batch finishes on the OLD
        version; every later execute reads the new one. The plan cache
        is untouched. Returns the swap latency in seconds (lock wait +
        pointer flip), also an obs histogram (``serve.swap.latency_s``)."""
        if not isinstance(version, GraphVersion):
            raise TypeError(
                f"swap() takes a GraphVersion (see build_version), "
                f"got {type(version).__name__}"
            )
        if int(version.nrows) != self.nrows:
            raise ValueError(
                f"version nrows={version.nrows} != engine nrows="
                f"{self.nrows}; hot-swap preserves the result shape"
            )
        if int(version.ncols) != int(self._version.ncols):
            raise ValueError(
                f"version ncols={version.ncols} != engine ncols="
                f"{self._version.ncols}; a different column space is "
                "a new engine, not a version swap"
            )
        if "pagerank" in self._kinds and version.P_ell is None:
            raise ValueError(
                "engine serves 'pagerank' but the new version has no "
                "P_ell; build it via engine.build_version(...)"
            )
        if "propagate" in self._kinds and version.X is None:
            raise ValueError(
                "engine serves 'propagate' but the new version has no "
                "feature table; pass features= to build_version (or "
                "reuse the current one via engine.build_version)"
            )
        if (
            "sssp" in self._kinds
            and self._version.E_weighted is not None
            and version.E_weighted is None
        ):
            # a weighted engine must stay weighted: E_weighted would
            # fall back to the structural E and serve hop counts
            raise ValueError(
                "engine serves weighted 'sssp' but the new version "
                "has no weights; pass weights= to build_version"
            )
        t0 = time.perf_counter()
        with self._exec_lock:
            version.vid = self._version.vid + 1
            self._version = version
            self.swaps += 1
        dt = time.perf_counter() - t0
        obs.observe("serve.swap.latency_s", dt)
        obs.gauge("serve.graph.version", version.vid)
        obs.count("serve.swap.count")
        return dt

    def coldeg_vec(self):
        """Col-aligned out-degree DistVec (the budget input of the
        direction-optimized searches) — uploaded lazily and cached."""
        if self.coldeg is None:
            outdeg = getattr(self, "_outdeg", None)
            if outdeg is None:
                raise ValueError(
                    "coldeg_vec needs the degree table: build the "
                    "engine with GraphEngine.from_coo"
                )
            from ..parallel.vec import DistVec

            self.coldeg = DistVec.from_global(
                self.grid, outdeg.astype(np.int32), align="col"
            )
        return self.coldeg

    def csc_companion(self):
        """The CSC companion (``ellmat.build_csc_companion``), built
        LAZILY on first use and cached; needs the host COO
        (``from_coo(..., keep_coo=True)``), which is released after the
        build."""
        if self.csc is None:
            if self._host_coo is None:
                raise ValueError(
                    "csc_companion needs the host COO: build the "
                    "engine with GraphEngine.from_coo(keep_coo=True)"
                )
            from ..parallel.ellmat import build_csc_companion

            rows, cols, ncols = self._host_coo
            self.csc = build_csc_companion(
                self.grid, rows, cols, self.nrows, ncols
            )
            self._host_coo = None  # companion built: drop the edge list
        return self.csc

    # -- plan cache --------------------------------------------------------

    def kinds(self) -> tuple[str, ...]:
        """The kinds this engine was BUILT to serve."""
        return self._kinds

    def plan(self, kind: str, width: int) -> _Plan:
        """The plan for (kind, width) — built (a cache MISS) only on
        first use; warm it via ``warmup()`` so serving never misses."""
        if kind not in self._kinds:
            raise ValueError(
                f"engine was not built for kind {kind!r} "
                f"(kinds={self._kinds})"
            )
        key = (kind, int(width))
        with self._exec_lock:
            with self._plans_lock:
                p = self._plans.get(key)
            if p is not None:
                self.plan_hits += 1
                obs.count("serve.plan_cache.hits", kind=kind, width=width)
                return p
            self.plan_misses += 1
            obs.count("serve.plan_cache.misses", kind=kind, width=width)
            p = self._build_plan(kind, int(width))
            with self._plans_lock:
                self._plans[key] = p
            self._record_lane(kind, int(width))
            return p

    def _record_lane(self, kind: str, width: int) -> None:
        """Remember a built (kind, width) lane in the persisted plan
        store: a fresh process's ``warmup()`` replays the recorded lane
        set. Best-effort — a store problem must never fail serving."""
        try:
            from ..tuner import store as plan_store

            st = plan_store.get_store()
            if st is not None:
                st.add_serve_lane(
                    plan_store.serve_plan_key(self), kind, width
                )
        except Exception:
            pass

    def _build_plan(self, kind: str, width: int) -> _Plan:
        from ..models.bc import _bc_batch_dense_impl
        from ..models.bfs import bfs_batch
        from ..models.pagerank import pagerank_batch
        from ..models.sssp import sssp_batch

        if kind == "bfs":

            def impl(E, sources):
                p, lv, niter = bfs_batch(E, sources, max_iters=self.max_iters)
                return p.blocks, lv.blocks, niter

        elif kind == "sssp":

            def impl(E, sources):
                d, niter = sssp_batch(E, sources)
                return d.blocks, niter

        elif kind == "pagerank":
            if self.P_ell is None:
                raise ValueError(
                    "engine was built without the pagerank artifacts "
                    "(kinds= did not include 'pagerank')"
                )
            alpha, tol, iters = self.pagerank_opts

            def impl(P, dangling, sources):
                x, niter = pagerank_batch(
                    P, sources, dangling, alpha=alpha, tol=tol,
                    max_iters=iters,
                )
                return x.blocks, niter

        elif kind == "bc":

            def impl(E, ET, sources):
                return _bc_batch_dense_impl(
                    E, ET, sources, max_depth=self.max_iters,
                    per_lane=True,
                )

        elif kind == "propagate":
            from ..models.propagate import _propagate_batch_impl

            if self._version.X is None:
                raise ValueError(
                    "engine was built without a feature table "
                    "(from_coo(features=...) opts into 'propagate')"
                )
            hops, normalize = self.propagate_opts
            backend = self._resolve_spmm_backend()

            def impl(ET, X, invdeg, sources):
                return _propagate_batch_impl(
                    ET, X, invdeg, sources, hops=hops,
                    normalize=normalize, backend=backend,
                )

        else:
            raise ValueError(f"unknown query kind {kind!r}")

        # operands resolved at CALL time from the current GraphVersion
        # (not closed over): this is what lets swap() replace the graph
        # under a surviving plan cache
        return _Plan(
            kind=kind, width=width, traces=1,
            fn=lambda sources: impl(*self._plan_args(kind), sources),
        )

    def _resolve_spmm_backend(self) -> str:
        """The op="spmm" tuner resolution, ONCE per engine, keyed at the
        widest warm-up LANE width: the plan's hot products are the k
        indicator hops over the [n, W] batch block."""
        if self._spmm_backend is None:
            from ..parallel.spmm import resolve_spmm_backend
            from ..semiring import PLUS_TIMES

            self._spmm_backend = resolve_spmm_backend(
                PLUS_TIMES, self.ET, max(self.DEFAULT_WARMUP_WIDTHS),
            )
        return self._spmm_backend

    def _propagate_invdeg(self):
        """Col-aligned 1/deg DistVec for normalized propagation — lazy
        per version (a merge resets it: degrees changed)."""
        v = self._version
        if v.invdeg is None:
            from ..parallel.vec import DistVec

            v.invdeg = DistVec.from_global(
                self.grid,
                (1.0 / np.maximum(v.deg, 1)).astype(np.float32),
                align="col",
            )
        return v.invdeg

    def _plan_args(self, kind: str) -> tuple:
        """The current version's operands for one kind (the properties
        apply the unit-weight / symmetric-transpose fallbacks)."""
        if kind == "bfs":
            return (self.E,)
        if kind == "sssp":
            return (self.E_weighted,)
        if kind == "pagerank":
            return (self.P_ell, self.dangling)
        if kind == "propagate":
            _hops, normalize = self.propagate_opts
            return (
                self.ET, self._version.X,
                self._propagate_invdeg() if normalize else None,
            )
        return (self.E, self.ET)

    #: Lane widths every warmup covers (the batcher's pow2 buckets).
    DEFAULT_WARMUP_WIDTHS = (1, 2, 4, 8, 16)

    def warmup(self, kinds: tuple[str, ...] | None = None,
               widths: tuple[int, ...] | None = None) -> dict:
        """Build every (kind, width) plan by executing it once on an
        all-``PAD_ROOT`` batch (inert lanes) and synchronising the
        device. After this, serving a request mix inside ``kinds`` x
        ``widths`` builds no plan — assert via ``retraces_since(mark)``.
        Returns {(kind, width): seconds}.

        ``widths=None`` warms ``DEFAULT_WARMUP_WIDTHS`` PLUS every lane
        the plan store remembers for this graph's shape bucket
        (``tuner.store``); explicit ``widths`` warms exactly those.
        """
        kinds = self.kinds() if kinds is None else kinds
        per_kind = {
            k: set(self.DEFAULT_WARMUP_WIDTHS if widths is None
                   else widths)
            for k in kinds
        }
        if widths is None:
            try:
                from ..tuner import store as plan_store

                st = plan_store.get_store()
                lanes = (
                    st.serve_lanes(plan_store.serve_plan_key(self))
                    if st is not None else ()
                )
            except Exception:
                lanes = ()
            for k, w in lanes:
                if k in per_kind:
                    per_kind[k].add(int(w))
        out = {}
        for kind in kinds:
            for w in sorted(per_kind[kind]):
                t0 = time.perf_counter()
                with self._exec_lock, obs.span(
                    "serve.warmup", kind=kind, width=int(w)
                ):
                    self.plan(kind, w).fn(np.full(int(w), PAD_ROOT, np.int32))
                    if self.grid.device.type == "cuda":
                        torch.cuda.synchronize(self.grid.device)
                out[(kind, int(w))] = time.perf_counter() - t0
        return out

    def trace_mark(self) -> int:
        """Total plan builds across all plans (snapshot before serving,
        then ``retraces_since`` asserts that none was built)."""
        return sum(p.traces for p in self._plans.values())

    def retraces_since(self, mark: int) -> int:
        return self.trace_mark() - mark

    # -- execution ---------------------------------------------------------

    def _lanes_to_global(self, blocks) -> np.ndarray:
        """[pa, L, W] device blocks -> [n, W] host array (the engine's
        device->host sync)."""
        from ..parallel.vec import DistMultiVec

        return DistMultiVec(
            blocks=blocks, length=self.nrows, align="row", grid=self.grid
        ).to_global()

    def execute(self, kind: str, sources) -> dict:
        """Run one batch: ``sources`` is the int32 lane vector (pad
        slots = ``PAD_ROOT``). Returns a dict of host arrays with the
        lane axis LAST (what ``batcher.scatter`` slices per request).
        """
        sources = np.asarray(sources, np.int32)
        W = sources.shape[0]
        plan = self.plan(kind, W)
        with self._exec_lock, obs.span("serve.batch", kind=kind, width=W):
            res = plan.fn(sources)
            plan.executions += 1
            # "batch_niter" is BATCH metadata (the max iteration count
            # over all lanes, pad included), not a per-request fact
            if kind == "bfs":
                p, lv, niter = res
                return {
                    "parents": self._lanes_to_global(p),
                    "levels": self._lanes_to_global(lv),
                    "batch_niter": int(niter),
                }
            if kind == "sssp":
                d, niter = res
                return {
                    "dist": self._lanes_to_global(d),
                    "batch_niter": int(niter),
                }
            if kind == "pagerank":
                x, niter = res
                return {
                    "ranks": self._lanes_to_global(x),
                    "batch_niter": int(niter),
                }
            if kind == "propagate":
                # [Fp, W] features — strip the pow2 pad lanes back to the
                # true feature dim; lane axis stays LAST
                return {"features": res.cpu().numpy()[: self._version.feat_dim]}
            # bc: per-lane Brandes dependency vectors
            return {"scores": self._lanes_to_global(res)}

    def stats(self) -> dict:
        # _plans_lock only: polling stats during a long batch must not
        # block on the device-holding execution lock
        with self._plans_lock:
            plans = {
                f"{k}/{w}": {
                    "traces": p.traces, "executions": p.executions,
                }
                for (k, w), p in sorted(self._plans.items())
            }
            hits, misses = self.plan_hits, self.plan_misses
        warm = self._refresh_modes.get("warm", 0)
        cold = self._refresh_modes.get("cold", 0)
        vid = self._version.vid
        return {
            "plans": plans,
            "plan_hits": hits,
            "plan_misses": misses,
            "nrows": self.nrows,
            "kinds": list(self.kinds()),
            "graph_version": vid,
            "graph_nnz": self._version.nnz,
            "swaps": self.swaps,
            # dynamic-lane freshness: how stale the cached analytics are
            # vs the served version, and how often a refresh repaired
            # instead of recomputing cold
            "freshness": {
                "refresh_modes": dict(self._refresh_modes),
                "repair_ratio": (
                    warm / (warm + cold) if warm + cold else None
                ),
                "versions_behind": (
                    max(
                        (vid - e["vid"] for e in self._analytics.values()),
                        default=0,
                    )
                ),
            },
        }
