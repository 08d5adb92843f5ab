"""Warm-restart recompute: repair analytics instead of re-deriving them;
counterpart of ``combblas_tpu/dynamic/refresh.py``.

The algebra allows incremental recompute for the kinds the engine
serves as whole-graph analytics:

* **BFS levels** — after an INSERT-ONLY delta, old levels are valid
  upper bounds, so a min-plus relaxation seeded from them converges to
  the exact new levels in ~(changed-region diameter) sweeps instead of
  a full traversal.  Deletions can RAISE levels, which no monotone
  repair can express — those fall back to a cold run.
* **Connected components** — same monotonicity: insertions only merge
  components, so FastSV seeded from the previous labels re-converges in
  a few hook/shortcut rounds.  Deletions may split — cold fallback.
* **PageRank** — the power iteration converges from ANY starting
  vector, so every delta warm-restarts from the previous ranks.

All three run over the engine's loaded ``EllParMat`` artifacts (the
same operands the serve plans use). The reference runs each as one
``lax.while_loop``; here each is a host loop over ``dist_spmv_ell``
that reads back one flag (or one error) a sweep, as every other loop of
the port does, and returns its sweep count as a Python int. Levels and
labels are exact, so they equal the reference's bit for bit; PageRank's
float sums may differ in their last bits. Exposed through
``GraphEngine.refresh(kind)`` — which owns the cached previous results,
version lineage checks (``GraphVersion.delta_from``), and the
cold-vs-warm decision.  Obs: ``dynamic.refresh.*``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..semiring import MIN_PLUS, PLUS_TIMES, SELECT2ND_MIN

#: Kinds ``GraphEngine.refresh`` understands.
REFRESH_KINDS = ("bfs", "cc", "pagerank")


def _row_vec(E):
    """Row-aligned DistVec blocks of E's rows -> DistVec."""
    from ..parallel.vec import DistVec

    return lambda blocks: DistVec(blocks=blocks, length=E.nrows, align="row", grid=E.grid)


# -- BFS level repair --------------------------------------------------------


def _bfs_relax(E, xb: torch.Tensor):
    """Min-plus relaxation to fixpoint: ``lev <- min(lev, min over
    in-neighbors j of lev[j] + 1)``, at most n sweeps.  From a cold
    start (inf everywhere except the root) this IS BFS; from a warm
    start (old levels after insert-only deltas) it repairs.  Returns
    (blocks, sweeps)."""
    from ..parallel.ellmat import dist_spmv_ell

    mk = _row_vec(E)
    it, changed = 0, True
    while changed and it < E.nrows:
        y = dist_spmv_ell(MIN_PLUS, E, mk(xb).realign("col"))
        nb = torch.minimum(xb, y.blocks)
        changed = bool((nb != xb).any())
        xb = nb
        it += 1
    return xb, it


def _bfs_refresh(engine, root: int, prev: np.ndarray | None):
    from ..parallel.vec import DistVec

    n = engine.nrows
    if prev is None:
        lev = np.full(n, np.inf, np.float32)
        lev[int(root)] = 0.0
    else:
        lev = np.where(prev < 0, np.inf, prev).astype(np.float32)
    x0 = DistVec.from_global(
        engine.grid, lev, align="row", fill=np.float32(np.inf)
    )
    blocks, niter = _bfs_relax(engine.E, x0.blocks)
    out = _row_vec(engine.E)(blocks).to_global()
    levels = np.where(np.isfinite(out), out, -1).astype(np.int32)
    return levels, niter


# -- connected-components repair ---------------------------------------------


def _cc_ell(E, fb: torch.Tensor):
    """FastSV over an ``EllParMat`` with an explicit initial parent
    vector (``models/cc.py:connected_components`` generalized: iota is
    just the cold start), then pointer jumping.  Any initial vector
    whose entries name SAME-COMPONENT vertices converges to the
    per-component minimum — previous labels qualify after insert-only
    deltas.  Returns (blocks, hooking rounds)."""
    from ..models.cc import _jump
    from ..parallel.ellmat import dist_spmv_ell

    mk = _row_vec(E)
    it, changed = 0, True
    while changed and it < E.nrows:
        f = mk(fb)
        gf = f.gather(f)
        u = dist_spmv_ell(SELECT2ND_MIN, E, gf.realign("col"))
        f1 = f.scatter_combine(SELECT2ND_MIN, idx=f, src=u)
        nb = torch.minimum(torch.minimum(f1.blocks, u.blocks), gf.blocks)
        changed = bool((nb != fb).any())
        fb = nb
        it += 1
    fb, _passes = _jump(mk, fb)
    return fb, it


def _cc_refresh(engine, prev: np.ndarray | None):
    from ..parallel.vec import DistVec

    n = engine.nrows
    f0 = (
        np.arange(n, dtype=np.int32) if prev is None
        else np.asarray(prev, np.int32)
    )
    x0 = DistVec.from_global(engine.grid, f0, align="row")
    # padding slots must carry self-ids out of range, like iota does
    x0 = x0.mask_padding(2**31 - 1)
    blocks, niter = _cc_ell(engine.E, x0.blocks)
    labels = _row_vec(engine.E)(blocks).to_global().astype(np.int32)
    return labels, niter


# -- PageRank restart --------------------------------------------------------


def _pagerank_ell(P_ell, dangling_col: torch.Tensor, xb: torch.Tensor,
                  alpha: float = 0.85, tol: float = 1e-6,
                  max_iters: int = 100):
    """Whole-graph PageRank over the loaded transition matrix with an
    explicit starting vector (``models/pagerank.py:pagerank``'s loop,
    retargeted at the serving artifacts ``P_ell``/``dangling``).  A warm
    ``x0`` near the fixed point saves most iterations.  Returns
    (blocks, iterations)."""
    from ..parallel.ellmat import dist_spmv_ell
    from ..parallel.vec import DistVec

    grid, n = P_ell.grid, P_ell.nrows
    col_gids = DistVec.iota(grid, n, torch.int32, align="col").blocks
    dang_mask = torch.where(col_gids < n, dangling_col, 0.0)
    row_valid = DistVec.iota(grid, n, torch.int32, align="row").blocks < n
    mk = _row_vec(P_ell)
    it, going = 0, True
    while going and it < max_iters:
        x_col = mk(xb).realign("col")
        spread = dist_spmv_ell(PLUS_TIMES, P_ell, x_col)
        dmass = torch.sum(dang_mask * x_col.blocks)
        base = (1.0 - alpha) / n + alpha * dmass / n
        nb = torch.where(row_valid, alpha * spread.blocks + base, 0.0)
        going = bool(torch.sum(torch.abs(nb - xb)) > tol)
        xb = nb
        it += 1
    return xb, it


def _pagerank_refresh(engine, prev: np.ndarray | None):
    from ..parallel.vec import DistVec

    n = engine.nrows
    if engine.P_ell is None:
        raise ValueError(
            "refresh('pagerank') needs the pagerank artifacts "
            "(engine kinds= did not include 'pagerank')"
        )
    x0 = (
        np.full(n, 1.0 / n, np.float32) if prev is None
        else np.asarray(prev, np.float32)
    )
    v0 = DistVec.from_global(engine.grid, x0, align="row")
    alpha, tol, iters = engine.pagerank_opts
    blocks, niter = _pagerank_ell(
        engine.P_ell, engine.dangling.realign("col").blocks, v0.blocks,
        alpha=alpha, tol=tol, max_iters=iters,
    )
    ranks = _row_vec(engine.P_ell)(blocks).to_global().astype(np.float32)
    return ranks, niter


# -- the engine-facing entry -------------------------------------------------


def refresh_analytic(engine, kind: str, root: int | None = None,
                     force_cold: bool = False) -> dict:
    """Compute (or repair) one whole-graph analytic for the engine's
    CURRENT version.  The engine's ``_analytics`` cache holds the
    previous result + the version it was computed on; the warm path is
    taken when the current version's ``delta_from`` lineage points at
    exactly the cached version AND the delta is repair-compatible
    (insert-only for bfs/cc; anything for pagerank).  Called under the
    engine's execution lock by ``GraphEngine.refresh``."""
    if kind not in REFRESH_KINDS:
        raise ValueError(
            f"unknown refresh kind {kind!r}; expected {REFRESH_KINDS}"
        )
    if kind == "bfs":
        if root is None:
            raise ValueError("refresh('bfs') needs root=")
        root = int(root)
        if not (0 <= root < engine.nrows):
            raise ValueError(f"root {root} outside [0, {engine.nrows})")
    ck = (kind, root if kind == "bfs" else None)
    entry = engine._analytics.get(ck)
    vid = engine.version_id
    if entry is not None and obs.ENABLED:
        # the ROADMAP-named freshness gauge: how many graph versions
        # the cached analytic lags the served version at refresh time
        # (0 = the cache answers for the current graph)
        obs.gauge(
            "dynamic.freshness.versions_behind",
            vid - entry["vid"], kind=kind,
        )
    if entry is not None and entry["vid"] == vid and not force_cold:
        engine._refresh_modes["cached"] = (
            engine._refresh_modes.get("cached", 0) + 1
        )
        obs.count("dynamic.refresh.runs", kind=kind, mode="cached")
        return {**entry, "mode": "cached", "latency_s": 0.0}

    prev = None
    mode = "cold"
    reason = "first" if entry is None else "lineage"
    if entry is not None and not force_cold:
        delta = getattr(engine.version, "delta_from", None)
        if delta is not None and delta[0] == entry["vid"]:
            _parent, ins, rem = delta
            if kind == "pagerank":
                prev, mode, reason = entry["result"], "warm", ""
            elif len(rem) == 0:  # monotone repair needs insert-only
                prev, mode, reason = entry["result"], "warm", ""
            else:
                reason = "deletes"
    elif force_cold:
        reason = "forced"

    t0 = time.perf_counter()
    if kind == "bfs":
        result, niter = _bfs_refresh(engine, root, prev)
    elif kind == "cc":
        result, niter = _cc_refresh(engine, prev)
    else:
        result, niter = _pagerank_refresh(engine, prev)
    dt = time.perf_counter() - t0
    out = {"kind": kind, "vid": vid, "result": result, "niter": niter}
    engine._analytics[ck] = out
    engine._refresh_modes[mode] = engine._refresh_modes.get(mode, 0) + 1
    obs.count("dynamic.refresh.runs", kind=kind, mode=mode)
    obs.observe("dynamic.refresh.iters", niter, kind=kind, mode=mode)
    obs.observe("dynamic.refresh.latency_s", dt, kind=kind, mode=mode)
    if obs.ENABLED:
        # repair-vs-cold ratio over this engine's recompute history —
        # the streaming lane's warm-start payoff as one gauge
        warm = engine._refresh_modes.get("warm", 0)
        cold = engine._refresh_modes.get("cold", 0)
        if warm + cold:
            obs.gauge(
                "dynamic.freshness.repair_ratio", warm / (warm + cold)
            )
    return {
        **out, "mode": mode, "cold_reason": reason, "latency_s": dt,
    }
