"""Micro-probe pass — counterpart of ``combblas_tpu/tuner/probe.py``:
MEASURE the admissible SpGEMM rungs on a bounded downsampled proxy and
write the winner into the plan store.

On a plan-store miss (probing enabled with ``COMBBLAS_TUNER_PROBE=1``, no
arg/env override) the router calls ``probe_spgemm``:

1. **Deterministic, degree-preserving downsample** — the operands' host
   COO maps through a seeded permutation into a pow2 proxy rectangle
   (``COMBBLAS_TUNER_PROBE_MAX_DIM``, default 2048), one axis RESTRICTED
   and the other FOLDED per operand, so the proxy keeps the density band
   the plan key records (``downsample_coo``).  The proxy is a pure
   function of the host arrays and the seed (numpy ``default_rng``),
   equal to the reference's array for array, and is built on the grid's
   device.
2. **Admissibility at REAL scale** — candidate rungs are gated on the
   real shapes with the router's own predicates (``admissible_tiers``).
3. **Bounded measurement** — each candidate runs once untimed (warm-up)
   then once timed, with ``torch.cuda.synchronize`` before the clock
   starts and before it stops; the timed seconds are capped by
   ``COMBBLAS_TUNER_PROBE_BUDGET_S`` (default 30 s), the heuristic's own
   choice measured FIRST so an exhausted budget still yields a measured
   plan.

The proxy runs on the same grid as the real product.  ``probe_spgemm3d``
and ``probe_spmm`` measure their candidates on the real operands.

A rung is skipped only for what it raises by design on operands that do
not fit it (``PROBE_SKIPS``: the tiers' ``TierRefusal``, the windowed
tier's ``CapacityOverflowError`` and ``torch.OutOfMemoryError``); each
skip is recorded in the probe's ``last_errors``.  Anything else — a
failed kernel build, a CUDA launch error, a kernel wrapper's
``ValueError`` on a bad call — propagates: the probe never hides a
kernel.  Probe cost is obs-visible, as in the reference: each pass runs
in a ``tuner.probe`` span (``tuner.probe.geometry`` for the windowed
geometry sweep) and counts ``tuner.probe.{runs,errors,budget_exhausted,
seconds,winner,geometry_runs}``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..parallel.spgemm import CapacityOverflowError, TierRefusal
from . import config
from .store import PlanKey, PlanRecord, PlanStore

#: What a rung may raise by design on operands it does not fit; the probe
#: skips such a rung and records it. Everything else propagates.
PROBE_SKIPS = (TierRefusal, CapacityOverflowError, torch.OutOfMemoryError)


def downsample_coo(
    rows,
    cols,
    dims: tuple[int, int],
    proxy_dims: tuple[int, int],
    seed: int = 0,
    modes: tuple[str, str] = ("restrict", "fold"),
):
    """Deterministically downsample a host COO to a proxy rectangle,
    PRESERVING the density band the plan key records.

    Each axis is mapped through a seeded permutation of its length and
    then either ``"restrict"``-ed (keep ids < proxy dim) or ``"fold"``-ed
    (id mod proxy dim).  Restricting ONE axis and folding the other keeps
    the per-row average degree of the original.  The probe uses
    ``("restrict", "fold")`` for A and ``("fold", "restrict")`` for B, so
    the shared k axis carries the SAME permutation+fold on both operands.
    Pure function of (inputs, seed)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    keep = np.ones(len(rows), bool)
    out = []
    for x, dim, pdim, mode in (
        (rows, dims[0], proxy_dims[0], modes[0]),
        (cols, dims[1], proxy_dims[1], modes[1]),
    ):
        mapped = _axis_perm(dim, seed)[x]
        if mode == "restrict":
            keep &= mapped < pdim
        elif mode == "fold":
            mapped = mapped % pdim
        else:
            raise ValueError(f"mode must be 'restrict' or 'fold', got {mode!r}")
        out.append(mapped)
    return (
        out[0][keep].astype(np.int64),
        out[1][keep].astype(np.int64),
        keep,
    )


def _dedup_sum(r, c, v, ncols: int):
    """Host sum-combine of duplicate (row, col) proxy entries."""
    key = r.astype(np.int64) * np.int64(ncols) + c
    uniq, inv = np.unique(key, return_inverse=True)
    vv = np.zeros(len(uniq), np.asarray(v).dtype)
    np.add.at(vv, inv, np.asarray(v))
    return (
        (uniq // ncols).astype(np.int64),
        (uniq % ncols).astype(np.int64),
        vv,
    )


def _axis_perm(length: int, seed: int) -> np.ndarray:
    """One seeded permutation per (axis length, seed): shared axes (the
    k dimension of A·B, or all three axes of A²) map identically."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + length))
    return rng.permutation(int(length))


def _proxy_dim(dim: int, max_dim: int) -> int:
    """Pow2 proxy dimension, never above ``max_dim`` — when the pow2
    ceiling would overshoot a non-pow2 cap, round DOWN instead."""
    d = min(int(dim), int(max_dim))
    p = 1 << max(d - 1, 1).bit_length()
    if p > max_dim:
        p >>= 1
    return max(p, 2)


def proxy_coo(A, B, max_dim: int, seed: int = 0, host_coo_a=None,
              host_coo_b=None):
    """The probe's proxy operands as host arrays: ``((rows, cols, vals)
    of A's proxy, the same of B's, (pm, pk, pn))``, or ``None`` when
    either proxy is empty.  A restricts rows and folds cols, B folds rows
    and restricts cols; folded duplicates are sum-combined
    (``_dedup_sum``) so the mxu candidate's unique-entries precondition
    holds on the proxy."""
    ra, ca, va = A.to_global_coo() if host_coo_a is None else host_coo_a
    pm = _proxy_dim(A.nrows, max_dim)
    pk = _proxy_dim(A.ncols, max_dim)
    pn = _proxy_dim(B.ncols, max_dim)
    par, pac, keep_a = downsample_coo(
        ra, ca, (A.nrows, A.ncols), (pm, pk), seed=seed,
        modes=("restrict", "fold"),
    )
    if B is A and host_coo_b is None:
        rb, cb, vb = ra, ca, va
    else:
        rb, cb, vb = B.to_global_coo() if host_coo_b is None else host_coo_b
    pbr, pbc, keep_b = downsample_coo(
        rb, cb, (B.nrows, B.ncols), (pk, pn), seed=seed,
        modes=("fold", "restrict"),
    )
    if len(par) == 0 or len(pbr) == 0:
        return None  # degenerate proxy: nothing to measure
    return (
        _dedup_sum(par, pac, np.asarray(va)[keep_a], pk),
        _dedup_sum(pbr, pbc, np.asarray(vb)[keep_b], pn),
        (pm, pk, pn),
    )


def admissible_tiers(sr, A, B, backend: str) -> list[str]:
    """Candidate rungs for the probe, gated at REAL scale with the
    router's own predicates; the heuristic's choice is listed FIRST (it
    is measured even when the budget runs out after one rung)."""
    from ..ops.spgemm import scatter_combine_for
    from ..parallel import spgemm as sp

    cands = []
    max_dim = max(A.local_rows, A.local_cols, B.local_cols)
    cells = A.local_rows * B.local_cols
    if (
        max_dim <= sp.MXU_MAX_TILE_DIM
        and sr.name in sp._PALLAS_KINDS
        and not (
            sp.coo_has_duplicates(A)
            or (B is not A and sp.coo_has_duplicates(B))
        )
    ):
        cands.append("mxu")
    if (
        scatter_combine_for(sr) is not None
        and cells <= sp.WINDOWED_MAX_TILE_CELLS
        and (
            backend == "scatter"
            or (
                sr.name in sp._PALLAS_KINDS
                and sp.dot_panel_feasible(B.local_rows, B.local_cols)
            )
        )
    ):
        cands.append("windowed")
    cands.append("scan")
    heur = sp._choose_spgemm_tier_2d(
        sr, A, B, backend=backend, assume_unique=True
    )
    if heur in cands:
        cands.remove(heur)
        cands.insert(0, heur)
    return cands


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_measure(device: torch.device):
    """The default cost functional on ``device``: the wall seconds of one
    run of ``fn`` (warmed up by the caller), with the device synchronised
    before the clock starts and before it stops."""
    def measure(fn) -> float:
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0

    return measure


def _measure_candidates(cands, run_of, measure, budget_s, errors,
                        spent0: float = 0.0, tier_of=None, geometry: bool = False):
    """Warm then time each candidate in order until the budget (counted
    from ``spent0``) is spent; the first is always measured.  Returns
    ``(costs, spent, runs)``; a candidate that raises one of
    ``PROBE_SKIPS`` is skipped and appended to ``errors``.  Counts
    ``tuner.probe.budget_exhausted``, ``tuner.probe.errors{tier}`` and
    ``tuner.probe.runs{tier}`` (``tier_of(cand)``, default the candidate
    itself), or for the ``geometry`` sweep ``tuner.probe.geometry_runs``
    and errors under ``tier=windowed``."""
    costs: dict = {}
    spent = 0.0
    runs = 0
    for cand in cands:
        if costs and spent0 + spent >= budget_s:
            if obs.ENABLED:
                obs.count("tuner.probe.budget_exhausted")
            break
        tier = "windowed" if geometry else (cand if tier_of is None else tier_of(cand))
        run = run_of(cand)
        try:
            run()  # warm-up (untimed)
            dt = float(measure(run))
        except PROBE_SKIPS as exc:
            errors.append({"candidate": cand, "error": f"{type(exc).__name__}: {exc}"})
            if obs.ENABLED:
                obs.count("tuner.probe.errors", tier=tier)
            continue
        costs[cand] = dt
        spent += dt
        runs += 1
        if obs.ENABLED:
            if geometry:
                obs.count("tuner.probe.geometry_runs")
            else:
                obs.count("tuner.probe.runs", tier=tier)
    return costs, spent, runs


def probe_spgemm(
    sr,
    A,
    B,
    *,
    backend: str,
    store: PlanStore | None = None,
    key: PlanKey | None = None,
    budget_s: float | None = None,
    max_dim: int | None = None,
    seed: int = 0,
    host_coo_a=None,
    host_coo_b=None,
    measure=None,
    tier_order=None,
    geometry: bool = True,
) -> PlanRecord | None:
    """Measure the admissible rungs on the downsampled proxy; return the
    winning :class:`PlanRecord` (and persist it into ``store`` under
    ``key`` when both are given), or ``None`` when no measurement was
    possible (empty proxy, or every rung skipped) — the caller then falls
    back to the heuristic.

    ``host_coo_a``/``host_coo_b`` ((rows, cols, vals) host arrays) skip
    the operand readback.  ``measure`` injects the cost functional
    (default ``wall_measure`` on the grid's device); ``tier_order``
    overrides the admissibility-gated candidate list and
    ``geometry=False`` skips the windowed block-shape sweep.
    ``probe_spgemm.last_errors`` lists the rungs the last call skipped,
    ``probe_spgemm.last_costs`` its measured seconds by tier and
    geometry."""
    from ..parallel.spgemm import spgemm_auto
    from ..parallel.spmat import SpParMat

    budget_s = config.probe_budget_s() if budget_s is None else budget_s
    max_dim = config.probe_max_dim() if max_dim is None else max_dim
    measure = wall_measure(A.grid.device) if measure is None else measure
    errors: list = []
    probe_spgemm.last_errors = errors
    probe_spgemm.last_costs = {}

    proxy = proxy_coo(A, B, max_dim, seed, host_coo_a, host_coo_b)
    if proxy is None:
        return None
    coo_a, coo_b, (pm, pk, pn) = proxy
    grid = A.grid
    pA = SpParMat.from_global_coo(grid, *coo_a, pm, pk)
    pB = SpParMat.from_global_coo(grid, *coo_b, pk, pn)

    cands = (
        list(tier_order) if tier_order is not None
        else admissible_tiers(sr, A, B, backend)
    )

    def run_tier(tier):
        return lambda: spgemm_auto(
            sr, pA, pB, tier=tier, backend=backend,
            assume_unique=(tier != "mxu"),
        )

    with obs.span("tuner.probe", sr=sr.name, dim=pm):
        costs, spent, runs = _measure_candidates(
            cands, run_tier, measure, budget_s, errors)
    if store is not None:
        store.record_probe(runs, spent)
    if obs.ENABLED:
        obs.count("tuner.probe.seconds", spent)
    probe_spgemm.last_costs = {"tiers": dict(costs)}
    if not costs:
        return None
    winner = min(costs, key=costs.get)
    if obs.ENABLED:
        obs.count("tuner.probe.winner", tier=winner)
    # the window-geometry sweep: when windowed won and budget remains,
    # sweep a small block_rows / block_cols grid on the same proxy and
    # persist the winning geometry, rescaled to the real dims, WITH the
    # plan
    best_geo = (None, None)
    if geometry and winner == "windowed" and spent < budget_s:
        best_cost = costs[winner]

        def run_geo(geo):
            br, bc = geo
            return lambda: spgemm_auto(
                sr, pA, pB, tier="windowed", backend=backend,
                block_rows=br, block_cols=bc, assume_unique=True,
            )

        with obs.span("tuner.probe.geometry", dim=pm):
            geo_costs, geo_spent, geo_runs = _measure_candidates(
                _geometry_candidates(pm, pn), run_geo, measure, budget_s,
                errors, spent0=spent, geometry=True)
        if store is not None:
            store.record_probe(geo_runs, geo_spent)
        if obs.ENABLED and geo_spent:
            obs.count("tuner.probe.seconds", geo_spent)
        probe_spgemm.last_costs["geometry"] = {
            f"{br}x{bc}": dt for (br, bc), dt in geo_costs.items()}
        for geo, dt in geo_costs.items():
            if dt < best_cost:
                best_cost, best_geo = dt, geo
        costs[winner] = best_cost
        if best_geo != (None, None):
            # the candidates are FRACTIONS of the proxy dims; persist them
            # rescaled to the real dims the plan key describes (factor 1
            # when the proxy was not downsampled)
            sm = -(-int(A.nrows) // pm)
            sn = -(-int(B.ncols) // pn)
            br, bc = best_geo
            best_geo = (
                None if br is None else int(br) * sm,
                None if bc is None else int(bc) * sn,
            )
    rec = PlanRecord(
        tier=winner, cost_s=costs[winner], source="probe",
        probe_dim=pm,
        block_rows=best_geo[0], block_cols=best_geo[1],
    )
    if store is not None and key is not None:
        store.put(key, rec)
    return rec


probe_spgemm.last_errors = []
probe_spgemm.last_costs = {}


def _geometry_candidates(pm: int, pn: int) -> list[tuple]:
    """Bounded non-default block-geometry grid for the windowed sweep: a
    handful of pow2 fractions of the proxy dims (the kernel default was
    already measured by the tier pass), deduped and capped at FOUR."""
    brs = sorted({max(pm // 8, 16), max(pm // 2, 32)})
    bcs = [None, max(pn // 4, 16)]
    cands = [(br, bc) for br in brs for bc in bcs]
    seen, out = set(), []
    for g in cands:
        if g not in seen and g != (None, None):
            seen.add(g)
            out.append(g)
    return out[:4]


def spgemm3d_candidates(sr, A3) -> list[tuple]:
    """The 3D probe's (tier, merge) candidates: the heuristic first (esc
    with its own merge resolution), then the merge alternates, then the
    windowed tier with its heuristic merge and the sort control (and hash
    on two or more layers) — at most five real-scale runs.  Under a
    fleet-wide ``COMBBLAS_SPGEMM_MERGE`` the None-merge candidates resolve
    to the env value, so identical kernels are deduplicated."""
    from ..ops.spgemm import scatter_combine_for

    candidates = [("esc", None), ("esc", "runs")]
    if scatter_combine_for(sr) is not None:
        candidates += [("windowed", None), ("windowed", "sort")]
        if A3.grid.layers >= 2:
            candidates.append(("windowed", "hash"))
    env_merge = config.env_merge()
    if env_merge is not None:
        seen, uniq = set(), []
        for tier, mg in candidates:
            eff = (tier, mg if mg is not None else env_merge)
            if eff not in seen:
                seen.add(eff)
                uniq.append((tier, mg))
        candidates = uniq
    return candidates


def probe_spgemm3d(
    sr,
    A3,
    B3,
    *,
    store: PlanStore | None = None,
    key: PlanKey | None = None,
    budget_s: float | None = None,
    measure=None,
    candidates=None,
) -> PlanRecord | None:
    """Measure admissible (tier, merge) pairs of the 3D entry ON THE REAL
    OPERANDS (``spgemm3d_candidates`` unless ``candidates`` is given) and
    return / persist the winner, its ``merge`` in the record.  No proxy:
    a 3D probe run is a warm run of a kernel the caller was about to run
    anyway, and the list is short.  ``probe_spgemm3d.last_errors`` and
    ``.last_costs`` as for ``probe_spgemm``."""
    from ..parallel import mesh3d

    budget_s = config.probe_budget_s() if budget_s is None else budget_s
    if candidates is None:
        candidates = spgemm3d_candidates(sr, A3)
    measure = wall_measure(A3.grid.device) if measure is None else measure
    errors: list = []
    probe_spgemm3d.last_errors = errors

    def run_of(cand):
        tier, merge = cand
        return lambda: mesh3d.spgemm3d(sr, A3, B3, tier=tier, merge=merge)

    with obs.span("tuner.probe", sr=sr.name, dim=int(A3.nrows), op="spgemm3d"):
        costs, spent, runs = _measure_candidates(
            candidates, run_of, measure, budget_s, errors, tier_of=lambda c: c[0])
    probe_spgemm3d.last_costs = {f"{t}/{m}": dt for (t, m), dt in costs.items()}
    if store is not None:
        store.record_probe(runs, spent)
    if obs.ENABLED:
        obs.count("tuner.probe.seconds", spent)
    if not costs:
        return None
    winner = min(costs, key=costs.get)
    if obs.ENABLED:
        obs.count("tuner.probe.winner", tier=winner[0])
    rec = PlanRecord(
        tier=winner[0], merge=winner[1], cost_s=costs[winner],
        source="probe", probe_dim=int(A3.nrows),
    )
    if store is not None and key is not None:
        store.put(key, rec)
    return rec


probe_spgemm3d.last_errors = []
probe_spgemm3d.last_costs = {}


def probe_spmm(
    sr,
    E,
    X,
    *,
    store: PlanStore | None = None,
    key: PlanKey | None = None,
    budget_s: float | None = None,
    measure=None,
) -> PlanRecord | None:
    """Measure the admissible SpMM backends ON THE REAL OPERANDS and
    return / persist the winner (the op="spmm" micro-probe): at most two
    warm runs of a kernel the caller was about to run anyway.  A semiring
    with a single admissible backend has nothing to measure (``None``).
    The heuristic's choice is measured first.
    ``probe_spmm.last_errors`` and ``.last_costs`` as for
    ``probe_spgemm``."""
    from ..parallel import spmm as spmm_mod

    probe_spmm.last_errors = errors = []
    probe_spmm.last_costs = {}
    cands = list(spmm_mod.admissible_spmm_backends(sr))
    if len(cands) < 2:
        return None
    heur = spmm_mod.spmm_backend_heuristic(sr)
    if heur in cands:
        cands.remove(heur)
        cands.insert(0, heur)
    budget_s = config.probe_budget_s() if budget_s is None else budget_s
    measure = wall_measure(E.grid.device) if measure is None else measure

    def run_of(backend):
        return lambda: spmm_mod.dist_spmm_ell(sr, E, X, backend=backend)

    with obs.span("tuner.probe", sr=sr.name, dim=int(E.nrows), op="spmm"):
        costs, spent, runs = _measure_candidates(
            cands, run_of, measure, budget_s, errors)
    probe_spmm.last_costs = dict(costs)
    if store is not None:
        store.record_probe(runs, spent)
    if obs.ENABLED:
        obs.count("tuner.probe.seconds", spent)
    if not costs:
        return None
    winner = min(costs, key=costs.get)
    if obs.ENABLED:
        obs.count("tuner.probe.winner", tier=winner)
    rec = PlanRecord(
        tier=winner, cost_s=costs[winner], source="probe",
        probe_dim=int(E.nrows),
    )
    if store is not None and key is not None:
        store.put(key, rec)
    return rec


probe_spmm.last_errors = []
probe_spmm.last_costs = {}
