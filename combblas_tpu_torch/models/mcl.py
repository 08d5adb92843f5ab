"""HipMCL — Markov clustering, counterpart of ``combblas_tpu/models/mcl.py``
(≈ ``Applications/MCL.cpp``).

Iterate {expand = A², prune / recover / select, make column-stochastic,
measure chaos, inflate} until the chaos drops below ``eps``, then read the
clusters off the converged matrix as connected components of A + Aᵀ
(``MCL.cpp:515-660``). Four loops, as in the reference:

  * the sparse loop: expansion by the phased SUMMA
    (``mem_efficient_spgemm``, ESC or scan) with the column sparsifier
    (``mcl_prune_recovery_select``) applied per phase;
  * the block loop (``chaos_every > 1``): K iterations a sync with frozen
    capacities (``summa_spgemm_scan``), on-device overflow flags, and a
    block rerun from its saved entry state with doubled capacities on
    overflow, so results are exact;
  * the dense loop (``expansion="dense"``, one tile): the state is Aᵀ as a
    dense ``[npad, npad]`` float32 matrix, squared by ``_mxu_dot`` (f32,
    bf16 or bf16x3), pruned with ``torch.topk`` thresholds, optionally
    kicked out of a flip-flop plateau (``perturb_delta``), and extracted
    exactly through ``dense_support_nnz`` + ``sparsify_windowed``;
  * the 3D loop (``layers > 1``, HipMCL's layered configuration): the
    matrix goes col-split onto a layers × p × p grid (``mesh3d``); each
    iteration resplits a row-split copy, expands by
    ``mem_efficient_spgemm3d`` with the 3D sparsifier
    (``mcl_prune_recovery_select3d``) and runs the column ops on the 3D
    matrix; with ``chaos_every > 1`` its block form (frozen capacities,
    ``summa3d_spgemm`` and ``resplit3d_fixed``, a reroll on overflow).
    The converged matrix goes back to the 2D grid for the clusters.

The reference runs the dense loop as one ``lax.while_loop`` with no
readback; here it is a host loop that reads back one small vector an
iteration (the chaos, the plateau flag and the loop condition). The
reference's block loop reads back once a block; the port's scan product
reads back its stage sizes inside each product, as every ported scan call
does. Iteration counts come back as Python ints. Float sums (the ESC
fold, the dense products, column sums) fold in another order than XLA's,
so iterates agree with the reference within float32 rounding, and labels
agree exactly on inputs with no near-tie at a threshold.

Telemetry, at the reference's sites: the sparse loop's ``mcl.round``
spans with a ``chaos`` event, the block loops' ``mcl.block_rerolls`` and
(2D) ``mcl.block_sync`` events, and the dense loop's ``mcl.dense`` span
with ``mcl.perturb_kicks`` and a ``mcl.converged`` event. The dense
loop's kick count is a host int here; its final chaos costs one more small
readback with telemetry on, as the reference's kick count does.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from .. import obs
from ..ops.spgemm import dense_support_nnz, sparsify_windowed
from ..parallel.mesh3d import (
    Grid3D,
    SpParMat3D,
    apply3d,
    dim_apply3d_cols,
    kselect3d,
    mem_efficient_spgemm3d,
    nnz_per_column3d,
    prune3d,
    prune_column3d,
    reduce3d_cols,
    resplit3d,
    resplit3d_fixed,
    summa3d_spgemm,
    summa3d_stage_flops,
)
from ..parallel.spgemm import (
    _mxu_dot,
    host_value,
    mem_efficient_spgemm,
    summa_spgemm_scan,
    summa_stage_flops,
)
from ..parallel.spmat import SpParMat
from ..parallel.vec import DistVec
from ..semiring import MAX_MIN, PLUS_TIMES
from .cc import connected_components

def _square(v):
    return v * v


def _stochastic_scale(v, s):
    return torch.where(s != 0, v / torch.where(s != 0, s, 1), v)


def _keep_ge(v, t):
    return v >= t


@lru_cache(maxsize=None)
def _lt_pred(threshold: float):
    def pred(v):
        return v < threshold

    return pred


@lru_cache(maxsize=None)
def _pow_fn(power: float):
    def f(v):
        return v**power

    return f


def make_col_stochastic(A: SpParMat) -> SpParMat:
    """Scale each column to sum 1 (empty columns unchanged). Reference:
    ``MakeColStochastic`` (MCL.cpp:390)."""
    sums = A.reduce(PLUS_TIMES, "rows")
    return A.dim_apply(sums, _stochastic_scale, "cols")


def chaos(A: SpParMat) -> torch.Tensor:
    """max over columns of nnz_j · (column max − column sum of squares), a
    0-dim tensor: zero exactly when every column is idempotent. Assumes A
    is column-stochastic. Reference: ``Chaos`` (MCL.cpp:408-422)."""
    colmax = A.reduce(MAX_MIN, "rows")
    colssq = A.reduce(PLUS_TIMES, "rows", map_fn=_square)
    nnzc = A.nnz_per_column()
    diff = colmax.ewise(colssq, lambda m, s: m - s)
    # empty and padding columns: colmax is -inf, their term is 0
    scaled = diff.ewise(nnzc, lambda d, c: torch.where(c > 0, d * c.to(d.dtype), 0))
    return scaled.reduce(MAX_MIN)


def inflate(A: SpParMat, power: float) -> SpParMat:
    """Hadamard power + column re-normalization. Reference: ``Inflate``
    (MCL.cpp:447)."""
    return make_col_stochastic(A.apply(_pow_fn(power)))


def mcl_prune_recovery_select(
    C: SpParMat,
    hard_threshold: float = 1e-8,
    select_num: int = 1100,
    recover_num: int = 1400,
    recover_pct: float = 0.9,
    device_gate: bool = False,
) -> SpParMat:
    """The MCL column sparsifier (``MCLPruneRecoverySelect``,
    ParFriends.h:186-350): drop values below ``hard_threshold``, keep each
    column's top ``select_num`` (ties at the threshold kept), and relax a
    column that lost more than ``1 - recover_pct`` of its mass to its top
    ``recover_num``. ``device_gate=False`` reads back whether any column
    needs recovery and skips the second ``kselect`` when none does;
    ``device_gate=True`` always computes it and blends with ``where``."""
    if hard_threshold > 0:
        C = C.prune(_lt_pred(float(hard_threshold)))
    s_th = C.kselect(select_num)
    pruned = C.prune_column(s_th, keep=_keep_ge)
    kept = pruned.reduce(PLUS_TIMES, "rows")
    orig = C.reduce(PLUS_TIMES, "rows")
    need_recover = kept.ewise(orig, lambda k, o: k < recover_pct * o)
    if not device_gate and not bool(need_recover.blocks.any()):
        return pruned
    r_th = C.kselect(recover_num)
    relaxed = r_th.ewise(s_th, torch.minimum)
    final = dataclasses.replace(
        s_th, blocks=torch.where(need_recover.blocks, relaxed.blocks, s_th.blocks))
    return C.prune_column(final, keep=_keep_ge)


def mcl(
    A: SpParMat,
    inflation: float = 2.0,
    *,
    eps: float = 1e-3,
    max_iters: int = 40,
    phases: int = 1,
    select_num: int = 1100,
    recover_num: int = 1400,
    recover_pct: float = 0.9,
    hard_threshold: float = 1e-4,
    add_self_loops: bool = True,
    layers: int = 1,
    grid3=None,
    scan: bool = False,
    chaos_every: int = 1,
    expansion: str = "sparse",
    dense_mode: str = "bf16x3",
    perturb_delta: float = 0.0,
) -> tuple[DistVec, int, float]:
    """Markov clustering: ``(labels, iterations, final chaos)``. Labels are
    a row-aligned int32 DistVec giving each vertex the least vertex id of
    its cluster. Defaults are HipMCL's ``InitParam`` (MCL.cpp:144-150)
    but ``eps`` (1e-3: float32's noise floor, as in the reference).

    ``phases``: the expansion's column phases (``mem_efficient_spgemm``);
    ``scan``: the output-bounded scan expansion; ``chaos_every=K > 1``: the
    block loop (needs ``phases == 1``); ``expansion="dense"``: the dense
    loop on a 1x1 grid, ``dense_mode`` its product precision,
    ``perturb_delta > 0`` its plateau kicks. ``layers > 1``: the 3D loop on
    ``grid3``, by default ``Grid3D.make(layers, p, p)`` on A's device where
    layers · p² is A's tile count (raises otherwise); ``grid3`` is read only
    then, as in the reference. ``mcl.last_run`` records the loop and the
    chaos of each iteration or sync (and the dense loop's kicks, the block
    loops' rerolls and capacities)."""
    if add_self_loops:
        A = A.add_loops(1)
    A = make_col_stochastic(A)
    prune_kwargs = dict(hard_threshold=hard_threshold, select_num=select_num,
                        recover_num=recover_num, recover_pct=recover_pct)

    if expansion == "dense":
        if layers != 1 or A.grid.size != 1:
            raise ValueError("expansion='dense' runs on a 1x1 grid")
        A, it, ch = _mcl_dense_loop(A, inflation, eps, max_iters, prune_kwargs,
                                    mode=dense_mode, perturb_delta=perturb_delta)
    elif layers > 1:
        if grid3 is None:
            p3 = math.isqrt(A.grid.size // layers)
            if layers * p3 * p3 != A.grid.size:
                raise ValueError(f"cannot factor {A.grid.size} devices into {layers} layers x "
                                 "square grid; pass grid3= explicitly")
            grid3 = Grid3D.make(layers, p3, p3, device=A.grid.device)
        A, it, ch = _mcl3d_loop(A, grid3, inflation, eps, max_iters, phases, prune_kwargs,
                                chaos_every=chaos_every)
    elif chaos_every > 1:
        if phases != 1:
            raise ValueError("chaos_every > 1 requires phases=1 (scan bounds memory)")
        A, it, ch = _mcl2d_block_loop(A, inflation, eps, max_iters, chaos_every, prune_kwargs)
        if hard_threshold > 0:
            A = A.prune(_lt_pred(float(hard_threshold)))
    else:

        def prune_fn(C):
            return mcl_prune_recovery_select(C, hard_threshold, select_num, recover_num,
                                             recover_pct)

        ch = float("inf")
        it = 0
        history = []
        for it in range(1, max_iters + 1):
            with obs.span("mcl.round", round=it):
                A = mem_efficient_spgemm(PLUS_TIMES, A, A, phases, prune_fn=prune_fn,
                                         scan=scan)
                A = make_col_stochastic(A)
                ch = float(chaos(A))
                history.append(ch)
                A = inflate(A, inflation)
                obs.span_event("chaos", round=it, chaos=ch)
            if ch < eps:
                break
        mcl.last_run = {"loop": "sparse", "chaos": history}
        if hard_threshold > 0:  # drop float32 residue before interpretation
            A = A.prune(_lt_pred(float(hard_threshold)))
    sym = A.ewise_add(A.transpose(), PLUS_TIMES)
    labels, _ = connected_components(sym)
    return labels, it, ch


# the last call's loop, chaos trajectory and kicks (dense), rerolls (block)
mcl.last_run = None


# --- the block loop: K iterations a sync ----------------------------------------


def _mcl_block_caps(A: SpParMat) -> tuple[int, int]:
    """Frozen block capacities from one symbolic pass at the sync point:
    2x headroom over the current iteration's needs, powers of two."""
    per_stage = host_value(summa_stage_flops(A, A)).astype(np.float64)
    rnd = lambda x: 1 << max(int(x) - 1, 1).bit_length()  # noqa: E731
    dense_tile = A.local_rows * A.local_cols
    fcap = rnd(per_stage.max() * 2)
    ocap = min(rnd(per_stage.sum(axis=0).max() * 2), max(dense_tile, 1))
    return fcap, ocap


def _mcl2d_iter_device(A: SpParMat, caps, inflation: float, prune_kwargs):
    """One MCL iteration at frozen capacities: ``(A_next, chaos, overflow)``,
    the last two 0-dim tensors; ``overflow > 0`` means a capacity was
    exceeded (expansion slots or distinct output keys) and the iteration's
    result cannot be trusted."""
    fcap, ocap = caps
    flop_need = summa_stage_flops(A, A).max()
    C, ov_out = summa_spgemm_scan(PLUS_TIMES, A, A, flop_capacity=fcap, out_capacity=ocap)
    C = mcl_prune_recovery_select(C, device_gate=True, **prune_kwargs)
    C = make_col_stochastic(C)
    ch = chaos(C)
    A_next = inflate(C, inflation)
    overflow = torch.maximum(ov_out.long(), (flop_need > fcap).long() * (1 << 30))
    return A_next, ch, overflow


def _mcl2d_block_loop(A: SpParMat, inflation: float, eps: float, max_iters: int, K: int,
                      prune_kwargs):
    """Host loop over K-iteration blocks: one sync a block, and a block
    that overflowed reruns from its saved entry state with doubled
    capacities, so results are exact."""
    ch = float("inf")
    it = 0
    caps = None
    history, rerolls = [], 0
    while it < max_iters:
        if caps is None:
            caps = _mcl_block_caps(A)
        k = min(K, max_iters - it)
        A_entry = A
        worst = torch.zeros((), dtype=torch.long, device=A.grid.device)
        for _ in range(k):
            A, ch_dev, ov = _mcl2d_iter_device(A, caps, inflation, prune_kwargs)
            worst = torch.maximum(worst, ov)
        if int(worst) > 0:  # the sync point
            rerolls += 1
            if obs.ENABLED:
                obs.count("mcl.block_rerolls")
            dense_tile = max(A_entry.local_rows * A_entry.local_cols, 1)
            caps = (caps[0] * 2, min(caps[1] * 2, dense_tile))
            A = A_entry
            continue
        ch = float(ch_dev)
        history.append(ch)
        it += k
        obs.span_event("mcl.block_sync", iters_done=it, chaos=ch)
        if ch < eps:
            break
    mcl.last_run = {"loop": "block", "chaos_at_sync": history, "rerolls": rerolls,
                    "capacities": caps}
    return A, it, ch


# --- the 3D loop (layers > 1) -------------------------------------------------------


def make_col_stochastic3d(A3: SpParMat3D) -> SpParMat3D:
    """``make_col_stochastic`` on a col-split 3D matrix."""
    return dim_apply3d_cols(A3, reduce3d_cols(PLUS_TIMES, A3), _stochastic_scale)


def chaos3d(A3: SpParMat3D) -> torch.Tensor:
    """``chaos`` of a col-split 3D matrix (a 0-dim tensor)."""
    colmax = reduce3d_cols(MAX_MIN, A3)
    colssq = reduce3d_cols(PLUS_TIMES, A3, map_fn=_square)
    nnzc = nnz_per_column3d(A3)
    diff = colmax - colssq
    return torch.where(nnzc > 0, diff * nnzc.to(diff.dtype), 0).max()


def inflate3d(A3: SpParMat3D, power: float) -> SpParMat3D:
    """``inflate`` of a col-split 3D matrix."""
    return make_col_stochastic3d(apply3d(A3, _pow_fn(power)))


def mcl_prune_recovery_select3d(C3: SpParMat3D, hard_threshold: float = 1e-8,
                                select_num: int = 1100, recover_num: int = 1400,
                                recover_pct: float = 0.9,
                                device_gate: bool = False) -> SpParMat3D:
    """``mcl_prune_recovery_select`` on a col-split 3D matrix (the
    ``MemEfficientSpGEMM3D`` prune hook)."""
    if hard_threshold > 0:
        C3 = prune3d(C3, _lt_pred(float(hard_threshold)))
    s_th = kselect3d(C3, select_num)
    pruned = prune_column3d(C3, s_th, keep=_keep_ge)
    kept = reduce3d_cols(PLUS_TIMES, pruned)
    orig = reduce3d_cols(PLUS_TIMES, C3)
    need_recover = kept < recover_pct * orig
    if not device_gate and not bool(need_recover.any()):
        return pruned
    r_th = kselect3d(C3, recover_num)
    final = torch.where(need_recover, torch.minimum(r_th, s_th), s_th)
    return prune_column3d(C3, final, keep=_keep_ge)


def _mcl3d_block_caps(A3: SpParMat3D, B3: SpParMat3D):
    """Frozen 3D block capacities from one symbolic pass at the sync point,
    2x headroom, powers of two: (flop, out, piece) for ``summa3d_spgemm``
    and (stage, tile) for the resplit."""
    g3 = A3.grid
    L = g3.layers
    per_stage = host_value(summa3d_stage_flops(A3, B3)).astype(np.float64)
    rnd = lambda x: 1 << max(int(x) - 1, 1).bit_length()  # noqa: E731
    total = per_stage.sum(axis=0)
    dense_tile = A3.tile_rows * max(B3.ncols // max(g3.pc * L, 1), 1)
    fcap = rnd(per_stage.max() * 2)
    pcap = rnd(total.max() * 2)
    ocap = max(min(rnd(total.max() * L * 2), dense_tile), 1)
    nnz_tot = float(host_value(A3.nnz.sum()))
    per_dest = max(-(-A3.capacity // f) for f in (g3.pc, g3.pr, L))
    stage_cap = rnd(per_dest * 2)
    tile_cap = rnd(max(nnz_tot / g3.size * 4, 4))
    return fcap, ocap, pcap, stage_cap, tile_cap


def _mcl3d_iter_device(A3: SpParMat3D, caps, inflation: float, prune_kwargs):
    """One 3D iteration at frozen capacities: ``(A3_next, chaos,
    overflow)``, the last two 0-dim tensors. Overflow bits: 1 the resplit
    dropped tuples, 2 the expansion or a fiber piece overflowed, 4 an
    output tile is full."""
    fcap, ocap, pcap, stage_cap, tile_cap = caps
    B3, dropped = resplit3d_fixed(A3, "row", stage_capacity=stage_cap, tile_capacity=tile_cap)
    flop_need = summa3d_stage_flops(A3, B3).max()
    C3, ov3 = summa3d_spgemm(PLUS_TIMES, A3, B3, flop_capacity=fcap, out_capacity=ocap,
                             piece_capacity=pcap)
    ov_out = (C3.nnz >= ocap).any().int()
    ov_piece = (ov3[0] > 0).int()
    C3 = mcl_prune_recovery_select3d(C3, device_gate=True, **prune_kwargs)
    C3 = make_col_stochastic3d(C3)
    ch = chaos3d(C3)
    overflow = ((dropped > 0).int() + torch.maximum((flop_need > fcap).int(), ov_piece) * 2
                + ov_out * 4)
    return inflate3d(C3, inflation), ch, overflow


def _mcl3d_block_loop(A3: SpParMat3D, inflation: float, eps: float, max_iters: int, K: int,
                      prune_kwargs):
    """The 3D twin of ``_mcl2d_block_loop``: one sync a K-iteration block,
    and a block that overflowed reruns from its entry state with only the
    overflowed group of capacities doubled (the out capacity clamped at
    the dense tile, where a full tile is no overflow)."""
    ch = float("inf")
    it = 0
    caps = dense_tile = None
    history, rerolls = [], 0
    while it < max_iters:
        if caps is None:
            B3_probe = resplit3d(A3, "row")
            caps = _mcl3d_block_caps(A3, B3_probe)
            g3 = A3.grid
            dense_tile = A3.tile_rows * max(B3_probe.ncols // max(g3.pc * g3.layers, 1), 1)
        k = min(K, max_iters - it)
        A_entry = A3
        worst = torch.zeros((), dtype=torch.int32, device=A3.grid.device)
        for _ in range(k):
            A3, ch_dev, ov = _mcl3d_iter_device(A3, caps, inflation, prune_kwargs)
            worst = torch.bitwise_or(worst, ov)
        bits = int(worst)
        if (bits & 4) and caps[1] >= dense_tile:
            bits &= ~4
        if bits > 0:
            rerolls += 1
            if obs.ENABLED:
                # same unlabeled series as the 2D loop
                obs.count("mcl.block_rerolls")
            fcap, ocap, pcap, stage_cap, tile_cap = caps
            if bits & 1:
                stage_cap, tile_cap = stage_cap * 2, tile_cap * 2
            if bits & 2:
                fcap, pcap = fcap * 2, pcap * 2
            if bits & 4:
                ocap = min(ocap * 2, max(dense_tile, 1))
                pcap = pcap * 2
            caps = (fcap, ocap, pcap, stage_cap, tile_cap)
            A3 = A_entry
            continue
        ch = float(ch_dev)
        history.append(ch)
        it += k
        if ch < eps:
            break
    mcl.last_run = {"loop": "3d_block", "chaos_at_sync": history, "rerolls": rerolls,
                    "capacities": caps}
    return A3, it, ch


def _mcl3d_loop(A: SpParMat, grid3: Grid3D, inflation: float, eps: float, max_iters: int,
                phases: int, prune_kwargs, chaos_every: int = 1):
    """The 3D expansion loop: ``(converged matrix on A's grid, iterations,
    chaos)``."""
    A3 = SpParMat3D.from_spmat(A, grid3, split="col")
    ht = prune_kwargs.get("hard_threshold", 0)
    if chaos_every > 1:
        if phases != 1:
            raise ValueError("chaos_every > 1 requires phases=1")
        A3, it, ch = _mcl3d_block_loop(A3, inflation, eps, max_iters, chaos_every,
                                       prune_kwargs)
    else:

        def prune_fn(C3):
            return mcl_prune_recovery_select3d(C3, **prune_kwargs)

        ch = float("inf")
        it = 0
        history = []
        for it in range(1, max_iters + 1):
            B3 = resplit3d(A3, "row").shrink_to_fit()
            C3 = mem_efficient_spgemm3d(PLUS_TIMES, A3, B3, phases, prune_fn=prune_fn)
            C3 = make_col_stochastic3d(C3)
            ch = float(chaos3d(C3))
            history.append(ch)
            A3 = inflate3d(C3, inflation).shrink_to_fit()
            if ch < eps:
                break
        mcl.last_run = {"loop": "3d", "chaos": history}
    if ht > 0:  # float32 residue, as in the 2D loops
        A3 = prune3d(A3, _lt_pred(float(ht)))
    return A3.to_spmat(A.grid), it, ch


# --- the dense loop ---------------------------------------------------------------


def _perturb_field(npad: int, device) -> torch.Tensor:
    """The deterministic jitter field ``(i * -1640531527 + j * 40503) &
    0xFFFF`` over ``[npad, npad]`` in int32 arithmetic (wrapping, as the
    reference's int32 does)."""
    i = torch.arange(npad, dtype=torch.int32, device=device)[:, None]
    j = torch.arange(npad, dtype=torch.int32, device=device)[None, :]
    return (i * -1640531527 + j * 40503) & 0xFFFF


def dense_mcl_program(n: int, npad: int, inflation: float, eps: float, max_iters: int, *,
                      hard: float, select: int, recover: int, rpct: float, mode: str,
                      perturb_delta: float = 0.0):
    """The whole dense clustering: returns ``run(rows, cols, vals) ->
    (M_final, iters, chaos, chaos_history[max_iters], kicks)``, where the
    state M is Aᵀ, so that MCL's column operations are row operations. One
    readback an iteration.

    Plateau kicks (``perturb_delta > 0``): when the chaos comes back within
    1e-3 (relative) of its value two iterations ago while still at or
    above ``eps``, the state is multiplied by ``1 + perturb_delta *
    hash(i, j) / 2^16``, given ``alpha = min(perturb_delta * 4^min(k, 8),
    0.8)`` more loop mass (k: kicks so far) and re-normalised; the chaos
    history then restarts. Reference: ``dense_mcl_program``'s doc."""
    kr = max(select, recover)

    def one_iter(m):
        c = _mxu_dot(m, m, mode, torch.float32)  # (A²)ᵀ
        if hard > 0:
            c = torch.where(c < hard, 0.0, c)  # values are >= 0 (stochastic)
        topv = torch.topk(c, kr, dim=1).values
        s_th = topv[:, select - 1]
        kept = topv[:, :select].sum(dim=1)
        orig = c.sum(dim=1)
        r_th = topv[:, recover - 1]
        th = torch.where(kept < rpct * orig, torch.minimum(r_th, s_th), s_th)
        # rows with fewer than select/recover entries see th == 0 and keep
        # every entry; ties at the threshold are kept (kselect's rule)
        c = torch.where(c >= th[:, None], c, 0.0)
        rs = c.sum(dim=1, keepdim=True)
        c = c / torch.where(rs > 0, rs, 1.0)
        cmax = c.amax(dim=1)
        cssq = (c * c).sum(dim=1)
        nnzr = (c > 0).sum(dim=1, dtype=torch.int32)
        ch = torch.where(nnzr > 0, (cmax - cssq) * nnzr, 0.0).max()
        c = c**inflation
        rs = c.sum(dim=1, keepdim=True)
        return c / torch.where(rs > 0, rs, 1.0), ch

    def perturb(m, kicks: int):
        # alpha in float32: perturb_delta times a power of two, capped at 0.8
        alpha = float(np.minimum(np.float32(perturb_delta) * np.float32(4.0 ** min(kicks, 8)),
                                 np.float32(0.8)))
        h = _perturb_field(m.shape[0], m.device)
        m = m * (1.0 + perturb_delta * h.to(torch.float32) / 65536.0)
        m = m + torch.tensor(alpha, dtype=torch.float32) * torch.eye(
            m.shape[0], dtype=torch.float32, device=m.device)
        rs = m.sum(dim=1, keepdim=True)
        return m / torch.where(rs > 0, rs, 1.0)

    def run(rows, cols, vals):
        dev = vals.device
        eps32 = torch.tensor(eps, dtype=torch.float32, device=dev)
        valid = rows < n
        m = torch.zeros((npad, npad), dtype=torch.float32, device=dev)
        # transpose on the way in: M[j, i] = A[i, j]; padding slots are cut
        # before the store (the reference drops them in its scatter)
        m[cols[valid].long(), rows[valid].long()] = vals[valid].to(torch.float32)
        hist = torch.zeros((max_iters,), dtype=torch.float32, device=dev)
        inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
        ch, ch1, ch2 = inf, inf, inf
        it, kicks = 0, 0
        go = max_iters > 0
        while go:
            m, ch = one_iter(m)
            hist[it] = ch
            stuck = torch.zeros((), dtype=torch.bool, device=dev)
            if perturb_delta > 0:
                stuck = ((ch >= eps32) & torch.isfinite(ch2)
                         & ((ch - ch2).abs() < 1e-3 * torch.clamp(ch, min=1e-30)))
            it += 1
            # the iteration's one readback: the kick flag and the loop test
            flags = torch.stack([stuck, ch >= eps32]).cpu()
            if bool(flags[0]):
                m = perturb(m, kicks)
                kicks += 1
                # the next two chaos values reflect the transient, not the
                # attractor
                ch1, ch2 = inf, inf
            else:
                ch1, ch2 = ch, ch1
            go = bool(flags[1]) and it < max_iters
        if hard > 0:
            m = torch.where(m < hard, 0.0, m)
        return m, it, ch, hist, kicks

    return run


def _mcl_dense_loop(A: SpParMat, inflation: float, eps: float, max_iters: int, prune_kwargs,
                    mode: str = "bf16x3", perturb_delta: float = 0.0):
    """One-tile MCL with a dense state (``dense_mcl_program``), then the
    exact extraction: ``dense_support_nnz`` sizes ``sparsify_windowed``,
    and the tuples are transposed back from Aᵀ to A."""
    if A.grid.size != 1 or A.nrows != A.ncols:
        raise ValueError("the dense MCL loop needs a square matrix on a 1x1 grid")
    n = A.nrows
    npad = -(-n // 128) * 128
    hard = float(prune_kwargs.get("hard_threshold", 1e-4))
    select = min(int(prune_kwargs["select_num"]), n)
    recover = min(int(prune_kwargs["recover_num"]), n)
    rpct = float(prune_kwargs["recover_pct"])
    run = dense_mcl_program(n, npad, inflation, eps, max_iters, hard=hard, select=select,
                            recover=recover, rpct=rpct, mode=mode, perturb_delta=perturb_delta)
    t0 = A.local_tile(0, 0)
    with obs.span("mcl.dense", n=int(n), mode=mode):
        m, it, ch, hist, kicks = run(t0.rows, t0.cols, t0.vals)
        if obs.ENABLED:
            obs.count("mcl.perturb_kicks", int(kicks))
            obs.span_event("mcl.converged", iters=int(it), chaos=float(ch),
                           perturb_kicks=int(kicks))
    nnz_exact = int(dense_support_nnz(m, 0.0, n, n))
    cap = 1 << max(nnz_exact, 1024).bit_length()
    t, total = sparsify_windowed(m, 0.0, n, n, cap)
    if int(total) != nnz_exact or nnz_exact > cap:
        raise AssertionError(f"dense MCL extraction: {int(total)} of {nnz_exact} in {cap}")
    t = t.transpose()  # back from Aᵀ to A
    out = SpParMat(rows=t.rows[None, None], cols=t.cols[None, None], vals=t.vals[None, None],
                   nnz=t.nnz.reshape(1, 1), nrows=n, ncols=n, grid=A.grid)
    mcl.last_run = {"loop": "dense", "chaos": hist[:it].cpu().tolist(), "kicks": kicks}
    return out, it, float(ch)
