#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``combblas_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one JSON line):
  1. card: name and power limit (``nvidia-smi``), float32 matmul settings;
  2. build: compiles every CUDA source of the port with ``nvcc``, one
     process per source, all started together; per K1 kind, the FFMA /
     FADD / FMNMX / LDS counts of the kernel's main loop from
     ``cuobjdump -sass`` of the built library;
  3. kernels: the semiring GEMM (K1) against its plain PyTorch version, all
     four semiring kinds, at a small, a ragged and the main path's full
     shape, and on either side of its 128 x 128 x 16 tiles so that both
     instantiations (tiled, edge) run; per kind a case with NaN, -0.0,
     +0.0, +inf and -inf cells (NaN cells compared by position, the rest
     by their bits); plus_times exact on integers of 12 significant bits
     times {-1, 0, 1}, which a product at TF32 or bf16 precision would
     round; and plus_times on uniform [-1, 1] data at 4096^3 against a
     float64 product, within K * 2^-24 * sum|a||b| per cell, both
     instantiations bit-equal;
  4. compaction: both instantiations of the dense -> sparse compaction
     kernel (K2: single, two_pass) against its plain version, whole arrays,
     at a small, a ragged and a multi-panel shape, on a case where the
     greedy placement drops a panel, over a density sweep at 8192 x 8192,
     with 8-row panels, with one panel of 2^15 rows and at 16384 x 16384;
     at each timed case the two in turns (single, two_pass, two_pass,
     single), each with its bound, share of it and achieved GB/s;
  5. main path: ``spgemm_auto`` through the mxu tier on an R-MAT scale-13
     graph (n = 8192, edgefactor 16) for MIN_PLUS, MAX_MIN and PLUS_TIMES,
     each result held exactly against the dense product recomputed with
     the plain version, then timed;
  6. K2 path: the mxu tier's dense accumulator for the same products
     (densify, stage product, fold), sized with ``dense_support_nnz`` and
     extracted with ``dense_to_sptuples``; the live entries held exactly
     against ``sparsify_windowed``, ``sparsify`` and the main path's
     result, then the extraction layers timed (K2's instantiations in
     turns), and for MIN_PLUS the device time of each operator and kernel
     of ``dense_support_nnz`` and ``dense_to_sptuples`` (``torch.profiler``);
  7. times: K1 per kind at the main path's shape, beside its bound, its
     instruction-issue floor (``floor_ms``, at the SM clock ``nvidia-smi``
     reads at the end of the timed loop), its plain version and
     (plus_times) one ``torch.matmul``;
  8. BFS path: the Graph500 batched BFS at scale 20, edgefactor 16, 256
     roots on a 1 x 1 grid. The host builds the graph and its search
     structures (``build_graph``, ``build_structures``); after the upload
     ``bfs_batch_compact`` + ``batch_traversed_edges`` run dense-only and
     direction-optimised (CSC budgets n/8 columns and max(nnz/16, 2^20)
     edges), a warm-up then timed calls (CUDA events and host clock
     around the whole call, the edge counts' readback inside). Both modes
     must agree on levels, parents and edge counts; ``validate_bfs_device``
     on 4 lanes must report no violation, every root must reach an edge,
     and a numpy BFS on the host from the same 4 roots must give the same
     levels and max-id parents. Then, level by level, the dense and (where
     the budgets hold) the sparse step timed on the same frontier, the
     parents pass, each beside its bytes bound, and a sweep of the row
     slicing's byte envelopes with peak memory. This path is PyTorch ops
     only (the reference runs it in XLA ops, outside any Pallas kernel):
     it launches no hand kernel, and the phase checks that. On the same
     graph and structures, last: ``bfs_single`` with ``DEFAULT_SEQ_TIERS``
     (the CSC arrays serve as the CSR companion, shown equal to the graph's
     CSR arrays on this 1 x 1 grid), a warm-up root then the first 16 roots
     one after another, each timed on the host clock around the search, the
     edge count and its readback, with the step of each level, per-root
     MTEPS and their harmonic mean; each root's parents, levels and edge
     count must equal its lane of the dense batched search, two roots must
     give the same with tiers "" (always dense), and the roots must take at
     least one top-down and one bottom-up step. Then the first root's levels
     driven by hand, each level's step and the dense sweep timed (CUDA
     events) beside their bytes bounds; ``bfs_batch`` on the first 16 roots
     (equal to those lanes; its SpMV ``dist_spmv_ell_masked_multi`` timed
     a launch); ``sssp_batch`` on unit float32 weights (distances equal to
     those lanes' levels, rounds the depth + 1; ``dist_spmv_ell_multi``
     timed a launch). The elapsed time is printed before these steps.
  9. SpParMat path, on the same graph and the batch's results: the graph
     as a COO ``SpParMat`` (host bucketing and upload timed), ``bfs``,
     ``bfs_diropt`` (the budgets of phase 8) and ``bfs_diropt_auto`` from
     the first root, each equal to lane 0 of the batch (parents, levels,
     edge count), with at least one top-down and one bottom-up level;
     ``sssp`` on unit float32 weights (distances equal to the levels,
     rounds to bfs's levels); FastSV and LACC equal to each other and to
     each scipy component's least vertex; ``pagerank`` within 1e-4 (L1) of
     a float64 power iteration of as many rounds, ``pagerank_batch`` on the
     column-normalised ELL (16 roots, two lanes held the same way); ``mis``
     independent and maximal over the edge list; each timed a call on the
     host clock (3 calls after a warm-up). Then ``dist_spmv`` per semiring
     and ``dist_spmspv_masked`` at a top-down level, timed a launch (CUDA
     events) beside their bytes bounds, with ``torch.profiler``'s operator
     breakdown; K1 and K2 must not launch in these steps.
Each path runs with every launch count set to 0 just before it and read
just after. Then the ``kernels`` line and, last,
``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; without a CUDA card it exits 1
before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from combblas_tpu_torch import (
    DEFAULT_SEQ_TIERS,
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    DistMultiVec,
    DistVec,
    EllParMat,
    Grid,
    SpParMat,
    batch_traversed_edges,
    bfs,
    bfs_batch,
    bfs_batch_compact,
    bfs_diropt,
    bfs_diropt_auto,
    bfs_single,
    build_graph,
    build_structures,
    choose_spgemm_tier,
    connected_components,
    csc_tiles,
    dense_support_nnz,
    dense_to_sptuples,
    dist_spmspv_masked,
    dist_spmv,
    dist_spmv_ell_masked_multi,
    dist_spmv_ell_multi,
    expand_ranges,
    flat_to_tuples_arrays,
    flat_to_tuples_arrays_reference,
    lacc,
    mis,
    num_components,
    ones_f32,
    pagerank,
    pagerank_batch,
    parse_tier_spec,
    rmat_symmetric_coo_host,
    semiring_matmul,
    semiring_matmul_reference,
    single_traversed_edges,
    sparsify,
    sparsify_windowed,
    spgemm_auto,
    sssp,
    sssp_batch,
    traversed_edges,
    upload_csc_companion,
    validate_bfs_device,
)
from combblas_tpu_torch import _build
from combblas_tpu_torch.ops.dense_to_tuples import _PANEL_ROWS, _panels
from combblas_tpu_torch.ops.dense_to_tuples import VARIANTS as K2_VARIANTS
from combblas_tpu_torch.ops.semiring_matmul import KINDS, TILE, main_loop_counts
from combblas_tpu_torch.ops.spgemm import densify
from combblas_tpu_torch.models import bfs as bfs_mod
from combblas_tpu_torch.parallel import ellmat
from combblas_tpu_torch.parallel.spgemm import _PALLAS_KINDS, _mxu_dot, _pad128
from combblas_tpu_torch.parallel.spmv import spmspv_counts

SCALE, EDGEFACTOR, GRAPH_SEED, WEIGHT_SEED = 13, 16, 42, 7
FULL = 1 << SCALE  # the mxu tier's largest tile: 8192
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_SOURCE = "combblas_tpu_torch/csrc/semiring_mm.cu"
TPU_KERNEL = "combblas_tpu/ops/pallas_kernels.py:33"
K2_SOURCE = "combblas_tpu_torch/csrc/dense_to_tuples.cu"
K2_TPU_KERNEL = "combblas_tpu/ops/pallas_sparsify.py:109"
SOURCES = ["semiring_mm", "dense_to_tuples"]
IDENTITY = {"min_plus": float("inf"), "max_plus": -float("inf"),
            "max_min": -float("inf"), "plus_times": 0.0}
# K1's exact cases: a small, a ragged and the full shape, then shapes on
# either side of its tiles
K1_SHAPES = ((256, 256, 256), (1000, 777, 1234), (FULL, FULL, FULL), (128, 128, 128),
             (129, 8, 127), (1024, 777, 1024), (FULL, FULL - 1, FULL))
K1_SPECIAL_SHAPES = ((256, 256, 256), (200, 136, 72))
# plus_times' wide-integer cases (tiled, edge): k <= 4096 keeps every sum
# of |a| <= 4095 times {-1, 0, 1} below 2^24, so any order is exact
K1_WIDE_INT_SHAPES = ((4096, 4096, 4096), (1000, 4095, 1234))
# cell values of the special cases and their odds (NaN rare enough that
# most outputs stay finite)
SPECIALS = (float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1.0, -1.0, 2.5, 3.0)
SPECIAL_ODDS = (0.002, 0.15, 0.15, 0.01, 0.01, 0.17, 0.17, 0.17, 0.168)
LANES_PER_SM_CLOCK = 4 * 32  # four schedulers, one 32-lane warp instruction each
# the BFS path: the defaults of the reference's benchmark script
BFS_SCALE, BFS_EDGEFACTOR, BFS_NROOTS = 20, 16, 256
BFS_CHECK_LANES = 4  # lanes validated on the device and against the host BFS
BFS_REPS = 3
SEQ_ROOTS = 16  # sequential roots, as the reference's benchmark script times them
SEQ_DENSE_ROOTS = 2  # of those, also searched with tiers "" (always dense)
# the SpParMat path: timed calls a search, PageRank's bound of its L1
# distance to float64, the personalised lanes held against float64
SPMAT_REPS = 3
PAGERANK_L1_BOUND = 1e-4
PAGERANK_W = 16
PAGERANK_CHECK_LANES = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_with_clock(fn, reps: int, tail_ms: float = 1500.0) -> tuple[float, dict]:
    """``time_cuda_ms`` of ``fn``, and the SM clock, power draw and
    temperature ``nvidia-smi`` reads at the end of the timed loop, while
    about ``tail_ms`` more of the same calls (not timed) keep the card
    busy."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()  # warm-up, and the length of one call
    end.record()
    end.synchronize()
    tail = max(1, math.ceil(tail_ms / max(start.elapsed_time(end), 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    for _ in range(tail):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    torch.cuda.synchronize()
    clock, power, temp = (float(x) for x in smi.stdout.splitlines()[0].split(","))
    return start.elapsed_time(end) / reps, {
        "sm_clock_mhz": clock, "power_draw_w": power, "temperature_c": temp}


def bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for an m×k by k×n semiring product: 2mnk operations at
    the float32 peak, or each operand read and the output written once."""
    ops_ms = 2.0 * m * n * k / PEAK_F32_OPS * 1e3
    bytes_ms = 4.0 * (m * k + k * n + m * n) / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def issue_floor_ms(m: int, k: int, n: int, insns_per_step: float, clock_mhz: float) -> float:
    """Least time to issue m·n·k semiring steps at ``insns_per_step`` warp
    instructions each (the kernel's main loop, from its machine code), one
    per scheduler a clock on every SM at ``clock_mhz``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return m * n * k * insns_per_step / (sms * LANES_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    same = (got == want) | (got.isnan() & want.isnan())
    diff = torch.where(same, 0.0, (got - want).abs())
    return float(diff.max()) if diff.numel() else 0.0


def operands(kind: str, m: int, k: int, n: int, seed: int, dev):
    """Integer-valued float32 operands from a numpy seed, a tenth of the
    cells set to the fold's identity (as the densified tiles hold it)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((m, k), (k, n)):
        x = rng.integers(-8, 9, shape).astype(np.float32)
        x[rng.random(shape) < 0.1] = IDENTITY[kind]
        out.append(torch.from_numpy(x).to(dev))
    return out


def special_operands(m: int, k: int, n: int, seed: int, dev):
    """float32 operands drawn from ``SPECIALS`` with ``SPECIAL_ODDS``."""
    rng = np.random.default_rng(seed)
    odds = np.array(SPECIAL_ODDS) / sum(SPECIAL_ODDS)
    values = np.array(SPECIALS, np.float32)
    return [torch.from_numpy(rng.choice(values, size=shape, p=odds)).to(dev)
            for shape in ((m, k), (k, n))]


def wide_int_operands(m: int, k: int, n: int, seed: int, dev):
    """A with integers in [-4095, 4095] (up to 12 significant bits, more
    than TF32's 11 or bf16's 8 keep), B in {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-4095, 4096, (m, k)).astype(np.float32)
    b = rng.integers(-1, 2, (k, n)).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def offset_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` one element into its buffer, so that its
    address is not 16-byte aligned."""
    store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = store[1:].view(x.shape)
    view.copy_(x)
    return view


def launch_k1(kind: str, a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, str]:
    """One K1 launch through its wrapper; the result and the instantiation
    that ran."""
    before = semiring_matmul.launches
    got = semiring_matmul(kind, a, b)
    torch.cuda.synchronize()
    if semiring_matmul.launches != before + 1:
        raise AssertionError(f"{kind}: the kernel did not launch")
    return got, semiring_matmul.last_variant


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision must be 'highest'")
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False,
          "float32_matmul_precision": "highest"})
    return card


def phase_build() -> dict:
    """Build every source; then K1's main-loop instruction counts per kind
    and instantiation, which ``phase_times`` turns into ``floor_ms``."""
    report = _build.build(SOURCES)
    ptxas = {name: [ln.strip() for ln in report[name]["log"].splitlines()
                    if "registers" in ln or "spill" in ln] for name in SOURCES}
    emit({"phase": "build", "seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": ptxas})
    loops = main_loop_counts()
    for kind in KINDS:
        if set(loops.get(kind, ())) != {"tiled", "edge"}:
            raise AssertionError(f"K1 {kind}: main loops not found in the machine code")
        emit({"phase": "build", "kernel": f"semiring_mm_{kind}", "tile": TILE,
              "main_loop": loops[kind]})
    return loops


def phase_kernels(dev) -> dict:
    """Each kind at ``K1_SHAPES`` with exact equality, and on special
    values; then plus_times on non-integer data. Returns per kind the
    full-shape max error and plain-version time."""
    full = {}
    for kind in KINDS:
        variants = set()
        for shape in K1_SHAPES:
            a, b = operands(kind, *shape, seed=sum(shape), dev=dev)
            got, variant = launch_k1(kind, a, b)
            variants.add(variant)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = semiring_matmul_reference(kind, a, b)
            end.record()
            end.synchronize()
            err = max_abs_err(got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"{kind} {shape}: kernel != plain (max err {err})")
            emit({"phase": "kernels", "kind": kind, "shape": shape, "variant": variant,
                  "equal": True, "max_abs_err": err})
            if shape == (FULL, FULL, FULL):
                full[kind] = {"max_abs_err": err, "plain_ms": start.elapsed_time(end)}
            del a, b, got, want
        for shape in K1_SPECIAL_SHAPES:
            a, b = special_operands(*shape, seed=sum(shape) + KINDS.index(kind), dev=dev)
            got, variant = launch_k1(kind, a, b)
            variants.add(variant)
            want = semiring_matmul_reference(kind, a, b)
            nan = want.isnan()
            if not (torch.equal(got.isnan(), nan) and torch.equal(
                    got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])):
                raise AssertionError(f"{kind} {shape} specials: kernel != plain")
            emit({"phase": "kernels", "kind": kind, "case": "specials", "shape": shape,
                  "variant": variant, "nan_cells": int(nan.sum()), "cells": nan.numel(),
                  "equal": True, "max_abs_err": max_abs_err(got, want)})
        if variants != {"tiled", "edge"}:
            raise AssertionError(f"{kind}: instantiations run {variants}")
    check_plus_times_wide_int(dev)
    check_plus_times_float(dev)
    torch.cuda.empty_cache()
    return full


def check_plus_times_wide_int(dev) -> None:
    """plus_times on ``wide_int_operands``, equal to the plain version at a
    tiled and an edge shape: rounding the inputs to TF32 or bf16 would
    change the sums."""
    for shape, expect in zip(K1_WIDE_INT_SHAPES, ("tiled", "edge")):
        a, b = wide_int_operands(*shape, seed=sum(shape), dev=dev)
        got, variant = launch_k1("plus_times", a, b)
        if variant != expect:
            raise AssertionError(f"plus_times wide integers {shape}: ran {variant}")
        want = semiring_matmul_reference("plus_times", a, b)
        if not torch.equal(got, want):
            raise AssertionError(f"plus_times wide integers {shape}: kernel != plain "
                                 f"(max err {max_abs_err(got, want)})")
        emit({"phase": "kernels", "kind": "plus_times", "case": "wide integers",
              "shape": shape, "variant": variant, "equal": True, "max_abs_err": 0.0,
              "max_abs_out": float(want.abs().max())})
        del a, b, got, want


def check_plus_times_float(dev, size: int = 4096) -> None:
    """plus_times on uniform [-1, 1] data against the float64 product:
    every cell within K · 2^-24 · Σ|a||b| (the float32 rounding of a
    K-term sum, whatever its order), and the tiled and edge instantiations
    bit-equal (both fold k in order with one FMA chain)."""
    m = k = n = size
    rng = np.random.default_rng(17)
    a, b = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)
            for shape in ((m, k), (k, n)))
    got, variant = launch_k1("plus_times", a, b)
    got_edge, variant_edge = launch_k1("plus_times", offset_copy(a), offset_copy(b))
    if (variant, variant_edge) != ("tiled", "edge"):
        raise AssertionError(f"plus_times float: instantiations {variant}, {variant_edge}")
    want = a.double() @ b.double()
    tol = k * 2.0**-24 * (a.double().abs() @ b.double().abs())
    err = (got.double() - want).abs()
    if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError("plus_times float: error above K * 2^-24 * sum|a||b|")
    if not torch.equal(got, got_edge):
        raise AssertionError("plus_times float: tiled and edge results differ")
    emit({"phase": "kernels", "kind": "plus_times", "case": "uniform[-1,1] vs float64",
          "shape": [m, k, n], "variants": [variant, variant_edge],
          "tolerance": "K * 2^-24 * sum|a||b| per cell", "within_tolerance": True,
          "max_abs_err": float(err.max()), "max_err_over_tolerance": float((err / tol).max()),
          "tiled_equals_edge": True})


def k2_bound(cells: int, slots: int) -> tuple[float, str]:
    """Least time for K2: each input cell read once (4 bytes) and each
    output slot written once (index and value, 8 bytes); it does no
    arithmetic to speak of, so bytes bound it."""
    return (4.0 * cells + 8.0 * slots) / PEAK_BYTES * 1e3, "bytes"


def random_dense(shape, density: float, seed: int, dev) -> torch.Tensor:
    """float32 cells in 1..99 with probability ``density``, else 0, from a
    seeded generator on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = torch.rand(shape, generator=g, device=dev) < density
    vals = torch.randint(1, 100, shape, generator=g, device=dev).to(torch.float32)
    return torch.where(keep, vals, 0.0)


def greedy_case(dev) -> torch.Tensor:
    """Four panels of 32 flat rows with 3000 / 100 / 3000 / 100 nonzeros:
    at capacity 64 the greedy placement writes panels 0, 1 and 3."""
    rng = np.random.default_rng(11)
    flat = np.zeros(4 * 4096, np.float32)
    for p, k in enumerate((3000, 100, 3000, 100)):
        flat[p * 4096 + rng.choice(4096, size=k, replace=False)] = rng.integers(1, 100, k)
    return torch.from_numpy(flat.reshape(128, 128)).to(dev)


def check_k2(case: str, xf: torch.Tensor, *, zero: float = 0.0, capacity: int,
             panel_rows: int = _PANEL_ROWS) -> dict:
    """Each instantiation of K2 against its plain version on one input: the
    whole idx and vals arrays (vals as bits, so that NaN compares), total
    and end_row equal."""
    kw = dict(zero=zero, capacity=capacity, panel_rows=panel_rows)
    wi, wv, wt, we = flat_to_tuples_arrays_reference(xf, **kw)
    before = flat_to_tuples_arrays.launches
    errs = []
    for variant in K2_VARIANTS:
        gi, gv, gt, ge = flat_to_tuples_arrays(xf, variant=variant, **kw)
        torch.cuda.synchronize()
        if flat_to_tuples_arrays.last_variant != variant:
            raise AssertionError(f"K2 {case}: {variant} did not launch")
        if not (int(gt) == int(wt) and int(ge) == int(we) and torch.equal(gi, wi)
                and torch.equal(gv.view(torch.int32), wv.view(torch.int32))):
            raise AssertionError(f"K2 {case} ({variant}): kernel != plain")
        errs.append(max_abs_err(gv, wv))
    if flat_to_tuples_arrays.launches != before + len(K2_VARIANTS):
        raise AssertionError(f"K2 {case}: launch count off")
    flat_to_tuples_arrays.launches = before  # checks are not a path's launches
    end = int(we) * 128
    out = {"phase": "compaction", "case": case, "shape": list(xf.shape),
           "capacity": capacity, "panel_rows": panel_rows, "total": int(wt),
           "end_row": int(we), "live": int((wi[:end] >= 0).sum()),
           "variants": list(K2_VARIANTS), "equal": True, "max_abs_err": max(errs)}
    emit(out)
    return out


def time_k2(case: str, xf: torch.Tensor, *, reps: int, zero: float = 0.0, capacity: int,
            panel_rows: int = _PANEL_ROWS) -> dict:
    """K2's instantiations timed in turns (single, two_pass, two_pass,
    single; ``reps`` calls each), one line per instantiation with its time,
    bound, share of the bound and achieved rate (the bound's bytes over the
    time). Returns ``{variant: line}`` and the default choice under
    ``"default"``."""
    kw = dict(zero=zero, capacity=capacity, panel_rows=panel_rows)
    before = flat_to_tuples_arrays.launches
    flat_to_tuples_arrays(xf, **kw)
    default = flat_to_tuples_arrays.last_variant
    turns = {v: [] for v in K2_VARIANTS}
    for variant in (*K2_VARIANTS, *K2_VARIANTS[::-1]):
        turns[variant].append(
            time_cuda_ms(lambda: flat_to_tuples_arrays(xf, variant=variant, **kw), reps))
    flat_to_tuples_arrays.launches = before  # timing launches are not a path's
    slots = _panels(xf, capacity, panel_rows)[1] * 128  # every output slot is stored once
    bound_ms, bound_by = k2_bound(xf.numel(), slots)
    out = {"default": default}
    for variant, times in turns.items():
        ms = sum(times) / len(times)
        out[variant] = {
            "phase": "compaction", "case": case, "shape": list(xf.shape),
            "panel_rows": panel_rows, "capacity": capacity, "variant": variant,
            "default": variant == default, "ms": ms, "turns_ms": times,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "gb_per_s": (4.0 * xf.numel() + 8.0 * slots) / (ms / 1e3) / 1e9}
        emit(out[variant])
    return out


def phase_compaction(dev) -> None:
    """K2's instantiations against the plain version at a small (with NaN
    and -0.0 cells), a ragged (panels of gcd(8000, 8192) = 64 rows) and a
    multi-panel shape, and on the greedy-drop case; then both timed in
    turns over a density sweep at 8192 x 8192, at 16384 x 16384 (5%), with
    8-row panels and with one panel of 2^15 rows. Each capacity is the exact
    count, except where the case says."""
    small = random_dense((64, 128), 0.3, 1, dev)
    small[0, :8] = torch.tensor([float("nan"), -0.0] * 4)
    check_k2("small", small, capacity=3000)
    check_k2("ragged", random_dense((8000, 128), 0.3, 2, dev), capacity=400_000)
    multi = random_dense((8 * 8192, 128), 0.2, 3, dev)
    check_k2("multi-panel", multi, capacity=int((multi != 0).sum()))
    check_k2("multi-panel-half-capacity", multi, capacity=int((multi != 0).sum()) // 2)
    greedy = greedy_case(dev)
    for cap in (64, 3100):
        check_k2(f"greedy-cap{cap}", greedy, capacity=cap, panel_rows=32)
    del small, multi, greedy
    for pct in (0.0, 0.1, 5.0, 20.0, 50.0, 100.0):
        x = random_dense((FULL, FULL), pct / 100, 4, dev).view(-1, 128)
        cap = int((x != 0).sum())
        check_k2(f"sweep-{FULL}-{pct}%", x, capacity=cap)
        time_k2(f"sweep-{FULL}-{pct}%", x, capacity=cap, reps=10)
        del x
    x = random_dense((FULL, FULL), 0.05, 6, dev).view(-1, 128)
    cap = int((x != 0).sum())
    for case, rows in (("pr8", 8), ("tall-panel", 1 << 15)):
        check_k2(f"{case}-{FULL}-5.0%", x, capacity=cap, panel_rows=rows)
        time_k2(f"{case}-{FULL}-5.0%", x, capacity=cap, panel_rows=rows, reps=5)
    x = random_dense((2 * FULL, 2 * FULL), 0.05, 5, dev).view(-1, 128)
    cap = int((x != 0).sum())
    check_k2(f"{2 * FULL}-5.0%", x, capacity=cap)
    time_k2(f"{2 * FULL}-5.0%", x, capacity=cap, reps=5)
    del x
    torch.cuda.empty_cache()


def dense_plain_product(sr, r, c, v, n: int, dev) -> torch.Tensor:
    """The graph's dense n×n matrix, duplicates folded with ``sr.add`` by a
    scatter on the card, squared with the plain semiring product."""
    zero = float(sr.zero_fn(torch.float32))
    flat = torch.from_numpy(r * n + c).to(dev)
    vals = torch.from_numpy(v).to(dev)
    dense = torch.full((n * n,), zero, device=dev)
    if sr.add_kind == "sum":
        dense.index_add_(0, flat, vals)
    else:
        reduce = "amin" if sr.add_kind == "min" else "amax"
        dense.scatter_reduce_(0, flat, vals, reduce=reduce, include_self=False)
    dense = dense.view(n, n)
    want = semiring_matmul_reference(_PALLAS_KINDS[sr.name], dense, dense)
    if sr.add_kind == "sum" and float(want.abs().max()) >= 2**24:
        # exactness in any summation order needs every partial sum < 2**24
        raise AssertionError("plus_times sums reach 2**24; exact comparison void")
    return want


def phase_main_path(dev) -> dict:
    """The counted run: spgemm_auto for each semiring with the launch
    count set to 0 just before and read just after; then the checks and
    the timed runs."""
    r, c = rmat_symmetric_coo_host(GRAPH_SEED, SCALE, EDGEFACTOR)
    v = np.random.default_rng(WEIGHT_SEED).integers(1, 16, r.shape[0]).astype(np.float32)
    grid = Grid.make(1, 1, device=dev)
    p = grid.pr
    semirings = (MIN_PLUS, MAX_MIN, PLUS_TIMES)

    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    runs = {}
    for sr in semirings:
        before = semiring_matmul.launches
        t0 = time.perf_counter()
        A = SpParMat.from_global_coo(grid, r, c, v, FULL, FULL, dedup_sr=sr)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tier = choose_spgemm_tier(sr, A, A)
        C = spgemm_auto(sr, A, A)
        torch.cuda.synchronize()
        runs[sr.name] = (A, C, tier, semiring_matmul.launches - before, load_s)
    launches = semiring_matmul.launches

    per_kind = {}
    for sr in semirings:
        A, C, tier, n_launch, load_s = runs[sr.name]
        if tier != "mxu":
            raise AssertionError(f"{sr.name}: routed to {tier}, not mxu")
        nnz = int(C.getnnz())
        cap0 = 1 << (max(A.capacity, 64) - 1).bit_length()
        attempts = 1 if int(C.nnz.max()) <= cap0 else 2
        if sr.name != "plus_times" and n_launch != attempts * p**3:
            raise AssertionError(
                f"{sr.name}: {n_launch} kernel launches for {attempts} attempts"
            )
        # exact check against the dense plain product
        zero = float(sr.zero_fn(torch.float32))
        want = dense_plain_product(sr, r, c, v, FULL, dev)
        wr, wc = torch.nonzero(want != zero, as_tuple=True)
        if nnz != wr.numel():
            raise AssertionError(f"{sr.name}: nnz {nnz} != plain {wr.numel()}")
        t = C.local_tile(0, 0)
        for got, exp, name in ((t.rows[:nnz], wr, "rows"), (t.cols[:nnz], wc, "cols"),
                               (t.vals[:nnz], want[wr, wc], "vals")):
            if not torch.equal(got.to(exp.dtype), exp):
                raise AssertionError(f"{sr.name}: {name} differ from the plain product")
        if not bool(torch.isfinite(t.vals[:nnz]).all()):
            raise AssertionError(f"{sr.name}: non-finite output values")
        del want, wr, wc
        torch.cuda.empty_cache()
        # timed runs (the counted run above was the warm-up)
        torch.cuda.reset_peak_memory_stats()
        reps = 3
        t0 = time.perf_counter()
        ms = time_cuda_ms(lambda: spgemm_auto(sr, A, A), reps)
        host_s = (time.perf_counter() - t0) / (reps + 1)
        per_kind[sr.name] = {
            "tier": tier, "nnz_in": int(A.getnnz()), "load_s": load_s, "nnz_out": nnz,
            "attempts": attempts, "kernel_launches": n_launch,
            "out_capacity": C.capacity, "ms": ms, "host_s_per_call": host_s,
            "nnz_out_per_s": nnz / (ms / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "layers_ms": layer_times(sr, A, C.capacity),
        }
        emit({"phase": "main_path", "semiring": sr.name, "exact": True,
              **per_kind[sr.name]})
    mats = {name: (run[0], run[1]) for name, run in runs.items()}
    return {"launches": launches, "per_kind": per_kind, "mats": mats}


def stage_product(sr, da: torch.Tensor) -> torch.Tensor:
    """The mxu tier's stage product ``da ⊗ da``: K1 for the tropical
    kinds, ``torch.matmul`` for plus_times, as ``summa_spgemm_mxu``."""
    kind = _PALLAS_KINDS[sr.name]
    if kind == "plus_times":
        return _mxu_dot(da, da, "f32", da.dtype)
    return semiring_matmul(kind, da, da)


def mxu_accumulator(sr, A: SpParMat) -> torch.Tensor:
    """The mxu tier's dense accumulator for A·A on a 1×1 grid, built as
    ``summa_spgemm_mxu`` builds it: densify, stage product, fold."""
    zero = float(sr.zero_fn(A.dtype))
    pm = _pad128(A.local_rows)
    prod = stage_product(sr, densify(A.local_tile(0, 0), pm, pm, zero))
    return sr.add(torch.full_like(prod, zero), prod)


def nonzero_gather(x: torch.Tensor, zero: float):
    """The nearest PyTorch call to K2: ``torch.nonzero`` of the mask plus
    the value gather (int64 indices, no panel layout)."""
    flat = x.view(-1)
    nz = torch.nonzero(flat != zero).squeeze(1)
    return nz, flat[nz]


def op_breakdown(fn, reps: int = 5) -> dict:
    """Device time per call of each operator and of each kernel of ``fn``,
    from a ``torch.profiler`` trace of ``reps`` calls after a warm-up
    (``key_averages``' own device time: an ``aten::`` operator's is that of
    the kernels it launched; the kernel list counts the same time again,
    by kernel, and also holds the kernels launched outside PyTorch's
    operators, such as K2's). Where the profiler reports no device time,
    each call is timed whole with CUDA events instead and the line says
    so. ``events_ms`` is each call timed whole with CUDA events, and
    ``coverage`` the share of it that the traced kernels account for: a
    trace that lost device records shows as a coverage well below 1."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops, kernels = [], []
    for e in prof.key_averages():
        own = getattr(e, "self_device_time_total", None)
        if own is None:
            own = getattr(e, "self_cuda_time_total", 0.0)
        if own <= 0 or e.key.startswith("Activity Buffer"):  # the tracer's own entries
            continue
        row = {"calls": e.count / reps, "device_ms": own / 1e3 / reps}
        if e.key.startswith("aten::"):
            ops.append({"op": e.key, **row})
        else:
            kernels.append({"kernel": e.key[:120], **row})
    if not kernels:
        return {"profiler_device_time": False, "events_ms": time_cuda_ms(fn, reps)}
    ops.sort(key=lambda r: -r["device_ms"])
    kernels.sort(key=lambda r: -r["device_ms"])
    kernels_ms = sum(k["device_ms"] for k in kernels)
    events_ms = time_cuda_ms(fn, reps)
    return {"profiler_device_time": True, "ops": ops, "kernels": kernels,
            "kernels_ms": kernels_ms, "events_ms": events_ms,
            "coverage": kernels_ms / events_ms}


def phase_k2_path(mats: dict) -> dict:
    """The counted run: for each semiring, the mxu accumulator, its exact
    support count (``dense_support_nnz``) as the capacity, and
    ``dense_to_sptuples`` (K2), with every launch count set to 0 just
    before and read just after. Then the checks: the live entries, in slot
    order, equal ``sparsify_windowed``'s and ``sparsify``'s prefixes and
    the main path's ``spgemm_auto`` result. Then the timed layers."""
    semirings = (MIN_PLUS, MAX_MIN, PLUS_TIMES)
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    runs = {}
    for sr in semirings:
        A, _ = mats[sr.name]
        zero = float(sr.zero_fn(A.dtype))
        acc = mxu_accumulator(sr, A)
        cap = int(dense_support_nnz(acc, zero, A.local_rows, A.local_cols))
        t, total = dense_to_sptuples(acc, A.local_rows, A.local_cols, zero=zero, capacity=cap)
        torch.cuda.synchronize()
        runs[sr.name] = (acc, zero, cap, t, total, flat_to_tuples_arrays.last_variant)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}

    per_kind = {}
    for sr in semirings:
        A, C = mats[sr.name]
        acc, zero, cap, t, total, variant = runs.pop(sr.name)
        n_r, n_c = A.local_rows, A.local_cols
        live = t.valid_mask()
        got = (t.rows[live], t.cols[live], t.vals[live])
        if not (int(total) == cap == got[0].numel() == int(t.nnz)):
            raise AssertionError(f"K2 path {sr.name}: total {int(total)}, nnz "
                                 f"{int(t.nnz)}, live {got[0].numel()}, capacity {cap}")
        w, w_total = sparsify_windowed(acc, zero, n_r, n_c, cap)
        s, s_total = sparsify(acc, zero, n_r, n_c, cap)
        c = C.local_tile(0, 0)
        nnz_c = int(C.getnnz())
        for other, o_total, name in ((w, w_total, "sparsify_windowed"),
                                     (s, s_total, "sparsify"), (c, C.nnz.sum(), "spgemm_auto")):
            k = min(cap, other.capacity)
            want = (other.rows[:k], other.cols[:k], other.vals[:k])
            if int(o_total) != cap or k != cap or not all(
                torch.equal(g, x) for g, x in zip(got, want)
            ):
                raise AssertionError(f"K2 path {sr.name}: entries differ from {name}")
        if not bool(torch.isfinite(got[2]).all()):
            raise AssertionError(f"K2 path {sr.name}: non-finite values")
        del w, s, got, t, live
        xf = acc.view(-1, 128)
        chk = check_k2(f"k2-path-{sr.name}", xf, zero=zero, capacity=cap)
        timed = time_k2(f"k2-path-{sr.name}", xf, zero=zero, capacity=cap, reps=20)
        k2 = timed[variant]
        rowcnt = (acc[:n_r, :n_c] != zero).sum(1, dtype=torch.int32)
        ramp = torch.arange(cap, dtype=torch.int32, device=acc.device)
        counted = flat_to_tuples_arrays.launches
        out = {
            "nnz": cap, "nnz_spgemm_auto": nnz_c, "k2_variant": variant, "k2_ms": k2["ms"],
            "k2_ms_other_variant": timed[next(v for v in K2_VARIANTS if v != variant)]["ms"],
            "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
            "max_abs_err": chk["max_abs_err"],
            "support_nnz_ms": time_cuda_ms(
                lambda: dense_support_nnz(acc, zero, n_r, n_c), 10),
            "dense_to_sptuples_ms": time_cuda_ms(
                lambda: dense_to_sptuples(acc, n_r, n_c, zero=zero, capacity=cap), 10),
            "sparsify_windowed_ms": time_cuda_ms(
                lambda: sparsify_windowed(acc, zero, n_r, n_c, cap), 5),
            "sparsify_ms": time_cuda_ms(lambda: sparsify(acc, zero, n_r, n_c, cap), 3),
            # sparsify's owner map, and one of its two cummax scans alone
            "expand_ranges_ms": time_cuda_ms(lambda: expand_ranges(rowcnt, cap), 3),
            "cummax_ms": time_cuda_ms(lambda: torch.cummax(ramp, 0), 3),
            "plain_ms": time_cuda_ms(
                lambda: flat_to_tuples_arrays_reference(xf, zero=zero, capacity=cap), 2),
            "library_ms": time_cuda_ms(lambda: nonzero_gather(acc, zero), 10),
            "library_call": "torch.nonzero(x.view(-1) != zero) + value gather "
                            "(int64 indices, no panel layout)",
        }
        if sr is MIN_PLUS:  # where the extraction step's time goes, op by op
            out["sizing_ops"] = op_breakdown(lambda: dense_support_nnz(acc, zero, n_r, n_c))
            out["dense_to_sptuples_ops"] = op_breakdown(
                lambda: dense_to_sptuples(acc, n_r, n_c, zero=zero, capacity=cap))
        flat_to_tuples_arrays.launches = counted
        per_kind[sr.name] = out
        emit({"phase": "k2_path", "semiring": sr.name, "exact": True, **out})
        del acc, xf, rowcnt, ramp
        torch.cuda.empty_cache()
    return {"launches": launches, "per_kind": per_kind}


def layer_times(sr, A: SpParMat, out_capacity: int) -> dict:
    """CUDA-event times of the mxu tier's layers at the main path's shapes
    (one tile, one stage): densify, stage product, fold, extraction."""
    zero = float(sr.zero_fn(A.dtype))
    pm = _pad128(A.local_rows)
    tile = A.local_tile(0, 0)
    da = densify(tile, pm, pm, zero)

    def product():
        return stage_product(sr, da)

    prod = product()
    acc = torch.full_like(prod, zero)
    counted = semiring_matmul.launches
    out = {
        "densify": time_cuda_ms(lambda: densify(tile, pm, pm, zero), 5),
        "stage_product": time_cuda_ms(product, 3),
        "fold": time_cuda_ms(lambda: sr.add(acc, prod), 5),
        "extract": time_cuda_ms(
            lambda: sparsify_windowed(prod, zero, A.local_rows, A.local_cols, out_capacity), 5
        ),
    }
    semiring_matmul.launches = counted  # timing launches are not the path's
    return out


def phase_times(dev, full: dict, loops: dict) -> dict:
    """The kernel per kind at the main path's shape: time, bound, issue
    floor at the clock read at the end of the timed loop, plain version
    and (plus_times) the library call."""
    m = k = n = FULL
    b_ms, b_by = bound(m, k, n)
    out = {}
    for kind in KINDS:
        a, b = operands(kind, m, k, n, seed=1, dev=dev)
        counted = semiring_matmul.launches
        ms, card = time_with_clock(lambda: semiring_matmul(kind, a, b), 5)
        variant = semiring_matmul.last_variant
        semiring_matmul.launches = counted
        lib = None
        if kind == "plus_times":
            lib = time_cuda_ms(lambda: torch.matmul(a, b), 5)
        ips = loops[kind][variant]["insns_per_step"]
        floor_ms = issue_floor_ms(m, k, n, ips, card["sm_clock_mhz"])
        out[kind] = {"ms": ms, "variant": variant, "bound_ms": b_ms, "bound_by": b_by,
                     "share_of_bound": b_ms / ms, "floor_ms": floor_ms,
                     "share_of_floor": floor_ms / ms, "insns_per_step": ips, **card,
                     "plain_ms": full[kind]["plain_ms"],
                     "library_ms": lib, "max_abs_err": full[kind]["max_abs_err"],
                     "shape": [m, k, n]}
        emit({"phase": "times", "kind": kind, **out[kind]})
        del a, b
    return out


def timed_call(fn):
    """One call of ``fn`` between two CUDA events and on the host clock,
    synchronised after it: (result, device ms, host seconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def host_bfs_levels(indptr: np.ndarray, cols: np.ndarray, root: int) -> np.ndarray:
    """Levels of a frontier-at-a-time BFS in numpy over a CSR graph (-1 =
    unreached): the check that shares no code with the device path."""
    level = np.full(len(indptr) - 1, -1, np.int32)
    level[root] = 0
    frontier = np.array([root], np.int64)
    depth = 0
    while len(frontier):
        depth += 1
        counts = indptr[frontier + 1] - indptr[frontier]
        ends = np.cumsum(counts)
        slot = np.arange(ends[-1]) - np.repeat(ends - counts, counts)
        nbr = cols[np.repeat(indptr[frontier], counts) + slot]
        frontier = np.unique(nbr[level[nbr] < 0]).astype(np.int64)
        level[frontier] = depth
    return level


def host_max_parents(rows: np.ndarray, cols: np.ndarray, indptr: np.ndarray,
                     level: np.ndarray, root: int) -> np.ndarray:
    """Per vertex the maximum-id neighbour one level up (-1 where
    unreached; the root is its own parent), from row-sorted COO."""
    up = (level[rows] > 0) & (level[cols] == level[rows] - 1)
    cand = np.where(up, cols, -1).astype(np.int64)
    deg = indptr[1:] - indptr[:-1]
    parent = np.full(len(level), -1, np.int64)
    has = deg > 0
    parent[has] = np.maximum.reduceat(cand, indptr[:-1][has])
    parent[root] = root
    return parent


def step_bounds(E: EllParMat, n: int, W: int) -> dict:
    """Bytes bounds (ms) of one dense level (M1) and of the parents pass
    (M2) at W lanes: the structure read once (int32 column ids and row
    ids), W bytes gathered per stored slot, and the state read and
    written ([n, W] int8 frontier, undiscovered mask and result for M1;
    [n, W] int8 levels twice and int32 parents for M2)."""
    slots = sum(bc.numel() for bc, _, _ in E.buckets)
    rows = sum(br.numel() for _, _, br in E.buckets)
    structure = 4 * slots + 4 * rows
    m1 = structure + slots * W + 3 * n * W
    m2 = structure + slots * W + 2 * n * W + 4 * n * W
    return {"slots": slots, "bucket_rows": rows,
            "m1_bytes": m1, "m1_bound_ms": m1 / PEAK_BYTES * 1e3,
            "m2_bytes": m2, "m2_bound_ms": m2 / PEAK_BYTES * 1e3}


def sparse_step_bound_ms(n: int, W: int, cnt: int, edges: int) -> float:
    """Bytes bound of one union-frontier level (M3) on this level's data:
    the frontier read once to find its union ([n, W]), the column
    pointers of the ``cnt`` active columns, one row id and W gathered
    bytes per walked edge, the undiscovered mask read and the result
    written ([n, W] each)."""
    return (3 * n * W + 8 * cnt + 4 * edges + edges * W) / PEAK_BYTES * 1e3


def bfs_level_breakdown(E, roots_dev, csc, fcap: int, ecap: int) -> tuple[list, dict]:
    """The search's level loop driven by hand, each level's steps timed on
    the same frontier: the dense sweep always, the sparse step where the
    union frontier fits the budgets (the step the direction-optimised
    call takes there), with its slots cut to the level's counts as the
    search calls it and at the full budgets. Returns one record per level and the final state
    (levels, and the widest frontier's operands for the envelope sweep)."""
    grid, n = E.grid, E.nrows
    W = roots_dev.numel()
    gids = torch.arange(n, dtype=torch.int32, device=grid.device)[None, :, None]
    at_root = gids == roots_dev[None, None, :]
    levels = at_root.to(torch.int8) - 1
    x = at_root.to(torch.int8)
    coldeg = csc[0][0, 0, 1:] - csc[0][0, 0, :-1]
    records, widest = [], None
    level, active = 0, True
    while active:
        undisc = (levels < 0).to(torch.int8)
        act = x.amax(dim=2) > 0
        cnt, edges = int(act.sum()), int((coldeg * act[0]).sum())
        if widest is None or edges > widest[0]:
            widest = (edges, x, undisc)
        rec = {"level": level + 1, "union_frontier": cnt, "union_edges": edges,
               "frontier_cells": int(x.sum()),
               "dense_ms": time_cuda_ms(lambda: ellmat._ell_levels_step(E, x, undisc), 2)}
        sparse_ok = cnt <= fcap and edges <= ecap
        rec["diropt_step"] = "sparse" if sparse_ok else "dense"
        if sparse_ok:  # at this level's counts, as the search calls it; at the budgets
            rec["sparse_ms"] = time_cuda_ms(
                lambda: ellmat._ell_union_sparse_step(E, *csc, x, undisc, cnt, edges), 2)
            rec["sparse_at_budgets_ms"] = time_cuda_ms(
                lambda: ellmat._ell_union_sparse_step(E, *csc, x, undisc, fcap, ecap), 2)
            rec["sparse_bound_ms"] = sparse_step_bound_ms(n, W, cnt, edges)
        reached = ellmat._ell_levels_step(E, x, undisc)
        new = reached > 0
        level += 1
        levels = levels.masked_fill(new, level)
        x = reached
        active = bool(new.any())
        rec["discovered_cells"] = int(new.sum())
        records.append(rec)
    return records, {"levels": levels, "widest": widest[1:]}


def envelope_sweep(E, state: dict) -> dict:
    """One dense level (at the widest frontier) and the parents pass under
    several byte envelopes of the row slicing: ms and peak device memory
    each. The envelopes in use are restored afterwards."""
    x, undisc = state["widest"]
    levels = state["levels"]
    out = {"levels_step": [], "parents_pass": []}
    keep = (ellmat.LEVELS_BUDGET_BYTES, ellmat.PARENTS_BUDGET_BYTES)
    try:
        for name, key, budgets, fn in (
            ("LEVELS_BUDGET_BYTES", "levels_step", (1 << 26, 1 << 28, 1 << 30, 1 << 32),
             lambda: ellmat._ell_levels_step(E, x, undisc)),
            ("PARENTS_BUDGET_BYTES", "parents_pass", (1 << 27, 1 << 29, 1 << 31, 1 << 32),
             lambda: ellmat._ell_parents_from_levels(E, levels, levels)),
        ):
            for budget in budgets:
                setattr(ellmat, name, budget)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                ms = time_cuda_ms(fn, 2)
                out[key].append({"budget_bytes": budget, "ms": ms, "in_use": budget == keep[
                    0 if key == "levels_step" else 1],
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    finally:
        ellmat.LEVELS_BUDGET_BYTES, ellmat.PARENTS_BUDGET_BYTES = keep
    return out


def single_step_bound_ms(E: EllParMat, n: int, step: str, selected: int, entries: int) -> float:
    """Bytes bound of one level of ``bfs_single``. The dense sweep: per
    stored slot its int32 column id read and the int32 candidate gathered,
    the bucket row ids read, the [n] frontier and undiscovered mask read and
    the result written. A walk: per walked entry its int32 row (or column)
    id read and one int32 candidate moved, per selected vertex its range
    start and length."""
    if step == "dense":
        slots = sum(bc.numel() for bc, _, _ in E.buckets)
        rows = sum(br.numel() for _, _, br in E.buckets)
        return (8 * slots + 4 * rows + 9 * n) / PEAK_BYTES * 1e3
    return (8 * entries + 8 * selected) / PEAK_BYTES * 1e3


def device_time(fn, reps: int = 3) -> dict:
    """Kernel launches a call of ``fn`` and their summed device ms
    (``op_breakdown``'s kernel list): beside the CUDA-event time of the
    same call, the share of it the card was busy."""
    trace = op_breakdown(fn, reps)
    if not trace["profiler_device_time"]:
        return {"kernels_ms": None, "kernel_launches": None}
    return {"kernels_ms": trace["kernels_ms"],
            "kernel_launches": sum(k["calls"] for k in trace["kernels"])}


def single_level_breakdown(E, csc, coldeg, rowdeg, tiers, root: int) -> tuple:
    """``bfs_single``'s level loop for one root driven by hand: per level
    the class counts (one readback), the step the rule picks, that step and
    the dense sweep each timed on the same state (CUDA events), the counts'
    and the step's kernel launches and device time (``torch.profiler``),
    and the step's bytes bound. Returns the records, one a level, and the
    parents and levels found."""
    search = bfs_mod._SingleSearch(E, csc, csc, coldeg, rowdeg, tiers)
    row_gids, col_gids = search.row_gids, search.col_gids
    parents = torch.where(row_gids == root, root, -1).to(torch.int32)
    levels = torch.where(row_gids == root, 0, -1).to(torch.int32)
    x = torch.where(col_gids == root, root, -1).to(torch.int32)
    n, new, level, records = E.nrows, None, 0, []
    while True:
        undisc = parents < 0
        counts_ms = time_cuda_ms(lambda: search.counts(x, undisc, new), 3)
        counts = search.counts(x, undisc, new)
        if not counts["active"]:
            break
        step = search.select(counts)
        kind = step[:2]
        selected = entries = 0
        if kind != "de":  # the walk's selected vertices and entries (1x1: one tile)
            selected, entries = sum(counts[kind][0]), sum(counts[kind][1])
        rec = {"level": level + 1, "branch": step, "counts_ms": counts_ms,
               "active_columns": sum(counts["fc"]), "undiscovered_rows": sum(counts["uc"]),
               "selected": selected, "walked_entries": entries,
               "step_ms": time_cuda_ms(lambda: search.step(step, x, undisc, counts), 3),
               "step_bound_ms": single_step_bound_ms(E, n, step, selected, entries),
               "dense_ms": time_cuda_ms(lambda: search.dense(x, undisc), 3),
               "dense_bound_ms": single_step_bound_ms(E, n, "dense", 0, 0),
               "counts_device": device_time(lambda: search.counts(x, undisc, new)),
               "step_device": device_time(lambda: search.step(step, x, undisc, counts))}
        y = search.step(step, x, undisc, counts)
        new = (y >= 0) & undisc & (row_gids >= 0)
        parents = torch.where(new, y, parents)
        level += 1
        levels = torch.where(new, level, levels)
        x = DistVec(blocks=torch.where(new, row_gids, -1), length=n, align="row",
                    grid=E.grid).realign("col").blocks
        rec["discovered"] = int(new.sum())
        records.append(rec)
    return records, parents, levels


def phase_bfs_single(g: dict, E: EllParMat, csc, indptr: np.ndarray, rowidx: np.ndarray,
                     deg_blocks, batch: tuple) -> dict:
    """The single-root search and the ELL SpMV family on the batched path's
    graph (module docstring, phase 8, its last four steps). ``batch``: the
    dense batched search's parents, levels and edge counts."""
    pd_, ld, ted = batch
    grid, n = E.grid, E.nrows
    # csr=csc: valid only on a 1x1 grid for a symmetric matrix; shown here by
    # the CSC arrays being equal to the graph's CSR arrays
    rows64 = g["rows"].astype(np.int64)
    if (grid.pr, grid.pc) != (1, 1) or not (
            np.array_equal(indptr[0, 0], np.searchsorted(rows64, np.arange(n + 1)))
            and np.array_equal(rowidx[0, 0], g["cols"])):
        raise AssertionError("bfs_single: csr=csc needs a 1x1 grid and a symmetric graph")
    tiers = parse_tier_spec(DEFAULT_SEQ_TIERS)
    coldeg = DistVec.from_global(grid, g["deg"], align="col").blocks
    kw = dict(csr=csc, coldeg=coldeg, rowdeg=deg_blocks)
    roots = [int(v) for v in g["roots"][:SEQ_ROOTS]]

    def one_root(root, spec):
        """The timed unit: the search, the edge count and its readback."""
        t0 = time.perf_counter()
        p, lv, it = bfs_single(E, root, csc, tiers=spec, **kw)
        te = int(single_traversed_edges(deg_blocks, p))
        return p, lv, it, te, time.perf_counter() - t0, bfs_single.last_run

    one_root(roots[0], tiers)  # warm-up
    lines, mteps = [], []
    for k, root in enumerate(roots):
        p, lv, it, te, dt, run = one_root(root, tiers)
        if not (torch.equal(p.blocks[0], pd_.blocks[0, :, k])
                and torch.equal(lv.blocks[0], ld.blocks[0, :, k].to(torch.int32))
                and te == int(ted[k])):
            raise AssertionError(f"bfs_single root {k}: differs from lane {k} of the batch")
        if k < SEQ_DENSE_ROOTS:
            pd1, ld1, it1, te1, _, _ = one_root(root, ())
            if not (torch.equal(pd1.blocks, p.blocks) and torch.equal(ld1.blocks, lv.blocks)
                    and (it1, te1) == (it, te)):
                raise AssertionError(f"bfs_single root {k}: tiers '' give another result")
        mteps.append(te / dt / 1e6)
        lines.append({"root": root, "levels": it, "steps": run["steps"],
                      "readbacks": run["readbacks"], "ms": dt * 1e3, "traversed_edges": te,
                      "mteps": mteps[-1]})
    kinds = {st[:2] for line in lines for st in line["steps"]}
    if not {"td", "bu"} <= kinds:
        raise AssertionError(f"bfs_single never took a td and a bu step: {sorted(kinds)}")
    single = {"phase": "bfs_path", "step": "single", "tiers": DEFAULT_SEQ_TIERS,
              "csr": "csc (1x1 grid, symmetric graph: the CSC arrays equal the CSR arrays)",
              "degrees": "g['deg'] as rowdeg and coldeg", "roots": lines,
              "harmonic_mean_mteps": len(mteps) / sum(1.0 / m for m in mteps),
              "median_ms": float(np.median([line["ms"] for line in lines])),
              "equal_to_batch_lanes": len(roots), "dense_tiers_equal_roots": SEQ_DENSE_ROOTS}
    emit(single)

    records, p0, l0 = single_level_breakdown(E, csc, coldeg, deg_blocks, tiers, roots[0])
    if not (torch.equal(p0[0], pd_.blocks[0, :, 0])
            and torch.equal(l0[0], ld.blocks[0, :, 0].to(torch.int32))):
        raise AssertionError("bfs_single: the level loop driven by hand gives another tree")
    for rec in records:
        emit({"phase": "bfs_path", "step": "single_levels", "root": roots[0], **rec})

    # the int32 batch (bfs_batch, M5 = dist_spmv_ell_masked_multi a level)
    W = SEQ_ROOTS
    roots_dev = torch.tensor(roots, dtype=torch.int32, device=grid.device)
    bfs_batch(E, roots_dev)  # warm-up
    runs = [timed_call(lambda: bfs_batch(E, roots_dev)) for _ in range(BFS_REPS)]
    pb, lb, itb = runs[-1][0]
    if not (torch.equal(pb.blocks, pd_.blocks[:, :, :W])
            and torch.equal(lb.blocks, ld.blocks[:, :, :W].to(torch.int32))):
        raise AssertionError("bfs_batch: differs from the first lanes of the batch")
    slots = sum(bc.numel() for bc, _, _ in E.buckets)
    rows = sum(br.numel() for _, _, br in E.buckets)
    # the first level's operands; the step reads every slot whatever the frontier
    xcol = torch.full((1, n, W), -1, dtype=torch.int32, device=grid.device)
    xcol[0, roots_dev.long(), torch.arange(W, device=grid.device)] = roots_dev
    undisc = DistMultiVec(blocks=xcol < 0, length=n, align="row", grid=grid)
    xv = DistMultiVec(blocks=xcol, length=n, align="col", grid=grid)
    m5_ms = time_cuda_ms(lambda: dist_spmv_ell_masked_multi(SELECT2ND_MAX, E, xv, undisc), 3)
    # column ids and row ids read, W int32 lanes gathered a slot, the [n, W]
    # frontier and mask read and the result written
    m5_bound = (4 * slots + 4 * rows + 4 * W * slots + 9 * n * W) / PEAK_BYTES * 1e3
    emit({"phase": "bfs_path", "step": "bfs_batch", "W": W, "levels": itb,
          "readbacks_per_call": bfs_batch.last_run["readbacks"],
          "ms_per_call": [r[1] for r in runs], "wall_s": [r[2] for r in runs],
          "equal_to_batch_lanes": W,
          "m5_dist_spmv_ell_masked_multi": {"ms_per_launch": m5_ms, "launches_per_call": itb,
                                            "bound_ms": m5_bound, "bound_by": "bytes"}})

    # the batched Bellman-Ford on unit weights (M6 = dist_spmv_ell_multi)
    lc = E.local_cols
    Ew = EllParMat(buckets=tuple((bc, torch.where(bc < lc, 1.0, 0.0), br)
                                 for bc, _, br in E.buckets), nrows=n, ncols=n, grid=grid)
    weight_bytes = sum(bv.numel() * bv.element_size() for _, bv, _ in Ew.buckets)
    sssp_batch(Ew, roots_dev)  # warm-up
    runs = [timed_call(lambda: sssp_batch(Ew, roots_dev)) for _ in range(BFS_REPS)]
    d, its = runs[-1][0]
    want = ld.blocks[:, :, :W].to(torch.float32)
    if not torch.equal(d.blocks, torch.where(want >= 0, want, float("inf"))):
        raise AssertionError("sssp_batch: unit-weight distances differ from the BFS levels")
    if its != int(ld.blocks[:, :, :W].max()) + 1:
        raise AssertionError(f"sssp_batch: {its} rounds, want the depth + 1")
    dv = DistMultiVec(blocks=d.blocks, length=n, align="row", grid=grid)
    m6_ms = time_cuda_ms(lambda: dist_spmv_ell_multi(MIN_PLUS, Ew, dv), 3)
    # column ids, weights and row ids read, W float32 lanes gathered a
    # slot, the [n, W] input read and the result written
    m6_bound = (8 * slots + 4 * rows + 4 * W * slots + 8 * n * W) / PEAK_BYTES * 1e3
    emit({"phase": "bfs_path", "step": "sssp_batch", "W": W, "weights": "1.0 (float32)",
          "weight_bytes": weight_bytes, "rounds": its,
          "readbacks_per_call": sssp_batch.last_run["readbacks"],
          "ms_per_call": [r[1] for r in runs], "wall_s": [r[2] for r in runs],
          "distances_equal_batch_levels": W,
          "m6_dist_spmv_ell_multi": {"ms_per_launch": m6_ms, "launches_per_call": its,
                                     "bound_ms": m6_bound, "bound_by": "bytes"}})
    return {"single": single, "levels": records}


def host_pagerank(csr, iters: int, alpha: float = 0.85, e=None) -> np.ndarray:
    """``iters`` rounds of the same power iteration in float64 with scipy:
    the column-stochastic matrix of the symmetric ``csr`` (out-degree =
    row degree), the dangling mass spread uniformly, or to ``e`` (a
    personalised lane: teleport and dangling mass both go to its source)."""
    n = csr.shape[0]
    deg = np.diff(csr.indptr).astype(np.float64)
    inv = np.divide(1.0, deg, out=np.zeros(n), where=deg > 0)
    x = np.full(n, 1.0 / n) if e is None else e.copy()
    for _ in range(iters):
        spread = csr @ (x * inv)
        dmass = x[deg == 0].sum()
        if e is None:
            x = alpha * spread + ((1 - alpha) + alpha * dmass) / n
        else:
            x = alpha * (spread + dmass * e) + (1 - alpha) * e
    return x


def spmv_bytes(nnz: int, n: int, reads_vals: bool) -> int:
    """Bytes ``dist_spmv`` must move on one tile: the int32 row and column
    id of every entry (and its 4-byte value where the product reads it),
    the 4-byte x gathered at every entry, x read once and the [n] result
    written once."""
    return nnz * (12 + (4 if reads_vals else 0)) + 8 * n


def phase_spmat_path(dev, g: dict, E: EllParMat, csr, batch: tuple) -> dict:
    """The SpParMat path on the BFS path's graph (module docstring, phase
    9): the COO matrix, bfs / bfs_diropt / bfs_diropt_auto, sssp, FastSV and
    LACC, pagerank and pagerank_batch, mis, then the SpMV layer timed a
    launch beside its bounds. ``E``: the BFS path's ELL buckets; ``csr``:
    the graph as a scipy CSR matrix; ``batch``: the dense batched search's
    parents, levels and edge counts. Raises on any disagreement."""
    pd_, ld, ted = batch
    n, nnz = len(g["deg"]), len(g["rows"])
    root = int(g["roots"][0])
    want_p, want_l = pd_.blocks[0, :, 0], ld.blocks[0, :, 0].to(torch.int32)
    want_te = int(ted[0])

    # spmat_build: the host bucketing on a CPU grid, then the upload
    t0 = time.perf_counter()
    host = SpParMat.from_global_coo(Grid.make(1, 1, device="cpu"), g["rows"], g["cols"],
                                    np.ones(nnz, np.int32), n, n)
    host_s = time.perf_counter() - t0
    grid = Grid.make(1, 1, device=dev)
    t0 = time.perf_counter()
    A = SpParMat(rows=host.rows.to(dev), cols=host.cols.to(dev), vals=host.vals.to(dev),
                 nnz=host.nnz.to(dev), nrows=n, ncols=n, grid=grid)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del host
    tile_bytes = sum(t.numel() * t.element_size() for t in (A.rows, A.cols, A.vals, A.nnz))
    emit({"phase": "spmat_path", "step": "spmat_build", "grid": "1x1", "n": n, "nnz": nnz,
          "capacity": A.capacity, "host_s": host_s, "upload_s": upload_s,
          "bytes": tile_bytes})

    # spmat_bfs: three searches from the first root, each equal to lane 0
    fcap, ecap = n // 8, max(nnz // 16, 1 << 20)
    searches = {
        "bfs": (lambda: bfs(A, root), bfs),
        "bfs_diropt": (lambda: bfs_diropt(A, root, frontier_capacity=fcap,
                                          exp_capacity=ecap), bfs_diropt),
        "bfs_diropt_auto": (lambda: bfs_diropt_auto(A, root), bfs_diropt),
    }
    lines, kinds = {}, set()
    for name, (call, fn) in searches.items():
        def unit():
            p, lv, it = call()
            return p, lv, it, int(traversed_edges(A, p))

        unit()  # warm-up
        runs = [timed_call(unit) for _ in range(SPMAT_REPS)]
        p, lv, it, te = runs[-1][0]
        if not (torch.equal(p.blocks[0], want_p) and torch.equal(lv.blocks[0], want_l)
                and te == want_te):
            raise AssertionError(f"{name}: differs from lane 0 of the batch")
        wall = [r[2] for r in runs]
        lines[name] = {"phase": "spmat_path", "step": "spmat_bfs", "search": name,
                       "niter": it, "readbacks": fn.last_run["readbacks"],
                       "ms_per_call": [w * 1e3 for w in wall], "device_ms": [r[1] for r in runs],
                       "traversed_edges": te, "mteps": te / float(np.median(wall)) / 1e6}
        if fn is bfs_diropt:
            lines[name]["steps"] = fn.last_run["steps"]
            lines[name]["frontiers"] = fn.last_run["frontiers"]
            kinds |= set(fn.last_run["steps"])
        emit(lines[name])
    if not {"td", "bu"} <= kinds:
        raise AssertionError(f"bfs_diropt never took a td and a bu level: {sorted(kinds)}")
    niter = lines["bfs"]["niter"]

    # spmat_sssp: unit float32 weights, distances equal to the levels
    Aw = A.apply(ones_f32)
    sssp(Aw, root)  # warm-up
    runs = [timed_call(lambda: sssp(Aw, root)) for _ in range(SPMAT_REPS)]
    d, rounds = runs[-1][0]
    wl = want_l.to(torch.float32)
    if not torch.equal(d.blocks[0], torch.where(wl >= 0, wl, float("inf"))):
        raise AssertionError("sssp: unit-weight distances differ from the BFS levels")
    if rounds != niter:
        raise AssertionError(f"sssp: {rounds} rounds, bfs ran {niter} levels")
    emit({"phase": "spmat_path", "step": "spmat_sssp", "weights": "1.0 (float32)",
          "rounds": rounds, "readbacks": sssp.last_run["readbacks"],
          "ms_per_call": [r[2] * 1e3 for r in runs], "device_ms": [r[1] for r in runs],
          "distances_equal_levels": True})

    # spmat_cc: FastSV and LACC against scipy's components
    t0 = time.perf_counter()
    ncomp, comp = csgraph.connected_components(csr, directed=False)
    first = np.full(ncomp, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    scipy_s = time.perf_counter() - t0
    cc_line = {"phase": "spmat_path", "step": "spmat_cc", "scipy_components": int(ncomp),
               "scipy_s": scipy_s}
    labels = {}
    for name, fn in (("fastsv", connected_components), ("lacc", lacc)):
        fn(A)  # warm-up
        runs = [timed_call(lambda: fn(A)) for _ in range(SPMAT_REPS)]
        lab, it = runs[-1][0]
        labels[name] = lab.blocks
        if num_components(lab) != ncomp:
            raise AssertionError(f"{name}: {num_components(lab)} components, scipy {ncomp}")
        if not np.array_equal(lab.to_global(), first[comp]):
            raise AssertionError(f"{name}: labels are not each component's least vertex")
        cc_line[name] = {"iterations": it, "readbacks": fn.last_run["readbacks"],
                         "ms_per_call": [r[2] * 1e3 for r in runs],
                         "device_ms": [r[1] for r in runs]}
    if not torch.equal(labels["fastsv"], labels["lacc"]):
        raise AssertionError("FastSV and LACC give different labels")
    emit(cc_line)

    # spmat_pagerank: against float64 power iterations of the same rounds
    pagerank(A)  # warm-up
    runs = [timed_call(lambda: pagerank(A, 0.85, 1e-6, 100)) for _ in range(SPMAT_REPS)]
    x, it = runs[-1][0]
    want = host_pagerank(csr, it)
    got = x.to_global().astype(np.float64)
    l1 = float(np.abs(got - want).sum())
    if not np.isfinite(got).all() or l1 > PAGERANK_L1_BOUND:
        raise AssertionError(f"pagerank: L1 distance {l1} to float64 above {PAGERANK_L1_BOUND}")
    pr_line = {"phase": "spmat_path", "step": "spmat_pagerank", "iterations": it,
               "readbacks": pagerank.last_run["readbacks"], "l1_to_float64": l1,
               "sum": float(got.sum()), "bound": PAGERANK_L1_BOUND,
               "ms_per_call": [r[2] * 1e3 for r in runs], "device_ms": [r[1] for r in runs]}
    # the column-normalised ELL from the same COO: the BFS path's buckets
    # with 1/deg(column) in every stored slot
    lc = E.local_cols
    inv = torch.from_numpy(np.divide(1.0, g["deg"], out=np.zeros(n), where=g["deg"] > 0)
                           .astype(np.float32)).to(dev)
    inv_pad = torch.cat([inv, inv.new_zeros(1)])
    P_ell = EllParMat(buckets=tuple((bc, inv_pad[torch.clamp(bc, max=lc).long()], br)
                                    for bc, _, br in E.buckets),
                      nrows=n, ncols=n, grid=grid)
    dang = DistVec.from_global(grid, (g["deg"] == 0).astype(np.float32), align="col")
    srcs = torch.from_numpy(g["roots"][:PAGERANK_W].astype(np.int32)).to(dev)
    pagerank_batch(P_ell, srcs, dang)  # warm-up
    runs = [timed_call(lambda: pagerank_batch(P_ell, srcs, dang)) for _ in range(SPMAT_REPS)]
    X, itb = runs[-1][0]
    lanes = []
    for k in range(PAGERANK_CHECK_LANES):
        e = np.zeros(n)
        e[int(g["roots"][k])] = 1.0
        lane = X.blocks[0, :, k].cpu().numpy().astype(np.float64)
        l1k = float(np.abs(lane - host_pagerank(csr, itb, e=e)).sum())
        if not np.isfinite(lane).all() or l1k > PAGERANK_L1_BOUND:
            raise AssertionError(f"pagerank_batch lane {k}: L1 {l1k} above {PAGERANK_L1_BOUND}")
        lanes.append({"lane": k, "l1_to_float64": l1k, "sum": float(lane.sum())})
    pr_line["batch"] = {"W": PAGERANK_W, "iterations": itb,
                        "readbacks": pagerank_batch.last_run["readbacks"], "lanes": lanes,
                        "ms_per_call": [r[2] * 1e3 for r in runs],
                        "device_ms": [r[1] for r in runs]}
    emit(pr_line)
    del P_ell, X

    # spmat_mis: independent and maximal over the edge list
    gen = torch.Generator(device=dev)
    mis(A, gen.manual_seed(1))  # warm-up
    runs = [timed_call(lambda: mis(A, gen.manual_seed(1))) for _ in range(SPMAT_REPS)]
    status, mrounds = runs[-1][0]
    s_ = status.to_global()
    rows64, cols64 = g["rows"].astype(np.int64), g["cols"].astype(np.int64)
    member = s_ == 1
    if (member[rows64] & member[cols64]).any():
        raise AssertionError("mis: two members share an edge")
    covered = np.zeros(n, bool)
    covered[rows64[member[cols64]]] = True
    if not (member | covered).all() or not set(np.unique(s_)) <= {1, -1}:
        raise AssertionError("mis: a vertex is undecided or has no member beside it")
    emit({"phase": "spmat_path", "step": "spmat_mis", "rounds": mrounds,
          "readbacks": mis.last_run["readbacks"], "members": int(member.sum()),
          "ms_per_call": [r[2] * 1e3 for r in runs], "device_ms": [r[1] for r in runs],
          "independent": True, "maximal": True})

    # spmat_layers: dist_spmv per semiring and one top-down level, a launch
    rng = np.random.default_rng(11)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    x_ids = DistVec(blocks=torch.where(torch.from_numpy(rng.random(n) < 0.1).to(dev), ids, -1)
                    [None], length=n, align="col", grid=grid)
    x_f = DistVec(blocks=torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)[None],
                  length=n, align="col", grid=grid)
    layers = {}
    for name, sr, M, x, reads_vals in (("select2nd_max_int32", SELECT2ND_MAX, A, x_ids, False),
                                       ("min_plus_f32", MIN_PLUS, Aw, x_f, True),
                                       ("plus_times_f32", PLUS_TIMES, Aw, x_f, True)):
        ms = time_cuda_ms(lambda: dist_spmv(sr, M, x), 5)
        b = spmv_bytes(nnz, n, reads_vals)
        layers[name] = {"ms_per_launch": ms, "bytes": b, "bound_ms": b / PEAK_BYTES * 1e3,
                        "bound_by": "bytes", "share": b / PEAK_BYTES * 1e3 / ms}
    layers["min_plus_f32"]["ops"] = op_breakdown(lambda: dist_spmv(MIN_PLUS, Aw, x_f), 3)
    layers["select2nd_max_int32"]["ops"] = op_breakdown(
        lambda: dist_spmv(SELECT2ND_MAX, A, x_ids), 3)
    # dist_spmspv_masked at the bfs_diropt run's first top-down level past
    # the root: its frontier and undiscovered rows rebuilt from the levels
    steps = lines["bfs_diropt"]["steps"]
    k = next((i for i, st in enumerate(steps) if st == "td" and i > 0), 0)
    frontier = want_l == k
    csc = csc_tiles(A)
    xk = DistVec(blocks=torch.where(frontier, ids, -1)[None], length=n, align="col",
                 grid=grid)
    ak = DistVec(blocks=frontier[None], length=n, align="col", grid=grid)
    uk = DistVec(blocks=((want_l < 0) | (want_l > k))[None], length=n, align="row", grid=grid)
    counts = spmspv_counts(csc, ak.blocks, fcap, ecap).tolist()
    td_ms = time_cuda_ms(lambda: dist_spmspv_masked(
        SELECT2ND_MAX, A, xk, ak, uk, frontier_capacity=fcap, exp_capacity=ecap, csc=csc,
        counts=counts), 5)
    cols_k, walked = counts[0], counts[1]
    # per active column its two pointers and its x value, per walked entry
    # its row id and the 4-byte candidate, the column and row masks read
    # and the [n] result written
    td_bytes = 8 * cols_k + 4 * cols_k + 8 * walked + 2 * n + 4 * n
    layers["dist_spmspv_masked"] = {
        "level": k + 1, "active_columns": cols_k, "walked_entries": walked,
        "ms_per_launch": td_ms, "bytes": td_bytes, "bound_ms": td_bytes / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "share": td_bytes / PEAK_BYTES * 1e3 / td_ms,
        "launches_per_call": {"bfs_diropt": steps.count("td"),
                              "bfs_diropt_auto": lines["bfs_diropt_auto"]["steps"].count("td")},
        "ops": op_breakdown(lambda: dist_spmspv_masked(
            SELECT2ND_MAX, A, xk, ak, uk, frontier_capacity=fcap, exp_capacity=ecap, csc=csc,
            counts=counts), 3)}
    layers["select2nd_max_int32"]["launches_per_call"] = {
        "bfs": niter, "bfs_diropt": steps.count("bu"),
        "bfs_diropt_auto": lines["bfs_diropt_auto"]["steps"].count("bu"),
        "fastsv": cc_line["fastsv"]["iterations"], "lacc": 2 * cc_line["lacc"]["iterations"],
        "mis": 2 * mrounds}
    layers["min_plus_f32"]["launches_per_call"] = {"sssp": rounds}
    layers["plus_times_f32"]["launches_per_call"] = {"pagerank": it}
    emit({"phase": "spmat_path", "step": "spmat_layers", **layers})
    del A, Aw, csc
    torch.cuda.empty_cache()
    return {"lines": lines, "layers": layers}


def phase_bfs_path(dev, t_start: float, scale: int = BFS_SCALE,
                   nroots: int = BFS_NROOTS) -> dict:
    """The Graph500 batched BFS, host kernel 1 to validated trees, then the
    single-root search and the SpMV family on the same graph (see the
    module docstring, phase 8). Raises on any disagreement."""
    n = 1 << scale
    t0 = time.perf_counter()
    g = build_graph(scale, BFS_EDGEFACTOR, nroots)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets, (indptr, rowidx) = build_structures(g["rows"], g["cols"], n)
    structures_s = time.perf_counter() - t0
    nnz = len(g["rows"])
    slots = sum(bc.size for bc, _, _ in buckets)
    structure_bytes = (sum(a.nbytes for b in buckets for a in b) + indptr.nbytes
                       + rowidx.nbytes)
    emit({"phase": "bfs_path", "step": "host_build", "scale": scale,
          "edgefactor": BFS_EDGEFACTOR, "roots": nroots, "grid": "1x1", "n": n, "nnz": nnz,
          "graph_s": graph_s, "structures_s": structures_s,
          "bucket_classes_nb_x_kb": [[bc.shape[2], bc.shape[3]] for bc, _, _ in buckets],
          "slots": slots, "slot_padding_ratio": slots / nnz,
          "structure_bytes": structure_bytes})

    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    t0 = time.perf_counter()
    grid = Grid.make(1, 1, device=dev)
    E = EllParMat.from_host_buckets(grid, buckets, n, n)
    csc = upload_csc_companion(grid, indptr, rowidx)
    deg_blocks = DistVec.from_global(grid, g["deg"], align="row").blocks
    roots_dev = torch.from_numpy(g["roots"]).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    fcap, ecap = n // 8, max(nnz // 16, 1 << 20)
    modes = {"dense": {}, "diropt": dict(csc=csc, frontier_capacity=fcap, edge_capacity=ecap)}

    def search(kw):
        """The timed unit: the search, the edge count and its readback."""
        p, l, it = bfs_batch_compact(E, roots_dev, **kw)
        te = batch_traversed_edges(deg_blocks, p).cpu().numpy()
        return p, l, it, te, bfs_batch_compact.last_run

    results, lines = {}, {}
    for mode, kw in modes.items():
        torch.cuda.reset_peak_memory_stats()
        _, warm_ms, _ = timed_call(lambda: search(kw))
        runs = [timed_call(lambda: search(kw)) for _ in range(BFS_REPS)]
        p, l, it, te, run = runs[-1][0]
        dev_ms = [r[1] for r in runs]
        wall_s = [r[2] for r in runs]
        dt = float(np.median(wall_s))
        total_te = int(te.astype(np.int64).sum())
        live = te[te > 0].astype(np.float64)
        results[mode] = (p, l, it, te)
        lines[mode] = {
            "phase": "bfs_path", "step": "search", "mode": mode, "levels": it,
            "steps": run["steps"], "host_readbacks_per_call": run["readbacks"] + 1,
            "warmup_ms": warm_ms, "device_ms": dev_ms, "wall_s": wall_s,
            "median_wall_s": dt, "total_traversed_edges": total_te,
            "mteps": total_te / dt / 1e6,
            "harmonic_mean_amortized_mteps": len(live) * len(te) / (dt * np.sum(1.0 / live)) / 1e6,
            "reachable_roots": int((te > 0).sum()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        }
        if lines[mode]["reachable_roots"] != nroots:
            raise AssertionError(f"bfs {mode}: a root reached no edge")
        emit(lines[mode])
    hand_launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(hand_launches.values()):
        raise AssertionError(f"the BFS path launched hand kernels: {hand_launches}")

    # both modes agree
    (pd_, ld, itd, ted), (ps, ls, its, tes) = results["dense"], results["diropt"]
    if not (torch.equal(pd_.blocks, ps.blocks) and torch.equal(ld.blocks, ls.blocks)
            and itd == its and np.array_equal(ted, tes)):
        raise AssertionError("bfs: dense and direction-optimised results differ")
    if "sparse" not in lines["diropt"]["steps"]:
        raise AssertionError(f"bfs diropt never took the sparse step: {lines['diropt']['steps']}")

    # the trees on the device, a lane subset (levels widened to int32)
    lanes = lambda mv, dt_: DistMultiVec(
        blocks=mv.blocks[:, :, :BFS_CHECK_LANES].to(dt_).contiguous(), length=mv.length,
        align=mv.align, grid=mv.grid)
    pv, lv = lanes(pd_, torch.int32), lanes(ld, torch.int32)
    viol, validate_ms, _ = timed_call(lambda: validate_bfs_device(E, pv, lv).cpu().numpy())
    if viol.shape != (4, BFS_CHECK_LANES) or viol.any():
        raise AssertionError(f"bfs validation: violations {viol.tolist()}")

    # the same lanes against a numpy BFS on the host
    t0 = time.perf_counter()
    rows64, cols64 = g["rows"].astype(np.int64), g["cols"].astype(np.int64)
    row_ptr = np.searchsorted(rows64, np.arange(n + 1))
    P = pd_.blocks[0, :, :BFS_CHECK_LANES].cpu().numpy()
    L = ld.blocks[0, :, :BFS_CHECK_LANES].cpu().numpy()
    for k in range(BFS_CHECK_LANES):
        root = int(g["roots"][k])
        want_l = host_bfs_levels(row_ptr, cols64, root)
        if not np.array_equal(L[:, k], want_l):
            raise AssertionError(f"bfs lane {k}: levels differ from the host BFS")
        if not np.array_equal(P[:, k], host_max_parents(rows64, cols64, row_ptr, want_l, root)):
            raise AssertionError(f"bfs lane {k}: parents are not the max-id neighbour one level up")
        if int(ted[k]) != int(g["deg"][want_l >= 0].astype(np.int64).sum()) // 2:
            raise AssertionError(f"bfs lane {k}: traversed edges differ from the host count")
    host_check_s = time.perf_counter() - t0
    emit({"phase": "bfs_path", "step": "checks", "modes_agree": True,
          "validate_bfs_device": viol.tolist(), "validate_lanes": BFS_CHECK_LANES,
          "validate_ms": validate_ms, "host_bfs_lanes_equal": BFS_CHECK_LANES,
          "host_check_s": host_check_s, "finite_shapes": [list(pd_.blocks.shape),
                                                          list(ld.blocks.shape)],
          "hand_kernel_launches": hand_launches})

    # where the time goes: level by level, the parents pass, the bounds
    bounds = step_bounds(E, n, nroots)
    records, state = bfs_level_breakdown(E, roots_dev, csc, fcap, ecap)
    if not torch.equal(state["levels"], ld.blocks):
        raise AssertionError("bfs: the level loop driven by hand gives other levels")
    for rec in records:
        emit({"phase": "bfs_path", "step": "level", **rec,
              "dense_bound_ms": bounds["m1_bound_ms"]})
    parents_ms = time_cuda_ms(
        lambda: ellmat._ell_parents_from_levels(E, state["levels"], state["levels"]), 2)
    te_ms = time_cuda_ms(lambda: batch_traversed_edges(deg_blocks, pd_), 3)
    dense_ms = [r["dense_ms"] for r in records]
    programs = {
        "phase": "bfs_path", "step": "programs", **bounds, "upload_s": upload_s,
        "m1_levels_step": {"ms_per_launch": sum(dense_ms) / len(dense_ms),
                           "ms_min_max": [min(dense_ms), max(dense_ms)],
                           "launches_per_call": {m: lines[m]["steps"].count("dense")
                                                 for m in modes},
                           "bound_ms": bounds["m1_bound_ms"], "bound_by": "bytes"},
        "m2_parents_from_levels": {"ms_per_launch": parents_ms,
                                   "launches_per_call": {m: 1 for m in modes},
                                   "bound_ms": bounds["m2_bound_ms"], "bound_by": "bytes"},
        "m3_union_sparse_step": {
            "ms_per_launch": [r["sparse_ms"] for r in records if "sparse_ms" in r],
            "bound_ms": [r["sparse_bound_ms"] for r in records if "sparse_ms" in r],
            "bound_by": "bytes",
            "launches_per_call": {m: lines[m]["steps"].count("sparse") for m in modes}},
        "batch_traversed_edges_ms": te_ms,
        # device time per operator at the widest frontier (torch.profiler)
        "m1_ops": op_breakdown(lambda: ellmat._ell_levels_step(E, *state["widest"]), 2),
        "m2_ops": op_breakdown(
            lambda: ellmat._ell_parents_from_levels(E, state["levels"], state["levels"]), 2),
        "envelopes_in_use": {"levels": ellmat.LEVELS_BUDGET_BYTES,
                             "parents": ellmat.PARENTS_BUDGET_BYTES},
    }
    emit(programs)
    sweep = envelope_sweep(E, state)
    emit({"phase": "bfs_path", "step": "envelope_sweep", **sweep})
    del state
    torch.cuda.empty_cache()

    emit({"phase": "bfs_path", "step": "elapsed", "total_s": time.perf_counter() - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    single = phase_bfs_single(g, E, csc, indptr, rowidx, deg_blocks, (pd_, ld, ted))
    hand_launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(hand_launches.values()):
        raise AssertionError(f"the single-root steps launched hand kernels: {hand_launches}")
    emit({"phase": "bfs_path", "step": "single_checks", "hand_kernel_launches": hand_launches,
          "total_s": time.perf_counter() - t_start})
    torch.cuda.empty_cache()

    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    csr = sp.csr_matrix((np.ones(len(rowidx[0, 0]), np.float64), rowidx[0, 0], indptr[0, 0]),
                        shape=(n, n))  # the CSC arrays of a symmetric graph on one tile
    spmat = phase_spmat_path(dev, g, E, csr, (pd_, ld, ted))
    hand_launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(hand_launches.values()):
        raise AssertionError(f"the SpParMat steps launched hand kernels: {hand_launches}")
    emit({"phase": "spmat_path", "step": "spmat_checks", "hand_kernel_launches": hand_launches,
          "total_s": time.perf_counter() - t_start})
    return {"lines": lines, "programs": programs, "single": single, "spmat": spmat}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_card()
    loops = phase_build()
    full = phase_kernels(dev)
    phase_compaction(dev)
    path = phase_main_path(dev)
    k2_path = phase_k2_path(path.pop("mats"))
    times = phase_times(dev, full, loops)
    phase_bfs_path(dev, t_start)
    kernels = []
    for sr in (MIN_PLUS, MAX_MIN):  # the kinds the main path launches
        kind = _PALLAS_KINDS[sr.name]
        t = times[kind]
        kernels.append({
            "name": f"semiring_mm_{kind}", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": path["per_kind"][sr.name]["kernel_launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "floor_ms": t["floor_ms"],
        })
    if sum(k["launches"] for k in kernels) != path["launches"]:
        raise AssertionError("K1's launch counts do not add up on the main path")
    k2 = k2_path["per_kind"]["min_plus"]
    kernels.append({
        "name": "dense_to_tuples_f32", "variant": k2["k2_variant"], "route": "cuda",
        "source": K2_SOURCE, "replaces": K2_TPU_KERNEL, "launches": k2_path["launches"]["k2"],
        "max_abs_err": max(v["max_abs_err"] for v in k2_path["per_kind"].values()),
        "ms": k2["k2_ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
        "floor_ms": None,  # no instruction-issue floor is derived for K2
    })
    # one extraction per semiring; K1 builds the tropical accumulators
    if k2_path["launches"] != {"k1": 2, "k2": 3}:
        raise AssertionError(f"K2 path launches {k2_path['launches']}, want k1 2, k2 3")
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never launched on the main path")
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
