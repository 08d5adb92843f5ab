"""Tests of the port that need an NVIDIA card: each CUDA kernel against its
plain PyTorch version, the mxu SpGEMM path, the dense -> sparse
extraction, the batched and single-root BFS, the ELL SpMV family, the
batched SSSP, and the SpParMat path (local and distributed SpMV forms,
the DistVec op pack, the SpParMat operations, bfs, bfs_diropt, sssp,
FastSV, LACC, mis, pagerank), the general and windowed SpGEMM, and the
applications on them (MCL, the matchings, the orderings, the SpMM lane
and feature propagation), and graph input (the threefry streams,
``rmat_edges``, ``DistVec.randperm`` with a key, tuple routing, Graph500
kernel 1 on the device, the ring fold of the batched BFS, a Matrix Market
read onto the grid and a checkpoint round trip), and the 3D tier (the
conversions and resplits, the ESC 3D product under each fiber merge tier
with ``hash_merge``, the windowed 3D product on both backends with K1's
launches, the routed ``windowed3d`` and the 3D MCL) on the card against the
same calls on the CPU, and the measured-plan tuner (the probe picks a rung
on the card with K1's launches counted and nothing skipped, then the store
replays it; the dot backend's windowed rung, the SpMM and the 3D probes),
and the telemetry's cost contract (obs on adds no kernel and no
synchronising call to ``spgemm_auto``; the ``spgemm.auto`` range holds K1's
kernels on the profiler's timeline), and the serving engine and the
mutation lane (served lanes of the five kinds, a merge chain, a snapshot
round trip and a recovery). Marked ``cuda``; they skip where there is no card. The module runs under a
fresh plan store of its own with probing off, so the routed calls take
their tiers from the code, not from an ambient store.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Comparisons are exact (``torch.equal``, or equal bits where a NaN may
appear): min/max folds do not depend on order, integer-valued float32
inputs keep every ``plus_times`` sum below 2**24, and the compaction
copies values without arithmetic. Two exceptions: where NaN cells occur
in a semiring product they are compared by position (NaN payloads
differ) and the other cells by their bits, and ``plus_times`` on
non-integer data is held to the float64 product within
K * 2**-24 * sum|a||b| per cell, and the SpMV's ``plus_times`` on
non-integer data to the CPU's result within ``rtol=1e-5, atol=1e-6``
(``index_add_`` on CUDA sums in no fixed order).
"""

import shutil

import numpy as np
import pytest
import torch

from combblas_tpu_torch import (
    DEFAULT_SEQ_TIERS,
    MAX_MIN,
    MIN_PLUS,
    PAD_ROOT,
    PLUS_TIMES,
    SELECT2ND_MAX,
    DistMultiVec,
    DistVec,
    EllParMat,
    Grid,
    SpParMat,
    Semiring,
    batch_traversed_edges,
    bfs_batch,
    bfs_batch_compact,
    bfs_single,
    build_csc_companion,
    build_csr_companion,
    build_graph,
    dense_to_sptuples,
    dist_spmv_ell,
    dist_spmv_ell_masked,
    dist_spmv_ell_masked_multi,
    dist_spmv_ell_multi,
    flat_to_tuples_arrays,
    flat_to_tuples_arrays_reference,
    rmat_symmetric_coo_host,
    semiring_matmul,
    parse_tier_spec,
    semiring_matmul_reference,
    single_traversed_edges,
    spgemm_auto,
    sssp_batch,
    validate_bfs_device,
)
from combblas_tpu_torch import (
    CSC,
    CSR,
    SELECT2ND_MIN,
    bfs,
    bfs_diropt,
    bfs_diropt_auto,
    concatenate,
    connected_components,
    dist_spmspv,
    dist_spmspv_masked,
    dist_spmv,
    dist_spmv_masked,
    lacc,
    mis,
    ones_i32,
    pagerank,
    pagerank_batch,
    sssp,
    traversed_edges,
)
from combblas_tpu_torch import (
    DenseParMat,
    awpm,
    dist_spmm_ell,
    maximal_matching,
    maximum_matching,
    mcl,
    minimum_degree_ordering,
    ones_f32,
    pad_features,
    propagate_features,
    rcm_ordering,
    row_invdeg,
    summa_spmm,
)
from combblas_tpu_torch.models import matching as matching_mod
from combblas_tpu_torch.models import mcl as mcl_mod
from combblas_tpu_torch.models import mis as mis_mod
from combblas_tpu_torch.models import propagate as propagate_mod
from combblas_tpu_torch.ops.dense_to_tuples import VARIANTS, chunk_rows, resident_blocks
from combblas_tpu_torch.ops.spmv import spmspv, spmspv_dense_out, spmv
from combblas_tpu_torch.ops.semiring_matmul import KINDS, TILE, _kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _plan_store(tmp_path_factory):
    """A fresh plan store for the module, probing off; removed at the end."""
    from combblas_tpu_torch.tuner import config as tuner_config
    from combblas_tpu_torch.tuner import store as tuner_store

    d = tmp_path_factory.mktemp("plans")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tuner_config.ENV_PLAN_STORE, str(d))
        for name in (tuner_config.ENV_PROBE, tuner_config.ENV_TIER, tuner_config.ENV_BACKEND,
                     tuner_config.ENV_TIER3D, tuner_config.ENV_MERGE,
                     tuner_config.ENV_SPMM_BACKEND):
            mp.delenv(name, raising=False)
        tuner_store._reset_for_tests()
        yield d
    tuner_store._reset_for_tests()
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _int_valued(rng, shape, dev):
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(1000, 777, 1234), (1, 1, 1), (65, 3, 129)])
def test_kernel_matches_plain_version(kind, shape, cuda_device):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = _int_valued(rng, (m, k), cuda_device)
    b = _int_valued(rng, (k, n), cuda_device)
    launches = semiring_matmul.launches
    got = semiring_matmul(kind, a, b)
    torch.cuda.synchronize()
    assert semiring_matmul.launches == launches + 1
    assert torch.equal(got, semiring_matmul_reference(kind, a, b))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize(
    "shape, variant",
    [
        ((128, 128, 128), "tiled"),
        ((256, 512, 384), "tiled"),
        ((129, 8, 127), "edge"),
        ((1024, 777, 1024), "edge"),
        ((128, 0, 256), "tiled"),
        ((130, 0, 3), "edge"),
    ],
)
def test_kernel_variants_match_plain_version(kind, shape, variant, cuda_device):
    """Shapes on either side of the kernel's tiles, each instantiation
    (tiled, edge) for every kind; k == 0 gives the fold's identity."""
    m, k, n = shape
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    a = _int_valued(rng, (m, k), cuda_device)
    b = _int_valued(rng, (k, n), cuda_device)
    got = semiring_matmul(kind, a, b)
    torch.cuda.synchronize()
    assert semiring_matmul.last_variant == variant
    assert torch.equal(got, semiring_matmul_reference(kind, a, b))


_SPECIALS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 2.5, 3.0], np.float32)
_SPECIAL_ODDS = np.array([0.002, 0.15, 0.15, 0.01, 0.01, 0.17, 0.17, 0.17, 0.168])


def _offset_copy(x):
    """A contiguous copy one element into its buffer: not 16-byte aligned."""
    store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = store[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(256, 256, 256), (200, 136, 72)])
def test_kernel_specials_match_plain_version(kind, shape, cuda_device):
    """NaN, -0.0, +0.0, +inf and -inf cells: NaN in the same cells, every
    other cell equal bit for bit (so the sign of a zero counts)."""
    rng = np.random.default_rng(sum(shape) + KINDS.index(kind))
    a, b = (
        torch.from_numpy(rng.choice(_SPECIALS, size=s, p=_SPECIAL_ODDS / _SPECIAL_ODDS.sum()))
        .to(cuda_device)
        for s in (shape[:2], shape[1:])
    )
    got = semiring_matmul(kind, a, b)
    want = semiring_matmul_reference(kind, a, b)
    nan = want.isnan()
    assert 0 < int(nan.sum()) < nan.numel()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


@pytest.mark.parametrize(
    "shape, variant", [((256, 4096, 384), "tiled"), ((300, 4095, 200), "edge")]
)
def test_plus_times_exact_on_wide_integers(shape, variant, cuda_device):
    """A with integers in [-4095, 4095] (up to 12 significant bits), B in
    {-1, 0, 1}, k <= 4096: every sum stays below 2**24, so the float32
    product is exact in any order, while inputs rounded to TF32 (11 bits)
    or bf16 (8 bits) would change it."""
    m, k, n = shape
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.integers(-4095, 4096, (m, k)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.integers(-1, 2, (k, n)).astype(np.float32)).to(cuda_device)
    got = semiring_matmul("plus_times", a, b)
    assert semiring_matmul.last_variant == variant
    assert torch.equal(got, semiring_matmul_reference("plus_times", a, b))


@pytest.mark.parametrize("shape", [(512, 1024, 384), (300, 1000, 200)])
def test_plus_times_on_float_data_within_rounding(shape, cuda_device):
    """Uniform [-1, 1] data: within K * 2**-24 * sum|a||b| of the float64
    product per cell, and the two instantiations bit-equal (both fold k in
    order with one FMA chain)."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    a, b = (
        torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(cuda_device)
        for s in ((m, k), (k, n))
    )
    got = semiring_matmul("plus_times", a, b)
    first = semiring_matmul.last_variant
    other = semiring_matmul("plus_times", _offset_copy(a), _offset_copy(b))
    assert (first, semiring_matmul.last_variant) == (
        "tiled" if m % TILE[0] == 0 and k % TILE[2] == 0 and n % TILE[1] == 0 else "edge",
        "edge",
    )
    want = a.double() @ b.double()
    tol = k * 2.0**-24 * (a.double().abs() @ b.double().abs())
    assert bool(((got.double() - want).abs() <= tol).all())
    assert torch.equal(got, other)


@pytest.mark.parametrize("kind", KINDS)
def test_unaligned_view_takes_edge_variant(kind, cuda_device):
    """A view at offset 1 (contiguous, not 16-byte aligned) of an operand
    whose shape fits the tiles runs the edge instantiation and gives the
    tiled one's result."""
    rng = np.random.default_rng(31)
    a = _int_valued(rng, (256, 128), cuda_device)
    b = _int_valued(rng, (128, 384), cuda_device)
    want = semiring_matmul(kind, a, b)
    assert semiring_matmul.last_variant == "tiled"
    for x, y in ((_offset_copy(a), b), (a, _offset_copy(b))):
        assert x.data_ptr() % 16 or y.data_ptr() % 16
        got = semiring_matmul(kind, x, y)
        assert semiring_matmul.last_variant == "edge"
        assert torch.equal(got, want)
    assert torch.equal(want, semiring_matmul_reference(kind, a, b))


def test_tiled_launcher_refuses_what_it_does_not_take(cuda_device):
    """Called directly, the tiled instantiation returns an error code for a
    ragged shape or an unaligned pointer instead of computing."""
    fn = _kernel("min_plus", "tiled")
    a = torch.zeros((256, 256), device=cuda_device)
    c = torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(a.data_ptr(), a.data_ptr(), c.data_ptr(), 256, 256, 256, stream) == 0
    assert fn(a.data_ptr(), a.data_ptr(), c.data_ptr(), 255, 256, 256, stream) != 0
    assert fn(a.data_ptr(), a.data_ptr(), c.data_ptr(), 256, 256, 255, stream) != 0
    assert fn(a.data_ptr() + 4, a.data_ptr(), c.data_ptr(), 128, 128, 128, stream) != 0
    torch.cuda.synchronize()


def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    a = torch.zeros((8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        semiring_matmul("min_plus", a.t(), a)
    with pytest.raises(TypeError, match="float32"):
        semiring_matmul("min_plus", a.half(), a.half())


@pytest.mark.parametrize("p", [1, 2])
def test_spgemm_auto_on_card_matches_cpu(p, cuda_device):
    """The mxu path on the card (kernel) gives the CPU path's (plain
    version) arrays."""
    n = 1 << 8
    r, c = rmat_symmetric_coo_host(3, 8, 8)
    v = np.random.default_rng(7).integers(1, 16, r.shape[0]).astype(np.float32)
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        mats = [
            SpParMat.from_global_coo(
                Grid.make(p, p, device=dev), r, c, v, n, n, dedup_sr=sr
            )
            for dev in ("cpu", cuda_device)
        ]
        want = spgemm_auto(sr, mats[0], mats[0])
        launches = semiring_matmul.launches
        got = spgemm_auto(sr, mats[1], mats[1])
        if sr is not PLUS_TIMES:
            assert semiring_matmul.launches > launches
        for field in ("rows", "cols", "vals", "nnz"):
            assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field


def _sparse_flat(rng, rows, density, dev):
    """A flat ``[rows, 128]`` float32 view, ``density`` of it nonzero."""
    x = np.where(rng.random((rows, 128)) < density, rng.integers(1, 100, (rows, 128)), 0)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _greedy_flat(dev):
    """Four panels of 32 rows with 3000 / 100 / 3000 / 100 nonzeros."""
    rng = np.random.default_rng(11)
    flat = np.zeros(4 * 4096, np.float32)
    for p, k in enumerate((3000, 100, 3000, 100)):
        flat[p * 4096 + rng.choice(4096, size=k, replace=False)] = rng.integers(1, 100, k)
    return torch.from_numpy(flat.reshape(128, 128)).to(dev)


def _assert_same_pack(got, want):
    gi, gv, gt, ge = got
    wi, wv, wt, we = want
    assert (int(gt), int(ge)) == (int(wt), int(we))
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))  # NaN-safe


def _panels_with_counts(counts, pr, seed, dev):
    """Consecutive panels of ``pr`` flat rows holding ``counts[p]``
    nonzeros each, as a flat ``[R, 128]`` view."""
    rng = np.random.default_rng(seed)
    cells = pr * 128
    flat = np.zeros(len(counts) * cells, np.float32)
    for p, k in enumerate(counts):
        flat[p * cells + rng.choice(cells, size=k, replace=False)] = rng.integers(1, 100, k)
    return torch.from_numpy(flat.reshape(-1, 128)).to(dev)


def _compaction_case(case, dev):
    """``(xf, kwargs)`` of one named compaction case."""
    rng = np.random.default_rng(len(case))
    zero, panel_rows = 0.0, 8192
    if case.startswith("greedy"):
        xf, capacity, panel_rows = _greedy_flat(dev), int(case[10:]), 32
    elif case == "ragged-gcd":  # R = 8000: panels of gcd(8000, 8192) = 64 rows
        xf, capacity = _sparse_flat(rng, 8000, 0.3, dev), 200_000
    elif case == "many-panels":  # 1500 panels of 16 rows, the later ones in part dropped
        xf, capacity, panel_rows = _sparse_flat(rng, 24000, 0.5, dev), 200_000, 16
    elif case == "tall-panel":  # one panel of 4096 tiles
        xf, capacity, panel_rows = _sparse_flat(rng, 32768, 0.1, dev), 500_000, 1 << 15
    elif case == "nan-and-signed-zero":
        xf, capacity = _sparse_flat(rng, 64, 0.5, dev), 8192
        xf[0, :8] = torch.tensor([float("nan"), -0.0] * 4)
    elif case == "inf-zero":
        xf = _sparse_flat(rng, 256, 0.4, dev)
        xf[xf == 0] = float("inf")
        zero, capacity = float("inf"), 10_000
    elif case.startswith("used8-steps"):  # 1024 / 1025 / 1023 / 2048 nonzeros
        xf, panel_rows = _panels_with_counts((1024, 1025, 1023, 2048), 16, 21, dev), 16
        capacity = 5120 if case.endswith("exact") else 1024  # at 1024 the last is dropped
    elif case == "first-overflows":  # the first panel (56 rows) does not fit in 40
        xf, capacity, panel_rows = _panels_with_counts((7000, 100, 1500, 50), 64, 22, dev), 64, 64
    elif case == "last-cell-only":
        xf, capacity, panel_rows = torch.zeros((128, 128), device=dev), 1, 8
        xf[-1, -1] = 7.0
    elif case == "pr8-alternating":  # 64 panels of 8 rows, alternately empty and full
        xf, panel_rows = _panels_with_counts((0, 1024) * 32, 8, 23, dev), 8
        capacity = 32 * 1024
    else:
        raise ValueError(case)
    return xf, dict(zero=zero, capacity=capacity, panel_rows=panel_rows)


COMPACTION_CASES = [
    "greedy-cap64",
    "greedy-cap3100",
    "ragged-gcd",
    "many-panels",
    "tall-panel",
    "nan-and-signed-zero",
    "inf-zero",
    "used8-steps-exact",
    "used8-steps-cap1024",
    "first-overflows",
    "last-cell-only",
    "pr8-alternating",
]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", COMPACTION_CASES)
def test_compaction_kernel_matches_plain_version(case, variant, cuda_device):
    """Each instantiation on each case: the whole idx and vals arrays (vals
    as bits), ``total`` and ``end_row`` equal the plain version's."""
    xf, kw = _compaction_case(case, cuda_device)
    launches = flat_to_tuples_arrays.launches
    got = flat_to_tuples_arrays(xf, variant=variant, **kw)
    torch.cuda.synchronize()
    assert flat_to_tuples_arrays.launches == launches + 1
    assert flat_to_tuples_arrays.last_variant == variant
    _assert_same_pack(got, flat_to_tuples_arrays_reference(xf, **kw))


@pytest.mark.parametrize("variant", VARIANTS)
def test_compaction_at_the_main_path_shape(variant, cuda_device):
    """8192 x 8192 at 20% (the K2 path's accumulator size), exact capacity;
    the default choice there is the single-pass instantiation."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    keep = torch.rand((8192, 8192), generator=g, device=cuda_device) < 0.2
    x = torch.where(keep, torch.randint(1, 100, (8192, 8192), generator=g,
                                        device=cuda_device).float(), 0.0)
    xf = x.view(-1, 128)
    capacity = int(keep.sum())
    got = flat_to_tuples_arrays(xf, capacity=capacity, variant=variant)
    _assert_same_pack(got, flat_to_tuples_arrays_reference(xf, capacity=capacity))
    flat_to_tuples_arrays(xf, capacity=capacity)
    assert flat_to_tuples_arrays.last_variant == "single"


@pytest.mark.parametrize("variant", VARIANTS)
def test_compaction_chunk_prefixes_hit_every_residue(variant, cuda_device):
    """One panel of eight 64-row chunks holding 1, 1, 1, 1, 2, 3, 5, 7
    nonzeros: the chunks' runs start at every residue mod 4 (so each store
    path, aligned quads with partial quads at either end, runs), and
    another panel's runs start after a 7-entry panel."""
    rows = chunk_rows(512)
    counts = (1, 1, 1, 1, 2, 3, 5, 7)
    prefixes = np.cumsum((0,) + counts[:-1])
    assert rows == 64 and set(prefixes % 4) == {0, 1, 2, 3}
    rng = np.random.default_rng(41)
    flat = np.zeros(2 * 512 * 128, np.float32)
    for c, k in enumerate(counts * 2):
        cells = c * rows * 128 + rng.choice(rows * 128, size=k, replace=False)
        flat[cells] = rng.integers(1, 100, k)
    xf = torch.from_numpy(flat.reshape(-1, 128)).to(cuda_device)
    kw = dict(capacity=2 * sum(counts), panel_rows=512)
    got = flat_to_tuples_arrays(xf, variant=variant, **kw)
    _assert_same_pack(got, flat_to_tuples_arrays_reference(xf, **kw))


def test_single_pass_refuses_a_panel_larger_than_the_card_holds(cuda_device):
    """A panel with one chunk more than the card holds blocks: the single
    instantiation is refused and raises (nothing counted, nothing run in
    its place); by default the two-pass one takes it."""
    resident = resident_blocks(cuda_device)
    R = 64 * (resident + 1)  # one panel of resident + 1 chunks of 64 rows
    xf = _sparse_flat(np.random.default_rng(43), R, 0.05, cuda_device)
    kw = dict(capacity=int((xf != 0).sum()), panel_rows=R)
    assert R // chunk_rows(R) == resident + 1
    launches, last = flat_to_tuples_arrays.launches, flat_to_tuples_arrays.last_variant
    with pytest.raises(RuntimeError, match="single"):
        flat_to_tuples_arrays(xf, variant="single", **kw)
    assert (flat_to_tuples_arrays.launches, flat_to_tuples_arrays.last_variant) == (launches, last)
    got = flat_to_tuples_arrays(xf, **kw)
    assert flat_to_tuples_arrays.last_variant == "two_pass"
    _assert_same_pack(got, flat_to_tuples_arrays_reference(xf, **kw))


def test_dense_to_sptuples_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    x = np.where(rng.random((1000, 1024)) < 0.2, rng.integers(1, 9, (1000, 1024)), 0)
    x = torch.from_numpy(x.astype(np.float32))
    for capacity in (1000, 300_000):  # panels dropped; every panel written
        want = dense_to_sptuples(x, 1000, 1024, capacity=capacity, panel_rows=64)
        got = dense_to_sptuples(x.to(cuda_device), 1000, 1024, capacity=capacity, panel_rows=64)
        for field in ("rows", "cols", "vals", "nnz"):
            assert torch.equal(getattr(got[0], field).cpu(), getattr(want[0], field)), field
        assert int(got[1]) == int(want[1])


def test_compaction_kernel_raises_on_what_it_does_not_take(cuda_device):
    x = torch.zeros((64, 128), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        flat_to_tuples_arrays(x.double(), capacity=16)
    with pytest.raises(ValueError, match="contiguous"):
        flat_to_tuples_arrays(torch.zeros((128, 64), device=cuda_device).t(), capacity=16)
    launches = flat_to_tuples_arrays.launches
    for _ in range(3):
        flat_to_tuples_arrays(x, capacity=16)
    assert flat_to_tuples_arrays.launches == launches + 3


@pytest.mark.parametrize("shape, max_k", [((1, 1), None), ((2, 2), 8)],
                         ids=["1x1", "2x2-split-rows"])
def test_bfs_batch_compact_on_card_matches_cpu(shape, max_k, cuda_device):
    """The batched BFS at scale 12 on the card and on the CPU: parents,
    levels, level count, edge counts and validation identical, dense-only
    and with the CSC budgets (a scatter or gather that diverged on CUDA
    would show here)."""
    scale = 12
    n = 1 << scale
    g = build_graph(scale, 16, nroots=32)
    roots = g["roots"].copy()
    roots[5] = PAD_ROOT
    budgets = dict(frontier_capacity=n // 8, edge_capacity=len(g["rows"]) // 4)
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(*shape, device=dev)
        E = EllParMat.from_host_coo(grid, g["rows"], g["cols"],
                                    np.zeros(len(g["rows"]), np.int8), n, n, max_k=max_k)
        csc = build_csc_companion(grid, g["rows"], g["cols"], n, n)
        deg = DistVec.from_global(grid, g["deg"], align="row").blocks
        dense = bfs_batch_compact(E, roots)
        diropt = bfs_batch_compact(E, roots, csc=csc, **budgets)
        steps = bfs_batch_compact.last_run["steps"]
        assert {"sparse", "dense"} == set(steps)
        for a, b in zip(dense[:2], diropt[:2]):
            assert torch.equal(a.blocks, b.blocks)
        assert dense[2] == diropt[2]
        lanes = lambda mv: DistMultiVec(blocks=mv.blocks[:, :, :4].to(torch.int32), length=n,
                                        align="row", grid=grid)
        viol = validate_bfs_device(E, lanes(dense[0]), lanes(dense[1]))
        assert not viol.any()
        out.append((dense[0].blocks.cpu(), dense[1].blocks.cpu(), dense[2], steps,
                         batch_traversed_edges(deg, dense[0]).cpu(), viol.cpu()))
    cpu, card = out
    for a, b in zip(cpu, card):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert (cpu[4] > 0).sum() == 31  # every live root reaches an edge


SINGLE_TIERS = {
    "dense": "",
    "mixed": "td:4,2,1,0,0,0|bu:2048,64,8,0,0,0|td:256,128,32,4,0,0",
    "default": DEFAULT_SEQ_TIERS,
}


@pytest.mark.parametrize("tiers", list(SINGLE_TIERS))
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_bfs_single_on_card_matches_cpu(shape, tiers, cuda_device):
    """The single-root search at scale 12, degree fallbacks on: parents,
    levels, level count, the step of each level, the readbacks and the
    edge count identical on the card and on the CPU."""
    scale = 12
    n = 1 << scale
    g = build_graph(scale, 16, nroots=4)
    spec = parse_tier_spec(SINGLE_TIERS[tiers])
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(*shape, device=dev)
        E = EllParMat.from_host_coo(grid, g["rows"], g["cols"],
                                    np.zeros(len(g["rows"]), np.int8), n, n)
        csc = build_csc_companion(grid, g["rows"], g["cols"], n, n)
        csr = build_csr_companion(grid, g["rows"], g["cols"], n, n)
        deg = DistVec.from_global(grid, g["deg"], align="row").blocks
        runs = []
        for root in g["roots"]:
            p, lv, it = bfs_single(E, int(root), csc, csr=csr, tiers=spec)
            runs.append((p.blocks.cpu(), lv.blocks.cpu(), it, bfs_single.last_run,
                         int(single_traversed_edges(deg, p))))
        out.append(runs)
    for cpu, card in zip(*out):
        assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[1], card[1])
        assert cpu[2:] == card[2:]
    if tiers != "dense":  # walks ran, and more than one kind of step
        kinds = {st[:2] for run in out[1] for st in run[3]["steps"]}
        assert "td" in kinds and len(kinds) > 1, kinds


@pytest.mark.parametrize("shape, max_k", [((1, 1), None), ((2, 2), 8)],
                         ids=["1x1", "2x2-split-rows"])
def test_bfs_batch_and_sssp_batch_on_card_match_cpu(shape, max_k, cuda_device):
    """``bfs_batch`` (with and without levels) and ``sssp_batch`` at scale
    12, with a PAD_ROOT lane: identical on the card and on the CPU, and the
    batch's lanes equal to ``bfs_batch_compact``'s."""
    scale = 12
    n = 1 << scale
    g = build_graph(scale, 16, nroots=16)
    roots = g["roots"].copy()
    roots[3] = PAD_ROOT
    w = np.random.default_rng(1).integers(1, 10, len(g["rows"])).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(*shape, device=dev)
        E = EllParMat.from_host_coo(grid, g["rows"], g["cols"],
                                    np.zeros(len(g["rows"]), np.int8), n, n, max_k=max_k)
        Ew = EllParMat.from_host_coo(grid, g["rows"], g["cols"], w, n, n, max_k=max_k)
        p, lv, it = bfs_batch(E, roots)
        cp, cl, cit = bfs_batch_compact(E, roots)
        assert torch.equal(p.blocks, cp.blocks) and torch.equal(lv.blocks, cl.blocks.int())
        assert it == cit
        p2, ind, it2 = bfs_batch(E, roots, track_levels=False)
        d, dit = sssp_batch(Ew, roots)
        out.append([p.blocks.cpu(), lv.blocks.cpu(), it, p2.blocks.cpu(), ind.blocks.cpu(), it2,
                    d.blocks.cpu(), dit])
    for a, b in zip(*out):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


BOR = Semiring(name="bitor_and", add=torch.bitwise_or, mul=torch.bitwise_and,
               zero_fn=lambda dt: 0, add_kind="generic")
SPMV_CASES = [("plus_times-int", PLUS_TIMES), ("plus_times-float", PLUS_TIMES),
              ("min_plus", MIN_PLUS), ("max_min", MAX_MIN), ("select2nd_max", SELECT2ND_MAX),
              ("generic", BOR)]


@pytest.mark.parametrize("case, sr", SPMV_CASES, ids=[c for c, _ in SPMV_CASES])
def test_spmv_forms_on_card_match_cpu(case, sr, cuda_device):
    """The four ``dist_spmv_ell*`` forms on a 2×2 grid with split rows:
    exact on the card against the CPU, but ``plus_times`` on non-integer
    data within ``rtol=1e-5, atol=1e-6``."""
    n, W = 3000, 16
    rng = np.random.default_rng(4)
    r = rng.integers(0, n, 40000)
    c = np.minimum(rng.zipf(1.6, 40000), n) - 1  # a few heavy columns
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    if case == "plus_times-float":
        vals, x, X = (rng.uniform(-1, 1, s).astype(np.float32) for s in (len(r), n, (n, W)))
    elif case == "select2nd_max":
        vals = np.ones(len(r), np.float32)
        x, X = (rng.integers(-1, n, s).astype(np.int32) for s in (n, (n, W)))
    elif case == "generic":
        vals, x, X = (rng.integers(0, 2**31 - 1, s).astype(np.int32)
                      for s in (len(r), n, (n, W)))
    else:
        vals, x, X = (rng.integers(-8, 9, s).astype(np.float32) for s in (len(r), n, (n, W)))
        if case != "plus_times-int":  # the identities and signed zeros too
            x[rng.random(n) < 0.05] = np.inf if case == "min_plus" else -np.inf
            x[rng.random(n) < 0.05] = -0.0
    act, act2 = rng.random(n) < 0.7, rng.random((n, W)) < 0.7
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(2, 2, device=dev)
        E = EllParMat.from_host_coo(grid, r, c, vals, n, n, max_k=16)
        xv, av = DistVec.from_global(grid, x), DistVec.from_global(grid, act, align="row")
        Xv = DistMultiVec.from_global(grid, X)
        Av = DistMultiVec.from_global(grid, act2, align="row")
        out.append([dist_spmv_ell(sr, E, xv).blocks.cpu(),
                    dist_spmv_ell_masked(sr, E, xv, av).blocks.cpu(),
                    dist_spmv_ell_multi(sr, E, Xv).blocks.cpu(),
                    dist_spmv_ell_masked_multi(sr, E, Xv, Av).blocks.cpu()])
    for a, b in zip(*out):
        if case == "plus_times-float":
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
            if a.is_floating_point():
                assert torch.equal(torch.signbit(a), torch.signbit(b))


# --- the SpParMat path: SpMV layer, op pack, apps --------------------------

def _graph_case(scale=11, seed=3):
    """A symmetric R-MAT-like graph with hubs, sorted and without
    duplicates or loops: (n, rows, cols)."""
    g = build_graph(scale, 16, nroots=4)
    return 1 << scale, g["rows"].astype(np.int64), g["cols"].astype(np.int64), g["roots"]


def _same(a, b, tol=False):
    a, b = a.cpu(), b.cpu()
    if tol:
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        assert torch.equal(a.isnan(), b.isnan())
        keep = ~a.isnan()
        assert torch.equal(a[keep], b[keep])
        assert torch.equal(torch.signbit(a[keep]), torch.signbit(b[keep]))
    else:
        assert torch.equal(a, b)


SP_CASES = [("plus_times-int", PLUS_TIMES), ("plus_times-float", PLUS_TIMES),
            ("min_plus", MIN_PLUS), ("max_min", MAX_MIN), ("select2nd_max", SELECT2ND_MAX),
            ("select2nd_min", SELECT2ND_MIN)]


@pytest.mark.parametrize("case, sr", SP_CASES, ids=[c for c, _ in SP_CASES])
def test_spparmat_spmv_layer_on_card_matches_cpu(case, sr, cuda_device):
    """The local kernels and the four distributed forms over a 2×2 grid:
    exact on the card against the CPU, but ``plus_times`` on non-integer
    data: per row within 2 · len · 2**-24 · Σ|a||x| of each other (two
    float32 sums of ``len`` terms in any order; rows here reach hundreds of
    entries)."""
    n, r, c, _ = _graph_case()
    rng = np.random.default_rng(5)
    if case == "plus_times-float":
        vals, x = rng.uniform(-1, 1, len(r)).astype(np.float32), rng.uniform(-1, 1, n)
        x = x.astype(np.float32)
    elif case.startswith("select2nd"):
        vals = np.ones(len(r), np.float32)
        x = np.where(rng.random(n) < 0.3, np.arange(n), -1).astype(np.int32)
    else:
        vals = rng.integers(-8, 9, len(r)).astype(np.float32)
        x = rng.integers(-8, 9, n).astype(np.float32)
        if case != "plus_times-int":
            x[rng.random(n) < 0.05] = -0.0
    act, unv = rng.random(n) < 0.2, rng.random(n) < 0.7
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(2, 2, device=dev)
        A = SpParMat.from_global_coo(grid, r, c, vals, n, n)
        t = A.local_tile(0, 0)
        csc = CSC.from_tuples(t)
        xv = DistVec.from_global(grid, x)
        av, uv = DistVec.from_global(grid, act), DistVec.from_global(grid, unv, align="row")
        xb = xv.blocks[0]
        sel = torch.nonzero(av.blocks[0]).squeeze(1).to(torch.int32)
        y, ya, ynnz = dist_spmspv(sr, A, xv, av)
        out.append([spmv(sr, t, xb), spmspv_dense_out(sr, csc, sel, xb[sel], exp_capacity=999),
                    *spmspv(sr, csc, sel, xb[sel], torch.tensor(0), out_capacity=300)[:2],
                    dist_spmv(sr, A, xv).blocks, dist_spmv_masked(sr, A, xv, uv).blocks,
                    y.blocks, ya.blocks, ynnz,
                    dist_spmspv_masked(sr, A, xv, av, uv, frontier_capacity=100,
                                       exp_capacity=5000).blocks])
    if case != "plus_times-float":
        for a, b in zip(*out):
            _same(a, b)
        return
    grid = Grid.make(2, 2, device="cpu")
    A = SpParMat.from_global_coo(grid, r, c, np.abs(vals), n, n)
    row_abs = dist_spmv(PLUS_TIMES, A, DistVec.from_global(grid, np.abs(x))).blocks
    row_len = A.reduce(PLUS_TIMES, "cols", map_fn=ones_i32).blocks
    tol = (2 * row_len * 2.0**-24 * row_abs).double()
    for a, b in zip(*out):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        if not a.is_floating_point():
            assert torch.equal(a, b)
            continue
        bound = tol if a.shape == tol.shape else tol[0] if a.shape == tol[0].shape else tol.max()
        assert ((a.double() - b.double()).abs() <= bound).all()


def test_spparmat_ops_on_card_match_cpu(cuda_device):
    """apply, prune, the triangles, reduce on both axes, transpose,
    dim_apply, to_dense and CSC/CSR on a 2×2 grid: exact."""
    n, r, c, _ = _graph_case(10)
    v = np.random.default_rng(6).integers(-5, 6, len(r)).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(2, 2, device=dev)
        A = SpParMat.from_global_coo(grid, r, c, v, n, n)
        s = DistVec.from_global(grid, np.arange(n, dtype=np.float32) % 7, align="row")
        mats = [A.apply(lambda x: x * 2), A.prune(lambda x: x < 0), A.tril(), A.triu(False),
                A.remove_loops(), A.transpose(), A.dim_apply(s, torch.mul, "cols"),
                A.dim_apply(s, torch.sub, "rows")]
        vecs = [A.reduce(sr, ax, map_fn=f).blocks for sr in (PLUS_TIMES, MIN_PLUS, MAX_MIN)
                for ax in ("rows", "cols") for f in (None, ones_i32)]
        t = A.local_tile(1, 0)
        comp = [CSC.from_tuples(t), CSR.from_tuples(t)]
        out.append([x for m in mats for x in (m.rows, m.cols, m.vals, m.nnz)] + vecs
                   + [t.to_dense(), t.to_dense(MIN_PLUS)]
                   + [x for cm in comp for x in (cm.indptr, cm.indices, cm.vals)])
    for a, b in zip(*out):
        _same(a, b)


def test_distvec_op_pack_on_card_matches_cpu(cuda_device):
    """Every op of the pack but randperm exact on the card against the CPU
    (a 2×4 grid, floats with ±0 and NaN); randperm a permutation with the
    padding last, from a generator on the card."""
    rng = np.random.default_rng(7)
    n = 5000
    f = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -1.5, 2.5, 3.0], np.float32), n)
    iv = rng.integers(-3, n + 3, n).astype(np.int32)
    act = rng.random(n) < 0.6
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(2, 4, device=dev)
        fv, ix = DistVec.from_global(grid, f), DistVec.from_global(grid, iv, align="row")
        av = DistVec.from_global(grid, act)
        base = DistVec.from_global(grid, np.full(n, 10**6, np.int32))
        src = DistVec.from_global(grid, np.arange(n, dtype=np.int32), align="row")
        sv, si = fv.sort()
        inds, cnt = ix.find_inds(lambda b: b > 100)
        out.append([fv.gather(ix).blocks, base.scatter_combine(SELECT2ND_MIN, ix, src).blocks,
                    fv.reduce(MIN_PLUS), fv.reduce(MAX_MIN), ix.reduce(PLUS_TIMES), sv.blocks,
                    si.blocks, inds.blocks, cnt, ix.invert(av.realign("row"), n, SELECT2ND_MIN)
                    .blocks, fv.uniq(av).blocks, fv.mask_padding(7.0).blocks,
                    concatenate([fv, DistVec.from_global(Grid.make(1, 1, device=dev), f[:9])])
                    .blocks])
    for a, b in zip(*out):
        _same(a, b)
    grid = Grid.make(2, 2, device=cuda_device)
    p = DistVec.randperm(grid, 1001, torch.Generator(device=cuda_device).manual_seed(3))
    flat = p.blocks.reshape(-1).cpu().numpy()
    assert p.blocks.device.type == "cuda"
    np.testing.assert_array_equal(np.sort(flat[:1001]), np.arange(1001))
    np.testing.assert_array_equal(flat[1001:], np.arange(1001, flat.shape[0]))


def test_default_generator_draws_on_the_card(cuda_device, monkeypatch):
    """Without a generator, randperm and mis draw with the card's default
    generator: every torch.randperm call they make is on the card, and so
    is what they return."""
    devices = []
    randperm = torch.randperm

    def spy(*args, **kwargs):
        out = randperm(*args, **kwargs)
        devices.append(out.device.type)
        return out

    monkeypatch.setattr(torch, "randperm", spy)
    grid = Grid.make(2, 2, device=cuda_device)
    p = DistVec.randperm(grid, 1001)
    flat = p.blocks.reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(np.sort(flat[:1001]), np.arange(1001))
    n, r, c, _ = _graph_case(9)
    A = SpParMat.from_global_coo(grid, r, c, np.ones(len(r), np.float32), n, n)
    st, rounds = mis(A)
    sg = st.to_global()
    members = np.flatnonzero(sg == 1)
    assert rounds > 0 and not (np.isin(r, members) & np.isin(c, members)).any()
    assert devices == ["cuda", "cuda"]
    assert p.blocks.device.type == "cuda" and st.blocks.device.type == "cuda"


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_spparmat_apps_on_card_match_cpu(shape, cuda_device):
    """bfs, bfs_diropt (both steps), bfs_diropt_auto, traversed_edges,
    sssp, FastSV, LACC and mis's rounds (the same priorities) exact on the
    card against the CPU; pagerank and pagerank_batch within float32
    rounding, with equal rounds; the public mis independent and maximal."""
    n, r, c, roots = _graph_case(11)
    w = np.random.default_rng(8).integers(1, 10, len(r)).astype(np.float32)
    rank_vals = None
    out, ranks = [], []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(*shape, device=dev)
        A = SpParMat.from_global_coo(grid, r, c, np.ones(len(r), np.float32), n, n)
        Aw = SpParMat.from_global_coo(grid, r, c, w, n, n)
        root = int(roots[0])
        p, lv, it = bfs(A, root)
        pd_, ld, itd = bfs_diropt(A, root, frontier_capacity=n // 16, exp_capacity=len(r) // 8)
        steps = set(bfs_diropt.last_run["steps"])
        pa, la, ita = bfs_diropt_auto(A, root)
        d, dit = sssp(Aw, root)
        f1, i1 = connected_components(A)
        f2, i2 = lacc(A)
        prio = torch.from_numpy(
            np.random.default_rng(9).permutation(f1.blocks.numel()).astype(np.int32)
        ).view(f1.blocks.shape).to(dev)
        s, si = mis_mod._mis_rounds(A, prio)
        out.append([p.blocks, lv.blocks, pd_.blocks, ld.blocks, pa.blocks, la.blocks,
                    traversed_edges(A, p), d.blocks, f1.blocks, f2.blocks, s.blocks,
                    (it, itd, ita, dit, i1, i2, si), steps])
        if rank_vals is None:
            outdeg = np.bincount(c, minlength=n).astype(np.float32)
            rank_vals = (1.0 / outdeg[c]).astype(np.float32)
        x, xi = pagerank(A)
        E = EllParMat.from_host_coo(grid, r, c, rank_vals, n, n)
        dang = DistVec.from_global(grid, np.zeros(n, np.float32))
        X, Xi = pagerank_batch(E, np.array([root, PAD_ROOT, int(roots[1])], np.int32), dang)
        ranks.append((x.blocks, xi, X.blocks, Xi))
        st, _ = mis(A, torch.Generator(device=dev).manual_seed(4))
        sg = st.to_global()
        members = np.flatnonzero(sg == 1)
        inside = np.isin(r, members) & np.isin(c, members)
        assert not inside.any()  # independent
        covered = np.zeros(n, bool)
        covered[r[np.isin(c, members)]] = True
        assert covered[sg == -1].all()  # maximal
    for a, b in zip(*out):
        if isinstance(a, torch.Tensor):
            _same(a, b)
        else:
            assert a == b
    assert {"td", "bu"} <= out[0][-1]
    (x0, i0, X0, I0), (x1, i1, X1, I1) = ranks
    assert i0 == i1 and I0 == I1
    torch.testing.assert_close(x1.cpu(), x0, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(X1.cpu(), X0, rtol=1e-4, atol=1e-7)


# --- the general SpGEMM, the elementwise layer, TC and BC -----------------------

from combblas_tpu_torch import (  # noqa: E402
    DenseParMat,
    SpTuples,
    bc_batch,
    bc_batch_dense_lanes,
    block_spgemm,
    choose_spgemm_tier,
    ewise_apply,
    ewise_mult,
    intersect_lookup,
    mem_efficient_spgemm,
    pack_support_bits,
    popcount32,
    popcount_pair_counts,
    spasgn,
    spgemm,
    spgemm_scan,
    spgemm_support_bits,
    subsref,
    summa_spgemm,
    summa_stage_flops,
    triangle_count,
)
from combblas_tpu_torch.models import tc as tc_mod  # noqa: E402
from combblas_tpu_torch.parallel.spmat import monotone_key_u32  # noqa: E402


def _mat_fields(M):
    return [M.rows, M.cols, M.vals, M.nnz]


def _esc_graph(seed=4):
    """A scale-9 R-MAT graph, its COO with repeats, integer weights 1..15."""
    r, c = rmat_symmetric_coo_host(seed, 9, 8)
    v = np.random.default_rng(seed).integers(1, 16, len(r)).astype(np.float32)
    return 1 << 9, r, c, v


@pytest.mark.parametrize("p", [1, 2])
def test_esc_and_scan_tiers_on_card_match_cpu(p, cuda_device):
    """The symbolic pass, spgemm (sort, runs, ring), spgemm_scan with a
    retry, mem_efficient_spgemm and block_spgemm for min_plus, max_min and
    plus_times on integer weights: exact on the card against the CPU."""
    n, r, c, v = _esc_graph()
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(p, p, device=dev)
        A = SpParMat.from_global_coo(grid, r, c, v, n, n)
        res = [summa_stage_flops(A, A), summa_stage_flops(A, A, padded=False)]
        for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
            res += _mat_fields(spgemm(sr, A, A))
            fc, oc = spgemm.last_capacities
            res += _mat_fields(summa_spgemm(sr, A, A, flop_capacity=fc, out_capacity=oc,
                                            merge="runs", ring=True))
            res += _mat_fields(spgemm_scan(sr, A, A, out_capacity=256))
            res += _mat_fields(mem_efficient_spgemm(sr, A, A, 4))
        for _, C in block_spgemm(MIN_PLUS, A, A, 2, 2):
            res += _mat_fields(C)
        res.append(choose_spgemm_tier(MIN_PLUS, A, A))
        out.append(res)
    for a, b in zip(*out):
        if isinstance(a, torch.Tensor):
            _same(a, b)
        else:
            assert a == b


def test_ewise_layer_on_card_matches_cpu(cuda_device):
    """ops.ewise and the SpParMat elementwise, select and split family on
    a 2×2 grid, kselect on floats with ±0, NaN and ±inf: exact."""
    rng = np.random.default_rng(5)
    n = 96
    da, db = rng.random((n, n)) < 0.2, rng.random((n, n)) < 0.2
    ra, ca = np.nonzero(da)
    rb, cb = np.nonzero(db)
    va = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.0, 3.0],
                             np.float32), len(ra))
    vb = rng.integers(-5, 6, len(rb)).astype(np.float32)
    kv = rng.integers(1, 6, n).astype(np.int32)
    out = []
    for dev in ("cpu", cuda_device):
        ta = SpTuples.from_coo(ra, ca, va, n, n, len(ra) + 3, device=dev)
        tb = SpTuples.from_coo(rb, cb, vb, n, n, len(rb) + 5, device=dev)
        res = list(intersect_lookup(ta, tb, -1.0))
        for t in (ewise_mult(ta, tb, False, torch.add), ewise_mult(ta, tb, True),
                  ewise_apply(ta, tb, torch.sub, allow_a_nulls=True, allow_b_nulls=True,
                              a_null=2.0, b_null=-3.0)):
            res += [t.rows, t.cols, t.vals, t.nnz]
        grid = Grid.make(2, 2, device=dev)
        A = SpParMat.from_global_coo(grid, ra, ca, va, n, n, capacity=900)
        B = SpParMat.from_global_coo(grid, rb, cb, vb, n, n, capacity=900)
        th = A.kselect(3)
        for M in (A.ewise_mult(B), A.ewise_mult(B, negate=True), A.ewise_add(B, MIN_PLUS),
                  A.ewise_apply(B, torch.mul, allow_b_nulls=True, b_null=4.0),
                  A.add_loops(7.0), A.prune_column(th, lambda x, t: x >= t),
                  A.prune_rowcol(DistVec.from_global(grid, kv.astype(np.float32), align="row"),
                                 DistVec.from_global(grid, kv.astype(np.float32)),
                                 lambda x, rr, cc: x > rr - cc),
                  A.with_capacity(1000), A.shrink_to_fit(), *A.col_split(3), *A.row_split(2),
                  SpParMat.col_concatenate(A.col_split(4))):
            res += _mat_fields(M)
        th2, act = A.kselect2(4)
        res += [th.blocks, th2.blocks, act, A.nnz_per_column().blocks,
                A.kselect(DistVec.from_global(grid, kv)).blocks,
                monotone_key_u32(torch.from_numpy(va).to(dev))]
        out.append(res)
    for a, b in zip(*out):
        _same(a, b)


def test_popcount_and_support_bits_on_card_match_cpu(cuda_device):
    """popcount32 on words with bit 31 set against numpy; the packed
    support words, the pair counts (hi, lo) and the support oracle on the
    card against the CPU."""
    rng = np.random.default_rng(6)
    w = rng.integers(-2**31, 2**31, 1 << 16, dtype=np.int64).astype(np.int32)
    w[:3] = [-1, -2**31, 2**31 - 1]
    want = np.array([bin(int(x) & 0xFFFFFFFF).count("1") for x in w], np.int32)
    got = popcount32(torch.from_numpy(w).to(cuda_device))
    assert got.device.type == cuda_device.type
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    n, r, c, v = _esc_graph(7)
    ii = rng.integers(0, n, 20000).astype(np.int32)
    jj = rng.integers(0, n, 20000).astype(np.int32)
    ww = rng.integers(0, 3, 20000).astype(np.int32)
    out = []
    for dev in ("cpu", cuda_device):
        rt, ct = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (r, c))
        bits = pack_support_bits(rt, ct, n, n)
        hilo = popcount_pair_counts(bits, bits, *(torch.from_numpy(x).to(dev)
                                                  for x in (ii, jj, ww)))
        a = SpTuples.from_coo(r[::2], c[::2], v[::2], n, n, device=dev)
        b = SpTuples.from_coo(c[1::2], r[1::2], v[1::2], n, n, device=dev)
        out.append([bits, hilo, *spgemm_support_bits(a, b, row_block=200)])
    for a, b in zip(*out):
        _same(a, b)


def test_indexing_on_card_matches_cpu(cuda_device):
    n, r, c, v = _esc_graph(8)
    rng = np.random.default_rng(8)
    ri, ci = rng.integers(0, n, 200), rng.permutation(n)[:150]
    ri2 = rng.permutation(n)[:20]
    out = []
    for dev in ("cpu", cuda_device):
        grid = Grid.make(2, 2, device=dev)
        A = SpParMat.from_global_coo(grid, r, c, v, n, n, dedup_sr=PLUS_TIMES)
        B = SpParMat.from_global_coo(grid, np.arange(20), np.arange(20) % 150,
                                     np.full(20, 9.0, np.float32), 20, 150)
        out.append(_mat_fields(subsref(A, ri, ci)) + _mat_fields(spasgn(A, ri2, ci, B)))
    for a, b in zip(*out):
        _same(a, b)


def test_triangle_counting_on_card_matches_cpu(cuda_device):
    """Every TC kernel's (hi, lo) split and count on the card against the
    CPU: one tile (dense, bit and bf16 edge harvest, sparse) and 2×2
    (distributed harvest, sparse), on a COO with repeats."""
    g = build_graph(10, 16, nroots=1)
    n, r, c = 1 << 10, g["rows"], g["cols"]
    rr, cc = np.concatenate([r, r[:50]]), np.concatenate([c, c[:50]])  # repeats
    out = []
    for dev in ("cpu", cuda_device):
        one = SpParMat.from_global_coo(Grid.make(1, 1, device=dev), rr, cc,
                                       np.ones(len(rr), np.float32), n, n)
        t = one.local_tile(0, 0)
        uniq = SpParMat.from_global_coo(Grid.make(2, 2, device=dev), r, c,
                                        np.ones(len(r), np.float32), n, n)
        two = SpParMat.from_global_coo(Grid.make(2, 2, device=dev), rr, cc,
                                       np.ones(len(rr), np.float32), n, n)
        out.append([tc_mod._tc_dense(t.rows, t.cols, n), tc_mod._tc_edge_harvest(t.rows, t.cols, n),
                    tc_mod._tc_edge_harvest_bits(t.rows, t.cols, n),
                    tc_mod._tc_edge_harvest_dist(two), triangle_count(uniq, "sparse"),
                    triangle_count(one, "edgeharvest"), triangle_count(two)])
    for a, b in zip(*out):
        if isinstance(a, torch.Tensor):
            _same(a, b)
        else:
            assert a == b


def test_betweenness_and_denseparmat_on_card_match_cpu(cuda_device):
    """bc_batch on 2×2 and bc_batch_dense_lanes on 1×1 within rtol 1e-5
    (float sums in another order); DenseParMat's ops exact."""
    n, r, c, _ = _graph_case(9)
    roots = np.array([0, 5, 17, PAD_ROOT], np.int32)
    live = roots[roots != PAD_ROOT]
    out, dense = [], []
    for dev in ("cpu", cuda_device):
        A = SpParMat.from_global_coo(Grid.make(2, 2, device=dev), r, c,
                                     np.ones(len(r), np.float32), n, n)
        E = EllParMat.from_host_coo(Grid.make(1, 1, device=dev), r, c,
                                    np.ones(len(r), np.float32), n, n)
        out.append([bc_batch(A, live).blocks, bc_batch_dense_lanes(E, E, roots).blocks])
        D = DenseParMat.from_global(Grid.make(2, 2, device=dev),
                                    np.arange(n * 3, dtype=np.float32).reshape(n, 3) % 5)
        S = SpParMat.from_global_coo(Grid.make(2, 2, device=dev), r[:300] % n, c[:300] % 3,
                                     np.ones(300, np.float32), n, 3)
        dense += [D.add_spmat(S).blocks, D.add_spmat(S, torch.maximum).blocks,
                  *_mat_fields(D.filter_spmat(S, lambda s, d: d < 2)),
                  *_mat_fields(D.scale_spmat(S, torch.mul)),
                  D.reduce(PLUS_TIMES, "rows").blocks, D.reduce(MIN_PLUS, "cols").blocks]
    for a, b in zip(*out):
        scale = float(a.abs().max())
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-6 * scale)
    half = len(dense) // 2
    for a, b in zip(dense[:half], dense[half:]):
        _same(a, b)


# --- the windowed tier and semantic.py -------------------------------------------

from combblas_tpu_torch import (  # noqa: E402
    SemanticGraph,
    densify_combine,
    filtered_bfs,
    spgemm_windowed,
    summa_rowblock_flops_pair,
    summa_window_flops_pair,
    support_window_counts,
)


@pytest.mark.parametrize("p", [1, 2])
def test_windowed_dot_on_card_matches_cpu(p, cuda_device):
    """The dot backend on the card gives the CPU path's arrays for min_plus,
    max_min and plus_times (gathered, and on 2×2 the carousel); K1 runs
    once a tile, stage and live window, as the plan counts."""
    n, r, c, v = _esc_graph()
    kw = dict(backend="dot", block_rows=64, block_cols=128)
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        mats = [SpParMat.from_global_coo(Grid.make(p, p, device=dev), r, c, v, n, n)
                for dev in ("cpu", cuda_device)]
        for ring in ((False, True) if p == 2 else (False,)):
            want = spgemm_windowed(sr, mats[0], mats[0], ring=ring, **kw)
            before = semiring_matmul.launches
            got = spgemm_windowed(sr, mats[1], mats[1], ring=ring, **kw)
            packed = spgemm_windowed.last_plan["packed"]
            launched = semiring_matmul.launches - before
            assert launched == (0 if sr is PLUS_TIMES else p ** 3 * packed)
            for a, b in zip(_mat_fields(want), _mat_fields(got)):
                _same(a, b)


@pytest.mark.parametrize("p", [1, 2])
def test_windowed_scatter_on_card_matches_cpu_and_esc(p, cuda_device):
    """The scatter backend on the card (local, blocked, fused, carousel)
    gives the CPU path's arrays, and the ESC tier's live entries; K1 never
    runs."""
    n, r, c, v = _esc_graph(5)
    forms = [{}] if p == 1 else [{}, {"dispatch": "fused"}, {"ring": True}]
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        mats = [SpParMat.from_global_coo(Grid.make(p, p, device=dev), r, c, v, n, n)
                for dev in ("cpu", cuda_device)]
        esc = spgemm(sr, mats[1], mats[1]).to_global_coo()
        order = np.lexsort((esc[1], esc[0]))
        for kw in forms:
            want = spgemm_windowed(sr, mats[0], mats[0], block_rows=48, **kw)
            before = semiring_matmul.launches
            got = spgemm_windowed(sr, mats[1], mats[1], block_rows=48, **kw)
            assert semiring_matmul.launches == before
            for a, b in zip(_mat_fields(want), _mat_fields(got)):
                _same(a, b)
            gr, gc, gv = got.to_global_coo()
            o = np.lexsort((gc, gr))
            for x, y in zip((gr[o], gc[o], gv[o]), (esc[0][order], esc[1][order],
                                                    esc[2][order])):
                np.testing.assert_array_equal(x, y)


def test_windowed_folds_and_plans_on_card_match_cpu(cuda_device):
    """densify_combine on ±0, NaN and ±inf (the scatter folds on integer
    keys), the symbolic passes and the oracle's window counts: exact on
    the card against the CPU."""
    rng = np.random.default_rng(8)
    n, r, c, v = _esc_graph(6)
    vs = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.0], np.float32),
                    len(r))
    out = []
    for dev in ("cpu", cuda_device):
        t = SpTuples.from_coo(r, c, vs, n, n, len(r) + 9, device=dev)
        res = [densify_combine(sr, t, n, n) for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES)]
        A = SpParMat.from_global_coo(Grid.make(2, 2, device=dev), r, c, v, n, n)
        res += [summa_rowblock_flops_pair(A, A, 48, 8), summa_window_flops_pair(A, A, 48, 64, 8)]
        bits, _ = spgemm_support_bits(t, t)
        res.append(support_window_counts(bits, 48, 64, n, n))
        out.append(res)
    for a, b in zip(*out):
        _same(a, b)


def test_filtered_bfs_on_card_matches_cpu(cuda_device):
    """filtered_bfs in both modes on a 2×2 grid: parents and levels exact."""
    n, r, c, _ = _esc_graph(7)
    attr = ((r * 131 + c * 17) % 100 + (c * 131 + r * 17) % 100).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        g = SemanticGraph.from_edges(Grid.make(2, 2, device=dev), r, c, {"w": attr}, n, n)
        for materialize in (True, False):
            p_, l_, it = filtered_bfs(g, lambda a: a["w"] < 100, 0, materialize=materialize)
            out.append((p_.blocks, l_.blocks, it))
    for (pa, la, ia), (pb, lb, ib) in zip(out[:2], out[2:]):
        _same(pa, pb)
        _same(la, lb)
        assert ia == ib


# --- the applications: MCL, matchings, orderings, SpMM ---------------------------------


def _ring_of_cliques(k=4, size=6, w=0.1):
    n = k * size
    d = np.zeros((n, n), np.float32)
    for b in range(k):
        d[b * size:(b + 1) * size, b * size:(b + 1) * size] = 1
    np.fill_diagonal(d, 0)
    for b in range(k):
        i, j = b * size + size - 1, ((b + 1) % k) * size
        d[i, j] = d[j, i] = w
    return d


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
def test_dense_mcl_iterations_on_card_match_cpu(mode, cuda_device):
    """Three iterations of the dense program: the state within 1e-6 of the
    CPU's (TF32 off; the card sums in another order), the iteration and
    kick counts equal; and the whole dense clustering gives the CPU's
    labels."""
    d = _ring_of_cliques()
    a = d + np.eye(len(d), dtype=np.float32)
    a = (a / a.sum(axis=0, keepdims=True)).astype(np.float32)
    r, c = np.nonzero(a)
    outs = []
    for dev in ("cpu", cuda_device):
        run = mcl_mod.dense_mcl_program(24, 128, 2.0, 0.0, 3, hard=1e-4, select=24, recover=24,
                                        rpct=0.9, mode=mode, perturb_delta=5e-5)
        m, it, ch, _, kicks = run(*(torch.from_numpy(x).to(dev) for x in
                                    (r.astype(np.int32), c.astype(np.int32), a[r, c])))
        outs.append((m.cpu(), it, kicks))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-6, rtol=0)
    assert outs[0][1:] == outs[1][1:]
    labs = [mcl(SpParMat.from_dense(Grid.make(1, 1, device=dev), d), expansion="dense",
                dense_mode=mode)[0].blocks.cpu() for dev in ("cpu", cuda_device)]
    assert torch.equal(labs[0], labs[1])


@pytest.mark.parametrize("kw", [{}, {"phases": 2}, {"scan": True}, {"chaos_every": 2}],
                         ids=["sparse", "phases2", "scan", "block2"])
def test_sparse_mcl_on_card_matches_cpu(kw, cuda_device):
    """MCL's sparse and block loops on a 2×2 grid: the card gives the CPU's
    labels and iteration count."""
    d = _ring_of_cliques()
    out = []
    for dev in ("cpu", cuda_device):
        lab, it, ch = mcl(SpParMat.from_dense(Grid.make(2, 2, device=dev), d), **kw)
        out.append((lab.blocks.cpu(), it))
        assert ch < 1e-3
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


def test_matchings_on_card_match_cpu(cuda_device):
    """maximal (both rules, weighted), one _mcm_phase, maximum (device and
    host) and AWPM on a 2×2 grid: mates exact."""
    rng = np.random.default_rng(3)
    d = ((rng.random((30, 26)) < 0.12) * (rng.permutation(780).reshape(30, 26) + 1.0)
         ).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        A = SpParMat.from_dense(Grid.make(2, 2, device=dev), d)
        res = [maximal_matching(A, karp_sipser=ks, weighted=w)
               for ks, w in ((False, False), (True, False), (True, True))]
        AT = A.transpose().apply(ones_f32)
        mr, mc, n_aug = matching_mod._mcm_phase(AT, *res[0])
        res += [(mr, mc), maximum_matching(A), maximum_matching(A, device=False), awpm(A)]
        out.append([(x.blocks.cpu(), y.blocks.cpu()) for x, y in res] + [int(n_aug)])
    for a, b in zip(out[0][:-1], out[1][:-1]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert out[0][-1] == out[1][-1]


def test_orderings_on_card_match_cpu(cuda_device):
    """rcm_ordering (probe and root 0) and minimum_degree_ordering: the
    card's permutations equal the CPU's."""
    rng = np.random.default_rng(4)
    d = np.zeros((40, 40), np.float32)
    for i in range(40):
        for j in range(max(0, i - 3), min(40, i + 4)):
            if i != j and rng.random() < 0.7:
                d[i, j] = d[j, i] = 1
    s = rng.permutation(40)
    d = d[np.ix_(s, s)]
    out = []
    for dev in ("cpu", cuda_device):
        A = SpParMat.from_dense(Grid.make(2, 2, device=dev), d)
        out.append([rcm_ordering(A).blocks.cpu(), rcm_ordering(A, root=0).blocks.cpu(),
                    minimum_degree_ordering(SpParMat.from_dense(
                        Grid.make(1, 1, device=dev), d[:16, :16])).blocks.cpu()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [1, 2])
def test_spmm_on_card_matches_cpu(p, cuda_device):
    """dist_spmm_ell (min_plus and max_min on NaN, ±0 and ±inf features;
    plus_times on integer-valued features, both backends) and summa_spmm
    (both stage orders): exact on the card against the CPU."""
    rng = np.random.default_rng(5)
    n, F = 72, 8
    r, c = rng.integers(0, n, 420), rng.integers(0, n, 420)
    r, c = np.concatenate([r, r[:30]]), np.concatenate([c, c[:30]])
    v = rng.integers(1, 5, len(r)).astype(np.float32)
    specials = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1, 2, -3], np.float32),
                          size=(n, F))
    ints = rng.integers(0, 4, (n, F)).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        g = Grid.make(p, p, device=dev)
        E = EllParMat.from_host_coo(g, r, c, v, n, n)
        A = SpParMat.from_global_coo(g, r, c, v, n, n)
        res = []
        for sr, X, backends in ((MIN_PLUS, specials, ("scatter",)),
                                (MAX_MIN, specials, ("scatter",)),
                                (PLUS_TIMES, ints, ("mxu_gather", "scatter"))):
            Xd = DistMultiVec.from_global(g, X)
            res += [dist_spmm_ell(sr, E, Xd, backend=b).blocks for b in backends]
            res += [summa_spmm(sr, A, DenseParMat.from_global(g, X), backend=backends[0],
                               ring=ring).blocks for ring in (False, True)]
        out.append([x.cpu() for x in res])
    for a, b in zip(*out):
        _same(a, b)


def test_propagation_on_card_matches_cpu(cuda_device):
    """spmm_khop normalised and propagate_features within rtol 1e-5 (float
    sums), _propagate_batch_impl's lanes within it and its PAD_ROOT lanes
    exactly zero."""
    rng = np.random.default_rng(6)
    n, F = 96, 10
    r, c = rng.integers(0, n, 380), rng.integers(0, n, 380)
    key = np.unique(np.concatenate([r * n + c, c * n + r]))
    r, c = key // n, key % n
    v = np.ones(len(r), np.float32)
    X = rng.integers(0, 3, (n, F)).astype(np.float32)
    roots = rng.integers(0, n, 16).astype(np.int32)
    roots[[3, 9]] = PAD_ROOT
    out = []
    for dev in ("cpu", cuda_device):
        E = EllParMat.from_host_coo(Grid.make(2, 2, device=dev), r, c, v, n, n)
        Xd = DistMultiVec.from_global(E.grid, pad_features(X), align="row")
        inv = row_invdeg(E).realign("col")
        batch = propagate_mod._propagate_batch_impl(E, Xd, inv, torch.from_numpy(roots), hops=2,
                                                    normalize=True, backend="mxu_gather")
        out.append((propagate_features(E, X, 2, normalize=True), batch.cpu()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-5, atol=1e-6)
    assert (out[1][1][:, [3, 9]] == 0).all()


# --- graph input -----------------------------------------------------------------

from combblas_tpu_torch import (  # noqa: E402
    checkpoint,
    from_device_coo,
    kernel1_device,
    read_mm_distributed,
    redistribute_coo,
    rmat_edges,
    write_mm,
)
from combblas_tpu_torch.utils import threefry  # noqa: E402


def _same_mat_fields(a: SpParMat, b: SpParMat) -> None:
    assert (a.nrows, a.ncols) == (b.nrows, b.ncols)
    for f in ("rows", "cols", "vals", "nnz"):
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        assert x.dtype == y.dtype and torch.equal(x.view(torch.uint8), y.view(torch.uint8)), f


def test_threefry_streams_on_card_match_cpu(cuda_device):
    """Integer arithmetic in int64: bits, uniforms (by their bits) and
    permutations on the card equal the CPU's."""
    k = threefry.key(123)
    for shape, off in (((1000, 20), 0), ((333,), 5 << 32)):
        assert torch.equal(threefry.bits(k, shape, cuda_device, off).cpu(),
                           threefry.bits(k, shape, "cpu", off))
    for lo, hi in ((0.0, 1.0), (0.95, 1.05)):
        a = threefry.uniform(k, (1 << 18,), lo, hi, device=cuda_device).cpu()
        b = threefry.uniform(k, (1 << 18,), lo, hi, device="cpu")
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for n in (1, 1000, 1 << 17):
        assert torch.equal(threefry.permutation(k, n, cuda_device).cpu(),
                           threefry.permutation(k, n, "cpu"))


@pytest.mark.parametrize("scale, noise", [(8, True), (11, True), (9, False)])
def test_rmat_edges_on_card_match_cpu(scale, noise, cuda_device):
    k = threefry.key(scale)
    a = rmat_edges(k, scale, 16 << scale, noise, device=cuda_device)
    b = rmat_edges(k, scale, 16 << scale, noise, device="cpu")
    for x, y in zip(a, b):
        assert x.device.type == "cuda" and torch.equal(x.cpu(), y)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)], ids=["1x1", "2x2", "2x4"])
def test_randperm_with_a_key_on_card_matches_cpu(shape, cuda_device):
    k = threefry.key(7)
    a = DistVec.randperm(Grid.make(*shape, device=cuda_device), 1001, k)
    b = DistVec.randperm(Grid.make(*shape, device="cpu"), 1001, k)
    assert torch.equal(a.blocks.cpu(), b.blocks)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)], ids=["1x1", "2x2", "2x4"])
def test_redistribute_on_card_matches_cpu(shape, cuda_device):
    """Routing with and without dedup, at capacities that drop tuples and at
    from_device_coo's: the same tiles and drop counts."""
    rng = np.random.default_rng(3)
    n, m = 300, 5000
    ntiles = shape[0] * shape[1]
    chunk = -(-m // ntiles)
    R = rng.integers(0, n, ntiles * chunk).astype(np.int32)
    C = rng.integers(0, n, ntiles * chunk).astype(np.int32)
    R[rng.random(len(R)) < 0.05] = n
    V = rng.integers(1, 9, len(R)).astype(np.float32)
    arrs = [x.reshape(*shape, chunk) for x in (R, C, V)]
    out = []
    for dev in ("cpu", cuda_device):
        g = Grid.make(*shape, device=dev)
        t = [torch.from_numpy(x).to(dev) for x in arrs]
        res = []
        for stage, tile, sr in ((64, 256, None), (64, 256, SELECT2ND_MAX),
                                (4096, 8192, PLUS_TIMES)):
            res.append(redistribute_coo(g, *t, n, n, stage_capacity=stage, tile_capacity=tile,
                                        dedup_sr=sr))
        res.append((from_device_coo(g, *t, n, n, dedup_sr=SELECT2ND_MAX), None))
        out.append(res)
    for (a, da), (b, db) in zip(*out):
        _same_mat_fields(a, b)
        if da is not None:
            assert int(da) == int(db)
    assert int(out[0][0][1]) > 0  # the small capacities dropped some


@pytest.mark.parametrize("shape, extra", [((1, 1), False), ((2, 2), True)],
                         ids=["1x1", "2x2-extra-relabel"])
def test_kernel1_device_on_card_matches_cpu(shape, extra, cuda_device):
    k = threefry.key(42)
    out = [kernel1_device(Grid.make(*shape, device=dev), 10, 16, k, extra_relabel=extra)
           for dev in ("cpu", cuda_device)]
    (A, deg, nkeep, t), (B, deg2, nkeep2, t2) = out
    _same_mat_fields(A, B)
    assert torch.equal(deg.blocks, deg2.blocks.cpu())
    assert int(nkeep) == int(nkeep2) and int(t["dropped_dev"]) == int(t2["dropped_dev"]) == 0
    assert t2["dropped_dev"].device.type == "cuda"


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_bfs_ring_on_card_matches_cpu(shape, cuda_device):
    n = 1 << 10
    r, c = rmat_symmetric_coo_host(4, 10, 8)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    srcs = np.flatnonzero(np.bincount(r, minlength=n) > 0)[:8].astype(np.int32)
    out = []
    for dev in ("cpu", cuda_device):
        E = EllParMat.from_host_coo(Grid.make(*shape, device=dev), r, c,
                                    np.ones(len(r), np.float32), n, n)
        p, lv, it = bfs_batch_compact(E, torch.from_numpy(srcs), ring=True)
        out.append((p.blocks.cpu(), lv.blocks.cpu(), it))
    off = bfs_batch_compact(E, torch.from_numpy(srcs))
    assert out[0][2] == out[1][2] == off[2]
    for a, b, o in zip(out[0][:2], out[1][:2], (off[0].blocks.cpu(), off[1].blocks.cpu())):
        assert torch.equal(a, b) and torch.equal(b, o)


def test_file_input_and_checkpoint_on_card(cuda_device, tmp_path):
    """A Matrix Market file read onto a 2x2 grid on the card equals the CPU
    read; a checkpoint of it loads back onto the card verbatim and onto a
    1x1 grid as the CPU load does."""
    rng = np.random.default_rng(9)
    n = 200
    r, c = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    v = rng.integers(1, 50, 1500).astype(np.float64)
    p = str(tmp_path / "g.mtx")
    write_mm(p, (r, c, v, n, n))
    cpu = read_mm_distributed(Grid.make(2, 2, device="cpu"), p, dedup_sr=PLUS_TIMES)
    card = read_mm_distributed(Grid.make(2, 2, device=cuda_device), p, dedup_sr=PLUS_TIMES)
    _same_mat_fields(card, cpu)
    ck = str(tmp_path / "g.npz")
    checkpoint.save(ck, card)
    _same_mat_fields(checkpoint.load(ck, Grid.make(2, 2, device=cuda_device)), card)
    _same_mat_fields(checkpoint.load(ck, Grid.make(1, 1, device=cuda_device)),
                     checkpoint.load(ck, Grid.make(1, 1, device="cpu")))



# --- the 3D tier --------------------------------------------------------------------

from combblas_tpu_torch import Grid3D, SpParMat3D, hash_merge, hash_table_capacity  # noqa: E402
from combblas_tpu_torch.parallel import mesh3d as mesh3d_mod  # noqa: E402


def _mat3_fields(M):
    return [M.rows, M.cols, M.vals, M.nnz]


def _mats3(dev, n=512, seed=4):
    """The scale-9 graph of ``_esc_graph`` col- and row-split on 2x2x2."""
    _, r, c, v = _esc_graph(seed)
    g = Grid3D.make(2, 2, 2, device=dev)
    return (SpParMat3D.from_global_coo(g, r, c, v, n, n, "col"),
            SpParMat3D.from_global_coo(g, r, c, v, n, n, "row"))


def test_hash_merge_on_card_matches_cpu(cuda_device):
    """``hash_merge`` on CUDA tensors: the table order, values, overflow and
    distinct count of the CPU (integer values: the sums are exact)."""
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 300, 5000), rng.integers(0, 200, 5000)
    v = rng.integers(1, 5, 5000).astype(np.float32)
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        for table, probes in ((hash_table_capacity(4096), 16), (1024, 3)):
            out = [hash_merge(sr, SpTuples.from_coo(r, c, v, 300, 200, device=dev),
                              out_capacity=4096, table_capacity=table, n_probes=probes)
                   for dev in ("cpu", cuda_device)]
            for a, b in zip(_mat_fields(out[0][0]), _mat_fields(out[1][0])):
                _same(a, b)
            assert [int(x) for x in out[0][1:]] == [int(x) for x in out[1][1:]]


@pytest.mark.parametrize("merge", ["sort", "runs", "hash"])
def test_esc3d_merge_tiers_on_card_match_cpu(merge, cuda_device):
    """``spgemm3d`` (ESC) under each fiber merge tier, gathered and carousel,
    on the card: the CPU's tiles for min_plus, max_min and plus_times."""
    mats = [_mats3(dev) for dev in ("cpu", cuda_device)]
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        for ring in (False, True):
            want = mesh3d_mod.spgemm3d(sr, *mats[0], merge=merge, ring=ring)
            got = mesh3d_mod.spgemm3d(sr, *mats[1], merge=merge, ring=ring)
            for a, b in zip(_mat3_fields(want), _mat3_fields(got)):
                _same(a, b)


@pytest.mark.parametrize("backend", ["scatter", "dot"])
def test_windowed3d_on_card_matches_cpu(backend, cuda_device):
    """The windowed 3D tier on the card gives the CPU's tiles; the dot
    backend's tropical products launch K1 once a layer, tile, stage and
    live window (the plan's count) and none for plus_times."""
    mats = [_mats3(dev) for dev in ("cpu", cuda_device)]
    kw = dict(backend=backend, block_rows=64, block_cols=128 if backend == "dot" else None)
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        want = mesh3d_mod.spgemm3d_windowed(sr, *mats[0], **kw)
        before = semiring_matmul.launches
        got = mesh3d_mod.spgemm3d_windowed(sr, *mats[1], **kw)
        plan = mesh3d_mod.spgemm3d_windowed.last_plan
        per_call = 0 if backend == "scatter" or sr is PLUS_TIMES else 2 * 2 ** 3 * plan["packed"]
        assert semiring_matmul.launches - before == per_call
        for a, b in zip(_mat3_fields(want), _mat3_fields(got)):
            _same(a, b)


def test_conversions_and_routed_3d_on_card_match_cpu(cuda_device):
    """2D → 3D (both splits), ``resplit3d``, 3D → 2D and the routed
    ``spgemm_auto(grid3=...)`` on the card: the CPU's tiles."""
    n, r, c, v = _esc_graph(6)
    out = []
    for dev in ("cpu", cuda_device):
        A = SpParMat.from_global_coo(Grid.make(2, 4, device=dev), r, c, v, n, n)
        A2 = SpParMat.from_global_coo(Grid.make(2, 2, device=dev), r, c, v, n, n)
        g3 = Grid3D.make(2, 2, 2, device=dev)
        col = SpParMat3D.from_spmat(A, g3, "col")
        row = SpParMat3D.from_spmat(A, g3, "row")
        out.append(_mat3_fields(col) + _mat3_fields(row)
                   + _mat3_fields(mesh3d_mod.resplit3d(col, "row"))
                   + _mat_fields(row.to_spmat(A.grid))
                   + _mat_fields(spgemm_auto(MIN_PLUS, A2, A2, grid3=g3, tier="windowed3d")))
    for a, b in zip(*out):
        _same(a, b)


def test_mcl_3d_on_card_matches_cpu(cuda_device):
    """``mcl(layers=2)`` on 2x2x2, plain and block loops: the CPU's labels
    and iteration count."""
    d = _ring_of_cliques()
    for kw in ({}, {"chaos_every": 2}):
        out = []
        for dev in ("cpu", cuda_device):
            lab, it, ch = mcl(SpParMat.from_dense(Grid.make(2, 2, device=dev), d), layers=2,
                              grid3=Grid3D.make(2, 2, 2, device=dev), **kw)
            out.append((lab.blocks.cpu(), it))
            assert ch < 1e-3
        assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


# --- the measured-plan tuner ---------------------------------------------------------

from combblas_tpu_torch.parallel import spmm as spmm_mod  # noqa: E402
from combblas_tpu_torch.tuner import config as tuner_config  # noqa: E402
from combblas_tpu_torch.tuner import probe as tuner_probe  # noqa: E402
from combblas_tpu_torch.tuner import store as tuner_store  # noqa: E402


@pytest.fixture
def probe_store(monkeypatch, tmp_path):
    """Probing on, into an empty store of the test's own."""
    monkeypatch.setenv(tuner_config.ENV_PLAN_STORE, str(tmp_path / "plans"))
    monkeypatch.setenv(tuner_config.ENV_PROBE, "1")
    tuner_store._reset_for_tests()
    yield tuner_store.get_store()
    tuner_store._reset_for_tests()


def _probe_graph(dev, sr, p=1):
    n = 1 << 8
    r, c = rmat_symmetric_coo_host(3, 8, 8)
    v = np.random.default_rng(7).integers(1, 16, r.shape[0]).astype(np.float32)
    return SpParMat.from_global_coo(Grid.make(p, p, device=dev), r, c, v, n, n, dedup_sr=sr)


@pytest.mark.parametrize("backend", ["scatter", "dot"])
def test_probe_on_card_picks_a_rung_then_store_replays(backend, probe_store, monkeypatch,
                                                       cuda_device):
    """``spgemm_auto`` with the probe on: the rungs are measured on the card
    (K1 launches in the mxu rung, and under the dot backend in the windowed
    rung and its geometry sweep), nothing is skipped, the winner is
    persisted under a ``platform: "cuda"`` key and its product equals the
    CPU's at that tier; the next call replays it from the store without
    probing, also after a reload from the file."""
    monkeypatch.setenv(tuner_config.ENV_BACKEND, backend)
    A = _probe_graph(cuda_device, MIN_PLUS)
    before = semiring_matmul.launches
    got = spgemm_auto(MIN_PLUS, A, A)
    run = spgemm_auto.last_run
    assert run["plan_source"] == "probe"
    assert tuner_probe.probe_spgemm.last_errors == []
    assert semiring_matmul.launches > before
    costs = tuner_probe.probe_spgemm.last_costs["tiers"]
    assert set(costs) == {"mxu", "windowed", "scan"} and run["tier"] == min(costs, key=costs.get)
    st = probe_store.stats()
    assert st["entries"] == 1 and st["probe_runs"] >= 3 and st["probe_seconds"] > 0
    key = tuner_store.spgemm_plan_key(MIN_PLUS, A, A, backend)
    assert key.platform == "cuda" and probe_store.peek(key).tier == run["tier"]
    Acpu = _probe_graph("cpu", MIN_PLUS)
    monkeypatch.setenv(tuner_config.ENV_PLAN_STORE, "0")
    want = spgemm_auto(MIN_PLUS, Acpu, Acpu, tier=run["tier"])
    for a, b in zip(_mat_fields(want), _mat_fields(got)):
        _same(a, b)
    monkeypatch.setenv(tuner_config.ENV_PLAN_STORE, probe_store.path)
    again = spgemm_auto(MIN_PLUS, A, A)
    assert spgemm_auto.last_run["plan_source"] == "store"
    assert probe_store.stats()["probe_runs"] == st["probe_runs"]
    assert probe_store.stats()["hits"] == st["hits"] + 1
    tuner_store._reset_for_tests()
    spgemm_auto(MIN_PLUS, A, A)
    assert spgemm_auto.last_run["plan_source"] == "store"
    assert tuner_store.get_store().stats()["hits"] == 1
    del again


def test_spmm_and_3d_probes_on_card(probe_store, cuda_device):
    """``resolve_spmm_backend`` with ``X`` measures both backends on the
    card and the next call replays the winner; ``spgemm3d`` probes its
    (tier, merge) candidates and its product equals the CPU's at the
    winning pair; nothing is skipped."""
    n = 256
    r, c = rmat_symmetric_coo_host(5, 8, 8)
    X = np.random.default_rng(2).integers(0, 3, (n, 16)).astype(np.float32)
    E = EllParMat.from_host_coo(Grid.make(1, 1, device=cuda_device), r, c,
                                np.ones(len(r), np.float32), n, n)
    Xd = DistMultiVec.from_global(E.grid, X, align="col")
    backend = spmm_mod.resolve_spmm_backend(PLUS_TIMES, E, 16, X=Xd)
    assert tuner_probe.probe_spmm.last_errors == []
    assert set(tuner_probe.probe_spmm.last_costs) == {"mxu_gather", "scatter"}
    runs = probe_store.stats()["probe_runs"]
    assert spmm_mod.resolve_spmm_backend(PLUS_TIMES, E, 16) == backend
    assert probe_store.stats()["probe_runs"] == runs
    mats = [_mats3(dev) for dev in ("cpu", cuda_device)]
    got = mesh3d_mod.spgemm3d(MIN_PLUS, *mats[1])
    run = dict(mesh3d_mod.spgemm3d.last_run)
    assert run["plan_source"] == "probe" and tuner_probe.probe_spgemm3d.last_errors == []
    rec = probe_store.peek(tuner_store.spgemm3d_plan_key(MIN_PLUS, *mats[1], ""))
    want = mesh3d_mod.spgemm3d(MIN_PLUS, *mats[0], tier=rec.tier, merge=rec.merge)
    for a, b in zip(_mat3_fields(want), _mat3_fields(got)):
        _same(a, b)
    mesh3d_mod.spgemm3d(MIN_PLUS, *mats[1])
    assert mesh3d_mod.spgemm3d.last_run["plan_source"] == "store"


# --- obs: the telemetry's cost contract on the card ----------------------------------


def _obs_mat(dev):
    n = 1 << 8
    r, c = rmat_symmetric_coo_host(3, 8, 8)
    v = np.random.default_rng(7).integers(1, 16, r.shape[0]).astype(np.float32)
    return SpParMat.from_global_coo(Grid.make(1, 1, device=dev), r, c, v, n, n,
                                    dedup_sr=MIN_PLUS)


def _syncs(fn):
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(1 for w in caught if "synchroniz" in str(w.message).lower())


def _kernels(fn, span_names=("spgemm.auto",)):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and e.name not in span_names
          and not e.name.startswith(("Memcpy", "Memset", "Activity Buffer"))]
    return out, ks, prof


def test_obs_adds_no_kernel_and_no_sync_to_spgemm_auto(cuda_device):
    """Telemetry on adds no kernel launch and no synchronising call to the
    mxu path; ``DEVICE_SYNC`` adds exactly the one readback of
    ``spgemm.realized_nnz``; the products are bit-equal. The profiler can
    drop device records, never add any, so a mode is traced again (eight
    times at most) while it shows fewer kernels than another."""
    from combblas_tpu_torch import obs

    A = _obs_mat(cuda_device)

    def traced(mode):
        obs.disable()
        obs.reset()
        if mode != "off":
            obs.enable(device_sync=mode == "sync", install_hooks=False)
        k1 = semiring_matmul.launches
        (C, syncs), ks, _ = _kernels(lambda: _syncs(lambda: spgemm_auto(MIN_PLUS, A, A)))
        return C, syncs, len(ks), semiring_matmul.launches - k1

    try:
        traced("off")  # warm-up: the duplicate check's memo, the first trace
        out = {m: [traced(m)] for m in ("off", "on", "sync")}
        assert obs.registry.get_counter("spgemm.realized_nnz") == int(out["off"][0][0].getnnz())
        while True:
            best = max(t[2] for ts in out.values() for t in ts)
            short = [m for m, ts in out.items() if max(t[2] for t in ts) < best and len(ts) < 8]
            if not short:
                break
            for m in short:
                out[m].append(traced(m))
    finally:
        obs.disable()
        obs.reset()
    ref = out["off"][0][0]
    for ts in out.values():
        for C, _, _, k1 in ts:
            for field in ("rows", "cols", "nnz"):
                assert torch.equal(getattr(C, field), getattr(ref, field))
            assert torch.equal(C.vals.view(torch.int32), ref.vals.view(torch.int32))
            assert k1 == out["off"][0][3] >= 1
    kernels = {m: max(t[2] for t in ts) for m, ts in out.items()}
    assert len(set(kernels.values())) == 1, {m: [t[2] for t in ts] for m, ts in out.items()}
    syncs = {m: {t[1] for t in ts} for m, ts in out.items()}
    assert syncs["on"] == syncs["off"] and len(syncs["off"]) == 1
    assert syncs["sync"] == {s + 1 for s in syncs["off"]}


def test_obs_span_encloses_k1_kernels(cuda_device):
    """On the profiler's timeline the ``spgemm.auto`` range holds every K1
    kernel of the call."""
    from combblas_tpu_torch import obs

    A = _obs_mat(cuda_device)
    spgemm_auto(MIN_PLUS, A, A)
    obs.enable(install_hooks=False)
    try:
        for _ in range(8):  # a trace may drop device records: trace again
            k = semiring_matmul.launches
            _, ks, prof = _kernels(lambda: spgemm_auto(MIN_PLUS, A, A))
            k1 = [e for e in ks if "semiring_mm" in e.name]
            if len(k1) == semiring_matmul.launches - k:
                break
    finally:
        obs.disable()
        obs.reset()
    spans = [e for e in prof.events() if e.name == "spgemm.auto"
             and e.device_type.name == "CPU"]
    assert len(spans) == 1 and len(k1) == semiring_matmul.launches - k >= 1
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    assert all(lo <= k.time_range.start and k.time_range.end <= hi for k in k1)


# --- the serving engine and the mutation lane ------------------------------------


def _serve_graph():
    rows, cols = rmat_symmetric_coo_host(3, 8, 8)
    rng = np.random.default_rng(7)
    w = rng.integers(1, 16, len(rows)).astype(np.float32)
    X = rng.integers(0, 3, (256, 6)).astype(np.float32)
    return rows, cols, w, X


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_engine_lanes_on_card_match_cpu(shape, cuda_device):
    """Every kind served on the card (a PAD_ROOT lane included) equals the
    CPU engine: bfs, sssp exactly; pagerank, bc and propagate within
    rtol 1e-5 (float sums in another order); device_bytes equal."""
    from combblas_tpu_torch.serve import GraphEngine

    rows, cols, w, X = _serve_graph()
    live = np.flatnonzero(np.bincount(rows, minlength=256)).astype(np.int32)
    srcs = np.array([live[0], PAD_ROOT, live[9], live[40]], np.int32)
    engs = [GraphEngine.from_coo(Grid.make(*shape, device=dev), rows, cols, 256, weights=w,
                                 features=X) for dev in ("cpu", cuda_device)]
    assert engs[0].version.device_bytes() == engs[1].version.device_bytes()
    engs[1].warmup(widths=(4,))
    mark = engs[1].trace_mark()
    for kind in engs[0].kinds():
        a, b = (e.execute(kind, srcs) for e in engs)
        for k in a:
            if k in ("ranks", "scores", "features"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                           atol=1e-6 * max(float(np.abs(a[k]).max()), 1e-30))
            else:
                assert np.array_equal(b[k], a[k]), (kind, k)
    assert engs[1].retraces_since(mark) == 0


def test_merge_chain_and_recovery_on_card_match_cpu(cuda_device, tmp_path):
    """A chain of incremental merges on the card equals the CPU chain
    array for array (untouched classes share the parent's tensors); a
    snapshot written from the card reloads onto the CPU equal; WAL
    recovery on the card equals the never-crashed version."""
    from combblas_tpu_torch import dynamic as dyn
    from combblas_tpu_torch.serve import GraphEngine

    rows, cols, w, X = _serve_graph()
    engs = [GraphEngine.from_coo(Grid.make(2, 2, device=dev), rows, cols, 256, weights=w,
                                 keep_coo=True, kinds=("bfs", "sssp", "pagerank"))
            for dev in ("cpu", cuda_device)]
    present = set(zip(rows.tolist(), cols.tolist()))
    pairs = [(a, b) for a in range(256) for b in range(a + 1, 256)
             if (a, b) not in present][:6]
    wal = dyn.open_wal(str(tmp_path))
    engs[1].version.wal_seq = -1
    checkpoint.save_version(str(tmp_path / checkpoint.snapshot_name(-1)), engs[1].version)
    vs = [e.version for e in engs]
    seq = 0
    for k, (a, b) in enumerate(pairs):
        ops = [("insert", a, b, 2.0), ("insert", b, a, 2.0)]
        if k >= 3:
            c, d = pairs[k - 3]
            ops += [("delete", c, d), ("delete", d, c)]
        first = seq
        wal.append(first, [o[1] for o in ops], [o[2] for o in ops],
                   [o[3] if len(o) > 3 else 1.0 for o in ops],
                   [dyn.OP_NAMES.index(o[0]) for o in ops])
        seq += len(ops)
        nv = [dyn.apply_delta(v, dyn.DeltaBatch.from_ops(ops, start_seq=first)) for v in vs]
        for v in nv:
            v.wal_seq = first + len(ops) - 1
        st = [v.dyn.last_stats for v in nv]
        assert st[0].mode == st[1].mode == "incremental"
        assert (st[0].buckets_uploaded, st[0].buckets_reused) == (
            st[1].buckets_uploaded, st[1].buckets_reused)
        for nm in ("E", "E_weighted", "P_ell"):
            for ta, tb in zip(getattr(nv[0], nm).buckets, getattr(nv[1], nm).buckets):
                for x, y in zip(ta, tb):
                    assert y.is_cuda and torch.equal(x, y.cpu()), nm
        vs = nv
    wal.close()
    back = checkpoint.load_version(_save(tmp_path, vs[1]), Grid.make(2, 2, device="cpu"))
    got = dyn.recover(str(tmp_path), Grid.make(2, 2, device=cuda_device))
    for v in (back, got):
        for nm in ("E", "E_weighted", "P_ell"):
            for ta, tb in zip(getattr(v, nm).buckets, getattr(vs[0], nm).buckets):
                for x, y in zip(ta, tb):
                    assert torch.equal(x.cpu(), y), nm
    assert got.wal_seq == vs[0].wal_seq


def _save(d, v):
    path = str(d / "card.npz")
    checkpoint.save_version(path, v)
    return path
