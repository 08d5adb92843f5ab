"""Tests of the port that need an NVIDIA card: each CUDA kernel against its
plain PyTorch version, the mxu SpGEMM path, the dense -> sparse
extraction, the batched and single-root BFS, the ELL SpMV family, the
batched SSSP, and the SpParMat path (local and distributed SpMV forms,
the DistVec op pack, the SpParMat operations, bfs, bfs_diropt, sssp,
FastSV, LACC, mis, pagerank) on the card against the same calls on the
CPU. Marked
``cuda``; they skip where there is no card.

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
from combblas_tpu_torch.models import mis as mis_mod
from combblas_tpu_torch.ops.dense_to_tuples import VARIANTS, chunk_rows, resident_blocks
from combblas_tpu_torch.ops.spmv import spmspv, spmspv_dense_out, spmv
from combblas_tpu_torch.ops.semiring_matmul import KINDS, TILE, _kernel

pytestmark = pytest.mark.cuda


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
