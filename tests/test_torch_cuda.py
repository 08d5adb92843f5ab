"""Tests of the port that need an NVIDIA card: each CUDA kernel against its
plain PyTorch version, the mxu SpGEMM path, the dense -> sparse
extraction and the batched BFS on the card against the same calls on the CPU. Marked ``cuda``; they skip where there is no card.

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
K * 2**-24 * sum|a||b| per cell.
"""

import numpy as np
import pytest
import torch

from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PAD_ROOT,
    PLUS_TIMES,
    DistMultiVec,
    DistVec,
    EllParMat,
    Grid,
    SpParMat,
    batch_traversed_edges,
    bfs_batch_compact,
    build_csc_companion,
    build_graph,
    dense_to_sptuples,
    flat_to_tuples_arrays,
    flat_to_tuples_arrays_reference,
    rmat_symmetric_coo_host,
    semiring_matmul,
    semiring_matmul_reference,
    spgemm_auto,
    validate_bfs_device,
)
from combblas_tpu_torch.ops.dense_to_tuples import VARIANTS, chunk_rows, resident_blocks
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
