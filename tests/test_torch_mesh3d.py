"""Parity of the port's 3D (layered) tier, ``parallel/mesh3d.py``, with
``combblas_tpu`` on the CPU, one case for each product case of the
reference's ``tests/test_mesh3d.py``: the col-split / concat round trip,
the phased 3D product (and its phase-snapping warning), SUMMA3D against
dense on one and two layers, rectangular and square, the windowed 3D tier
against the ESC 3D tier (both backends), and the symbolic host pass
against the device pass. Its conversion and column-op cases are in
``test_torch_mesh3d_convert.py``.

Both packages get the same numpy-seeded inputs; the reference runs on its
eight virtual CPU devices, the port on ``Grid3D.make(..., device="cpu")``.
Matrices are compared whole: tiles with their padding slots, ``nnz`` and
capacities. Bit for bit, except ``plus_times`` values on random float32
data, which are held within rtol 1e-5 and atol 1e-6 (the folds add a
cell's products in another order); min_plus runs on the same operands and
is held bit for bit.
"""

import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu_torch import MAX_MIN, MIN_PLUS, PLUS_TIMES, Grid, SpParMat
from combblas_tpu_torch.parallel import mesh3d as tm

SEMIRINGS = {"plus_times": (PLUS_TIMES, jsr.PLUS_TIMES), "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
             "max_min": (MAX_MIN, jsr.MAX_MIN)}
RTOL, ATOL = 1e-5, 1e-6  # plus_times on random float32


def random_dense(rng, m, n, density=0.3):
    d = rng.random((m, n)) * (rng.random((m, n)) < density)
    return d.astype(np.float32)


def grids(layers=2, p=2):
    return jm.Grid3D.make(layers, p, p), tm.Grid3D.make(layers, p, p, device="cpu")


def both3(d, split, layers=2, p=2, dup=0):
    """The same COO (``dup`` entries repeated) as a reference and a port
    ``SpParMat3D``."""
    r, c = np.nonzero(d)
    v = d[r, c]
    if dup:
        r, c, v = (np.concatenate([x, x[:dup]]) for x in (r, c, v))
    jg, tg = grids(layers, p)
    m, n = d.shape
    return (jm.SpParMat3D.from_global_coo(jg, r, c, v, m, n, split),
            tm.SpParMat3D.from_global_coo(tg, r, c, v, m, n, split))


def arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_arrays(got, want):
    got, want = arr(got), arr(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32), want[keep].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


def same_mat3(got, want, close=False):
    """Same layout slot for slot; values bit for bit, or within RTOL/ATOL."""
    assert (got.nrows, got.ncols, got.split, got.capacity) == (
        want.nrows, want.ncols, want.split, want.rows.shape[3])
    for f in ("rows", "cols", "nnz"):
        same_arrays(getattr(got, f), getattr(want, f))
    if close:
        np.testing.assert_allclose(arr(got.vals), arr(want.vals), rtol=RTOL, atol=ATOL)
    else:
        same_arrays(got.vals, want.vals)


def same_mat2(got, want):
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "vals", "nnz"):
        same_arrays(getattr(got, f), getattr(want, f))


def both2(shape, d):
    return (JaxSpParMat.from_dense(JaxGrid.make(*shape), d),
            SpParMat.from_dense(Grid.make(*shape, device="cpu"), d))


def test_col_split_concat_roundtrip():
    d = random_dense(np.random.default_rng(0), 16, 16, 0.35)
    jB, tB = both3(d, "row")
    jp, tp = jB.col_split(2), tB.col_split(2)
    for g, w in zip(tp, jp):
        assert g.ncols == 8
        same_mat3(g, w)
    same_mat3(tm.SpParMat3D.col_concatenate(tp), jm.SpParMat3D.col_concatenate(jp))
    np.testing.assert_array_equal(tm.SpParMat3D.col_concatenate(tp).to_dense(), d)
    with pytest.raises(ValueError, match="row-split"):
        both3(d, "col")[1].col_split(2)


@pytest.mark.parametrize("phases", [2, 3, pytest.param(4, marks=pytest.mark.slow)])
def test_mem_efficient_spgemm3d(phases):
    """Phased products equal the reference's; 3 phases do not split the
    8-wide tile columns over 2 layers and snap to 2 with a warning in both
    packages."""
    rng = np.random.default_rng(1)
    da, db = random_dense(rng, 16, 16, 0.3), random_dense(rng, 16, 16, 0.3)
    (jA, tA), (jB, tB) = both3(da, "col"), both3(db, "row")
    for name in ("plus_times", "min_plus"):
        sr, jr = SEMIRINGS[name]
        if phases == 3:
            with pytest.warns(UserWarning, match="snapping to 2 phases"):
                got = tm.mem_efficient_spgemm3d(sr, tA, tB, phases)
            with pytest.warns(UserWarning, match="snapping to 2 phases"):
                want = jm.mem_efficient_spgemm3d(jr, jA, jB, phases)
        else:
            got = tm.mem_efficient_spgemm3d(sr, tA, tB, phases)
            want = jm.mem_efficient_spgemm3d(jr, jA, jB, phases)
        same_mat3(got, want, close=name == "plus_times")
    np.testing.assert_allclose(got.to_dense(), want.to_dense())


@pytest.mark.parametrize("case", ["two_layers", "single_layer", "rectangular", "square"])
def test_summa3d_matches_dense(case):
    """``spgemm3d`` (ESC) equals the reference's, and the dense product:
    2x2x2 and 1x2x2 (L = 1 is 2D SUMMA), 32x16 · 16x32 (B's own row
    blocking sizes the pass) and A·A (the MCL shape)."""
    rng = np.random.default_rng(3)
    layers, shape_a, shape_b, dens = {
        "two_layers": (2, (16, 16), (16, 16), 0.3), "single_layer": (1, (12, 12), (12, 12), 0.4),
        "rectangular": (2, (32, 16), (16, 32), 0.3), "square": (2, (16, 16), None, 0.25)}[case]
    da = random_dense(rng, *shape_a, dens)
    db = da if shape_b is None else random_dense(rng, *shape_b, dens)
    (jA, tA), (jB, tB) = both3(da, "col", layers), both3(db, "row", layers)
    flops = tm.summa3d_stage_flops(tA, tB)
    same_arrays(flops, jm.summa3d_stage_flops(jA, jB))
    for name in ("min_plus", "plus_times"):
        sr, jr = SEMIRINGS[name]
        got, want = tm.spgemm3d(sr, tA, tB), jm.spgemm3d(jr, jA, jB)
        assert got.split == "col"
        same_mat3(got, want, close=name == "plus_times")
    np.testing.assert_allclose(got.to_dense(), da @ db, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["plus_times", pytest.param("min_plus", marks=pytest.mark.slow)])
def test_spgemm3d_windowed_matches_esc3d(name):
    """The windowed 3D tier on duplicated COO, scatter and 2D dot
    backends, equals the reference's (layout and values) and the ESC 3D
    tier's entries; ``spgemm3d(tier="windowed")`` routes to it. (min_plus,
    whose dot backend runs the reference's interpreted Pallas kernel, is
    in the slow set; ``test_torch_mesh3d_merge.py`` holds min_plus through
    the windowed tier in tier 1.)"""
    rng = np.random.default_rng(8)
    n = 32
    d = random_dense(rng, n, n, 0.25)
    (jA, tA), (jB, tB) = both3(d, "col", dup=20), both3(d, "row", dup=20)
    sr, jr = SEMIRINGS[name]
    esc = tm.spgemm3d(sr, tA, tB)
    for backend, bc in (("scatter", None), ("dot", 16)):
        got = tm.spgemm3d_windowed(sr, tA, tB, block_rows=8, block_cols=bc,
                                   backend=backend)
        want = jm.spgemm3d_windowed(jr, jA, jB, block_rows=8, block_cols=bc,
                                    backend=backend, interpret=True)
        same_mat3(got, want, close=name == "plus_times")
        assert int(got.getnnz()) == int(esc.getnnz())
        if name == "min_plus":
            same_arrays(np.sort(got.to_global_coo()[2]), np.sort(esc.to_global_coo()[2]))
    same_mat3(tm.spgemm3d(sr, tA, tB, tier="windowed", backend="scatter", block_rows=8),
              jm.spgemm3d(jr, jA, jB, tier="windowed", backend="scatter", block_rows=8),
              close=name == "plus_times")


def test_summa3d_window_symbolic_host_matches_device():
    """The 3D window passes: the port's device pass, its host twin and the
    reference's agree, padded and true; the B panel counts too; the plan
    from them is the reference's."""
    rng = np.random.default_rng(9)
    n = 64
    d = random_dense(rng, n, n, 0.15)
    r, c = np.nonzero(d)
    rd, cd = np.concatenate([r, r[:25]]), np.concatenate([c, c[:25]])
    v = np.ones(len(rd), np.float32)
    jg, tg = grids()
    jA, tA = (m.SpParMat3D.from_global_coo(g, rd, cd, v, n, n, "col")
              for m, g in ((jm, jg), (tm, tg)))
    jB, tB = (m.SpParMat3D.from_global_coo(g, rd, cd, v, n, n, "row")
              for m, g in ((jm, jg), (tm, tg)))
    dev = arr(tm.summa3d_window_flops_pair(tA, tB, 8, 16, chunk_w=8))
    same_arrays(dev, jm.summa3d_window_flops_pair(jA, jB, 8, 16, chunk_w=8))
    hpad = tm.summa3d_window_flops_host(tg, rd, cd, rd, cd, n, n, n, 8, 16, chunk_w=8)
    htrue = tm.summa3d_window_flops_host(tg, rd, cd, rd, cd, n, n, n, 8, 16, chunk_w=0)
    np.testing.assert_array_equal(dev[0].astype(np.int64), hpad.astype(np.int64))
    np.testing.assert_array_equal(dev[1].astype(np.int64), htrue.astype(np.int64))
    np.testing.assert_array_equal(hpad, jm.summa3d_window_flops_host(
        jg, rd, cd, rd, cd, n, n, n, 8, 16, chunk_w=8))
    bn = arr(tm.summa3d_window_bnnz(tB, 16))
    same_arrays(bn, jm.summa3d_window_bnnz(jB, 16))
    np.testing.assert_array_equal(bn.astype(np.int64),
                                  tm.summa3d_window_bnnz_host(tg, rd, cd, n, n, 16))
    assert (tm.windowed_plan3d(None, dev[1], 8, 16, 32, 32)
            == jm.windowed_plan3d(None, dev[1], 8, 16, 32, 32))
    assert (tm.windowed_plan3d(dev[0], dev[1], 8, 16, 32, 32)
            == jm.windowed_plan3d(dev[0], dev[1], 8, 16, 32, 32))
    for dims in ((64, 64, 64), (98, 98, 98), (64, 32, 64)):
        assert tm.summa3d_compatible(tg, *dims) == jm.summa3d_compatible(jg, *dims)
