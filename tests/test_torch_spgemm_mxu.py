"""Parity of the port's SpGEMM mxu path (``combblas_tpu_torch``) with the JAX
package (``combblas_tpu``): R-MAT generation, ``SpParMat`` construction and
carry-over, and ``spgemm_auto`` through the dense (mxu) tier on 1×1 and 2×2
grids, compared array by array (rows, cols, vals, nnz, capacity).

The port runs on the CPU, where its semiring GEMM is the plain PyTorch
version; the JAX package runs its Pallas kernel in interpret mode. Every
comparison is exact (``assert_array_equal``): min/max folds do not depend on
order, and the integer-valued float32 weights (1..15) keep every
``plus_times`` sum below 2**24.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.parallel.grid import Grid as JGrid
from combblas_tpu.parallel.mesh3d import Grid3D as JGrid3D
from combblas_tpu.parallel.spgemm import _mxu_dot as jax_mxu_dot
from combblas_tpu.parallel.spgemm import choose_spgemm_tier as jax_choose_tier
from combblas_tpu.parallel.spgemm import coo_has_duplicates as jax_has_dups
from combblas_tpu.parallel.spgemm import spgemm_auto as jax_spgemm_auto
from combblas_tpu.parallel.spmat import SpParMat as JSpParMat
from combblas_tpu.semiring import MAX_MIN as J_MAX_MIN
from combblas_tpu.semiring import MIN_PLUS as J_MIN_PLUS
from combblas_tpu.semiring import PLUS_TIMES as J_PLUS_TIMES
from combblas_tpu.semiring import SELECT2ND_MAX as J_SELECT2ND_MAX
from combblas_tpu.utils.rmat import rmat_symmetric_coo_host as jax_rmat
from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    Grid,
    Grid3D,
    SpParMat,
    choose_spgemm_tier,
    coo_has_duplicates,
    rmat_symmetric_coo_host,
    semiring_matmul,
    spgemm_auto,
    spparmat_from_arrays,
)
from combblas_tpu_torch.parallel.spgemm import _mxu_dot

SEMIRINGS = [(MIN_PLUS, J_MIN_PLUS), (MAX_MIN, J_MAX_MIN), (PLUS_TIMES, J_PLUS_TIMES)]
SCALE = 7
N = 1 << SCALE


def _graph(seed=1, edgefactor=8):
    r, c = jax_rmat(seed, SCALE, edgefactor)
    v = np.random.default_rng(7).integers(1, 16, r.shape[0]).astype(np.float32)
    return r, c, v


def _both(p, r, c, v, dedup):
    """The same COO loaded by each package on a p×p grid."""
    sr, jsr = dedup if dedup is not None else (None, None)
    jA = JSpParMat.from_global_coo(JGrid.make(p, p), r, c, v, N, N, dedup_sr=jsr)
    tA = SpParMat.from_global_coo(
        Grid.make(p, p, device="cpu"), r, c, v, N, N, dedup_sr=sr
    )
    return jA, tA


def _assert_same(jM, tM):
    for field in ("rows", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(
            getattr(tM, field).numpy(), np.asarray(getattr(jM, field)), err_msg=field
        )
    assert (tM.nrows, tM.ncols, tM.capacity) == (jM.nrows, jM.ncols, jM.capacity)


@pytest.mark.parametrize("seed", [1, 42])
def test_rmat_copy_gives_the_same_edges(seed):
    want_r, want_c = jax_rmat(seed, SCALE, 16)
    got_r, got_c = rmat_symmetric_coo_host(seed, SCALE, 16)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("p", [1, 2])
def test_carried_over_matrix_equals_own_construction(p):
    """``from_global_coo(dedup_sr=...)`` in both packages; the reference's
    arrays carried over with ``spparmat_from_arrays`` equal the port's own."""
    r, c, v = _graph()
    jA, tA = _both(p, r, c, v, SEMIRINGS[0])
    carried = spparmat_from_arrays(
        Grid.make(p, p, device="cpu"),
        np.asarray(jA.rows), np.asarray(jA.cols), np.asarray(jA.vals),
        np.asarray(jA.nnz), jA.nrows, jA.ncols,
    )
    _assert_same(jA, tA)
    _assert_same(jA, carried)
    np.testing.assert_array_equal(tA.to_dense(), jA.to_dense())


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("pair", SEMIRINGS, ids=lambda s: s[0].name)
def test_spgemm_auto_matches_reference(p, pair):
    """A·A through the mxu tier: equal output arrays, padding included."""
    sr, jsr = pair
    jA, tA = _both(p, *_graph(), pair)
    assert jax_choose_tier(jsr, jA, jA) == choose_spgemm_tier(sr, tA, tA) == "mxu"
    jC = jax_spgemm_auto(jsr, jA, jA, interpret=True)
    launches = semiring_matmul.launches
    tC = spgemm_auto(sr, tA, tA)
    assert semiring_matmul.launches == launches  # CPU tensors: plain version
    _assert_same(jC, tC)


def test_forced_overflow_retries_to_the_same_capacity():
    """A too-small ``out_capacity`` overflows and retries; both packages end
    at the same capacity with the same arrays."""
    jA, tA = _both(1, *_graph(), SEMIRINGS[0])
    jC = jax_spgemm_auto(J_MIN_PLUS, jA, jA, out_capacity=100, interpret=True)
    tC = spgemm_auto(MIN_PLUS, tA, tA, out_capacity=100)
    assert tC.capacity > 128  # it did retry
    _assert_same(jC, tC)
    with pytest.raises(ValueError, match="still overflowing"):
        spgemm_auto(MIN_PLUS, tA, tA, out_capacity=100, max_retries=0)


def test_duplicates_and_unported_tiers():
    """``coo_has_duplicates`` agrees with the reference; where the reference
    leaves the mxu tier the port routes as it does and runs the esc, scan
    and windowed tiers as it does; forced to the 3D tier it runs the
    layered route on a 2x2x2 grid as the reference does, and without
    ``grid3`` it fails as the reference's does."""
    r, c, v = _graph()
    jD, tD = _both(1, r, c, v, None)  # symmetrized R-MAT keeps duplicates
    jU, tU = _both(1, r, c, v, SEMIRINGS[0])
    assert jax_has_dups(jD) is coo_has_duplicates(tD) is True
    assert jax_has_dups(jU) is coo_has_duplicates(tU) is False
    # duplicate tiles: the reference falls back to windowed or scan
    assert jax_choose_tier(J_MIN_PLUS, jD, jD) in ("windowed", "scan")
    assert choose_spgemm_tier(MIN_PLUS, tD, tD) == jax_choose_tier(J_MIN_PLUS, jD, jD)
    assert choose_spgemm_tier(MIN_PLUS, tD, tD, assume_unique=True) == "mxu"
    # a semiring without a dense kernel
    tier = jax_choose_tier(J_SELECT2ND_MAX, jU, jU)
    assert tier != "mxu" and choose_spgemm_tier(SELECT2ND_MAX, tU, tU) == tier
    # forced tiers: esc, scan, windowed and the layered windowed3d run
    for tier in ("esc", "scan", "windowed"):
        _assert_same(jax_spgemm_auto(J_MIN_PLUS, jU, jU, tier=tier),
                     spgemm_auto(MIN_PLUS, tU, tU, tier=tier))
    _assert_same(jax_spgemm_auto(J_MIN_PLUS, jU, jU, tier="windowed3d",
                                 grid3=JGrid3D.make(2, 2, 2)),
                 spgemm_auto(MIN_PLUS, tU, tU, tier="windowed3d",
                             grid3=Grid3D.make(2, 2, 2, device="cpu")))
    with pytest.raises(AssertionError, match="needs a grid3"):
        jax_spgemm_auto(J_MIN_PLUS, jU, jU, tier="windowed3d")
    with pytest.raises(ValueError, match="needs a grid3"):
        spgemm_auto(MIN_PLUS, tU, tU, tier="windowed3d")


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
def test_mxu_dot_modes_match_reference(mode):
    """The dense plus_times stage product at each precision. Integer
    values up to 600 are not all bf16-representable, so the bf16 modes
    round; every product and sum stays an integer below 2**24."""
    rng = np.random.default_rng(3)
    a = rng.integers(-600, 601, (48, 32)).astype(np.float32)
    b = rng.integers(-600, 601, (32, 40)).astype(np.float32)
    want = np.asarray(jax_mxu_dot(jnp.asarray(a), jnp.asarray(b), mode, jnp.float32))
    got = _mxu_dot(torch.from_numpy(a), torch.from_numpy(b), mode, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "bf16":
        assert not np.array_equal(want, a @ b)  # the rounding did happen
