"""Parity of the port's ``DistVec`` / ``DistMultiVec`` with
``combblas_tpu.parallel.vec`` on the CPU: blocks equal array for array
(padding rows included), exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.parallel import vec as jax_vec
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu_torch import DistMultiVec, DistVec, Grid

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2)]
GRID_IDS = [f"{a}x{b}" for a, b in GRIDS]
ALIGNS = ["row", "col"]


def other(align):
    return "col" if align == "row" else "row"


def assert_same_vec(got, want):
    assert (got.length, got.align) == (want.length, want.align)
    w = np.asarray(want.blocks)
    assert got.blocks.shape == w.shape
    np.testing.assert_array_equal(got.blocks.numpy(), w)


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_distvec_from_global_and_back(shape, align):
    x = np.random.default_rng(1).integers(-50, 50, 37).astype(np.int32)
    got = DistVec.from_global(Grid.make(*shape, device="cpu"), x, align=align, fill=-7)
    want = jax_vec.DistVec.from_global(JaxGrid.make(*shape), x, align=align, fill=-7)
    assert_same_vec(got, want)
    assert (got.nblocks, got.block_len) == (want.nblocks, want.block_len)
    np.testing.assert_array_equal(got.to_global(), x)


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_distvec_realign_both_ways(shape, align):
    """Realigned blocks equal the reference's, padding slots included, and
    coming back restores the vector."""
    x = np.random.default_rng(2).random(37).astype(np.float32)
    grid = Grid.make(*shape, device="cpu")
    mine = DistVec.from_global(grid, x, align=align, fill=-1.5)
    ref = jax_vec.DistVec.from_global(JaxGrid.make(*shape), x, align=align, fill=-1.5)
    there, ref_there = mine.realign(other(align)), ref.realign(other(align))
    assert_same_vec(there, ref_there)
    assert_same_vec(there.realign(align), ref_there.realign(align))
    np.testing.assert_array_equal(there.realign(align).to_global(), x)
    assert mine.realign(align) is mine


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_distvec_full_and_iota(shape):
    grid, ref_grid = Grid.make(*shape, device="cpu"), JaxGrid.make(*shape)
    assert_same_vec(DistVec.full(grid, 11, 3, torch.int32, align="row"),
                    jax_vec.DistVec.full(ref_grid, 11, 3, jnp.int32, align="row"))
    assert_same_vec(DistVec.iota(grid, 11), jax_vec.DistVec.iota(ref_grid, 11))
    assert_same_vec(DistVec.iota(grid, 11, torch.float32, align="row"),
                    jax_vec.DistVec.iota(ref_grid, 11, jnp.float32, align="row"))


@pytest.mark.parametrize("name", ["gather", "sort", "invert", "uniq", "randperm", "reduce",
                                  "scatter_combine", "find_inds", "apply", "ewise",
                                  "mask_padding"])
def test_distvec_ops_of_the_spmv_layer_are_not_ported(name):
    v = DistVec.iota(Grid.make(1, 1, device="cpu"), 4)
    with pytest.raises(NotImplementedError, match=f"{name}.*item 9"):
        getattr(v, name)(v, v, v)


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_distmultivec_from_global_realign_and_back(shape, align):
    x = np.random.default_rng(3).integers(-1, 5, (37, 3)).astype(np.int8)
    grid = Grid.make(*shape, device="cpu")
    mine = DistMultiVec.from_global(grid, x, align=align, fill=-1)
    ref = jax_vec.DistMultiVec.from_global(JaxGrid.make(*shape), x, align=align, fill=-1)
    assert_same_vec(mine, ref)
    assert (mine.width, mine.block_len) == (ref.width, ref.block_len)
    np.testing.assert_array_equal(mine.to_global(), x)
    there, ref_there = mine.realign(other(align)), ref.realign(other(align))
    assert_same_vec(there, ref_there)
    assert_same_vec(there.realign(align), ref_there.realign(align))
    np.testing.assert_array_equal(there.to_global(), x)


def test_unknown_alignment_raises():
    with pytest.raises(ValueError, match="'row' or 'col'"):
        DistVec.from_global(Grid.make(1, 1, device="cpu"), np.zeros(3), align="diag")
