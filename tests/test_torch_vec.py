"""Parity of the port's ``DistVec`` / ``DistMultiVec`` and of the
``DistVec`` op pack with ``combblas_tpu.parallel.vec`` on the CPU: blocks
equal array for array (padding rows included), floats by their bits, NaN
cells by position. ``randperm`` draws from a torch.Generator and is
checked for its contract.

``scatter_combine`` runs on small integers and ±0 without NaN: over
several devices the reference's result for a NaN source depends on how
XLA splits its scatter between the devices, which the port (one device)
does not model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.parallel import vec as jax_vec
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu_torch import DistMultiVec, DistVec, Grid, concatenate

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


# --- the op pack --------------------------------------------------------------

SPECIALS = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -2.5, 3.0],
                    np.float32)
jit_sort = jax.jit(jax_vec.DistVec.sort)
jit_uniq = jax.jit(jax_vec.DistVec.uniq)
jit_invert = jax.jit(jax_vec.DistVec.invert, static_argnums=(2, 3))


def both(shape, x, align, fill=0):
    """The same host vector on both packages (padding slots: ``fill``)."""
    return (DistVec.from_global(Grid.make(*shape, device="cpu"), x, align=align, fill=fill),
            jax_vec.DistVec.from_global(JaxGrid.make(*shape), x, align=align, fill=fill))


def assert_same_bits(got, want):
    """Equal blocks, floats by their bits (±0 apart), NaN cells by
    position (NaN payloads differ)."""
    g, w = got.blocks.numpy(), np.asarray(want.blocks)
    assert (got.length, got.align, g.shape, g.dtype) == (want.length, want.align, w.shape,
                                                         w.dtype)
    if g.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        g, w = g[~np.isnan(w)].view(np.int32), w[~np.isnan(w)].view(np.int32)
    np.testing.assert_array_equal(g, w)


def specials(seed, n=23):
    return np.random.default_rng(seed).choice(SPECIALS, n)


def is_pos(v):
    return v > 0


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_apply_and_ewise(shape, align):
    x = np.random.default_rng(10).integers(-9, 9, 23).astype(np.int32)
    y = np.random.default_rng(11).integers(-9, 9, 23).astype(np.int32)
    mine, ref = both(shape, x, align, fill=5)
    mine2, ref2 = both(shape, y, align, fill=-5)
    assert_same_bits(mine.apply(lambda b: b * 3 - 1), ref.apply(lambda b: b * 3 - 1))
    assert_same_bits(mine.ewise(mine2, torch.maximum), ref.ewise(ref2, jnp.maximum))
    with pytest.raises(ValueError, match="ewise"):
        mine.ewise(mine2.realign(other(align)), torch.maximum)


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_mask_padding(shape, align):
    mine, ref = both(shape, np.arange(23, dtype=np.int32), align, fill=7)
    assert_same_bits(mine.mask_padding(-3), ref.mask_padding(-3))


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_gather_clips_the_index(shape, align):
    """Indices out of range (and the index vector's padding) are clipped
    to the padded blocks, as in the reference."""
    rng = np.random.default_rng(12)
    x = (np.arange(23) * 10).astype(np.int32)
    idx = rng.integers(-3, 30, 19).astype(np.int32)
    mine, ref = both(shape, x, align, fill=-1)
    mi, ri = both(shape, idx, other(align), fill=40)
    assert_same_bits(mine.gather(mi), ref.gather(ri))


@pytest.mark.parametrize("sr", ["select2nd_min", "plus_times", "max_min"])
@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_scatter_combine(shape, align, sr):
    """Sources fold by ``sr.add`` into their targets; padding sources and
    targets outside [0, length) drop; untouched slots keep their value."""
    from combblas_tpu_torch import MAX_MIN, PLUS_TIMES, SELECT2ND_MIN
    from combblas_tpu import semiring as jsr

    tsr, jsr_ = {"select2nd_min": (SELECT2ND_MIN, jsr.SELECT2ND_MIN),
                 "plus_times": (PLUS_TIMES, jsr.PLUS_TIMES),
                 "max_min": (MAX_MIN, jsr.MAX_MIN)}[sr]
    rng = np.random.default_rng(13)
    if sr == "select2nd_min":
        base, src = (rng.integers(0, 100, 23).astype(np.int32),
                     rng.integers(0, 100, 31).astype(np.int32))
    else:  # small integers and ±0 (see the module docstring for NaN)
        vals = np.array([0.0, -0.0, 1.0, -2.0, 3.0], np.float32)
        base, src = rng.choice(vals, 23), rng.choice(vals, 31)
    idx = rng.integers(-2, 26, 31).astype(np.int32)
    mine, ref = both(shape, base, align, fill=0)
    mi, ri = both(shape, idx, "col", fill=3)  # padding targets slot 3: dropped
    ms, rs = both(shape, src, "col", fill=1)
    assert_same_bits(mine.scatter_combine(tsr, mi, ms), ref.scatter_combine(jsr_, ri, rs))


@pytest.mark.parametrize("sr", ["plus_times", "min", "max", "generic"])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_reduce(shape, sr):
    """Sums keep the dtype (int32 wraps as in the reference); float min and
    max give the reference's NaN and signed zeros, block by block and over
    the blocks. A generic monoid runs on one block only: the reference's
    cross-device reduction has no generic form."""
    if sr == "generic" and shape != (1, 1):
        shape = (1, 1)
    from combblas_tpu_torch import MAX_MIN, MIN_PLUS, PLUS_TIMES, Semiring
    from combblas_tpu import semiring as jsr

    cases = {
        "plus_times": (PLUS_TIMES, jsr.PLUS_TIMES,
                       [np.array([2**30, 2**30, 2**30, 5], np.int32),
                        np.random.default_rng(16).integers(-50, 50, 23).astype(np.int32)]),
        "min": (MIN_PLUS, jsr.MIN_PLUS,
                [np.array([0.0, -0.0, 1.0], np.float32), np.array([-0.0, 0.0], np.float32),
                 np.array([np.nan, 1.0, -np.inf], np.float32), specials(17)]),
        "max": (MAX_MIN, jsr.MAX_MIN,
                [np.array([-0.0, 0.0, -1.0], np.float32), np.array([0.0, -0.0], np.float32),
                 np.array([1.0, np.nan], np.float32), specials(18)]),
        "generic": (Semiring(name="bor", add=torch.bitwise_or, mul=torch.bitwise_and,
                             zero_fn=lambda dt: 0),
                    jsr.Semiring(name="bor", add=jnp.bitwise_or, mul=jnp.bitwise_and,
                                 zero_fn=lambda dt: 0),
                    [np.random.default_rng(19).integers(0, 2**20, 23).astype(np.int32)]),
    }
    tsr, jsr_, xs = cases[sr]
    for x in xs:
        fill = 0 if sr in ("plus_times", "generic") else (np.inf if sr == "min" else -np.inf)
        mine, ref = both(shape, x, "row", fill=fill)
        got, want = mine.reduce(tsr), np.asarray(ref.reduce(jsr_))
        assert got.shape == () and got.numpy().dtype == want.dtype
        if want.dtype.kind == "f" and np.isnan(want):
            assert got.isnan(), (x, got, want)
        elif want.dtype.kind == "f":
            assert got.numpy().view(np.int32) == want.view(np.int32), (x, got, want)
        else:
            assert got.item() == want.item()
    mine, ref = both(shape, np.ones(23, bool), "col", fill=False)
    assert mine.reduce(PLUS_TIMES).dtype == torch.int32
    assert mine.reduce(PLUS_TIMES).item() == int(ref.reduce(jsr.PLUS_TIMES)) == 23


@pytest.mark.parametrize("data", ["ints", "floats"])
@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_sort(shape, align, data):
    """Values in ``lax.sort``'s order (-NaN, -inf, -0.0, +0.0, ..., NaN),
    ties in slot order, padding last whatever its value."""
    rng = np.random.default_rng(20)
    x = rng.integers(-4, 4, 23).astype(np.int32) if data == "ints" else specials(21)
    mine, ref = both(shape, x, align, fill=-100 if data == "ints" else -np.inf)
    got, want = mine.sort(), jit_sort(ref)
    assert_same_bits(got[0], want[0])
    assert_same_bits(got[1], want[1])


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_find_inds(shape, align):
    x = np.random.default_rng(22).integers(-5, 5, 23).astype(np.int32)
    mine, ref = both(shape, x, align, fill=9)  # positive padding is not found
    (gi, gc), (wi, wc) = mine.find_inds(is_pos), ref.find_inds(is_pos)
    assert_same_bits(gi, wi)
    assert gc.dtype == torch.int32 and int(gc) == int(wc)


@pytest.mark.parametrize("out_length", [8, 31])
@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_invert(shape, align, out_length):
    """Collisions resolve by ``sr.add``, untouched outputs are -1, values
    outside [0, out_length) and inactive slots drop."""
    from combblas_tpu_torch import SELECT2ND_MAX, SELECT2ND_MIN
    from combblas_tpu import semiring as jsr

    rng = np.random.default_rng(23)
    x = rng.integers(-2, 12, 23).astype(np.int32)
    act = rng.random(23) < 0.7
    mine, ref = both(shape, x, align, fill=1)
    ma, ra = both(shape, act, align, fill=True)  # active padding must not count
    for tsr, jsr_ in ((SELECT2ND_MIN, jsr.SELECT2ND_MIN), (SELECT2ND_MAX, jsr.SELECT2ND_MAX)):
        assert_same_bits(mine.invert(ma, out_length, tsr), jit_invert(ref, ra, out_length, jsr_))


@pytest.mark.parametrize("data", ["ints", "floats"])
@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_uniq(shape, align, data):
    """The first active occurrence (by value, then index) of each value
    stays; ±0 are one value, every NaN its own."""
    rng = np.random.default_rng(24)
    x = rng.integers(0, 6, 23).astype(np.int32) if data == "ints" else specials(25)
    act = rng.random(23) < 0.8
    mine, ref = both(shape, x, align, fill=0)
    ma, ra = both(shape, act, align, fill=True)
    assert_same_bits(mine.uniq(ma), jit_uniq(ref, ra))


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_randperm_is_a_permutation_with_padding_last(shape, align):
    """``randperm`` draws from a torch.Generator, so its permutation is not
    the reference's: it is a permutation of [0, length) with the padding
    slots after it in order, and the same seed gives the same one."""
    grid = Grid.make(*shape, device="cpu")
    p = DistVec.randperm(grid, 23, torch.Generator().manual_seed(7), align=align)
    ref = jax_vec.DistVec.iota(JaxGrid.make(*shape), 23, align=align)
    assert p.blocks.shape == np.asarray(ref.blocks).shape and p.blocks.dtype == torch.int32
    flat = p.blocks.reshape(-1).numpy()
    np.testing.assert_array_equal(np.sort(flat[:23]), np.arange(23))
    np.testing.assert_array_equal(flat[23:], np.arange(23, flat.shape[0]))
    again = DistVec.randperm(grid, 23, torch.Generator().manual_seed(7), align=align)
    assert torch.equal(p.blocks, again.blocks)
    other_seed = DistVec.randperm(grid, 23, torch.Generator().manual_seed(8), align=align)
    assert not torch.equal(p.blocks, other_seed.blocks)
    default = DistVec.randperm(grid, 23, align=align)  # the grid device's default generator
    assert default.blocks.device == grid.device
    np.testing.assert_array_equal(np.sort(default.blocks.reshape(-1).numpy()[:23]), np.arange(23))


@pytest.mark.parametrize("target", [None, (2, 2), (1, 1)], ids=["first", "2x2", "1x1"])
def test_concatenate(target):
    """Vectors on different grids and alignments, cut to their lengths,
    joined and laid out on the target grid, padded with ``fill``."""
    parts = [(np.arange(5, dtype=np.int32), (2, 4), "row"),
             (np.arange(100, 113, dtype=np.int32), (2, 2), "col"),
             (np.arange(7, dtype=np.int32) - 7, (1, 1), "row")]
    mine = [DistVec.from_global(Grid.make(*s, device="cpu"), x, align=a, fill=-9)
            for x, s, a in parts]
    ref = [jax_vec.DistVec.from_global(JaxGrid.make(*s), x, align=a, fill=-9)
           for x, s, a in parts]
    kw_m = {} if target is None else {"grid": Grid.make(*target, device="cpu"), "align": "col"}
    kw_r = {} if target is None else {"grid": JaxGrid.make(*target), "align": "col"}
    assert_same_bits(concatenate(mine, fill=-1, **kw_m),
                     jax_vec.concatenate(ref, fill=-1, **kw_r))
    with pytest.raises(ValueError, match="at least one"):
        concatenate([])


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
