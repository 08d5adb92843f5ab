"""Parity of the port's random streams and edge generators with
``combblas_tpu`` on the CPU: the threefry primitives (``utils/threefry.py``)
against ``jax.random`` under ``jax_threefry_partitionable``, the device
R-MAT generator ``rmat_edges`` against the reference's, the Graph500 v2.1
generator (numpy and native) against the reference generator's golden
edges and the reference's numpy stream, and ``DistVec.randperm`` with a
key; and five API repairs of the port (``SpParMat.tile_map(out_like=)``,
``SpParMat.load_imbalance``, ``segment_reduce(ids_sorted=)``,
``spgemm(merge_source=)``, ``semiring.ADD_KINDS``). Every comparison is
bit for bit: the data are integers, or floats compared by their bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from combblas_tpu import semiring as jax_semiring
from combblas_tpu.ops import segment as jax_segment
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spgemm import spgemm as jax_spgemm
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu.utils import refgen21 as jax_refgen21
from combblas_tpu.utils.rmat import rmat_edges as jax_rmat_edges
from combblas_tpu.utils.rmat import rmat_symmetric_coo as jax_rmat_symmetric_coo
from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    SELECT2ND_MAX,
    DistVec,
    Grid,
    SpParMat,
    graph500_edges,
    graph500_edges_native,
    key_from_jax,
    rmat_edges,
    rmat_symmetric_coo,
    semiring,
    spgemm,
)
from combblas_tpu_torch import _build
from combblas_tpu_torch.ops.segment import segment_reduce
from combblas_tpu_torch.utils import refgen21, threefry
from test_refgen21 import GOLDEN_S6_SEED0, GOLDEN_S10_SEED_DECAFBAD


def carried(k) -> threefry.ThreefryKey:
    return key_from_jax(np.asarray(jax.random.key_data(k)))


def same_key(got: threefry.ThreefryKey, want) -> None:
    np.testing.assert_array_equal(got.data(), np.asarray(jax.random.key_data(want)))


# --- threefry primitives ------------------------------------------------------


def test_jax_partitionable_threefry_is_the_reference_stream():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -7])
def test_key_from_seed(seed):
    same_key(threefry.key(seed), jax.random.key(seed))
    np.testing.assert_array_equal(threefry.key(seed).data(),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_key_from_jax_round_trips_and_checks_its_input():
    k = jax.random.key(5)
    assert carried(k) == threefry.key(5)
    assert key_from_jax(np.asarray(jax.random.PRNGKey(5))) == threefry.key(5)
    with pytest.raises(ValueError, match="uint32"):
        key_from_jax(np.zeros(2, np.int64))


@pytest.mark.parametrize("num", [1, 2, 4, 7])
def test_split(num):
    k = jax.random.key(11)
    for got, want in zip(threefry.split(carried(k), num), jax.random.split(k, num)):
        same_key(got, want)


@pytest.mark.parametrize("data", [0, 1, 17, 2**32 - 1])
def test_fold_in(data):
    k = jax.random.key(3)
    same_key(threefry.fold_in(carried(k), data), jax.random.fold_in(k, data))


@pytest.mark.parametrize("shape", [(1,), (5,), (7, 3), (64, 20)])
def test_bits_count_the_flat_index(shape):
    k = jax.random.key(9)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    got = threefry.bits(carried(k), shape, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_bits_with_an_offset_continue_the_stream():
    k = jax.random.key(9)
    whole = np.asarray(jax.random.bits(k, (300,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(threefry.bits(carried(k), (40, 5), "cpu", offset=100)
                                  .numpy().reshape(-1), whole[100:300])


def test_uniform_unit_interval():
    k = jax.random.key(2)
    want = np.asarray(jax.random.uniform(k, (257, 3)))
    got = threefry.uniform(carried(k), (257, 3), device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_noise_range_is_rounded_once():
    """``floats * (max - min) + min`` is one fused multiply-add in the
    reference's XLA program: a million draws equal it bit for bit, where a
    separately rounded product would differ in about 2% of them."""
    k = jax.random.key(4)
    shape = (1 << 20,)
    want = np.asarray(jax.jit(lambda k: jax.random.uniform(k, shape, minval=0.95,
                                                           maxval=1.05))(k))
    got = threefry.uniform(carried(k), shape, 0.95, 1.05, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo, hi", [(-1.0, 1.0), (2.0, 3.0)])
def test_uniform_other_ranges(lo, hi):
    """Ranges where the float64 form is exact match the reference; ranges
    where it could round twice raise instead of drifting."""
    k = jax.random.key(6)
    want = np.asarray(jax.jit(lambda k: jax.random.uniform(k, (4096,), minval=lo,
                                                           maxval=hi))(k))
    got = threefry.uniform(carried(k), (4096,), lo, hi, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="bit for bit"):
        threefry.uniform(carried(k), (8,), 1000.0, 1001.0, device="cpu")


@pytest.mark.parametrize("n", [1, 2, 10, 128, 1000, 1 << 16])
def test_permutation(n):
    k = jax.random.key(n)
    got = threefry.permutation(carried(k), n, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.permutation(k, n)))


# --- the device R-MAT generator -------------------------------------------------


@pytest.mark.parametrize("scale, edgefactor, seed, noise",
                         [(6, 8, 11, True), (7, 16, 1, True), (8, 4, 5, False),
                          (9, 16, 3, True), (10, 16, 42, True)])
def test_rmat_edges_matches_reference(scale, edgefactor, seed, noise):
    k = jax.random.key(seed)
    ws, wd = jax_rmat_edges(k, scale, edgefactor << scale, noise)
    gs, gd = rmat_edges(carried(k), scale, edgefactor << scale, noise, device="cpu")
    assert gs.dtype == gd.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_rmat_edges_drawn_in_pieces_is_the_same_stream(monkeypatch):
    k = jax.random.key(8)
    whole = rmat_edges(carried(k), 8, 2048, device="cpu")
    from combblas_tpu_torch.utils import rmat

    monkeypatch.setattr(rmat, "RMAT_PIECE_WORDS", 8 * 37)  # pieces of 37 edges
    pieces = rmat_edges(carried(k), 8, 2048, device="cpu")
    for a, b in zip(whole, pieces):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_rmat_symmetric_coo_matches_reference():
    k = jax.random.key(9)
    wr, wc = jax_rmat_symmetric_coo(k, 7, 8)
    gr, gc = rmat_symmetric_coo(carried(k), 7, 8, device="cpu")
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gc, wc)
    assert gr.dtype == wr.dtype


# --- DistVec.randperm with a key ------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)], ids=["1x1", "2x2", "2x4"])
@pytest.mark.parametrize("align", ["row", "col"])
def test_randperm_with_a_key_matches_reference(shape, align):
    for n in (7, 37, 1000):
        k = jax.random.key(n)
        want = JaxDistVec.randperm(JaxGrid.make(*shape), n, k, align=align)
        got = DistVec.randperm(Grid.make(*shape, device="cpu"), n, carried(k), align=align)
        assert (got.length, got.align) == (want.length, want.align)
        np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))


# --- the Graph500 v2.1 generator -------------------------------------------------


def test_graph500_edges_golden():
    s, d = graph500_edges(10, nedges=16, userseed=0xDECAFBAD)
    np.testing.assert_array_equal(np.stack([s, d], 1), GOLDEN_S10_SEED_DECAFBAD)
    s, d = graph500_edges(6, nedges=20, userseed=0)
    np.testing.assert_array_equal(np.stack([s, d], 1), GOLDEN_S6_SEED0)


def test_graph500_edges_native_golden():
    s, d = graph500_edges_native(10, nedges=16, userseed=0xDECAFBAD, nthreads=4)
    np.testing.assert_array_equal(np.stack([s, d], 1), GOLDEN_S10_SEED_DECAFBAD)
    s, d = graph500_edges_native(6, nedges=20, userseed=0)
    np.testing.assert_array_equal(np.stack([s, d], 1), GOLDEN_S6_SEED0)


@pytest.mark.parametrize("scale, nedges, seed, start, end",
                         [(8, 64, 42, 0, None), (9, 512, 7, 17, 401), (12, 4096, 0xDECAFBAD, 0, None)])
def test_graph500_edges_match_reference(scale, nedges, seed, start, end):
    want = jax_refgen21.graph500_edges(scale, nedges, seed, start_edge=start, end_edge=end)
    got = graph500_edges(scale, nedges, seed, start_edge=start, end_edge=end)
    for nthreads in (1, 3, 16):
        nat = graph500_edges_native(scale, nedges, seed, start_edge=start, end_edge=end,
                                    nthreads=nthreads)
        for g, n, w in zip(got, nat, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(n, w)
    np.testing.assert_array_equal(refgen21.skip_table(), jax_refgen21.skip_table())
    np.testing.assert_array_equal(refgen21.make_mrg_seed(seed, seed),
                                  jax_refgen21.make_mrg_seed(seed, seed))


def test_generate_kronecker_range_matches_reference():
    seed5 = jax_refgen21.make_mrg_seed(3, 9)
    for a, b in zip(refgen21.generate_kronecker_range(seed5, 11, 100, 300),
                    jax_refgen21.generate_kronecker_range(seed5, 11, 100, 300)):
        np.testing.assert_array_equal(a, b)


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """No quiet fallback: with no g++ the native generator raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_host_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        graph500_edges_native(6, nedges=4)


def test_native_build_raises_on_a_compile_error(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "graphgen.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_host_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for io/native/graphgen.cpp"):
        graph500_edges_native(6, nedges=4)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_host_build_is_keyed_by_source_and_reused():
    first = _build.build_host("graphgen")
    again = _build.build_host("graphgen")
    assert again == {"seconds": 0.0, "path": first["path"]}
    assert first["path"].startswith(str(_build.BUILD_DIR))


# --- API repairs -----------------------------------------------------------------------


def _transpose_tile(t):
    return t.transpose()


SEMIRINGS = {"select2nd_max": (jax_semiring.SELECT2ND_MAX, SELECT2ND_MAX),
             "plus_times": (jax_semiring.PLUS_TIMES, PLUS_TIMES),
             "min_plus": (jax_semiring.MIN_PLUS, MIN_PLUS)}


def grids(shape):
    return JaxGrid.make(*shape), Grid.make(*shape, device="cpu")


def assert_same_mat(got: SpParMat, want) -> None:
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    for f in ("rows", "cols", "vals", "nnz"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=f)


def test_tile_map_out_like_matches_reference():
    """A tile function that changes the tile's shape: with ``out_like`` the
    result takes its dims, without it the input's, as in the reference."""
    jg, tg = grids((2, 2))
    d = (np.random.default_rng(6).random((10, 6)) < 0.4).astype(np.float32)
    dt = np.ascontiguousarray(d.T)
    jA, jB = JaxSpParMat.from_dense(jg, d), JaxSpParMat.from_dense(jg, dt)
    gA, gB = SpParMat.from_dense(tg, d), SpParMat.from_dense(tg, dt)
    assert_same_mat(gA.tile_map(_transpose_tile, out_like=gB),
                    jA.tile_map(_transpose_tile, out_like=jB))
    assert_same_mat(gA.tile_map(_transpose_tile), jA.tile_map(_transpose_tile))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)], ids=["1x1", "2x2", "2x4"])
def test_load_imbalance_matches_reference(shape):
    jg, tg = grids(shape)
    d = (np.random.default_rng(8).random((19, 19)) < 0.2).astype(np.float32)
    d[:5, :5] = 1  # a dense corner loads one tile
    got = SpParMat.from_dense(tg, d).load_imbalance()
    want = JaxSpParMat.from_dense(jg, d).load_imbalance()
    assert got.dtype == torch.float32
    assert got.item() == float(np.asarray(want))
    empty = SpParMat.from_dense(tg, np.zeros((4, 4), np.float32)).load_imbalance()
    assert empty.item() == float(np.asarray(
        JaxSpParMat.from_dense(jg, np.zeros((4, 4), np.float32)).load_imbalance()))


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "select2nd_max"])
def test_segment_reduce_ids_sorted_hint(name):
    jsr, tsr = SEMIRINGS[name]
    rng = np.random.default_rng(2)
    ids = np.sort(rng.integers(0, 12, 50)).astype(np.int32)
    vals = rng.integers(-5, 5, 50).astype(np.float32)
    want = np.asarray(jax_segment.segment_reduce(jsr, jnp.asarray(vals), jnp.asarray(ids), 10,
                                                 ids_sorted=True))
    for hint in (True, False):
        got = segment_reduce(tsr, torch.from_numpy(vals), torch.from_numpy(ids), 10,
                             ids_sorted=hint)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_spgemm_accepts_merge_source():
    jg, tg = grids((2, 2))
    d = (np.random.default_rng(3).random((12, 12)) < 0.3) * np.float32(2)
    d = d.astype(np.float32)
    want = jax_spgemm(jax_semiring.MAX_MIN, JaxSpParMat.from_dense(jg, d),
                      JaxSpParMat.from_dense(jg, d), merge="runs", merge_source="arg")
    got = spgemm(MAX_MIN, SpParMat.from_dense(tg, d), SpParMat.from_dense(tg, d),
                 merge="runs", merge_source="arg")
    np.testing.assert_array_equal(got.to_dense(), np.asarray(want.to_dense()))


def test_add_kinds():
    assert semiring.ADD_KINDS == jax_semiring.ADD_KINDS
    assert all(sr.add_kind in semiring.ADD_KINDS for sr in semiring.STANDARD_SEMIRINGS.values())
