"""Parity of the port's file I/O (``io/mm.py``, ``io/labels.py``) and
``.npz`` checkpoints (``utils/checkpoint.py``) with ``combblas_tpu`` on the
CPU. Each writer writes the reference's bytes, each reader gives the
reference's arrays on the files ``tests/test_io.py`` uses, and each
package reads the other's files. Loaded matrices and vectors are compared
tile array for tile array. Everything is integer, unit-valued or parsed
text, so every comparison is exact.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jax_semiring
from combblas_tpu.io import labels as jax_labels
from combblas_tpu.io import mm as jax_mm
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu.utils import checkpoint as jax_checkpoint
from combblas_tpu_torch import (
    PLUS_TIMES,
    DistVec,
    Grid,
    SpParMat,
    checkpoint,
    read_binary,
    read_labeled_spmat,
    read_labeled_tuples,
    read_mm,
    read_mm_distributed,
    read_mm_spmat,
    read_vec,
    write_binary,
    write_mm,
    write_vec,
)
from combblas_tpu_torch import _build
from combblas_tpu_torch.io import mm as port_mm
from test_io import MM_GENERAL, MM_PATTERN, MM_SYMMETRIC

MM_ARRAY = "%%MatrixMarket matrix array real general\n2 2\n1.0\n2.5\n0.0\n3.0\n"
MM_ARRAY_SYM = "%%MatrixMarket matrix array real symmetric\n2 2\n1.0\n2.0\n0.0\n"
MM_SKEW = """%%MatrixMarket matrix coordinate real skew-symmetric
3 3 2
2 1 4.5
3 2 -1.0
"""
FILES = {"general": MM_GENERAL, "symmetric": MM_SYMMETRIC, "pattern": MM_PATTERN,
         "skew": MM_SKEW, "array": MM_ARRAY, "array_symmetric": MM_ARRAY_SYM}


def grids(shape):
    return JaxGrid.make(*shape), Grid.make(*shape, device="cpu")


def assert_same_mat(got: SpParMat, want) -> None:
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    for f in ("rows", "cols", "vals", "nnz"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=f)


def assert_same_vec(got: DistVec, want) -> None:
    assert (got.length, got.align) == (want.length, want.align)
    w = np.asarray(want.blocks)
    assert got.blocks.numpy().dtype == w.dtype
    np.testing.assert_array_equal(got.blocks.numpy(), w)


def assert_same_arrays(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def weighted(m, n, density, seed):
    """Random (rows, cols, vals) with values of 3-4 significant digits and a
    few integers, as files hold them."""
    rng = np.random.default_rng(seed)
    d = (rng.random((m, n)) < density) * np.round(rng.random((m, n)) * 100 - 50, 2)
    r, c = np.nonzero(d)
    return r, c, d[r, c]


# --- Matrix Market ----------------------------------------------------------------


@pytest.mark.parametrize("name", FILES)
def test_read_mm_matches_reference(tmp_path, name):
    p = tmp_path / f"{name}.mtx"
    p.write_text(FILES[name])
    assert_same_arrays(read_mm(str(p)), jax_mm.read_mm(str(p)))
    assert_same_arrays(read_mm(str(p), expand_symmetric=False),
                       jax_mm.read_mm(str(p), expand_symmetric=False))
    assert_same_arrays(port_mm._read_mm_python(str(p)), jax_mm._read_mm_python(str(p)))


def test_native_parser_order_does_not_depend_on_threads(tmp_path):
    r, c, v = weighted(300, 200, 0.1, 1)
    p = str(tmp_path / "big.mtx")
    write_mm(p, (r, c, v, 300, 200))
    one = read_mm(p, nthreads=1)
    for nt in (2, 7, 16):
        assert_same_arrays(read_mm(p, nthreads=nt), one)
    assert_same_arrays(one, jax_mm.read_mm(p))
    expect = port_mm._read_mm_python(p)[:5]
    assert_same_arrays(one, expect)


@pytest.mark.parametrize("form", ["tuples", "spparmat"])
def test_write_mm_writes_the_reference_bytes(tmp_path, form):
    r, c, v = weighted(13, 9, 0.3, 2)
    if form == "tuples":
        mine, ref = (r, c, v, 13, 9), (r, c, v, 13, 9)
    else:
        d = np.zeros((13, 9), np.float32)
        d[r, c] = v
        jg, tg = grids((2, 2))
        mine, ref = SpParMat.from_dense(tg, d), JaxSpParMat.from_dense(jg, d)
    a, b = tmp_path / "port.mtx", tmp_path / "ref.mtx"
    write_mm(str(a), mine, comment="two lines\nof comment")
    jax_mm.write_mm(str(b), ref, comment="two lines\nof comment")
    assert a.read_bytes() == b.read_bytes()
    # each package reads the other's file
    assert_same_arrays(read_mm(str(b)), jax_mm.read_mm(str(a)))


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_read_mm_spmat_and_distributed_match_reference(tmp_path, shape):
    jg, tg = grids(shape)
    p = str(tmp_path / "g.mtx")
    r, c, v = weighted(24, 24, 0.2, 3)
    # duplicates, so that the dedup path combines some
    write_mm(p, (np.r_[r, r[:5]], np.r_[c, c[:5]], np.r_[v, v[:5]], 24, 24))
    assert_same_mat(read_mm_spmat(tg, p), jax_mm.read_mm_spmat(jg, p))
    assert_same_mat(read_mm_spmat(tg, p, dedup_sr=PLUS_TIMES),
                    jax_mm.read_mm_spmat(jg, p, dedup_sr=jax_semiring.PLUS_TIMES))
    assert_same_mat(read_mm_distributed(tg, p), jax_mm.read_mm_distributed(jg, p))
    assert_same_mat(read_mm_distributed(tg, p, dedup_sr=PLUS_TIMES),
                    jax_mm.read_mm_distributed(jg, p, dedup_sr=jax_semiring.PLUS_TIMES))


def test_read_mm_distributed_symmetric(tmp_path):
    jg, tg = grids((2, 2))
    p = tmp_path / "s.mtx"
    p.write_text(MM_SYMMETRIC)
    assert_same_mat(read_mm_distributed(tg, str(p)), jax_mm.read_mm_distributed(jg, str(p)))


def test_read_mm_raises_when_the_parser_cannot_be_built(monkeypatch, tmp_path):
    """No quiet Python fallback for coordinate files."""
    p = tmp_path / "a.mtx"
    p.write_text(MM_GENERAL)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_host_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="mmparse.cpp cannot be built"):
        read_mm(str(p))


# --- binary triples --------------------------------------------------------------


def test_binary_round_trip_and_reference_bytes(tmp_path):
    r, c, v = weighted(17, 21, 0.25, 4)
    a, b = tmp_path / "port.bin", tmp_path / "ref.bin"
    write_binary(str(a), (r, c, v, 17, 21))
    jax_mm.write_binary(str(b), (r, c, v, 17, 21))
    assert a.read_bytes() == b.read_bytes()
    assert_same_arrays(read_binary(str(b)), jax_mm.read_binary(str(a)))
    rows, cols, vals, m, n = read_binary(str(a))
    assert (m, n) == (17, 21)
    np.testing.assert_array_equal(np.stack([rows, cols]), np.stack([r, c]))
    np.testing.assert_array_equal(vals, v)


def test_binary_of_a_spparmat(tmp_path):
    jg, tg = grids((2, 2))
    d = np.zeros((11, 11), np.float32)
    r, c, v = weighted(11, 11, 0.3, 5)
    d[r, c] = v
    a, b = tmp_path / "port.bin", tmp_path / "ref.bin"
    write_binary(str(a), SpParMat.from_dense(tg, d))
    jax_mm.write_binary(str(b), JaxSpParMat.from_dense(jg, d))
    assert a.read_bytes() == b.read_bytes()


# --- vectors --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["float32", "int32", "bool"])
def test_vec_round_trip_and_reference_bytes(tmp_path, kind):
    jg, tg = grids((2, 2))
    rng = np.random.default_rng(6)
    x = {"float32": rng.random(15).astype(np.float32),
         "int32": rng.integers(-9, 9, 15).astype(np.int32),
         "bool": rng.random(15) < 0.5}[kind]
    act = rng.random(15) < 0.6
    fill = False if kind == "bool" else 0
    a, b = tmp_path / "port.txt", tmp_path / "ref.txt"
    write_vec(str(a), DistVec.from_global(tg, x, align="row", fill=fill),
              active=DistVec.from_global(tg, act, align="row", fill=False))
    jax_mm.write_vec(str(b), JaxDistVec.from_global(jg, x, align="row", fill=fill),
                     active=JaxDistVec.from_global(jg, act, align="row", fill=False))
    assert a.read_bytes() == b.read_bytes()
    dtype = {"float32": np.float32, "int32": np.int32, "bool": np.bool_}[kind]
    for align in ("row", "col"):
        gv, ga = read_vec(tg, str(b), dtype=dtype, align=align, fill=fill)
        wv, wa = jax_mm.read_vec(jg, str(a), dtype=dtype, align=align, fill=fill)
        assert_same_vec(gv, wv)
        assert_same_vec(ga, wa)
        np.testing.assert_array_equal(ga.to_global(), act)
        np.testing.assert_array_equal(gv.to_global()[act], x[act])


def test_read_vec_rejects_bad_files(tmp_path):
    _, tg = grids((1, 1))
    p = tmp_path / "bad.txt"
    p.write_text("3 1\n4 1.0\n")
    with pytest.raises(ValueError, match="out of range"):
        read_vec(tg, str(p))
    p.write_text("3 1\n2 3.7\n")
    with pytest.raises(ValueError, match="non-integer"):
        read_vec(tg, str(p), dtype=np.int32)


# --- labelled tuples --------------------------------------------------------------


def test_labeled_tuples_match_reference(tmp_path):
    p = tmp_path / "net.txt"
    p.write_text("# comment\nprotA protB 0.9\nprotB protC\nprotA protC 0.4\n"
                 "% another\nprotC protA 0.4\nprotD protD 2\nprotB protC 1.5\n")
    assert_same_arrays(read_labeled_tuples(str(p)), jax_labels.read_labeled_tuples(str(p)))
    jg, tg = grids((2, 2))
    for sym in (False, True):
        gA, gl = read_labeled_spmat(tg, str(p), symmetrize=sym, dedup_sr=PLUS_TIMES)
        wA, wl = jax_labels.read_labeled_spmat(jg, str(p), symmetrize=sym,
                                               dedup_sr=jax_semiring.PLUS_TIMES)
        assert gl == wl == ["protA", "protB", "protC", "protD"]
        assert_same_mat(gA, wA)
    p.write_text("lonely\n")
    with pytest.raises(ValueError, match="expected 'src dst"):
        read_labeled_tuples(str(p))


# --- checkpoints -------------------------------------------------------------------


def members(path) -> dict:
    """The .npy bytes of each member of an .npz (the zip's own timestamps
    differ between any two writes)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def spmat_pair(shape, seed=7):
    jg, tg = grids(shape)
    rng = np.random.default_rng(seed)
    d = ((rng.random((21, 21)) < 0.25) * rng.integers(1, 9, (21, 21))).astype(np.float32)
    return SpParMat.from_dense(tg, d), JaxSpParMat.from_dense(jg, d)


def test_checkpoint_spparmat_same_grid(tmp_path):
    mine, ref = spmat_pair((2, 2))
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    checkpoint.save(a, mine)
    jax_checkpoint.save(b, ref)
    assert members(a) == members(b)
    meta = json.loads(bytes(np.load(a)["__meta__"]).decode())
    assert meta == {"kind": "SpParMat", "nrows": 21, "ncols": 21, "grid": [2, 2]}
    _, tg = grids((2, 2))
    assert_same_mat(checkpoint.load(b, tg), ref)  # the reference's file, verbatim
    assert_same_mat(mine, jax_checkpoint.load(a, JaxGrid.make(2, 2)))


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)], ids=["2x2-to-1x1", "2x2-to-2x4"])
def test_checkpoint_spparmat_across_grids(tmp_path, shape):
    mine, ref = spmat_pair((2, 2))
    a = str(tmp_path / "port.npz")
    checkpoint.save(a, mine)
    jg, tg = grids(shape)
    got = checkpoint.load(a, tg)
    assert_same_mat(got, jax_checkpoint.load(a, jg))
    np.testing.assert_array_equal(got.to_dense(), mine.to_dense())


@pytest.mark.parametrize("align", ["row", "col"])
@pytest.mark.parametrize("to", [(2, 2), (1, 1)], ids=["same-grid", "to-1x1"])
def test_checkpoint_distvec(tmp_path, align, to):
    """The padding fill (-1 here) travels in the meta and pads the vector on
    another grid, as in the reference."""
    jg, tg = grids((2, 2))
    x = np.arange(19, dtype=np.int32) * 3 - 20
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    checkpoint.save(a, DistVec.from_global(tg, x, align=align, fill=-1))
    jax_checkpoint.save(b, JaxDistVec.from_global(jg, x, align=align, fill=-1))
    assert members(a) == members(b)
    jg2, tg2 = grids(to)
    got = checkpoint.load(b, tg2)
    assert_same_vec(got, jax_checkpoint.load(a, jg2))
    np.testing.assert_array_equal(got.to_global(), x)


def test_checkpoint_distvec_without_padding_warns_across_grids(tmp_path):
    jg, tg = grids((2, 2))
    x = np.linspace(0, 1, 20, dtype=np.float32)
    a = str(tmp_path / "v.npz")
    checkpoint.save(a, DistVec.from_global(tg, x, align="row", fill=-1.0))
    jg3, tg3 = grids((4, 2))
    with pytest.warns(UserWarning, match="padding with 0"):
        got = checkpoint.load(a, tg3)
    with pytest.warns(UserWarning, match="padding with 0"):
        want = jax_checkpoint.load(a, jg3)
    assert_same_vec(got, want)
    assert_same_vec(checkpoint.load(a, tg3, fill=np.float32(-1.0)),
                    jax_checkpoint.load(a, jg3, fill=np.float32(-1.0)))


def test_checkpoint_refuses_other_objects(tmp_path):
    with pytest.raises(TypeError, match="unsupported"):
        checkpoint.save(str(tmp_path / "x.npz"), torch.zeros(3))
