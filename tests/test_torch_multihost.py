"""The port's grid over several processes (``parallel/multihost.py``) on the
CPU: two ranks over gloo run the reference's multi-process path
(``tests/_multihost_worker.py``) and the rest of the slice
(``tests/_torch_multihost_worker.py``), held against

  * the port's one-process grid of the same shape, bit for bit for every
    semiring (float ``plus`` included: the partials are folded in grid
    order on every rank), the Matrix Market read as entries (its chunks,
    and so its slot order, differ);
  * the JAX package run in this process on the 8-device CPU mesh at the
    same grid shape: bit-exact for the integer case and min_plus,
    ``plus_times`` on random float32 within ``rtol=1e-5, atol=1e-6`` (the
    order of a float sum differs), the mxu tier's Pallas kernel in
    interpret mode.

The two ranks run once for the module (about 15 s, while this process
computes the one-process and JAX sides); ``multihost.launch`` kills both
and raises as soon as one fails, and the run and every collective time out
after 120 s, so a hung rank ends its test, not the suite.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multihost_worker as worker
from combblas_tpu.io.mm import read_mm_distributed as jax_read_mm_distributed
from combblas_tpu.obs.sinks import psum_counters as jax_psum_counters
from combblas_tpu.parallel.grid import Grid as JGrid
from combblas_tpu.parallel.spgemm import spgemm as jax_spgemm
from combblas_tpu.parallel.spgemm import summa_spgemm_mxu as jax_summa_spgemm_mxu
from combblas_tpu.parallel.spmat import SpParMat as JSpParMat
from combblas_tpu.parallel.spmv import dist_spmv
from combblas_tpu.parallel.vec import DistVec as JDistVec
from combblas_tpu.semiring import MIN_PLUS as J_MIN_PLUS
from combblas_tpu.semiring import PLUS_TIMES as J_PLUS_TIMES
from combblas_tpu_torch import Grid, LocalOnlyError
from combblas_tpu_torch.io.mm import read_mm, read_mm_range, write_mm
from combblas_tpu_torch.parallel import multihost

JAX_SR = {"plus_times": J_PLUS_TIMES, "min_plus": J_MIN_PLUS, "int": J_PLUS_TIMES}
jax_dist_spmv = jax.jit(dist_spmv, static_argnums=0)
RTOL, ATOL = 1e-5, 1e-6  # plus_times on random float32 against the JAX package
GRID_KEYS = [k for k in worker.GRIDS]
# the ranks' environment: two threads each (the data is tiny; the suite
# runs several files at once)
RANK_ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
# the per-(grid, case) values held bit for bit against the one-process grid
PER_CASE = ["coo", "nnz", "imbalance", "spmv", "spmv_masked", "spgemm", "spgemm_caps",
            "stage_flops", "mxu", "mxu_overflow"]
PER_GRID = ["dups", "redistribute", "redistribute_drops", "from_device_coo", "mm_dedup", "psum"]


def _keys(one):
    out = []
    for g in GRID_KEYS:
        for case in worker.CASES:
            out += [f"{g}/{case}/{k}" for k in PER_CASE if f"{g}/{case}/{k}" in one]
        out += [f"{g}/{k}" for k in PER_GRID]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ranks": [rank 0's, rank 1's], "one": one-process, "jax": JAX
    package}`` results; the ranks run in a thread while this process
    computes the others."""
    tmp = tmp_path_factory.mktemp("multihost")
    r, c, v = worker.matrix("plus_times")
    mm = str(tmp / "graph.mtx")
    write_mm(mm, (r, c, v, worker.N, worker.N))
    got = {}

    def ranks():
        try:
            got["ranks"] = multihost.launch(
                f"{worker.__file__}:job", 2, kwargs={"mm_path": mm}, device="cpu",
                timeout_s=120.0, workdir=tmp / "ranks", env=RANK_ENV)
        except Exception as e:  # noqa: BLE001 - re-raised in the test thread
            got["error"] = e

    t = threading.Thread(target=ranks)
    t.start()
    one = worker.one_process(mm)
    jax_side = _jax_results(mm)
    t.join(180)
    assert not t.is_alive(), "the ranks' thread outlived its launch timeout"
    if "error" in got:
        raise got["error"]
    return {"ranks": got["ranks"], "one": one, "jax": jax_side}


def _jax_results(mm: str) -> dict:
    """The JAX package's values at the worker's grid shapes."""
    out = {}
    for gname in ("2x4", "2x2"):
        pr, pc, _ = worker.GRIDS[gname]
        grid = JGrid.make(pr, pc)
        for case, (_, dt) in worker.CASES.items():
            key = f"{gname}/{case}"
            sr = JAX_SR[case]
            r, c, v = worker.matrix(case)
            A = JSpParMat.from_global_coo(grid, r, c, v, worker.N, worker.N)
            out[key + "/nnz"] = int(A.getnnz())
            x = JDistVec.from_global(grid, np.arange(worker.N, dtype=dt), align="col")
            out[key + "/spmv"] = np.asarray(jax_dist_spmv(sr, A, x).blocks)
            if pr == pc:
                C = jax_spgemm(sr, A, A)
                out[key + "/spgemm"] = (*C.to_global_coo(), C.capacity)
                if dt == np.float32:
                    C, over = jax_summa_spgemm_mxu(sr, A, A,
                                                   out_capacity=A.local_rows * A.local_cols,
                                                   interpret=True)
                    out[key + "/mxu"] = ((*C.to_global_coo(), C.capacity), int(over))
        M = jax_read_mm_distributed(grid, mm)
        out[gname + "/mm"] = (*M.to_global_coo(), int(M.getnnz()))
        cnt = np.array([[[10 * i + j, 1, 7] for j in range(pc)] for i in range(pr)], np.int32)
        out[gname + "/psum"] = np.asarray(jax_psum_counters(grid, jnp.asarray(cnt)))
    return out


def same_bits(a, b) -> bool:
    """Equal values, dtypes and shapes, floats by their bits; tuples
    element by element."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.kind == "f":
            return np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))
        return np.array_equal(a, b)
    return a == b


def sorted_entries(r, c, v):
    o = np.lexsort((np.asarray(c), np.asarray(r)))
    return np.asarray(r, np.int64)[o], np.asarray(c, np.int64)[o], np.asarray(v)[o]


def test_ranks_hold_the_same_results(runs):
    """Every value the two ranks computed is replicated: equal bits."""
    r0, r1 = runs["ranks"]
    for k in runs["one"]:
        assert same_bits(r0[k], r1[k]), k


@pytest.mark.parametrize("grid", GRID_KEYS)
def test_two_ranks_equal_one_process(runs, grid):
    """The main path and the rest of the slice on two ranks give the
    one-process grid's values bit for bit: tiles (indices, values, counts
    and capacity, in tile order), nnz and load imbalance, ``dist_spmv``
    and ``dist_spmv_masked`` blocks, ``spgemm`` and its capacities, the
    symbolic pass, ``summa_spgemm_mxu`` and its overflow (also when it
    truncates), ``coo_has_duplicates``, ``redistribute_coo`` and its drop
    count (also when it drops), ``from_device_coo`` with its retries, the
    deduplicated Matrix Market read and ``psum_counters``."""
    keys = [k for k in _keys(runs["one"]) if k.startswith(grid + "/")]
    assert len(keys) >= 20
    for k in keys:
        assert same_bits(runs["ranks"][0][k], runs["one"][k]), k


@pytest.mark.parametrize("grid", GRID_KEYS)
def test_byte_range_read_equals_whole_file(runs, grid):
    """``read_mm_distributed`` over two ranks, each parsing its byte range,
    holds the one-process read's entries (sorted; the chunks and so the
    slot order differ) and the file's."""
    got, want = runs["ranks"][0][grid + "/mm"], runs["one"][grid + "/mm"]
    for a, b in zip(sorted_entries(*got[:3]), sorted_entries(*want[:3])):
        assert same_bits(a, b)
    r, c, v = worker.matrix("plus_times")
    assert len(got[0]) == len(r)


# on 2x4 these raise the same ValueError on one process and on two ranks:
# add_loops needs square blocking, the products a square grid
NEED_SQUARE = {"add_loops", "square", "summa_spgemm_ring"}


@pytest.mark.parametrize("op", sorted(worker.OPS))
@pytest.mark.parametrize("grid", worker.OPS_GRIDS)
def test_carried_methods_equal_one_process(runs, grid, op):
    """Each ``SpParMat`` method the slice carries gives, on two ranks, the
    one-process result (or the same error) bit for bit."""
    k = f"{grid}/op/{op}"
    got, want = runs["ranks"][0][k], runs["one"][k]
    assert same_bits(got, want), (got, want)
    if op not in NEED_SQUARE or grid != "2x4":
        assert not (isinstance(want, tuple) and isinstance(want[0], str)), want


GUARDED = ([f"SpParMat.{n}" for n in worker.SPMAT_GUARDED]
           + [f"DistVec.{n}" for n in worker.VEC_GUARDED]
           + [f"app.{n}" for n in worker._apps()])


@pytest.mark.parametrize("name", GUARDED)
def test_outside_the_slice_raises(runs, name):
    """A method or app the slice does not carry raises ``LocalOnlyError``
    on a grid over several processes, naming its ROADMAP sub-item, on
    both ranks."""
    for res in runs["ranks"]:
        kind, *msg = res[f"guard/{name}"]
        assert kind == "LocalOnlyError", (name, kind, msg)
        assert "ROADMAP item 12c." in msg[0], msg


def test_each_rank_holds_only_its_tiles(runs):
    """``make_global_grid`` lays the tiles out process-major, as the
    reference lays out a grid over all its devices, and refuses a grid that
    leaves a rank without a tile; ``grid_of_owners`` gives the reference's
    round-robin 2x2 subgrid, and refuses owners that leave a rank out. A
    rank's tile tensors hold its own tiles only: ``[k, cap]`` for its k
    tiles."""
    r0, r1 = runs["ranks"]
    assert r0["owners"] == r1["owners"] == (0, 1, 0, 1)
    assert r0["owned"] == [(0, 0), (1, 0)] and r1["owned"] == [(0, 1), (1, 1)]
    for gname, owners in (("2x4", (0, 0, 0, 0, 1, 1, 1, 1)), ("2x2", (0, 0, 1, 1)),
                          ("2x2rr", (0, 1, 0, 1))):
        assert r0[f"owners/{gname}"] == owners
    assert r0["owners/1x3"] == r1["owners/1x3"] == (0, 0, 1)
    for res in (r0, r1):
        assert res["refused/1x1"][:2] == ("raised", "ValueError"), res["refused/1x1"]
        assert res["refused/owners"][:2] == ("raised", "ValueError"), res["refused/owners"]
    cap = runs["one"]["2x2rr/plus_times/coo"][3]
    for res in (r0, r1):
        assert res["tile_shapes"] == ((2, cap), (2, cap), (2,))


def test_ranks_agree_on_capacity(runs):
    """Capacities are global: both ranks allocate the one-process
    capacity, for the input matrices and for the products."""
    r0, r1 = runs["ranks"]
    for k in runs["one"]:
        if k.endswith(("/coo", "/spgemm")):
            assert r0[k][3] == r1[k][3] == runs["one"][k][3], k
        if k.endswith("/spgemm_caps"):
            assert r0[k] == r1[k] == runs["one"][k], k


def test_axis_reduce_over_a_grid_row(runs):
    """``axis_reduce`` over grid row 0's group (both ranks) for sum, min,
    max and a generic monoid, and ``axis_reduce_scatter``'s chunks."""
    x = [np.array([r + 1.5, -float(r), 2.0 ** r], np.float32) for r in (0, 1)]
    want = {"sum": x[0] + x[1], "min": np.minimum(x[0], x[1]),
            "max": np.maximum(x[0], x[1]), "generic": x[0] + x[1]}
    for res in runs["ranks"]:
        for name, w in want.items():
            np.testing.assert_array_equal(res[f"axis_reduce/{name}"], w)
    full = np.arange(4, dtype=np.float32) * 3
    np.testing.assert_array_equal(runs["ranks"][0]["axis_reduce_scatter"], full[:2])
    np.testing.assert_array_equal(runs["ranks"][1]["axis_reduce_scatter"], full[2:])


@pytest.mark.parametrize("case", list(worker.CASES))
@pytest.mark.parametrize("grid", ["2x4", "2x2"])
def test_two_ranks_equal_the_jax_package(runs, grid, case):
    """The reference worker's checks and more, against the JAX package at
    the same grid shape: ``getnnz``, ``dist_spmv``'s blocks, ``spgemm``
    (entries and capacity) and ``summa_spgemm_mxu`` (entries, capacity,
    overflow). Exact for integers and min_plus; plus_times on float32
    within rtol 1e-5, atol 1e-6."""
    key = f"{grid}/{case}"
    got, want = runs["ranks"][0], runs["jax"]
    exact = case != "plus_times"

    def close(a, b):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)

    assert got[key + "/nnz"] == want[key + "/nnz"]
    close(got[key + "/spmv"], want[key + "/spmv"])
    if grid == "2x2":
        for name in ("spgemm", "mxu"):
            if key + "/" + name not in want:
                continue
            g, w = got[key + "/" + name], want[key + "/" + name]
            if name == "mxu":
                assert g[1] == w[1]
                g, w = g[0], w[0]
            assert g[3] == w[3]
            gs, ws = sorted_entries(*g[:3]), sorted_entries(*w[:3])
            np.testing.assert_array_equal(gs[0], ws[0])
            np.testing.assert_array_equal(gs[1], ws[1])
            close(gs[2], ws[2])


@pytest.mark.parametrize("grid", ["2x4", "2x2"])
def test_read_and_counters_equal_the_jax_package(runs, grid):
    """``read_mm_distributed`` (entries and nnz, exact) and
    ``psum_counters`` (exact) against the JAX package."""
    got, want = runs["ranks"][0], runs["jax"]
    for a, b in zip(sorted_entries(*got[grid + "/mm"][:3]), sorted_entries(*want[grid + "/mm"][:3])):
        np.testing.assert_array_equal(a, b)
    assert len(got[grid + "/mm"][0]) == want[grid + "/mm"][3]
    np.testing.assert_array_equal(got[grid + "/psum"], want[grid + "/psum"])


def test_failing_rank_ends_the_run(tmp_path):
    """A rank that raises while the other waits in a collective ends the
    job at once: ``launch`` kills the other rank (or sees it exit when gloo
    notices its peer gone) and raises with the ranks' logs."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        multihost.launch(f"{worker.__file__}:fail_on_rank_one", 2, device="cpu",
                         timeout_s=60.0, workdir=tmp_path, env=RANK_ENV)
    assert time.monotonic() - t0 < 40


@pytest.mark.parametrize("parts", [1, 2, 3, 7])
def test_byte_ranges_tile_the_file(tmp_path, parts):
    """``read_mm_range`` over ranges that tile the file (cut anywhere,
    mid-line included) gives every entry once, in file order."""
    r, c, v = worker.matrix("plus_times")
    path = tmp_path / "g.mtx"
    write_mm(path, (r, c, v, worker.N, worker.N))
    want = read_mm(path)
    size = path.stat().st_size
    cuts = [size * k // parts for k in range(parts + 1)]
    got = [read_mm_range(path, a, b) for a, b in zip(cuts[:-1], cuts[1:])]
    for k in range(3):
        np.testing.assert_array_equal(np.concatenate([g[k] for g in got]), want[k])


def test_one_process_grid_is_unchanged():
    """Without a process group a grid holds every tile, as before, and
    ``make_default`` / ``make_global_grid`` give one-process grids."""
    g = Grid.make(2, 3, device="cpu")
    assert not g.is_distributed and g.owners is None and g.world == 1
    assert g.tiles_shape == (2, 3) and g.tile_index(1, 2) == (1, 2)
    assert g.owned_tiles() == [(i, j) for i in range(2) for j in range(3)]
    d = Grid.make_default(8, device="cpu")
    assert (d.pr, d.pc, d.is_distributed) == (2, 4, False)
    assert multihost.init_distributed(num_processes=1, process_id=0, device="cpu") == 1
    try:
        m = multihost.make_global_grid(2, 2)
        assert (m.pr, m.pc, m.device, m.is_distributed) == (2, 2, torch.device("cpu"), False)
    finally:
        multihost.shutdown()


def test_distributed_grid_owner_math():
    """Owner math of a grid over two ranks, seen from rank 1: its tiles,
    their slots, and ``LocalOnlyError`` for a tile rank 0 holds."""
    g = Grid(pr=2, pc=2, device=torch.device("cpu"), owners=(0, 1, 0, 1), rank=1, world=2)
    assert g.is_distributed and g.owned_tiles() == [(0, 1), (1, 1)]
    assert g.tiles_shape == (2,) and g.tile_index(1, 1) == 1
    assert g.row_ranks(0) == [0, 1] and g.col_ranks(1) == [1]
    with pytest.raises(LocalOnlyError, match="ROADMAP item 12c.4"):
        g.tile_index(0, 0)
