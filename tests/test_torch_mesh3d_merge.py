"""Parity of the port's 3D fiber merge tiers with ``combblas_tpu`` on the
CPU: ``hash_merge`` and ``hash_table_capacity``, and the 3D cases of the
reference's ``tests/test_spgemm_merge.py`` (every merge tier and the per-layer
carousel against the sort tier, the hash overflow's rerun through
``runs`` with ``HASH_MERGE_PROBES`` patched to 0 in both packages, the
fiber piece overflow reported and raised, a forced hash on a generic
monoid degrading to ``runs``). The router's layered route is in
``test_torch_mesh3d_route.py``.

Values are small integers, so every semiring's folds are exact and every
comparison is bit for bit: tiles with their padding, ``nnz``, capacities,
overflow vectors and raises.
"""

import numpy as np
import pytest
import torch

from combblas_tpu import semiring as jsr
from combblas_tpu.ops import spgemm as jops
from combblas_tpu.ops.tuples import SpTuples as JaxSpTuples
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu_torch import MAX_MIN, MIN_PLUS, PLUS_TIMES, Semiring, SpTuples
from combblas_tpu_torch.ops import spgemm as tops
from combblas_tpu_torch.parallel import mesh3d as tm

SEMIRINGS = {"plus_times": (PLUS_TIMES, jsr.PLUS_TIMES), "min_plus": (MIN_PLUS, jsr.MIN_PLUS),
             "max_min": (MAX_MIN, jsr.MAX_MIN)}
SLOW = pytest.mark.slow


def arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(got, want):
    got, want = arr(got), arr(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def same_tiles(got, want, fields=("rows", "cols", "vals", "nnz")):
    for f in fields:
        same(getattr(got, f), getattr(want, f))


def canon(C):
    """Global (rows, cols, vals) sorted by key."""
    r, c, v = (np.asarray(x) for x in C.to_global_coo())
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


def same_canon(a, b):
    for x, y in zip(a, b):
        same(x, y)


def sorted_run(rng, nrows, ncols, n, cap):
    r = rng.integers(0, nrows, n)
    c = rng.integers(0, ncols, n)
    v = rng.integers(1, 5, n).astype(np.float32)
    o = np.lexsort((c, r))
    return (JaxSpTuples.from_coo(r[o], c[o], v[o], nrows, ncols, capacity=cap),
            SpTuples.from_coo(r[o], c[o], v[o], nrows, ncols, capacity=cap, device="cpu"))


def mats3d(rng, n=64, m=500, layers=2):
    """The reference's ``_mats3d``: duplicated COO with values 1..3, col- and
    row-split on layers x 2 x 2, in both packages."""
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    v = rng.integers(1, 4, m).astype(np.float32)
    jg, tg = jm.Grid3D.make(layers, 2, 2), tm.Grid3D.make(layers, 2, 2, device="cpu")
    return tuple(mod.SpParMat3D.from_global_coo(g, r, c, v, n, n, split=split)
                 for mod, g in ((jm, jg), (tm, tg)) for split in ("col", "row"))


@pytest.mark.parametrize("srname", ["plus_times", pytest.param("min_plus", marks=SLOW),
                                    pytest.param("max_min", marks=SLOW)])
def test_hash_merge_matches_compact(srname):
    """``hash_merge`` gives the reference's table-ordered tile, overflow and
    distinct count bit for bit, the same key set as ``compact``, and a
    counted overflow on a deliberately small table."""
    rng = np.random.default_rng(1313)
    sr, jr = SEMIRINGS[srname]
    cap, table = 207, tops.hash_table_capacity(200)
    assert table == jops.hash_table_capacity(200)
    for n in (0, 1, 17, 200):
        jt, tt = sorted_run(rng, 41, 23, n, cap)
        got = tops.hash_merge(sr, tt, out_capacity=cap, table_capacity=table)
        want = jops.hash_merge(jr, jt, out_capacity=cap, table_capacity=table)
        same_tiles(got[0], want[0])
        assert (int(got[1]), int(got[2])) == (int(want[1]), int(want[2])) == (
            0, int(tt.compact(sr, capacity=cap).nnz))
        ref = tt.compact(sr, capacity=cap)
        k, kr = arr(got[0].valid_mask()), arr(ref.valid_mask())
        o = np.lexsort((arr(got[0].cols)[k], arr(got[0].rows)[k]))
        for f in ("rows", "cols", "vals"):
            same(arr(getattr(got[0], f))[k][o], arr(getattr(ref, f))[kr])
    jt, tt = sorted_run(rng, 41, 23, 200, 210)
    got = tops.hash_merge(PLUS_TIMES, tt, out_capacity=256, table_capacity=16, n_probes=4)
    want = jops.hash_merge(jsr.PLUS_TIMES, jt, out_capacity=256, table_capacity=16, n_probes=4)
    assert int(got[1]) == int(want[1]) > 0
    same_tiles(got[0], want[0])
    for m in (0, 1, 7, 8, 9, 1000, 1 << 20):
        assert tops.hash_table_capacity(m) == jops.hash_table_capacity(m)
    with pytest.raises(ValueError, match="power of two"):
        tops.hash_merge(PLUS_TIMES, tt, out_capacity=8, table_capacity=24)


@pytest.mark.parametrize("tier,merge,kw,srname", [
    pytest.param("windowed", "runs", {}, "plus_times", marks=SLOW),
    ("windowed", "hash", {}, "plus_times"),
    ("esc", "runs", {}, "plus_times"),
    ("esc", "hash", {}, "min_plus"),
    ("windowed", "runs", {}, "min_plus"),
    pytest.param("windowed", "runs", {}, "max_min", marks=SLOW),
    pytest.param("esc", "runs", {}, "max_min", marks=SLOW),
    ("windowed", "runs", {"ring": True}, "plus_times"),
    pytest.param("windowed", "runs", {"ring": True, "pipeline": False}, "plus_times", marks=SLOW),
    pytest.param("esc", "sort", {"ring": True}, "plus_times", marks=SLOW),
])
def test_spgemm3d_merge_tiers_bitexact(tier, merge, kw, srname):
    """Each merge tier and the carousel give the reference's tiles and the
    sort tier's entries on the 2x2x2 grid with duplicated COO."""
    sr, jr = SEMIRINGS[srname]
    jA, jB, tA, tB = mats3d(np.random.default_rng(1313))
    golden = canon(tm.spgemm3d(sr, tA, tB, tier=tier, merge="sort"))
    got = tm.spgemm3d(sr, tA, tB, tier=tier, merge=merge, **kw)
    same_canon(canon(got), golden)
    want = jm.spgemm3d(jr, jA, jB, tier=tier, merge=merge, **kw)
    same_tiles(got, want)
    assert got.capacity == want.rows.shape[3]


def test_hash_overflow_falls_back_to_runs(monkeypatch):
    """With no probe round nothing places: the hash overflow is counted and
    the product reruns through ``runs``, in both packages, equal to the
    sort tier."""
    monkeypatch.setattr(tm, "HASH_MERGE_PROBES", 0)
    monkeypatch.setattr(jm, "HASH_MERGE_PROBES", 0)
    jA, jB, tA, tB = mats3d(np.random.default_rng(1313), n=32, m=300)
    golden = canon(tm.spgemm3d(PLUS_TIMES, tA, tB, tier="windowed", merge="sort"))
    got = tm.spgemm3d(PLUS_TIMES, tA, tB, tier="windowed", merge="hash")
    assert tm.spgemm3d_windowed.last_plan["hash_overflow"] > 0
    same_canon(canon(got), golden)
    same_tiles(got, jm.spgemm3d(jsr.PLUS_TIMES, jA, jB, tier="windowed", merge="hash"))
    # the ESC tier reruns its sized kernel the same way
    got = tm.spgemm3d(PLUS_TIMES, tA, tB, tier="esc", merge="hash")
    assert tm.spgemm3d.last_run["hash_overflow"] > 0 and tm.spgemm3d.last_run["merge"] == "runs"
    same_tiles(got, jm.spgemm3d(jsr.PLUS_TIMES, jA, jB, tier="esc", merge="hash"))


def test_piece_overflow_detected_and_diagnosed():
    """A starved piece capacity is reported by the kernel (the same
    overflow vector and truncated tiles as the reference) and raised by the
    sized entries' check, naming the slack knob."""
    jA, jB, tA, tB = mats3d(np.random.default_rng(1313))
    caps = dict(flop_capacity=1 << 14, out_capacity=1 << 12, piece_capacity=1)
    got, gov = tm.summa3d_spgemm(PLUS_TIMES, tA, tB, **caps)
    want, wov = jm.summa3d_spgemm(jsr.PLUS_TIMES, jA, jB, **caps)
    same(gov, wov)
    assert int(gov[0]) > 0
    same_tiles(got, want)
    with pytest.raises(ValueError, match="slack"):
        tm._check_fiber_overflow(int(gov[0]), 1, "spgemm3d_windowed", 1.02)
    tm._check_fiber_overflow(0, 1, "spgemm3d", 1.05)


def test_forced_hash_on_generic_monoid_degrades():
    """``merge="hash"`` on a monoid with no scatter combiner runs as
    ``runs`` (the reference degrades at the knob), equal to the reference's
    tiles."""
    tsr = Semiring(name="plus_times_generic", add=lambda x, y: x + y, mul=lambda a, x: a * x,
                   zero_fn=lambda dt: 0, one_fn=lambda dt: 1, add_kind="generic")
    jr = jsr.Semiring(name="plus_times_generic", add=lambda x, y: x + y,
                      mul=lambda a, x: a * x, zero_fn=lambda dt: 0, one_fn=lambda dt: 1,
                      add_kind="generic")
    jA, jB, tA, tB = mats3d(np.random.default_rng(1313))
    got = tm.spgemm3d(tsr, tA, tB, tier="esc", merge="hash")
    assert tm.spgemm3d.last_run["merge"] == "runs"
    same_tiles(got, jm.spgemm3d(jr, jA, jB, tier="esc", merge="hash"))
    same_canon(canon(got), canon(tm.spgemm3d(tsr, tA, tB, tier="esc", merge="runs")))
