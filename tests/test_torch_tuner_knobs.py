"""Parity of the port's tier knobs, ``headroom`` and sharded checkpoints
with ``combblas_tpu`` on the CPU: ``COMBBLAS_SPGEMM_BACKEND`` through
``resolve_spgemm_backend``, ``COMBBLAS_SPGEMM_MERGE`` through ``spgemm``,
``COMBBLAS_SPGEMM_DISPATCH`` and ``COMBBLAS_SPGEMM_BUCKET_CAPS`` through
``spgemm_windowed``, ``COMBBLAS_DYNAMIC_HEADROOM`` through
``EllParMat.host_build(headroom=None)``, ``COMBBLAS_SPGEMM_MERGE`` through
``spgemm3d_windowed``, and ``save_sharded`` /
``load_sharded`` against the reference's ``save_orbax`` / ``load_orbax``
round trip (that one case skips where orbax is not installed).

Both packages run under the same environment. Values are small integers,
so products are compared bit for bit: tiles with their padding, ``nnz``
and capacity; bucket arrays and restored arrays likewise.
"""

import json
import os
import re

import numpy as np
import pytest

from combblas_tpu import semiring as jsr
from combblas_tpu.parallel import mesh3d as jm
from combblas_tpu.parallel import ellmat as jell
from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import MIN_PLUS, PLUS_TIMES, DistVec, EllParMat, Grid, SpParMat
from combblas_tpu_torch.parallel import mesh3d as tm
from combblas_tpu_torch.parallel import spgemm as tpar
from combblas_tpu_torch.tuner import config as tcfg
from combblas_tpu_torch.utils import checkpoint as tck
from test_torch_tuner_routes import ROUTE_KNOBS, operands, same, same_mat
from test_torch_tuner_routes3d import mats3d

SRS = {"plus_times": (PLUS_TIMES, jsr.PLUS_TIMES), "min_plus": (MIN_PLUS, jsr.MIN_PLUS)}


@pytest.fixture(autouse=True)
def _knobs(monkeypatch, tmp_path):
    for name in ROUTE_KNOBS + ("ENV_DYNAMIC_HEADROOM",):
        monkeypatch.delenv(getattr(tcfg, name), raising=False)
    monkeypatch.setenv(tcfg.ENV_PLAN_STORE, str(tmp_path / "plans"))


def test_backend_and_merge_knobs_match_reference(monkeypatch):
    """``COMBBLAS_SPGEMM_BACKEND`` picks the windowed backend (argument
    first, an unknown value raises); ``COMBBLAS_SPGEMM_MERGE`` picks
    ``spgemm``'s merge (``hash`` runs as ``runs``) — products bit-equal to
    the reference's under the same environment."""
    assert tpar.resolve_spgemm_backend() == jpar.resolve_spgemm_backend() == "scatter"
    monkeypatch.setenv(tcfg.ENV_BACKEND, "dot")
    assert tpar.resolve_spgemm_backend() == jpar.resolve_spgemm_backend() == "dot"
    assert tpar.resolve_spgemm_backend("scatter") == "scatter"
    monkeypatch.setenv(tcfg.ENV_BACKEND, "tensor")
    with pytest.raises(ValueError, match="backend must be"):
        tpar.resolve_spgemm_backend()
    monkeypatch.delenv(tcfg.ENV_BACKEND)
    tA, jA = operands(8, p=2, nnz=500, dup=0.1)
    for env in ("runs", "hash", "sort"):
        monkeypatch.setenv(tcfg.ENV_MERGE, env)
        for srname in ("min_plus", "plus_times"):
            sr, jr = SRS[srname]
            same_mat(tpar.spgemm(sr, tA, tA), jpar.spgemm(jr, jA, jA))
    monkeypatch.setenv(tcfg.ENV_MERGE, "quick")
    with pytest.raises(ValueError, match="COMBBLAS_SPGEMM_MERGE"):
        tpar.spgemm(MIN_PLUS, tA, tA)


def test_windowed_dispatch_and_bucket_knobs(monkeypatch):
    """``COMBBLAS_SPGEMM_DISPATCH`` picks the windowed form (argument
    first) and ``COMBBLAS_SPGEMM_BUCKET_CAPS=0`` keeps the plan's exact
    capacities: tiles and capacities equal to the reference's under the
    same environment."""
    tA, jA = operands(9, p=2, nnz=150, dup=0.1)
    for env, want_form in (("fused", "fused"), ("blocked", "blocked")):
        monkeypatch.setenv(tcfg.ENV_DISPATCH, env)
        got = tpar.spgemm_windowed(MIN_PLUS, tA, tA, block_rows=8, backend="scatter")
        assert tpar.spgemm_windowed.last_plan["form"] == want_form
        same_mat(got, jpar.spgemm_windowed(jsr.MIN_PLUS, jA, jA, block_rows=8,
                                           backend="scatter"))
    tpar.spgemm_windowed(MIN_PLUS, tA, tA, block_rows=8, backend="scatter", dispatch="fused")
    assert tpar.spgemm_windowed.last_plan["form"] == "fused"
    monkeypatch.delenv(tcfg.ENV_DISPATCH)
    monkeypatch.setenv(tcfg.ENV_BUCKET_CAPS, "0")
    got = tpar.spgemm_windowed(PLUS_TIMES, tA, tA, block_rows=8, backend="scatter")
    caps = tpar.spgemm_windowed.last_plan["out_caps"]
    same_mat(got, jpar.spgemm_windowed(jsr.PLUS_TIMES, jA, jA, block_rows=8,
                                       backend="scatter"))
    tpar.spgemm_windowed(PLUS_TIMES, tA, tA, block_rows=8, backend="scatter", bucket=True)
    bucketed = tpar.spgemm_windowed.last_plan["out_caps"]
    assert bucketed != caps  # the argument beats the knob
    assert all(b >= c for b, c in zip(bucketed, caps))


def test_host_build_headroom_from_environment(monkeypatch):
    """``host_build(headroom=None)`` reads ``COMBBLAS_DYNAMIC_HEADROOM``
    (unset: 0; negative: 0) and an explicit argument beats it: the bucket
    arrays equal the reference's under the same environment."""
    rng = np.random.default_rng(11)
    n = 64
    r, c = rng.integers(0, n, 500), rng.integers(0, n, 500)
    v = rng.integers(1, 5, 500).astype(np.float32)
    tg, jg = Grid.make(2, 2, device="cpu"), JaxGrid.make(2, 2)

    def same_buckets(got, want):
        assert len(got) == len(want)
        for gb, wb in zip(got, want):
            for x, y in zip(gb, wb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    base = EllParMat.host_build(tg, r, c, v, n, n, headroom=0.0)
    for env, kw in ((None, {}), ("0.5", {}), ("-1", {}), ("0.5", {"headroom": 0.25})):
        if env is None:
            monkeypatch.delenv(tcfg.ENV_DYNAMIC_HEADROOM, raising=False)
        else:
            monkeypatch.setenv(tcfg.ENV_DYNAMIC_HEADROOM, env)
        got = EllParMat.host_build(tg, r, c, v, n, n, **kw)
        same_buckets(got, jell.EllParMat.host_build(jg, r, c, v, n, n, **kw))
        rows_of = [b[0].shape[2] for b in got]
        if env == "0.5" and not kw:
            assert all(x > y for x, y in zip(rows_of, [b[0].shape[2] for b in base]))
        if env in (None, "-1"):
            same_buckets(got, base)
    monkeypatch.setenv(tcfg.ENV_DYNAMIC_HEADROOM, "0.5")
    E = EllParMat.from_host_coo(tg, r, c, v, n, n)
    jE = jell.EllParMat.from_host_coo(jg, r, c, v, n, n)
    assert int(E.getnnz()) == int(jE.getnnz())
    for tb, jb in zip(E.buckets, jE.buckets):
        for x, y in zip(tb, jb):
            same(x, y)


def test_sharded_checkpoint_matches_orbax_roundtrip(tmp_path):
    """``save_sharded`` / ``load_sharded`` give back the arrays the
    reference's ``save_orbax`` / ``load_orbax`` give back (an SpParMat on
    2x2, DistVecs of both alignments onto the same and another grid), with
    the same ``cbtpu_meta.json``; an SpParMat onto another grid shape
    raises the reference's message."""
    pytest.importorskip("orbax.checkpoint")
    from combblas_tpu.utils import checkpoint as jck

    tA, jA = operands(12, n=24, nnz=90, p=2)
    tck.save_sharded(str(tmp_path / "t"), tA)
    jck.save_orbax(str(tmp_path / "j"), jA)
    assert (json.load(open(tmp_path / "t" / "cbtpu_meta.json"))
            == json.load(open(tmp_path / "j" / "cbtpu_meta.json")))
    got = tck.load_sharded(str(tmp_path / "t"), Grid.make(2, 2, device="cpu"))
    same_mat(got, jck.load_orbax(str(tmp_path / "j"), JaxGrid.make(2, 2)))
    same_mat(got, tA)
    with pytest.raises(AssertionError) as want:
        jck.load_orbax(str(tmp_path / "j"), JaxGrid.make(1, 2))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tck.load_sharded(str(tmp_path / "t"), Grid.make(1, 2, device="cpu"))
    x = -np.arange(2, 9, dtype=np.int32)
    for align in ("row", "col"):
        tv = DistVec.from_global(Grid.make(2, 2, device="cpu"), x, align=align,
                                 fill=np.int32(-7))
        jv = JaxDistVec.from_global(JaxGrid.make(2, 2), x, align=align, fill=np.int32(-7))
        tck.save_sharded(str(tmp_path / f"tv{align}"), tv)
        jck.save_orbax(str(tmp_path / f"jv{align}"), jv)
        assert (json.load(open(tmp_path / f"tv{align}" / "cbtpu_meta.json"))
                == json.load(open(tmp_path / f"jv{align}" / "cbtpu_meta.json")))
        for shape in ((2, 2), (1, 4)):
            got = tck.load_sharded(str(tmp_path / f"tv{align}"),
                                   Grid.make(*shape, device="cpu"))
            want = jck.load_orbax(str(tmp_path / f"jv{align}"), JaxGrid.make(*shape))
            same(got.blocks, want.blocks)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        ["cbtpu_meta.json"] + [f"{a}.{i}.{j}.pt" for a in ("rows", "cols", "vals", "nnz")
                               for i in range(2) for j in range(2)])


def test_spgemm3d_windowed_merge_from_environment(monkeypatch):
    """``spgemm3d_windowed``'s merge: argument > ``COMBBLAS_SPGEMM_MERGE`` >
    the heuristic, bit-equal to the reference under the same environment."""
    t3, j3 = mats3d(seed=7)
    for env, want in ((None, None), ("hash", "hash"), ("sort", "sort")):
        if env is not None:
            monkeypatch.setenv(tcfg.ENV_MERGE, env)
        got = tm.spgemm3d_windowed(MIN_PLUS, *t3, block_rows=8)
        ref = jm.spgemm3d_windowed(jsr.MIN_PLUS, *j3, block_rows=8)
        for f in ("rows", "cols", "vals", "nnz"):
            same(getattr(got, f), getattr(ref, f))
        if want is not None:
            assert tm.spgemm3d_windowed.last_plan["merge"] == want
    tm.spgemm3d_windowed(MIN_PLUS, *t3, block_rows=8, merge="runs")
    assert tm.spgemm3d_windowed.last_plan["merge"] == "runs"
