"""Parity of the port's sharded serving with real slice subprocesses
(``serve/_shardworker.py`` children) against ``combblas_tpu.serve``'s on
the CPU.

Tier 1 holds one case: a 2-slice ``mode="process"`` engine of each
package answers one bfs and one sssp batch equal to its local mode and to
the other package's. The reference's three ``slow`` cases of
``tests/test_serve_shard.py`` stay ``slow`` here, run through both
packages: the crash-recovery sweep over every append / commit /
checkpoint boundary, the SIGKILL-and-respawn case with real children and
zero plan builds after the warm-up, and the encoding-equivalence sweep
(propagate ``allclose`` at the reference's tolerance: 1e-5 on the f32
wire, 3e-2 on bf16).
"""

import numpy as np
import pytest

from test_torch_serve_shard import _build, _crash_scenario, _engine, _host, _same
from torch_serve_parity import NAMES, isolated  # noqa: F401


def _weighted(seed, n, m):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    return rows, cols, rng.random(m).astype(np.float32) + 0.1


def test_process_mode_answers_equal_local_mode(tmp_path):
    """Two real children a package (the port's on ``device="cpu"``) boot
    from their slab COOs, answer one bfs and one sssp batch equal to the
    same package's local mode, and the two packages' answers are equal;
    the port's children name the device they ran on."""
    n = 48
    rows, cols, w = _weighted(1, n, 300)
    srcs = np.array([0, 5, 17, 40], np.int32)
    seen = {}
    for name in NAMES:
        local = _build(name, rows, cols, tmp_path / f"loc-{name}", nrows=n, nslices=2,
                       weights=w, kinds=("bfs", "sssp"), warmup=False)
        proc = _build(name, rows, cols, tmp_path / f"proc-{name}", nrows=n, nslices=2,
                      weights=w, kinds=("bfs", "sssp"), mode="process",
                      warmup_widths=(4,))
        try:
            got = {}
            for kind in ("bfs", "sssp"):
                want = local.execute(kind, srcs)
                got[kind] = proc.execute(kind, srcs)
                _same(want, got[kind])
            if name == "torch":
                assert [sl.boot_info["device"] for sl in proc.slices] == ["cpu", "cpu"]
                assert not proc.shares_context and proc.device.type == "cpu"
        finally:
            proc.close()
            local.close()
        assert all(sl.rp.proc.poll() is not None for sl in proc.slices)
        seen[name] = got
    _same(seen["jax"], seen["torch"])


# --- the reference's slow cases ---------------------------------------------------


@pytest.mark.slow
def test_crash_recovery_bit_exact_at_every_boundary(tmp_path):
    """The reference's acceptance sweep in both packages: a crash after
    every append / commit / checkpoint boundary combination (partial
    commits, checkpoints skewing either slice's frontier, torn tails)
    recovers to its never-crashed twin's COO, equal across packages."""
    cases = []
    for n_commit, n_append in ((1, 0), (0, 1), (2, 1), (1, 2)):
        for partial in ({False, n_append > 0}):
            ck_positions = [None] + [(s, p) for s in (0, 1)
                                     for p in range(1, n_commit + n_append + 1)]
            for ckpt in ck_positions:
                cases.append((n_commit, n_append, partial, ckpt, False))
    cases.append((2, 1, True, (1, 2), True))
    cases.append((0, 2, False, None, True))
    for i, (nc, na, partial, ckpt, torn) in enumerate(cases):
        got = {name: _crash_scenario(name, tmp_path, str(i), n_commit=nc, n_append_only=na,
                                     commit_partial=partial, ckpt=ckpt, torn=torn)
               for name in NAMES}
        _same(got["jax"], got["torch"])


@pytest.mark.slow
def test_process_mode_sigkill_respawn_bit_exact(tmp_path):
    """Real subprocess slices: bfs and sssp equal to the unsharded engine,
    one slice SIGKILLed mid-service respawns from its slab snapshot + WAL
    while the other keeps serving and the answer stays equal, in both
    packages; the port's respawn builds no plan after its warm-up. (The
    reference's count is not held here: its own copy of this case,
    ``tests/test_serve_shard.py``, reads one retrace on the JAX release
    these tests run with.)"""
    n = 48
    rows, cols, w = _weighted(1, n, 300)
    srcs = np.array([0, 5, 17, 40], np.int32)
    seen = {}
    for name in NAMES:
        eng = _engine(name, rows, cols, n, weights=w, kinds=("bfs", "sssp"), keep_coo=True)
        sh = _build(name, rows, cols, tmp_path / f"proc-{name}", nrows=n, nslices=2,
                    weights=w, kinds=("bfs", "sssp"), mode="process", warmup_widths=(4,))
        try:
            got = {}
            for kind, key in (("bfs", "parents"), ("sssp", "dist")):
                got[kind] = sh.execute(kind, srcs)
                np.testing.assert_array_equal(_host(eng.execute(kind, srcs)[key]),
                                              got[kind][key])
            mark = sh.trace_mark()
            survivor = sh.slices[1]
            sh.slices[0].kill()
            got["healed"] = sh.execute("bfs", srcs)
            np.testing.assert_array_equal(_host(eng.execute("bfs", srcs)["parents"]),
                                          got["healed"]["parents"])
            assert sh.replacements == 1 and sh.slices[1] is survivor
            if name == "torch":
                assert sh.retraces_since(mark) == 0
        finally:
            sh.close()
        seen[name] = got
    _same(seen["jax"], seen["torch"])


@pytest.mark.slow
def test_encoding_equivalence_sweep(tmp_path):
    """The reference's sweep in both packages: kinds x widths {1, 4, 16}
    x {2, 3} slices under forced sparse, forced dense and auto, bfs and
    sssp equal to the unsharded engine and across packages; propagate
    ``allclose`` to the unsharded engine (1e-5 on the f32 wire, 3e-2 on
    bf16) and within 1e-5 across packages; the hops == 0 edge."""
    rng = np.random.default_rng(21)
    n, m = 48, 300
    r0 = rng.integers(0, n, m // 2)
    c0 = rng.integers(0, n, m // 2)
    rows = np.concatenate([r0, c0])
    cols = np.concatenate([c0, r0])
    w = rng.random(rows.shape[0]).astype(np.float32) + 0.1
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    widths = {1: rng.integers(0, n, 1).astype(np.int32),
              4: rng.integers(0, n, 4).astype(np.int32),
              16: rng.integers(0, n, 16).astype(np.int32)}
    seen = {}
    for name in NAMES:
        eng = _engine(name, rows, cols, n, weights=w, features=feats, symmetric=True,
                      kinds=("bfs", "sssp", "propagate"))
        out = []
        for nslices in (2, 3):
            sh = _build(name, rows, cols, tmp_path / f"s{nslices}-{name}", nrows=n,
                        nslices=nslices, weights=w, features=feats, symmetric=True,
                        kinds=("bfs", "sssp", "propagate"), warmup=False)
            try:
                for width, srcs in widths.items():
                    refs = {k: eng.execute(k, srcs) for k in ("bfs", "sssp", "propagate")}
                    for mode in ("sparse", "dense", "auto"):
                        sh.frontier_mode = mode
                        for kind, keys in (("bfs", ("parents", "levels")), ("sssp", ("dist",))):
                            got = sh.execute(kind, srcs)
                            for key in keys:
                                np.testing.assert_array_equal(
                                    _host(refs[kind][key]), got[key],
                                    err_msg=f"{nslices}sl/{kind}/{key}/w{width}/{mode}")
                            assert int(got["batch_niter"]) == int(refs[kind]["batch_niter"])
                            out.append(got)
                    ref_f = _host(refs["propagate"]["features"])
                    for wire in ("f32", "bf16"):
                        sh.wire = wire
                        got = sh.execute("propagate", srcs)
                        tol = 1e-5 if wire == "f32" else 3e-2
                        np.testing.assert_allclose(ref_f, got["features"], rtol=tol, atol=tol)
                        out.append(got["features"])
                    sh.wire = "f32"
                sh.propagate_hops = 0
                got = sh.execute("propagate", np.array([0, 1], np.int32))
                assert got["features"].shape == (feats.shape[1], 2)
                out.append(got["features"])
            finally:
                sh.close()
        seen[name] = out
    for a, b in zip(seen["jax"], seen["torch"]):
        if isinstance(a, dict):
            _same(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
