"""``models/bfs.py:bfs_levels_instrumented`` against ``combblas_tpu``'s on
the CPU, on ``SpParMat`` and ``EllParMat``: parents, levels, the level
count, and the spans and events of each hop, compared as in
``test_torch_obs_spgemm.py``. ``spmv.dispatch`` counts the reference's one
trace of its jitted level program and the port's calls, one a hop, so it is
held apart."""

import numpy as np
import pytest

from combblas_tpu.parallel.ellmat import EllParMat as JaxEll
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu_torch import EllParMat, Grid
from torch_obs_parity import clean, graph, mats, run_both, tobs


@pytest.fixture(autouse=True)
def _clean():
    with clean():
        yield


# --- models/bfs.py: bfs_levels_instrumented -----------------------------------------


@pytest.mark.parametrize("fmt,shape", [("spmat", (2, 2)), ("ell", (2, 2))],
                         ids=["spmat-2x2", "ell-2x2"])
def test_bfs_levels_instrumented_matches_reference(fmt, shape):
    """Parents, levels and the level count equal the reference's, and so do
    the spans: one ``bfs`` span, one ``bfs.hop`` a level, each with its
    ``frontier`` event. ``spmv.dispatch`` counts the reference's one trace
    of its level program, and the port's calls: one a hop."""
    from combblas_tpu.models import bfs as jbfs
    from combblas_tpu_torch.models import bfs as tbfs

    d = graph(9, n=50, density=0.05, weights=False)
    d = np.maximum(d, d.T)
    np.fill_diagonal(d, 0)
    if fmt == "ell":
        r, c = np.nonzero(d)
        v = np.ones(len(r), np.float32)
        jA = JaxEll.from_host_coo(JaxGrid.make(*shape), r, c, v, 50, 50)
        tA = EllParMat.from_host_coo(Grid.make(*shape, device="cpu"), r, c, v, 50, 50)
    else:
        jA, tA = mats(shape, d)
    for root in (0, 17):
        want, got = run_both(lambda: jbfs.bfs_levels_instrumented(jA, root),
                             lambda: tbfs.bfs_levels_instrumented(tA, root),
                             drop=("spmv.dispatch",))
        np.testing.assert_array_equal(got[0].blocks.numpy(), np.asarray(want[0].blocks))
        np.testing.assert_array_equal(got[1].blocks.numpy(), np.asarray(want[1].blocks))
        assert got[2] == int(want[2])
        assert tobs.registry.get_counter("spmv.dispatch", kernel="dist_spmv_masked") == got[2]
        hops = [r for r in tobs._spans.log if r["name"] == "bfs.hop"]
        assert len(hops) == got[2]
        sizes = [h["events"][0]["nnz"] for h in hops]
        lv = got[1].to_global() if hasattr(got[1], "to_global") else None
        if lv is not None:
            found = np.bincount(lv[lv >= 0], minlength=got[2] + 1)
            assert sizes == list(found[1:got[2] + 1])
            assert sum(sizes) == int((lv >= 0).sum()) - 1
