"""Parity of the port's instrumented SpGEMM sites (``parallel/spgemm.py``)
with ``combblas_tpu``'s on the CPU: the same call runs in both packages with
telemetry on, and every series (name, labels and value; a histogram by its
count) and every span (name, path, attributes, events without times) must
agree.

Left out of the comparison, as the port leaves them out: the ``trace.*``
counters (JAX retraces), the ``cache.bfs.*`` gauges and the ``/jax/``
events; and ``compile_cache.*``, which count XLA's cache in the reference
(once any test of the process has installed its hooks) and the hand
kernels' builds in the port. The reference's
sites that run while JAX traces a program count once a trace;
``jax.clear_caches()`` before its call (``torch_obs_parity.run_both``)
makes them fire once, as the port's fire once a call.
"""

import warnings

import numpy as np
import pytest

from combblas_tpu.parallel import spgemm as jpar
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu_torch import Grid
from combblas_tpu_torch.parallel import spgemm as tpar
from torch_obs_parity import SR, clean, graph, mats, nnz, run_both, tobs


@pytest.fixture(autouse=True)
def _clean():
    with clean():
        yield


# --- parallel/spgemm.py ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2)], ids=["2x2"])
def test_esc_scan_and_phased_sites(shape):
    d = graph(1, n=48, density=0.1)
    jA, tA = mats(shape, d)
    sr, jsr_ = SR["min_plus"]
    want, got = run_both(lambda: jpar.spgemm(jsr_, jA, jA, merge="runs"),
                         lambda: tpar.spgemm(sr, tA, tA, merge="runs"), device_sync=True)
    assert tobs.registry.get_counter("spgemm.realized_nnz") == nnz(got) == nnz(want)
    run_both(lambda: jpar.spgemm_scan(jsr_, jA, jA, out_capacity=16, ring=True),
             lambda: tpar.spgemm_scan(sr, tA, tA, out_capacity=16, ring=True),
             device_sync=True)
    assert tobs.registry.get_counter("spgemm.scan.overflow_retries") >= 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_both(lambda: jpar.mem_efficient_spgemm(jsr_, jA, jA, 5),
                 lambda: tpar.mem_efficient_spgemm(sr, tA, tA, 5))
        assert tobs.registry.get_counter("spgemm.phase_adjusted") == 1
        run_both(lambda: jpar.mem_efficient_spgemm(jsr_, jA, jA, 2, scan=True),
                 lambda: tpar.mem_efficient_spgemm(sr, tA, tA, 2, scan=True))
    host = [np.nonzero(d)[0], np.nonzero(d)[1]]
    g = Grid.make(*shape, device="cpu")
    run_both(lambda: jpar.summa_capacities_host(JaxGrid.make(*shape), *host, *host, 48, 48, 48),
             lambda: tpar.summa_capacities_host(g, *host, *host, 48, 48, 48))


@pytest.mark.parametrize("shape,dispatch,ring", [((1, 1), None, False), ((2, 2), None, False),
                                                 ((2, 2), "blocked", True)],
                         ids=["1x1", "2x2-auto", "2x2-ring-conflict"])
def test_windowed_scatter_sites(shape, dispatch, ring):
    d = graph(2, n=48, density=0.1)
    jA, tA = mats(shape, d)
    sr, jsr_ = SR["min_plus"]
    want, got = run_both(
        lambda: jpar.spgemm_windowed(jsr_, jA, jA, block_rows=16, dispatch=dispatch, ring=ring),
        lambda: tpar.spgemm_windowed(sr, tA, tA, block_rows=16, dispatch=dispatch, ring=ring),
        device_sync=True)
    assert nnz(got) == nnz(want)


@pytest.mark.parametrize("block_cols", [32, 16], ids=["oracle", "oracle-skipped"])
def test_windowed_dot_sites(block_cols):
    """The oracle applies with word-aligned windows on one tile, and is
    skipped (counted) with 16-wide ones."""
    d = graph(3, n=48, density=0.1)
    jA, tA = mats((1, 1), d)
    sr, jsr_ = SR["max_min"]
    run_both(lambda: jpar.spgemm_windowed(jsr_, jA, jA, backend="dot", block_rows=16,
                                          block_cols=block_cols, oracle=True, interpret=True),
             lambda: tpar.spgemm_windowed(sr, tA, tA, backend="dot", block_rows=16,
                                          block_cols=block_cols, oracle=True))
    skipped = tobs.registry.get_counter("spgemm.windowed.oracle_skipped")
    assert skipped == (1 if block_cols == 16 else 0)
