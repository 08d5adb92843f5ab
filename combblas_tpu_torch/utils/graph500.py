"""Graph500 kernel 1 on the host — the graph and search-structure recipe
of the reference's benchmark script (``bench.py:build_graph_npz`` and
``augment_npz_with_structures``) as functions that return arrays.

Pure numpy with that script's seeds, so the same scale gives the same
graph, roots and structures as the reference.
"""

from __future__ import annotations

import numpy as np

from ..parallel.ellmat import EllParMat, build_csc_companion_host
from ..parallel.grid import HostGrid
from .rmat import rmat_symmetric_coo_host

GRAPH_SEED = 42
ROOT_SEED = 7


def build_graph(scale: int, edgefactor: int = 16, nroots: int = 256) -> dict:
    """R-MAT over ``2**scale`` vertices, symmetrized and deduplicated.

    Returns ``rows``, ``cols`` (int32, sorted by row then column), ``deg``
    (int32 [n], entries per row) and ``roots`` (int32 [nroots], distinct
    vertices of nonzero degree)."""
    n = 1 << scale
    rows, cols = rmat_symmetric_coo_host(GRAPH_SEED, scale, edgefactor)
    uniq = np.unique(rows * np.int64(n) + cols)
    rows_u = (uniq // n).astype(np.int64)
    cols_u = (uniq % n).astype(np.int64)
    deg = np.bincount(rows_u, minlength=n)
    rng = np.random.default_rng(ROOT_SEED)
    roots = rng.choice(np.flatnonzero(deg > 0), size=nroots, replace=False)
    return {
        "rows": rows_u.astype(np.int32),
        "cols": cols_u.astype(np.int32),
        "deg": deg.astype(np.int32),
        "roots": roots.astype(np.int32),
    }


def build_structures(rows, cols, n: int):
    """The search structures of an n×n graph on a 1×1 grid: the ELL
    buckets (``EllParMat.host_build`` with int8 zero values: the search is
    structural) and the CSC companion. Returns ``(buckets, (indptr,
    rowidx))``, numpy arrays."""
    grid = HostGrid(1, 1)
    buckets = EllParMat.host_build(grid, rows, cols, np.zeros(len(rows), np.int8), n, n)
    return buckets, build_csc_companion_host(grid, rows, cols, n, n)
