"""Graph500 R-MAT edges on the host — copy of
``combblas_tpu/utils/rmat.py:rmat_symmetric_coo_host``.

Pure numpy, the same draws in the same order, so the same seed gives the
same edges as the reference.
"""

from __future__ import annotations

import numpy as np


def rmat_symmetric_coo_host(
    seed: int, scale: int, edgefactor: int = 16, noise: bool = True
):
    """R-MAT over ``2**scale`` vertices with Graph500 parameters
    (A, B, C, D) = (0.57, 0.19, 0.19, 0.05), per-level noise on A and a
    random vertex relabeling; self-loops dropped, then symmetrized.
    Returns int64 (rows, cols) with duplicates kept."""
    rng = np.random.default_rng(seed)
    a, b, c = 0.57, 0.19, 0.19
    d = 1.0 - a - b - c
    n = 1 << scale
    nedges = edgefactor * n
    # one level at a time: [nedges]-sized temporaries, not [nedges, scale]
    src = np.zeros(nedges, np.int64)
    dst = np.zeros(nedges, np.int64)
    for level in range(scale):
        u = rng.random(nedges)
        v = rng.random(nedges)
        a_eff = a * rng.uniform(0.95, 1.05, nedges) if noise else a
        ab = a_eff + b
        src_bit = u >= ab
        p_dst1 = np.where(src_bit, d / (c + d), b / ab)
        dst_bit = v < p_dst1
        w = np.int64(1) << level
        src += src_bit * w
        dst += dst_bit * w
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    return rows, cols
