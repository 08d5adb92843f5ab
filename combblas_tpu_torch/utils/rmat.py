"""Graph500 R-MAT edges — counterpart of ``combblas_tpu/utils/rmat.py``.

``rmat_symmetric_coo_host`` is pure numpy, the same draws in the same
order, so the same seed gives the same edges as the reference.
``rmat_edges`` and ``rmat_symmetric_coo`` draw on a device from a
threefry key (``utils/threefry.py``), the same stream as the reference's
``jax.random``, so the same key gives the same edges.
"""

from __future__ import annotations

import numpy as np
import torch


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


# --- the device generator (``jax.random`` threefry), bit for bit ------------

# flat [edges, scale] draws per piece: the stream is drawn in pieces of at
# most this many words (each piece a few int64 temporaries of 8 B a word)
RMAT_PIECE_WORDS = 1 << 25


def rmat_edges(key, scale: int, nedges: int, noise: bool = True, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, *, device=None):
    """``nedges`` R-MAT edges over ``2**scale`` vertices from a threefry
    key (``utils.threefry.ThreefryKey``): the reference's
    ``utils/rmat.py:rmat_edges`` bit for bit, on ``device`` (default: the
    CUDA card). Returns int32 (src, dst) tensors; loops and duplicates
    are kept.

    The key splits in four (source draws, destination draws, noise,
    relabeling). Per edge and level: ``a_eff = a · mu`` (mu uniform in
    [0.95, 1.05), or 1 without noise), source bit ``u >= a_eff + b``,
    destination bit ``v < (d / (c + d) if the source bit else b / (a_eff +
    b))``, all in float32 with the Python constants rounded once, and
    ``a_eff + b`` rounded once as the reference's fused multiply-add does.
    The [nedges, scale] draws are made in pieces of edges (the flat index
    of each draw is kept, so the stream is the same) and each piece is
    freed before the next. Then a random permutation relabels the
    vertices."""
    from . import threefry

    dev = torch.device("cuda" if device is None else device)
    d = 1.0 - a - b - c
    k_src, k_dst, k_noise, k_perm = threefry.split(key, 4)
    a32, b32 = float(np.float32(a)), float(np.float32(b))
    p_src1 = torch.tensor(np.float32(d / (c + d)), device=dev)
    b_t = torch.tensor(np.float32(b), device=dev)
    weights = torch.ones(scale, dtype=torch.int64, device=dev) << torch.arange(
        scale, dtype=torch.int64, device=dev)
    src = torch.empty(nedges, dtype=torch.int32, device=dev)
    dst = torch.empty(nedges, dtype=torch.int32, device=dev)
    step = max(RMAT_PIECE_WORDS // max(scale, 1), 1)
    for e0 in range(0, nedges, step):
        e1 = min(e0 + step, nedges)
        shape, off = (e1 - e0, scale), e0 * scale
        if noise:
            mu = threefry.uniform(k_noise, shape, 0.95, 1.05, dev, off)
            ab = (mu.double() * a32 + b32).float()  # exact in float64, rounded once
            del mu
        else:
            ab = torch.full(shape, np.float32(a32) + np.float32(b32), device=dev)
        src_bit = threefry.uniform(k_src, shape, device=dev, offset=off) >= ab
        p_dst1 = torch.where(src_bit, p_src1, b_t / ab)
        del ab
        dst_bit = threefry.uniform(k_dst, shape, device=dev, offset=off) < p_dst1
        del p_dst1
        src[e0:e1] = (src_bit * weights).sum(1).to(torch.int32)
        dst[e0:e1] = (dst_bit * weights).sum(1).to(torch.int32)
    perm = threefry.permutation(k_perm, 1 << scale, dev)
    return perm[src.long()], perm[dst.long()]


def rmat_symmetric_coo(key, scale: int, edgefactor: int = 16, noise: bool = True, *,
                       device=None):
    """``rmat_edges`` → symmetrized COO without loops (both directions,
    duplicates kept), as host int32 numpy (rows, cols): the reference's
    ``rmat_symmetric_coo``."""
    n = 1 << scale
    src, dst = rmat_edges(key, scale, edgefactor * n, noise, device=device)
    src, dst = src.cpu().numpy(), dst.cpu().numpy()
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return np.concatenate([src, dst]), np.concatenate([dst, src])
