"""Graph500 R-MAT edges — counterpart of ``combblas_tpu/utils/rmat.py``.

``rmat_symmetric_coo_host`` is pure numpy, the same draws in the same
order, so the same seed gives the same edges as the reference.
``rmat_symmetric_coo_drawn`` gives the same edges with only the draws
on the host (in pieces, on threads) and the arithmetic on a device.
``rmat_edges`` and ``rmat_symmetric_coo`` draw on a device from a
threefry key (``utils/threefry.py``), the same stream as the reference's
``jax.random``, so the same key gives the same edges.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

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


def _stream_piece(state: dict, offset: int) -> np.random.Generator:
    """A generator on a copy of the PCG64 ``state`` advanced by ``offset``
    64-bit draws: ``random`` and ``uniform`` take one draw a value, so it
    continues the stream at value ``offset``."""
    bg = np.random.PCG64()
    bg.state = state
    bg.advance(offset)
    return np.random.Generator(bg)


def rmat_symmetric_coo_drawn(
    seed: int, scale: int, edgefactor: int = 16, noise: bool = True, *,
    device=None, threads: int | None = None,
):
    """``rmat_symmetric_coo_host``'s edges, bit for bit, as int64 (rows,
    cols) tensors on ``device`` (default: the CUDA card).

    The host makes only the draws: each level's ``u``, ``v`` and noise
    arrays are cut into ``threads`` pieces (default: the CPU count, at
    most 8), each drawn by its own generator on a copy of
    ``default_rng(seed)``'s PCG64 state advanced to the piece's offset in
    the stream (numpy releases the GIL while it fills), into one pinned
    buffer reused by every level. The device then takes the bits in
    float64 with ``rmat_symmetric_coo_host``'s operations one at a time
    (``b / ab`` a true division, never a reciprocal), the relabeling by
    ``permutation`` drawn where the stream stands after the levels, and
    the symmetrization."""
    dev = torch.device("cuda" if device is None else device)
    a, b, c = 0.57, 0.19, 0.19
    d = 1.0 - a - b - c
    n = 1 << scale
    nedges = edgefactor * n
    rng = np.random.default_rng(seed)
    state = rng.bit_generator.state
    per_level = 3 if noise else 2
    pieces = max(1, min(threads or min(os.cpu_count() or 1, 8), nedges))
    cuts = np.linspace(0, nedges, pieces + 1).astype(np.int64)
    host_t = torch.empty((per_level, nedges), dtype=torch.float64,
                         pin_memory=dev.type == "cuda")
    host = host_t.numpy()

    def fill(level: int, which: int, lo: int, hi: int) -> None:
        g = _stream_piece(state, (level * per_level + which) * nedges + lo)
        if which < 2:
            g.random(out=host[which, lo:hi])
        else:
            host[which, lo:hi] = g.uniform(0.95, 1.05, hi - lo)

    b_t = torch.tensor(b, dtype=torch.float64, device=dev)
    p_src1 = torch.tensor(d / (c + d), dtype=torch.float64, device=dev)
    src = torch.zeros(nedges, dtype=torch.int64, device=dev)
    dst = torch.zeros(nedges, dtype=torch.int64, device=dev)
    with ThreadPoolExecutor(pieces) as pool:
        for level in range(scale):
            jobs = [pool.submit(fill, level, which, int(lo), int(hi))
                    for which in range(per_level) for lo, hi in zip(cuts[:-1], cuts[1:])]
            for job in jobs:
                job.result()
            draws = host_t.to(dev)  # blocking: the next level refills the buffer
            u, v = draws[0], draws[1]
            ab = (draws[2] * a if noise else torch.full_like(u, a)) + b
            src_bit = u >= ab
            dst_bit = v < torch.where(src_bit, p_src1, torch.div(b_t, ab))
            del draws, u, v, ab
            w = 1 << level
            src += src_bit * w
            dst += dst_bit * w
    rng.bit_generator.advance(scale * per_level * nedges)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return torch.cat([src, dst]), torch.cat([dst, src])


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
