"""k-hop feature propagation, the graph-ML workload — counterpart of
``combblas_tpu/models/propagate.py``.

Every node carries a dense feature row and a query wants the k-hop
neighbourhood aggregate ``(D⁻¹A)ᵏ·X`` (normalised) or ``Aᵏ·X``: the
SGC / LightGCN-style propagation step, the SpMM lane applied k times.

  * ``propagate_features``: host ``[n, F]`` features in, propagated
    ``[n, F]`` out (``spmm_khop``).
  * ``_propagate_batch_impl``: W root queries answered without touching
    the whole feature table per query. Lane w's result is row ``v_w`` of
    ``(D⁻¹A)ᵏX``, computed through the transpose,
    ``e_vᵀ(D⁻¹A)ᵏX == ((AᵀD⁻¹)ᵏ e_v)ᵀ X``: the k hops are ``dist_spmm_ell``
    calls over an ``[n, W]`` indicator block, and the feature table enters
    once, in one ``[F, n] × [n, W]`` product (``torch.matmul``; the
    reference computes it with a plain ``jnp.dot`` too), summed over the
    grid rows. ``PAD_ROOT`` lanes have all-zero indicators and give zero
    features.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.spmm import dist_spmm_ell, spmm_khop
from ..parallel.vec import DistMultiVec
from ..semiring import PLUS_TIMES
from . import PAD_ROOT
from .bfs import _global_ids


def propagate_features(E, X, k: int, normalize: bool = False, sr=PLUS_TIMES,
                       backend: str | None = None) -> np.ndarray:
    """Whole-graph k-hop propagation: host ``[n, F]`` features → propagated
    host ``[n, F]`` (the pad lanes cut). ``E`` is an ``EllParMat`` in the
    gather orientation (entry (i, j) = edge j → i): each hop aggregates
    in-neighbour features; ``normalize`` divides by the in-degree a hop
    (plus_times only)."""
    F = int(np.asarray(X).shape[1])
    Y = spmm_khop(sr, E, X, k, normalize=normalize, backend=backend)
    return np.asarray(Y.to_global())[:, :F]


def _propagate_batch_impl(ET, X: DistMultiVec, invdeg, sources, *, hops: int,
                          normalize: bool, backend: str) -> torch.Tensor:
    """W root queries → ``[F, W]`` propagated feature columns (lane axis
    last).

    ``ET``: the hop operator in transpose orientation (E itself on a
    symmetric graph); ``X``: the row-aligned feature table (``[n, F]``
    DistMultiVec, pow2-padded F); ``invdeg``: col-aligned 1/deg DistVec
    when ``normalize``, else None; ``sources``: int32 ``[W]`` with
    ``PAD_ROOT`` pad slots."""
    grid = ET.grid
    n = ET.ncols
    col_gids = _global_ids(grid, grid.pc, grid.local_cols(n), n, "col")
    src = torch.as_tensor(sources, device=grid.device).to(torch.int32)[None, None, :]
    live = src != PAD_ROOT
    # a PAD_ROOT lane never matches, not even the -1 padding slots of the
    # id table: its indicator column is all zero
    q0 = ((col_gids[:, :, None] == src) & live).to(torch.float32)
    Q = DistMultiVec(blocks=q0, length=n, align="col", grid=grid)
    for _ in range(max(int(hops), 0)):
        if normalize:
            # (AᵀD⁻¹)Q: scale by the reciprocal degree before the hop
            Qc = Q.realign("col")
            Q = dataclasses.replace(Qc, blocks=Qc.blocks * invdeg.blocks[..., None])
        Q = dist_spmm_ell(PLUS_TIMES, ET, Q, backend=backend)
    Qr = Q.realign("row")
    xb = X.realign("row").blocks.to(torch.float32)
    out = None
    for i in range(grid.pr):  # one [F, L] × [L, W] product a grid row, summed
        r = torch.matmul(xb[i].T, Qr.blocks[i])
        out = r if out is None else out + r
    return out
