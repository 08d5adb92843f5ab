"""Monoid segment reductions — counterpart of ``combblas_tpu/ops/segment.py``.

Combine values that share a key with the semiring's ``add``, for the
monoids torch can scatter-combine natively (``sum``, ``min``, ``max``).
Out-of-range ids (>= num_segments, the padding slots) are dropped.
"""

from __future__ import annotations

import torch

from ..semiring import Semiring

_SCATTER_REDUCE = {"min": "amin", "max": "amax"}


def segment_reduce(
    sr: Semiring, vals: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[s] = sr.add``-fold of ``vals[ids == s]``; empty segments get
    ``sr.zero``. ids >= num_segments are dropped."""
    sink = torch.clamp(ids, max=num_segments).long()  # one drop slot at the end
    if sr.add_kind == "sum":
        # 0 is the identity of any '+'-monoid: empty segments need no patch
        out = torch.zeros(num_segments + 1, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, sink, vals)[:num_segments]
    reduce = _SCATTER_REDUCE.get(sr.add_kind)
    if reduce is None:
        raise NotImplementedError(
            f"segment_reduce for add_kind {sr.add_kind!r} is not ported yet "
            "(ROADMAP queue 1, the SpMV layer)"
        )
    out = torch.full(
        (num_segments + 1,), sr.zero(vals.dtype), dtype=vals.dtype, device=vals.device
    )
    # include_self=False: a touched segment folds only its own values, an
    # untouched one keeps the semiring zero
    out.scatter_reduce_(0, sink, vals, reduce=reduce, include_self=False)
    return out[:num_segments]
