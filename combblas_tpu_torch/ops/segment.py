"""Monoid segment reductions — counterpart of ``combblas_tpu/ops/segment.py``.

Combine values that share a key with the semiring's ``add``, for the
monoids torch can scatter-combine natively (``sum``, ``min``, ``max``).
Out-of-range ids (>= num_segments, the padding slots) are dropped.
``expand_ranges`` maps static-capacity slots back to variable-length
ranges.
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


def expand_ranges(
    lens: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten variable-length ranges into ``capacity`` slots.

    Source ``i`` contributes ``lens[i]`` items. Returns, per slot ``f``,
    ``(owner[f], offset[f])`` such that slot ``f`` is item ``offset[f]`` of
    source ``owner[f]``, the mask ``f < sum(lens)`` and ``sum(lens)``, all
    int32 (``valid`` bool). ``owner[f]`` is the last source that starts at
    or before ``f``: a binary search of the slot number in the sources'
    starts (``searchsorted(side='right') - 1``), so zero-length sources
    resolve to the highest index and slots past ``sum(lens)`` to the last
    source. The reference gets the same map from a scatter-max at the
    starts and a cumulative max, the cheap form on its hardware; on a CUDA
    card the search is the cheap one (PERF.md, section 6).
    """
    dev = lens.device
    lens = lens.to(torch.int32)
    n = lens.shape[0]
    starts = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev), torch.cumsum(lens, 0, dtype=torch.int32)]
    )
    total = starts[-1]
    f = torch.arange(capacity, dtype=torch.int32, device=dev)
    owner = torch.searchsorted(starts[:-1], f, right=True, out_int32=True) - 1
    owner = torch.clamp(owner, 0, n - 1)
    return owner, f - starts.index_select(0, owner), f < total, total
