"""Monoid segment reductions — counterpart of ``combblas_tpu/ops/segment.py``.

Combine values that share a key with the semiring's ``add``: the monoids
torch can scatter-combine natively (``sum``, ``min``, ``max``) in one
scatter, any other monoid by a sort and a segmented fold. Out-of-range ids
(>= num_segments, the padding slots) are dropped; ``spread_drops`` and
``segment_reduce_dropping`` drop the slots of a mask over many sink
segments.
``expand_ranges`` maps static-capacity slots back to variable-length
ranges.
"""

from __future__ import annotations

import torch

from ..semiring import Semiring

_SCATTER_REDUCE = {"min": "amin", "max": "amax"}

# sink segments of ``segment_reduce_dropping``, cycled over the dropped slots
DROP_SPREAD = 4096


def segment_reduce(
    sr: Semiring, vals: torch.Tensor, ids: torch.Tensor, num_segments: int, *,
    ids_sorted: bool = False,
) -> torch.Tensor:
    """``out[s] = sr.add``-fold of ``vals[ids == s]`` (``vals`` is ``[n]`` or
    ``[n, F]``); empty segments get ``sr.zero``. ids >= num_segments are
    dropped. ``ids_sorted`` is the reference's hint that the ids ascend; the
    result does not depend on it, and the scatters here do not use it."""
    sink = torch.clamp(ids, max=num_segments).long()  # one drop slot at the end
    if sr.add_kind == "sum":
        # 0 is the identity of any '+'-monoid: empty segments need no patch
        out = torch.zeros((num_segments + 1, *vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, sink, vals)[:num_segments]
    reduce = _SCATTER_REDUCE.get(sr.add_kind)
    if reduce is None:
        return _generic_segment_reduce(sr, vals, ids, num_segments)
    out = torch.full(
        (num_segments + 1, *vals.shape[1:]), sr.zero(vals.dtype), dtype=vals.dtype,
        device=vals.device,
    )
    # include_self=False: a touched segment folds only its own values, an
    # untouched one keeps the semiring zero
    index = sink.view(-1, *[1] * (vals.dim() - 1)).expand_as(vals)
    out.scatter_reduce_(0, index, vals, reduce=reduce, include_self=False)
    if out.is_floating_point():
        ints = float_bits(out).dtype
        bits = torch.full(out.shape, torch.iinfo(ints).max if sr.add_kind == "min"
                          else torch.iinfo(ints).min, dtype=ints, device=out.device)
        bits.scatter_reduce_(0, index, float_bits(vals), reduce=reduce)
        out = fix_signed_zeros(out, bits, sr.add_kind)
    return out[:num_segments]


def spread_drops(ids: torch.Tensor, keep: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``ids`` where ``keep``; elsewhere one of ``DROP_SPREAD`` sink ids past
    ``num_segments``, cycled along the last axis. Folded by
    ``segment_reduce`` into ``num_segments + DROP_SPREAD`` segments, the
    first ``num_segments`` are the fold of the kept slots: one sink would
    serialise the atomics of every dropped slot on one address."""
    sink = torch.arange(ids.shape[-1], dtype=ids.dtype, device=ids.device) % DROP_SPREAD
    return torch.where(keep, ids, sink + num_segments)


def segment_reduce_dropping(sr: Semiring, vals: torch.Tensor, ids: torch.Tensor,
                            keep: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_reduce`` of the slots where ``keep``; the others fold into
    spread sinks (``spread_drops``) and are cut off."""
    return segment_reduce(sr, vals, spread_drops(ids, keep, num_segments),
                          num_segments + DROP_SPREAD)[:num_segments]


def float_bits(v: torch.Tensor) -> torch.Tensor:
    """The bit patterns of float ``v`` as signed integers of its width."""
    return v.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()])


def fold_dim(sr: Semiring, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``sr.add``-fold of ``b`` along ``dim``: a sum keeps ``b``'s dtype
    (bool counts as int32); a float min or max gives the reference's signed
    zeros (``fix_signed_zeros``); any other monoid folds by a pairwise
    tree."""
    if sr.add_kind == "sum":
        return b.sum(dim=dim, dtype=torch.int32 if b.dtype == torch.bool else b.dtype)
    if sr.add_kind in ("min", "max"):
        fold = torch.amin if sr.add_kind == "min" else torch.amax
        out = fold(b, dim=dim)
        if out.is_floating_point():
            out = fix_signed_zeros(out, fold(float_bits(b), dim=dim), sr.add_kind)
        return out
    parts = b.movedim(dim, -1)
    while parts.shape[-1] > 1:
        if parts.shape[-1] % 2:
            parts = torch.cat([parts, parts.new_full((*parts.shape[:-1], 1), sr.zero(b.dtype))],
                              dim=-1)
        parts = sr.add(parts[..., 0::2], parts[..., 1::2])
    return parts[..., 0]


def fix_signed_zeros(out: torch.Tensor, folded_bits: torch.Tensor, kind: str) -> torch.Tensor:
    """Give each zero of a float min/max result the sign the reference
    gives it: its min is -0.0 where any -0.0 took part, its max +0.0 where
    any +0.0 did. torch's ``amin``/``amax`` and ``scatter_reduce_`` keep
    whichever of two equal zeros comes first.

    ``folded_bits``: the operands' ``float_bits`` folded the same way (min
    for "min", max for "max"). Where a min is a zero no operand is below
    zero, so the folded patterns are the smallest integer (the pattern of
    -0.0) exactly when a -0.0 took part; where a max is a zero no operand
    is above it, and the folded patterns are 0 (+0.0) exactly when a +0.0
    took part."""
    hit = folded_bits == (torch.iinfo(folded_bits.dtype).min if kind == "min" else 0)
    pref = out.new_tensor(-0.0 if kind == "min" else 0.0)
    return torch.where(out == 0, torch.where(hit, pref, -pref), out)


def _generic_segment_reduce(
    sr: Semiring, vals: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Any monoid: sort by id (stable), an inclusive segmented fold in
    log2(n) doubling steps (slot i takes ``sr.add(slot i-d, slot i)`` where
    both hold the same id; ids are sorted, so a run is contiguous), then
    the last slot of each run scattered out. The reference folds with an
    associative scan; for an associative monoid the results are equal."""
    out = torch.full(
        (num_segments + 1, *vals.shape[1:]), sr.zero(vals.dtype), dtype=vals.dtype,
        device=vals.device,
    )
    n = ids.shape[0]
    if n == 0:
        return out[:num_segments]
    ids, order = torch.sort(torch.clamp(ids, max=num_segments).long(), stable=True)
    vals = vals.index_select(0, order)
    lanes = [1] * (vals.dim() - 1)
    d = 1
    while d < n:
        same = (ids[d:] == ids[:-d]).view(-1, *lanes)
        vals = torch.cat([vals[:d], torch.where(same, sr.add(vals[:-d], vals[d:]), vals[d:])])
        d *= 2
    is_last = torch.ones(n, dtype=torch.bool, device=ids.device)
    is_last[:-1] = ids[1:] != ids[:-1]
    # one store per run (distinct targets); the other slots go to the sink
    out.index_put_((torch.where(is_last, ids, num_segments),), vals)
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
