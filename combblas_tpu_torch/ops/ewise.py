"""Elementwise set operations on sparse tiles by sort and merge —
counterpart of ``combblas_tpu/ops/ewise.py``.

Both tiles' (row, col) keys go into one stable sort; an ``a`` slot matches
``b`` when the slot just before it in sorted order is a ``b`` slot with the
same key. The reference sorts three int32 keys (row, col, tag); here one
int64 key ``(row * (ncols + 1) + col) * 2 + tag`` with tag 0 for ``b`` and 1
for ``a`` orders the same way, so a ``b`` entry lands just before the ``a``
entries with its key.
"""

from __future__ import annotations

import dataclasses

import torch

from .tuples import SpTuples


def intersect_lookup(a: SpTuples, b: SpTuples, b_zero) -> tuple[torch.Tensor, torch.Tensor]:
    """For every slot of ``a``: whether its (row, col) is present in ``b``,
    and ``b``'s value there (``b_zero`` where absent). Returns ``(hit
    bool[capa], bval[capa])``. ``b`` must hold no repeated valid entry;
    hits on ``a``'s padding slots mean nothing (callers mask with
    ``a.valid_mask()``)."""
    capa, capb = a.capacity, b.capacity
    dev = a.rows.device
    rows = torch.cat([b.rows, a.rows]).long()
    cols = torch.cat([b.cols, a.cols]).long()
    tag = torch.cat([torch.zeros(capb, dtype=torch.long, device=dev),
                     torch.ones(capa, dtype=torch.long, device=dev)])
    key = (rows * (a.ncols + 1) + cols) * 2 + tag
    key, order = torch.sort(key, stable=True)
    t = key & 1
    matched = (key[1:] == key[:-1] + 1) & (t[1:] == 1)
    hit_sorted = torch.cat([matched.new_zeros(1), matched])
    bval = torch.cat([b.vals, b.vals.new_zeros(capa)])[order]
    bv_prev = torch.cat([bval[:1], bval[:-1]])
    # a slot's position in a; b slots go to the sink slot capa
    apos = torch.where(t == 1, order - capb, capa)
    hit = torch.zeros(capa + 1, dtype=torch.bool, device=dev)
    hit[apos] = hit_sorted
    bvals = torch.full((capa + 1,), b_zero, dtype=b.vals.dtype, device=dev)
    bvals[apos] = torch.where(hit_sorted, bv_prev, torch.full_like(bv_prev, b_zero))
    return hit[:capa], bvals[:capa]


def ewise_apply(a: SpTuples, b: SpTuples, fn, *, allow_a_nulls: bool, allow_b_nulls: bool,
                a_null, b_null) -> SpTuples:
    """Elementwise apply with nulls: the output pattern is the
    intersection, extended to the entries only in ``b`` when
    ``allow_a_nulls`` (``a``'s value there is ``a_null``) and to those only
    in ``a`` when ``allow_b_nulls``. ``fn(a_val, b_val)`` gives the kept
    values. Both tiles must be free of repeated entries. Capacity: ``a``'s,
    or ``a.capacity + b.capacity`` with ``allow_a_nulls``. Reference:
    ``EWiseApply``."""
    hit_ab, bvals = intersect_lookup(a, b, b_zero=b_null)
    keep_a = a.valid_mask() & (hit_ab | allow_b_nulls)
    vals_a = torch.where(keep_a, fn(a.vals, bvals), a.vals).to(a.vals.dtype)
    a_side = dataclasses.replace(a, vals=vals_a)._select(keep_a)
    if not allow_a_nulls:
        return a_side
    hit_ba, _ = intersect_lookup(b, a, b_zero=0)
    keep_b = b.valid_mask() & ~hit_ba
    vals_b = fn(torch.full_like(b.vals, a_null, dtype=a.vals.dtype), b.vals)
    b_side = dataclasses.replace(b, vals=vals_b.to(a.vals.dtype))._select(keep_b)
    return SpTuples.concat([a_side, b_side])


def ewise_mult(a: SpTuples, b: SpTuples, negate: bool, combine=None) -> SpTuples:
    """``a .* structure(b)`` (``negate=False``) or ``a .* ¬structure(b)``;
    ``combine(a_val, b_val)`` gives the kept values of an intersection
    (default: ``a``'s). Reference: ``EWiseMult``."""
    hit, bvals = intersect_lookup(a, b, b_zero=0)
    keep = a.valid_mask() & (hit != negate)
    out = a
    if combine is not None and not negate:
        out = dataclasses.replace(a, vals=torch.where(keep, combine(a.vals, bvals), a.vals))
    return out._select(keep)
