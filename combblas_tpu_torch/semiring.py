"""Semirings as frozen dataclasses of torch ops.

Counterpart of ``combblas_tpu/semiring.py``. CombBLAS encodes semirings
as C++ functor classes (``Semirings.h``) so that one SpGEMM / SpMV serves
BFS, SSSP, MIS, triangle counting and MCL; here a semiring is a frozen
dataclass of elementwise torch functions. ``add_kind`` names the monoid so
that reductions can use torch's native ``scatter_reduce`` (``sum``,
``amin``, ``amax``) instead of a generic segmented fold.

The identities keep the reference's values: ``zero`` is +inf for
``min_plus`` on floats (the integer maximum on ints), -inf for ``max_min``
and 0 for ``plus_times``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .operations import minimum as _ieee_minimum


# Monoid kinds with a native scatter-combine (``generic``: a segmented fold).
ADD_KINDS = ("sum", "min", "max", "generic")


def _minval(dtype: torch.dtype) -> Any:
    if dtype.is_floating_point:
        return -float("inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _maxval(dtype: torch.dtype) -> Any:
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


@dataclasses.dataclass(frozen=True)
class Semiring:
    """An algebraic semiring ``(add, zero) / (mul, one)``.

    Attributes:
      name: stable identifier; semirings compare and hash by it.
      add: associative, commutative elementwise op (the monoid).
      mul: elementwise ``mul(a_val, x_val)``; absorbs ``zero`` in its
        second argument.
      zero_fn: dtype -> additive identity as a Python scalar.
      one_fn: dtype -> multiplicative identity (may be None).
      add_kind: "sum", "min", "max" or "generic"; selects the native
        reduction.
    """

    name: str
    add: Callable[[Any, Any], Any]
    mul: Callable[[Any, Any], Any]
    zero_fn: Callable[[torch.dtype], Any]
    one_fn: Callable[[torch.dtype], Any] | None = None
    add_kind: str = "generic"

    def zero(self, dtype: torch.dtype) -> Any:
        return self.zero_fn(dtype)

    def one(self, dtype: torch.dtype) -> Any:
        if self.one_fn is None:
            raise ValueError(f"semiring {self.name} has no multiplicative identity")
        return self.one_fn(dtype)

    def __hash__(self):
        return hash(("Semiring", self.name))

    def __eq__(self, other):
        return isinstance(other, Semiring) and other.name == self.name


#: Ordinary arithmetic (+, *). Reference: ``PlusTimesSRing``.
PLUS_TIMES = Semiring(
    name="plus_times",
    add=torch.add,
    mul=torch.mul,
    zero_fn=lambda dt: 0,
    one_fn=lambda dt: 1,
    add_kind="sum",
)


def _saturating_plus(a, x):
    """a + x that absorbs the MIN_PLUS identity (+inf / INT_MAX) exactly,
    so that integer INT_MAX + w cannot wrap to a negative distance."""
    a = torch.as_tensor(a)
    x = torch.as_tensor(x, device=a.device)
    rd = torch.result_type(a, x)
    top = _maxval(rd)
    a_, x_ = a.to(rd), x.to(rd)
    return torch.where((a_ >= top) | (x_ >= top), top, a_ + x_)


#: Tropical (min, +): SSSP / shortest distances. Reference: ``MinPlusSRing``.
MIN_PLUS = Semiring(
    name="min_plus",
    add=torch.minimum,
    mul=_saturating_plus,
    zero_fn=_maxval,
    one_fn=lambda dt: 0,
    add_kind="min",
)

#: (max, select2nd): Graph500 BFS parent selection.
SELECT2ND_MAX = Semiring(
    name="select2nd_max",
    add=torch.maximum,
    mul=lambda a, x: x,
    zero_fn=lambda dt: (
        -1 if (not dt.is_floating_point and dt != torch.bool and dt.is_signed)
        else _minval(dt)
    ),
    one_fn=None,
    add_kind="max",
)

#: (min, select2nd): minimum-label propagation in connected components.
SELECT2ND_MIN = Semiring(
    name="select2nd_min",
    add=torch.minimum,
    mul=lambda a, x: x,
    zero_fn=_maxval,
    one_fn=None,
    add_kind="min",
)

#: Boolean (or, and): reachability / structure-only products.
OR_AND = Semiring(
    name="or_and",
    add=torch.logical_or,
    mul=torch.logical_and,
    zero_fn=lambda dt: False,
    one_fn=lambda dt: True,
    add_kind="max",
)

#: (max, min): bottleneck / widest-path semiring. Its product gives -0.0
#: for (+0.0, -0.0) in either order, as the reference's does.
MAX_MIN = Semiring(
    name="max_min",
    add=torch.maximum,
    mul=_ieee_minimum,
    zero_fn=_minval,
    one_fn=_maxval,
    add_kind="max",
)

STANDARD_SEMIRINGS = {
    sr.name: sr
    for sr in (PLUS_TIMES, MIN_PLUS, SELECT2ND_MAX, SELECT2ND_MIN, OR_AND, MAX_MIN)
}
