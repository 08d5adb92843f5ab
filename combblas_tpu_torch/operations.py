"""The functor zoo (≈ Operations.h) as plain functions on tensors —
counterpart of ``combblas_tpu/operations.py``.

Binary functors take two tensors of one shape (or a tensor and a Python
number), unary ones a tensor. Every functor but ``rand_reduce`` gives the
reference's result bit for bit, NaN, ±0 and ±inf included.
"""

from __future__ import annotations

from functools import lru_cache

import torch

# --- binary fold / combine ops ---------------------------------------------


def maximum(a, b):
    """≈ maximum<T>; a NaN operand gives NaN, and +0 counts as greater
    than -0 (the reference's order; ``torch.maximum`` alone keeps
    whichever zero comes first)."""
    out = torch.maximum(a, b)
    if not out.is_floating_point():
        return out
    return torch.where((a == 0) & (b == 0), a + b, out)  # (+0) + (-0) = +0


def minimum(a, b):
    """≈ minimum<T>; a NaN operand gives NaN, and -0 counts as less than
    +0."""
    out = torch.minimum(a, b)
    if not out.is_floating_point():
        return out
    return torch.where((a == 0) & (b == 0), -((-a) + (-b)), out)


def plus(a, b):
    return a + b


def multiplies(a, b):
    return a * b


def sel1st(a, b):
    """Keep the first operand."""
    return a


def sel2nd(a, b):
    """Keep the second operand."""
    return b


def logical_or(a, b):
    return torch.logical_or(a != 0, b != 0)


def logical_and(a, b):
    return torch.logical_and(a != 0, b != 0)


def bitwise_or(a, b):
    return a | b


def bitwise_and(a, b):
    return a & b


def bitwise_xor(a, b):
    return a ^ b


@lru_cache(maxsize=None)
def set_if_not_equal(sentinel: float):
    """≈ SetIfNotEqual: keep a where a != sentinel, else take b. One
    cached closure per sentinel."""

    def f(a, b):
        return torch.where(a != sentinel, a, b)

    return f


def rand_reduce(generator: torch.Generator, a, b):
    """≈ RandReduce: pick between the operands by a fair coin per element,
    drawn from ``generator`` (which stands where the reference threads a
    JAX key, and must live on the operands' device). The draws are
    torch's, not JAX's, so this functor is excluded from bit parity with
    the reference: only its contract holds (every element is a's or b's,
    and the same generator state gives the same picks)."""
    coin = torch.rand(a.shape, generator=generator, device=a.device) < 0.5
    return torch.where(coin, a, b)


# --- unary ops --------------------------------------------------------------


def identity(v):
    return v


def safemultinv(v):
    """≈ safemultinv: 1/x with 0 mapped to 0."""
    nz = v != 0
    one = torch.ones((), dtype=v.dtype, device=v.device)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.where(nz, 1.0 / torch.where(nz, v, one), zero)


def totality(v):
    """≈ totality: constant true (structural counting)."""
    return torch.ones(v.shape, dtype=torch.bool, device=v.device)


@lru_cache(maxsize=None)
def exponentiate(power: float):
    """≈ exponentiate (MCL's inflation functor), cached per power."""

    def f(v):
        return v**power

    return f


def negate(v):
    return -v


def absolute(v):
    return torch.abs(v)
