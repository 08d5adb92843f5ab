"""Parity of the port's functors (``combblas_tpu_torch.operations``) with
``combblas_tpu.operations`` on the CPU, on arrays that hold NaN, ±0 and
±inf. Results are compared by their bits, NaN cells by position (NaN
payloads are not part of either package's contract); no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu import operations as jax_ops
from combblas_tpu_torch import operations as ops

SPECIALS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 2.5, -3.0, 1e-30],
                    np.float32)


def float_operands(seed):
    rng = np.random.default_rng(seed)
    a = rng.choice(SPECIALS, size=(40, 25))
    b = rng.choice(SPECIALS, size=(40, 25))
    return a, b


def int_operands(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-9, 10, (40, 25)).astype(np.int32),
            rng.integers(-9, 10, (40, 25)).astype(np.int32))


def assert_same_bits(got: torch.Tensor, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        view = {4: np.int32, 8: np.int64}[got.dtype.itemsize]
        np.testing.assert_array_equal(got.view(view)[~nan], want.view(view)[~nan])
    else:
        np.testing.assert_array_equal(got, want)


BINARY_FLOAT = ["maximum", "minimum", "plus", "multiplies", "sel1st", "sel2nd",
                "logical_or", "logical_and"]
BINARY_INT = BINARY_FLOAT + ["bitwise_or", "bitwise_and", "bitwise_xor"]


@pytest.mark.parametrize("name", BINARY_FLOAT)
def test_binary_functor_on_floats(name):
    a, b = float_operands(len(name))
    got = getattr(ops, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert_same_bits(got, getattr(jax_ops, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", BINARY_INT)
def test_binary_functor_on_ints(name):
    a, b = int_operands(len(name))
    got = getattr(ops, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert_same_bits(got, getattr(jax_ops, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("sentinel", [0.0, -1.0, float("inf")])
def test_set_if_not_equal(sentinel):
    a, b = float_operands(7)
    f = ops.set_if_not_equal(sentinel)
    assert f is ops.set_if_not_equal(sentinel)  # one closure per sentinel
    got = f(torch.from_numpy(a), torch.from_numpy(b))
    assert_same_bits(got, jax_ops.set_if_not_equal(sentinel)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["identity", "safemultinv", "totality", "negate", "absolute"])
def test_unary_functor_on_floats(name):
    a, _ = float_operands(len(name))
    got = getattr(ops, name)(torch.from_numpy(a))
    assert_same_bits(got, getattr(jax_ops, name)(jnp.asarray(a)))


@pytest.mark.parametrize("name", ["identity", "totality", "negate", "absolute"])
def test_unary_functor_on_ints(name):
    a, _ = int_operands(len(name))
    got = getattr(ops, name)(torch.from_numpy(a))
    assert_same_bits(got, getattr(jax_ops, name)(jnp.asarray(a)))


@pytest.mark.parametrize("power", [2.0, 0.5, 3.0])
def test_exponentiate(power):
    """Squares, cubes and square roots are correctly rounded in both
    packages; on the special values every power is exact."""
    rng = np.random.default_rng(5)
    a = np.concatenate([SPECIALS, rng.integers(0, 64, 90).astype(np.float32)]).reshape(10, 10)
    if power == 0.5:
        a = np.abs(a)
    f = ops.exponentiate(power)
    assert f is ops.exponentiate(power)
    assert_same_bits(f(torch.from_numpy(a)), jax_ops.exponentiate(power)(jnp.asarray(a)))


def test_rand_reduce_keeps_its_contract():
    """Excluded from bit parity (torch's draws, not JAX's): every element
    is one operand's, both operands are picked, and the same generator
    state gives the same picks."""
    a, b = int_operands(9)
    a, b = torch.from_numpy(a), torch.from_numpy(b) + 100
    got = ops.rand_reduce(torch.Generator().manual_seed(3), a, b)
    again = ops.rand_reduce(torch.Generator().manual_seed(3), a, b)
    assert torch.equal(got, again)
    from_a, from_b = got == a, got == b
    assert bool((from_a ^ from_b).all())
    assert 0.3 < float(from_a.float().mean()) < 0.7
