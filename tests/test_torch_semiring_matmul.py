"""Parity of the port's semiring GEMM (``combblas_tpu_torch.ops.semiring_matmul``)
with the JAX package's Pallas kernel (``combblas_tpu.ops.pallas_kernels``).

On the CPU the port's wrapper runs its plain PyTorch version; the JAX kernel
runs in Pallas interpret mode. Every comparison is exact
(``assert_array_equal``): the min/max folds do not depend on the order of
the fold, each tropical candidate is one IEEE add or min, and the
integer-valued float32 inputs keep every ``plus_times`` sum below 2**24, so
no sum is rounded in either order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.ops.pallas_kernels import min_plus_matmul as jax_min_plus_matmul
from combblas_tpu.ops.pallas_kernels import semiring_matmul as jax_semiring_matmul
from combblas_tpu_torch.ops.semiring_matmul import (
    KINDS,
    min_plus_matmul,
    semiring_matmul,
    semiring_matmul_reference,
)

_NP_FOLDS = {
    "min_plus": (np.min, np.add, np.inf),
    "max_plus": (np.max, np.add, -np.inf),
    "max_min": (np.max, np.minimum, -np.inf),
    "plus_times": (np.sum, np.multiply, 0.0),
}


def _int_valued(rng, shape, lo=-8, hi=9):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _numpy_semiring_mm(kind, a, b):
    reduce, mul, zero = _NP_FOLDS[kind]
    if a.shape[1] == 0:
        return np.full((a.shape[0], b.shape[1]), zero, np.float32)
    return reduce(mul(a[:, :, None], b[None, :, :]), axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_matches_pallas_kernel(kind):
    """The four kinds of the reference's ``_FOLDS`` at 256³, against the
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(11)
    a = _int_valued(rng, (256, 256))
    b = _int_valued(rng, (256, 256))
    want = np.asarray(
        jax_semiring_matmul(kind, jnp.asarray(a), jnp.asarray(b), interpret=True)
    )
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    launches = semiring_matmul.launches
    np.testing.assert_array_equal(semiring_matmul(kind, ta, tb).numpy(), want)
    np.testing.assert_array_equal(semiring_matmul_reference(kind, ta, tb).numpy(), want)
    assert semiring_matmul.launches == launches  # the CPU path launches nothing


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(37, 53, 29), (1, 7, 3), (5, 0, 4), (64, 130, 1)])
def test_ragged_shapes_match_numpy(kind, shape):
    """Shapes the Pallas kernel cannot take (no block multiple, k == 0),
    folded in one chunk and in chunks of one k column."""
    m, k, n = shape
    rng = np.random.default_rng(m * 10007 + k * 101 + n)
    a = _int_valued(rng, (m, k))
    b = _int_valued(rng, (k, n))
    want = _numpy_semiring_mm(kind, a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(semiring_matmul(kind, ta, tb).numpy(), want)
    np.testing.assert_array_equal(
        semiring_matmul_reference(kind, ta, tb, chunk_elems=1).numpy(), want
    )


def test_min_plus_repeated_squaring():
    """Dense APSP by repeated tropical squaring (the kernel's use case),
    on the graph of ``tests/test_parity_ops.py``'s squaring test. Each
    candidate distance is one float32 add and min is exact, so the port,
    the Pallas kernel and numpy agree bit for bit."""
    n = 128
    d = np.full((n, n), np.inf, np.float32)
    np.fill_diagonal(d, 0)
    rng = np.random.default_rng(1)
    for _ in range(300):
        i, j = rng.integers(0, n, 2)
        if i != j:
            w = float(rng.random() + 0.1)
            d[i, j] = min(d[i, j], w)
            d[j, i] = min(d[j, i], w)
    dist = np.where(np.isinf(d), np.float32(1e6), d)
    want = dist.copy()
    for _ in range(8):
        want = np.minimum(want, np.min(want[:, :, None] + want[None, :, :], axis=1))
    ref = jnp.asarray(dist)
    got = torch.from_numpy(dist)
    for _ in range(8):
        ref = jnp.minimum(ref, jax_min_plus_matmul(ref, ref, interpret=True))
        got = torch.minimum(got, min_plus_matmul(got, got))
    np.testing.assert_array_equal(np.asarray(ref), want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="unknown semiring kind"):
        semiring_matmul("min_times", a, a)
    with pytest.raises(ValueError, match="do not chain"):
        semiring_matmul("min_plus", a, torch.zeros((3, 4)))
    with pytest.raises(TypeError, match="float32"):
        semiring_matmul("min_plus", a.double(), a.double())
    with pytest.raises(ValueError, match="cuda or cpu"):
        semiring_matmul("min_plus", a.to("meta"), a.to("meta"))

