"""Tests of the port that need an NVIDIA card: each CUDA kernel against its
plain PyTorch version, and the mxu SpGEMM path on the card against the same
path on the CPU. Marked ``cuda``; they skip where there is no card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Comparisons are exact (``torch.equal``): min/max folds do not depend on
order, and integer-valued float32 inputs keep every ``plus_times`` sum
below 2**24.
"""

import numpy as np
import pytest
import torch

from combblas_tpu_torch import (
    MAX_MIN,
    MIN_PLUS,
    PLUS_TIMES,
    Grid,
    SpParMat,
    rmat_symmetric_coo_host,
    semiring_matmul,
    semiring_matmul_reference,
    spgemm_auto,
)
from combblas_tpu_torch.ops.semiring_matmul import KINDS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _int_valued(rng, shape, dev):
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(1000, 777, 1234), (1, 1, 1), (65, 3, 129)])
def test_kernel_matches_plain_version(kind, shape, cuda_device):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = _int_valued(rng, (m, k), cuda_device)
    b = _int_valued(rng, (k, n), cuda_device)
    launches = semiring_matmul.launches
    got = semiring_matmul(kind, a, b)
    torch.cuda.synchronize()
    assert semiring_matmul.launches == launches + 1
    assert torch.equal(got, semiring_matmul_reference(kind, a, b))


def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    a = torch.zeros((8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        semiring_matmul("min_plus", a.t(), a)
    with pytest.raises(TypeError, match="float32"):
        semiring_matmul("min_plus", a.half(), a.half())


@pytest.mark.parametrize("p", [1, 2])
def test_spgemm_auto_on_card_matches_cpu(p, cuda_device):
    """The mxu path on the card (kernel) gives the CPU path's (plain
    version) arrays."""
    n = 1 << 8
    r, c = rmat_symmetric_coo_host(3, 8, 8)
    v = np.random.default_rng(7).integers(1, 16, r.shape[0]).astype(np.float32)
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        mats = [
            SpParMat.from_global_coo(
                Grid.make(p, p, device=dev), r, c, v, n, n, dedup_sr=sr
            )
            for dev in ("cpu", cuda_device)
        ]
        want = spgemm_auto(sr, mats[0], mats[0])
        launches = semiring_matmul.launches
        got = spgemm_auto(sr, mats[1], mats[1])
        if sr is not PLUS_TIMES:
            assert semiring_matmul.launches > launches
        for field in ("rows", "cols", "vals", "nnz"):
            assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
