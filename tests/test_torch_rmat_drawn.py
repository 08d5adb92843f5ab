"""The R-MAT generator with its draws on host threads and its arithmetic
on a device (``rmat_symmetric_coo_drawn``, ``build_graph(device=)``)
against the pure numpy recipe, bit for bit, and that recipe against the
reference's."""

import numpy as np
import pytest
import torch

from combblas_tpu.utils.rmat import rmat_symmetric_coo_host as ref_rmat_host
from combblas_tpu_torch.utils.graph500 import build_graph
from combblas_tpu_torch.utils.rmat import rmat_symmetric_coo_drawn, rmat_symmetric_coo_host


@pytest.mark.parametrize("scale,edgefactor,noise,threads", [
    (6, 16, True, 1), (8, 4, True, 3), (9, 16, False, 8), (11, 16, True, 5), (12, 8, True, None),
])
def test_drawn_equals_host(scale, edgefactor, noise, threads):
    rows, cols = rmat_symmetric_coo_host(42, scale, edgefactor, noise)
    r, c = rmat_symmetric_coo_drawn(42, scale, edgefactor, noise, device="cpu", threads=threads)
    assert r.dtype == c.dtype == torch.int64
    np.testing.assert_array_equal(r.numpy(), rows)
    np.testing.assert_array_equal(c.numpy(), cols)


@pytest.mark.parametrize("scale", [7, 10])
def test_host_recipe_equals_reference(scale):
    rows, cols = rmat_symmetric_coo_host(42, scale, 16)
    want_r, want_c = ref_rmat_host(42, scale, 16)
    np.testing.assert_array_equal(rows, want_r)
    np.testing.assert_array_equal(cols, want_c)


@pytest.mark.parametrize("scale,nroots", [(8, 4), (11, 16), (13, 64)])
def test_build_graph_on_device_equals_host(scale, nroots):
    want = build_graph(scale, 16, nroots)
    got = build_graph(scale, 16, nroots, device="cpu")
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
