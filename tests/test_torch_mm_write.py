"""``write_mm`` formats its body a block of lines at a time: the bytes
equal the reference's ``np.savetxt`` output across block edges and for
special values."""

import numpy as np
import pytest

from combblas_tpu.io import mm as jax_mm
from combblas_tpu_torch.io import mm as port_mm


@pytest.mark.parametrize("lines", [1, port_mm._MM_WRITE_LINES, port_mm._MM_WRITE_LINES + 7])
def test_write_mm_bytes_across_blocks(tmp_path, lines):
    rng = np.random.default_rng(lines)
    n = 1 << 20
    r = rng.integers(0, n, lines).astype(np.int32)
    c = rng.integers(0, n, lines).astype(np.int32)
    v = np.where(rng.random(lines) < 0.5, rng.integers(1, 16, lines),
                 rng.standard_normal(lines) * 10.0 ** rng.integers(-30, 30, lines))
    v = v.astype(np.float32)
    v[: min(lines, 6)] = [np.nan, np.inf, -np.inf, -0.0, 1e-38, 3.4e38][: min(lines, 6)]
    a, b = tmp_path / "port.mtx", tmp_path / "ref.mtx"
    port_mm.write_mm(str(a), (r, c, v, n, n))
    jax_mm.write_mm(str(b), (r, c, v, n, n))
    assert a.read_bytes() == b.read_bytes()
