"""combblas_tpu_torch — the PyTorch/CUDA port of ``combblas_tpu``.

Semiring sparse linear algebra over a pr×pc grid of tiles on one CUDA
card, with hand-written Hopper kernels where the JAX package had Pallas
ones. Ported so far: the tropical SpGEMM path (``spgemm_auto`` -> the
dense (mxu) tier -> the semiring GEMM kernel, ``csrc/semiring_mm.cu``) and
the dense -> sparse extraction (``dense_to_sptuples`` -> the compaction
kernel, ``csrc/dense_to_tuples.cu``), beside the plain extractions
``sparsify`` and ``sparsify_windowed``.
Entry points run on the card unless the caller passes ``device="cpu"``
to ``Grid.make``; on the CPU each kernel's plain PyTorch version runs.
"""

from .convert import spparmat_from_arrays
from .ops.dense_to_tuples import (
    dense_to_sptuples,
    dense_to_tuples_arrays,
    flat_to_tuples_arrays,
    flat_to_tuples_arrays_reference,
)
from .ops.semiring_matmul import (
    min_plus_matmul,
    semiring_matmul,
    semiring_matmul_reference,
)
from .ops.segment import expand_ranges
from .ops.spgemm import dense_support_nnz, sparsify, sparsify_windowed
from .ops.tuples import SpTuples
from .parallel.grid import Grid, HostGrid
from .parallel.spgemm import (
    MXU_MAX_TILE_DIM,
    choose_spgemm_tier,
    coo_has_duplicates,
    spgemm_auto,
    summa_spgemm_mxu,
)
from .parallel.spmat import SpParMat
from .semiring import (
    MAX_MIN,
    MIN_PLUS,
    OR_AND,
    PLUS_TIMES,
    SELECT2ND_MAX,
    SELECT2ND_MIN,
    STANDARD_SEMIRINGS,
    Semiring,
)
from .utils.rmat import rmat_symmetric_coo_host

__all__ = [
    "Grid",
    "HostGrid",
    "MAX_MIN",
    "MIN_PLUS",
    "MXU_MAX_TILE_DIM",
    "OR_AND",
    "PLUS_TIMES",
    "SELECT2ND_MAX",
    "SELECT2ND_MIN",
    "STANDARD_SEMIRINGS",
    "Semiring",
    "SpParMat",
    "SpTuples",
    "choose_spgemm_tier",
    "coo_has_duplicates",
    "dense_support_nnz",
    "dense_to_sptuples",
    "dense_to_tuples_arrays",
    "expand_ranges",
    "flat_to_tuples_arrays",
    "flat_to_tuples_arrays_reference",
    "min_plus_matmul",
    "rmat_symmetric_coo_host",
    "semiring_matmul",
    "semiring_matmul_reference",
    "sparsify",
    "sparsify_windowed",
    "spgemm_auto",
    "spparmat_from_arrays",
    "summa_spgemm_mxu",
]
