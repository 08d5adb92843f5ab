"""combblas_tpu_torch — the PyTorch/CUDA port of ``combblas_tpu``.

Semiring sparse linear algebra over a pr×pc grid of tiles on one CUDA
card, with hand-written Hopper kernels where the JAX package had Pallas
ones. Ported so far: the tropical SpGEMM path (``spgemm_auto`` -> the
dense (mxu) tier -> the semiring GEMM kernel, ``csrc/semiring_mm.cu``) and
the dense -> sparse extraction (``dense_to_sptuples`` -> the compaction
kernel, ``csrc/dense_to_tuples.cu``), beside the plain extractions
``sparsify`` and ``sparsify_windowed``; and the Graph500 batched BFS
(``utils.graph500`` builds the graph and its search structures on the
host, ``EllParMat`` holds them, ``bfs_batch_compact`` searches from W roots
at once, ``batch_traversed_edges`` and ``validate_bfs_device`` count and
check), in PyTorch ops as the reference runs it in XLA ops.
Entry points run on the card unless the caller passes ``device="cpu"``
to ``Grid.make``; on the CPU each kernel's plain PyTorch version runs.
"""

from . import operations
from .convert import (
    csc_companion_from_arrays,
    distmultivec_from_arrays,
    ellparmat_from_arrays,
    spparmat_from_arrays,
)
from .models import PAD_ROOT
from .models.bfs import (
    batch_traversed_edges,
    bfs_batch_compact,
    validate_bfs_device,
    validate_bfs_tree,
)
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
from .parallel.ellmat import (
    EllParMat,
    build_csc_companion,
    build_csc_companion_host,
    build_csr_companion,
    build_csr_companion_host,
    upload_csc_companion,
)
from .parallel.grid import Grid, HostGrid
from .parallel.spgemm import (
    MXU_MAX_TILE_DIM,
    choose_spgemm_tier,
    coo_has_duplicates,
    spgemm_auto,
    summa_spgemm_mxu,
)
from .parallel.spmat import SpParMat
from .parallel.vec import DistMultiVec, DistVec
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
from .utils.graph500 import build_graph, build_structures
from .utils.rmat import rmat_symmetric_coo_host

__all__ = [
    "DistMultiVec",
    "DistVec",
    "EllParMat",
    "Grid",
    "HostGrid",
    "MAX_MIN",
    "MIN_PLUS",
    "MXU_MAX_TILE_DIM",
    "OR_AND",
    "PAD_ROOT",
    "PLUS_TIMES",
    "SELECT2ND_MAX",
    "SELECT2ND_MIN",
    "STANDARD_SEMIRINGS",
    "Semiring",
    "SpParMat",
    "SpTuples",
    "batch_traversed_edges",
    "bfs_batch_compact",
    "build_csc_companion",
    "build_csc_companion_host",
    "build_csr_companion",
    "build_csr_companion_host",
    "build_graph",
    "build_structures",
    "choose_spgemm_tier",
    "coo_has_duplicates",
    "csc_companion_from_arrays",
    "dense_support_nnz",
    "dense_to_sptuples",
    "dense_to_tuples_arrays",
    "distmultivec_from_arrays",
    "ellparmat_from_arrays",
    "expand_ranges",
    "flat_to_tuples_arrays",
    "flat_to_tuples_arrays_reference",
    "min_plus_matmul",
    "operations",
    "rmat_symmetric_coo_host",
    "semiring_matmul",
    "semiring_matmul_reference",
    "sparsify",
    "sparsify_windowed",
    "spgemm_auto",
    "spparmat_from_arrays",
    "summa_spgemm_mxu",
    "upload_csc_companion",
    "validate_bfs_device",
    "validate_bfs_tree",
]
