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
at once and ``bfs_single`` from one root at a time,
``batch_traversed_edges``, ``single_traversed_edges`` and
``validate_bfs_device`` count and check) with the ELL SpMV family under it
(``dist_spmv_ell*``, ``EllParMat.reduce``, ``bfs_batch``,
``sssp_batch``); and the SpMV layer on the COO-tiled ``SpParMat``
(``dist_spmv``, ``dist_spmv_masked``, ``dist_spmspv``,
``dist_spmspv_masked`` over the local ``ops.spmv`` kernels and ``CSC``
tiles, the ``DistVec`` op pack, ``SpParMat.reduce`` / ``transpose`` /
``dim_apply`` and the per-tile maps) with the applications on it: ``bfs``,
``bfs_diropt``, ``sssp``, ``pagerank``, ``pagerank_batch``,
``connected_components`` (FastSV), ``lacc`` and ``mis``. All of it is in
PyTorch ops as the reference runs it in XLA ops.
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
    BFS_CLASS_LADDER,
    DEFAULT_SEQ_TIERS,
    batch_traversed_edges,
    bfs,
    bfs_batch,
    bfs_batch_compact,
    bfs_diropt,
    bfs_diropt_auto,
    bfs_single,
    parse_tier_spec,
    single_traversed_edges,
    traversed_edges,
    validate_bfs_device,
    validate_bfs_tree,
)
from .models.cc import connected_components, lacc, num_components
from .models.mis import mis
from .models.pagerank import pagerank, pagerank_batch
from .models.sssp import sssp, sssp_batch
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
from .ops.compressed import CSC, CSR
from .ops.segment import expand_ranges, segment_reduce
from .ops.spgemm import dense_support_nnz, sparsify, sparsify_windowed
from .ops.tuples import SpTuples
from .parallel.ellmat import (
    EllParMat,
    build_csc_companion,
    build_csc_companion_host,
    build_csr_companion,
    build_csr_companion_host,
    dist_spmv_ell,
    dist_spmv_ell_masked,
    dist_spmv_ell_masked_multi,
    dist_spmv_ell_multi,
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
from .parallel.spmat import SpParMat, ones_f32, ones_i32
from .parallel.spmv import (
    csc_tiles,
    dist_spmspv,
    dist_spmspv_masked,
    dist_spmv,
    dist_spmv_masked,
)
from .parallel.vec import DistMultiVec, DistVec, concatenate
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
    "BFS_CLASS_LADDER",
    "CSC",
    "CSR",
    "DEFAULT_SEQ_TIERS",
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
    "bfs",
    "bfs_batch",
    "bfs_batch_compact",
    "bfs_diropt",
    "bfs_diropt_auto",
    "bfs_single",
    "build_csc_companion",
    "build_csc_companion_host",
    "build_csr_companion",
    "build_csr_companion_host",
    "build_graph",
    "build_structures",
    "choose_spgemm_tier",
    "concatenate",
    "connected_components",
    "coo_has_duplicates",
    "csc_companion_from_arrays",
    "csc_tiles",
    "dense_support_nnz",
    "dense_to_sptuples",
    "dense_to_tuples_arrays",
    "dist_spmspv",
    "dist_spmspv_masked",
    "dist_spmv",
    "dist_spmv_ell",
    "dist_spmv_ell_masked",
    "dist_spmv_ell_masked_multi",
    "dist_spmv_ell_multi",
    "dist_spmv_masked",
    "distmultivec_from_arrays",
    "ellparmat_from_arrays",
    "expand_ranges",
    "flat_to_tuples_arrays",
    "flat_to_tuples_arrays_reference",
    "lacc",
    "min_plus_matmul",
    "mis",
    "num_components",
    "ones_f32",
    "ones_i32",
    "operations",
    "pagerank",
    "pagerank_batch",
    "parse_tier_spec",
    "rmat_symmetric_coo_host",
    "segment_reduce",
    "semiring_matmul",
    "semiring_matmul_reference",
    "single_traversed_edges",
    "sparsify",
    "sparsify_windowed",
    "spgemm_auto",
    "spparmat_from_arrays",
    "sssp",
    "sssp_batch",
    "summa_spgemm_mxu",
    "traversed_edges",
    "upload_csc_companion",
    "validate_bfs_device",
    "validate_bfs_tree",
]
