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
``connected_components`` (FastSV), ``lacc`` and ``mis``; and the general
sparse SpGEMM: the ESC tier (``spgemm``, ``summa_spgemm``, merge by sort or
by sorted runs, ring or all-gather stage order) and the scan tier
(``spgemm_scan``) with their symbolic sizing (``summa_stage_flops``,
``summa_capacities``), phased and blocked products
(``mem_efficient_spgemm``, ``block_spgemm``), the router
(``choose_spgemm_tier``, ``spgemm_auto``), the windowed tier
(``spgemm_windowed``: dense row-block accumulators folded by the semiring's
scatter or by dense window products, the semiring GEMM kernel's second
caller; its fused, blocked and local forms, symbolic passes and plans),
the 3D (layered) tier (``Grid3D``, ``SpParMat3D``, ``spgemm3d``: ESC and
windowed SUMMA per layer with the fiber merge by sort, sorted runs or
``hash_merge``; ``spgemm_auto(grid3=...)`` routes windowed products there;
``parallel.mesh3d``), the bit-packed support oracle
(``pack_support_bits``, ``popcount_pair_counts``,
``spgemm_support_bits``), the sparse elementwise layer (``ops.ewise``, the
elementwise, select and split methods of ``SpParMat``), ``subsref`` /
``spasgn``, ``DenseParMat``, and on them ``triangle_count`` and
betweenness centrality (``bc_batch``, ``betweenness_centrality``,
``bc_batch_dense``); and attributed-edge graphs with runtime filters
(``SemanticGraph``, ``filtered_bfs``, ``filtered_mis``); and the CombBLAS
applications on the SpGEMM and SpMV layers: Markov clustering (``mcl``:
sparse, block, dense and 3D loops), bipartite matchings (``maximal_matching``,
``maximum_matching``, ``awpm``), orderings (``rcm_ordering``,
``minimum_degree_ordering``), and the SpMM lane (``dist_spmm_ell``,
``summa_spmm``, ``spmm_khop``) with k-hop feature propagation
(``propagate_features``); and graph input: the device R-MAT generator
(``rmat_edges`` on threefry keys, ``utils.threefry``, the reference's
stream bit for bit), the Graph500 v2.1 generator (``graph500_edges``,
``graph500_edges_native``), tuple routing to owner tiles
(``redistribute_coo``, ``from_device_coo``), Graph500 kernel 1 on the
device (``kernel1_device``, ``permute_vertices``,
``isolated_compression_perm``), Matrix Market, binary, vector and
labelled-tuple files (``io``) and ``.npz`` and sharded checkpoints
(``utils.checkpoint``); and the measured-plan tuner (``tuner``: the one
parser of the ``COMBBLAS_*`` knobs, the JSONL plan store beside the
kernel build cache (``utils.compile_cache``), the probe that measures the
rungs), which ``spgemm_auto``, ``spgemm3d`` and the SpMM backend consult; and
the serving engine and the mutation lane (``serve``: ``GraphEngine`` with its
(kind, width) plan cache over the batch searches, the lane batcher;
``dynamic``: the delta log, incremental merges into graph versions, warm
refreshes, the write-ahead log and crash recovery from ``utils.checkpoint``'s
version snapshots). All of it is in PyTorch ops as the reference runs
it in XLA ops (the generator and the Matrix Market parser as host C++).
Entry points run on the card unless the caller passes ``device="cpu"``
to ``Grid.make``; on the CPU each kernel's plain PyTorch version runs.
"""

from . import operations
from .convert import (
    csc_companion_from_arrays,
    denseparmat_from_arrays,
    distmultivec_from_arrays,
    ellparmat_from_arrays,
    key_from_jax,
    spparmat_from_arrays,
)
from .io import (
    read_binary,
    read_labeled_spmat,
    read_labeled_tuples,
    read_mm,
    read_mm_distributed,
    read_mm_spmat,
    read_vec,
    write_binary,
    write_mm,
    write_vec,
)
from .models.graph500 import isolated_compression_perm, kernel1_device, permute_vertices
from .parallel.collectives import axis_reduce, axis_reduce_scatter, axis_ring_reduce
from .parallel.redistribute import from_device_coo, redistribute_coo
from .models import PAD_ROOT
from .models.bc import (
    bc_batch,
    bc_batch_dense,
    bc_batch_dense_lanes,
    betweenness_centrality,
)
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
from .models.matching import (
    awpm,
    is_maximal,
    is_valid_matching,
    matching_weight,
    maximal_matching,
    maximum_matching,
    maximum_matching_device,
)
from .models.mcl import chaos, inflate, make_col_stochastic, mcl, mcl_prune_recovery_select
from .models.mis import mis
from .models.ordering import (
    bandwidth,
    minimum_degree_ordering,
    pseudo_peripheral_vertex,
    rcm_ordering,
)
from .models.pagerank import pagerank, pagerank_batch
from .models.propagate import propagate_features
from .models.sssp import sssp, sssp_batch
from .models.tc import (
    DENSE_MAX_DIM,
    EDGE_HARVEST_BITS_MAX_DIM,
    EDGE_HARVEST_MAX_DIM,
    triangle_count,
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
from .ops.compressed import CSC, CSR
from .ops.ewise import ewise_apply, ewise_mult, intersect_lookup
from .ops.segment import expand_ranges, segment_reduce
from .ops.spgemm import (
    CHUNK_W,
    accumulate_block_scatter,
    combine_hilo,
    dense_support_nnz,
    densify_combine,
    expand,
    expansion_slots,
    flops,
    flops_padded,
    hash_merge,
    hash_table_capacity,
    hilo_split,
    local_spgemm,
    mask_rows,
    merge_sorted_runs,
    pack_support_bits,
    popcount32,
    popcount_pair_counts,
    sparsify,
    sparsify_windowed,
    spgemm_support_bits,
    support_window_counts,
)
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
from .parallel.dense import DenseParMat
from .parallel.grid import Grid, HostGrid, LocalOnlyError
from .parallel.multihost import init_distributed, make_global_grid
from .parallel.mesh3d import Grid3D, SpParMat3D, spgemm3d
from .parallel.indexing import col_selector, row_selector, spasgn, subsref
from .parallel.spgemm import (
    MXU_MAX_TILE_DIM,
    TIERS,
    WINDOWED_MAX_CELLS_PER_FLOP,
    WINDOWED_MAX_COL_WINDOWS,
    WINDOWED_MAX_PANEL_CELLS,
    WINDOWED_MAX_TILE_CELLS,
    PhaseAdjustedWarning,
    block_spgemm,
    bucket_plan_caps,
    calculate_phases,
    choose_spgemm_tier,
    choose_tier_from_counts,
    coo_has_duplicates,
    default_block_cols,
    default_block_rows,
    dot_panel_feasible,
    estimate_flops,
    estimate_nnz_upper,
    host_value,
    local_spgemm_windowed,
    mem_efficient_spgemm,
    packed_windows,
    packed_windows_2d,
    panel_cap_from_bnnz,
    resolve_spgemm_backend,
    spgemm,
    spgemm_auto,
    spgemm_scan,
    spgemm_windowed,
    summa_capacities,
    summa_capacities_host,
    summa_rowblock_flops,
    summa_rowblock_flops_host,
    summa_rowblock_flops_pair,
    summa_spgemm,
    summa_spgemm_mxu,
    summa_spgemm_scan,
    summa_spgemm_windowed,
    summa_spgemm_windowed_blocked,
    summa_stage_flops,
    summa_stage_flops_host,
    summa_window_bnnz,
    summa_window_bnnz_host,
    summa_window_flops_host,
    summa_window_flops_pair,
    windowed_plan,
    windowed_plan_2d,
)
from .parallel.spmat import SpParMat, key_u32_to_val, monotone_key_u32, ones_f32, ones_i32
from .parallel.spmm import (
    SPMM_BACKENDS,
    admissible_spmm_backends,
    dist_spmm,
    dist_spmm_ell,
    pad_feature_width,
    pad_features,
    resolve_spmm_backend,
    row_invdeg,
    spmm_backend_heuristic,
    spmm_khop,
    summa_spmm,
)
from .parallel.spmv import (
    csc_tiles,
    dist_spmspv,
    dist_spmspv_masked,
    dist_spmv,
    dist_spmv_masked,
)
from .parallel.vec import DistMultiVec, DistVec, concatenate
from .semantic import FILTERED_SELECT2ND_MAX, SemanticGraph, filtered_bfs, filtered_mis
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
from .utils.refgen21 import graph500_edges, graph500_edges_native
from .utils.rmat import rmat_edges, rmat_symmetric_coo, rmat_symmetric_coo_host
from .utils.threefry import ThreefryKey
from .utils import checkpoint, compile_cache
from . import tuner

__all__ = [
    "BFS_CLASS_LADDER",
    "CHUNK_W",
    "CSC",
    "CSR",
    "DEFAULT_SEQ_TIERS",
    "DENSE_MAX_DIM",
    "DenseParMat",
    "DistMultiVec",
    "DistVec",
    "EDGE_HARVEST_BITS_MAX_DIM",
    "EDGE_HARVEST_MAX_DIM",
    "EllParMat",
    "FILTERED_SELECT2ND_MAX",
    "Grid",
    "Grid3D",
    "HostGrid",
    "LocalOnlyError",
    "init_distributed",
    "make_global_grid",
    "axis_reduce",
    "axis_reduce_scatter",
    "MAX_MIN",
    "MIN_PLUS",
    "MXU_MAX_TILE_DIM",
    "OR_AND",
    "PAD_ROOT",
    "PLUS_TIMES",
    "PhaseAdjustedWarning",
    "SELECT2ND_MAX",
    "SELECT2ND_MIN",
    "SPMM_BACKENDS",
    "STANDARD_SEMIRINGS",
    "SemanticGraph",
    "Semiring",
    "SpParMat",
    "SpParMat3D",
    "SpTuples",
    "TIERS",
    "ThreefryKey",
    "WINDOWED_MAX_CELLS_PER_FLOP",
    "WINDOWED_MAX_COL_WINDOWS",
    "WINDOWED_MAX_PANEL_CELLS",
    "WINDOWED_MAX_TILE_CELLS",
    "accumulate_block_scatter",
    "admissible_spmm_backends",
    "awpm",
    "axis_ring_reduce",
    "bandwidth",
    "batch_traversed_edges",
    "bc_batch",
    "bc_batch_dense",
    "bc_batch_dense_lanes",
    "betweenness_centrality",
    "bfs",
    "bfs_batch",
    "bfs_batch_compact",
    "bfs_diropt",
    "bfs_diropt_auto",
    "bfs_single",
    "block_spgemm",
    "bucket_plan_caps",
    "build_csc_companion",
    "build_csc_companion_host",
    "build_csr_companion",
    "build_csr_companion_host",
    "build_graph",
    "build_structures",
    "calculate_phases",
    "chaos",
    "checkpoint",
    "compile_cache",
    "tuner",
    "choose_spgemm_tier",
    "choose_tier_from_counts",
    "col_selector",
    "combine_hilo",
    "concatenate",
    "connected_components",
    "coo_has_duplicates",
    "csc_companion_from_arrays",
    "csc_tiles",
    "default_block_cols",
    "default_block_rows",
    "dense_support_nnz",
    "dense_to_sptuples",
    "dense_to_tuples_arrays",
    "denseparmat_from_arrays",
    "densify_combine",
    "dist_spmm",
    "dist_spmm_ell",
    "dist_spmspv",
    "dist_spmspv_masked",
    "dist_spmv",
    "dist_spmv_ell",
    "dist_spmv_ell_masked",
    "dist_spmv_ell_masked_multi",
    "dist_spmv_ell_multi",
    "dist_spmv_masked",
    "distmultivec_from_arrays",
    "dot_panel_feasible",
    "ellparmat_from_arrays",
    "estimate_flops",
    "estimate_nnz_upper",
    "ewise_apply",
    "ewise_mult",
    "expand",
    "expand_ranges",
    "expansion_slots",
    "filtered_bfs",
    "filtered_mis",
    "flat_to_tuples_arrays",
    "flat_to_tuples_arrays_reference",
    "flops",
    "flops_padded",
    "from_device_coo",
    "graph500_edges",
    "graph500_edges_native",
    "hash_merge",
    "hash_table_capacity",
    "hilo_split",
    "host_value",
    "inflate",
    "intersect_lookup",
    "is_maximal",
    "is_valid_matching",
    "isolated_compression_perm",
    "kernel1_device",
    "key_from_jax",
    "key_u32_to_val",
    "lacc",
    "local_spgemm",
    "local_spgemm_windowed",
    "make_col_stochastic",
    "mask_rows",
    "matching_weight",
    "maximal_matching",
    "maximum_matching",
    "maximum_matching_device",
    "mcl",
    "mcl_prune_recovery_select",
    "mem_efficient_spgemm",
    "merge_sorted_runs",
    "min_plus_matmul",
    "minimum_degree_ordering",
    "mis",
    "monotone_key_u32",
    "num_components",
    "ones_f32",
    "ones_i32",
    "operations",
    "pack_support_bits",
    "packed_windows",
    "packed_windows_2d",
    "pad_feature_width",
    "pad_features",
    "pagerank",
    "pagerank_batch",
    "panel_cap_from_bnnz",
    "parse_tier_spec",
    "permute_vertices",
    "popcount32",
    "popcount_pair_counts",
    "propagate_features",
    "pseudo_peripheral_vertex",
    "rcm_ordering",
    "read_binary",
    "read_labeled_spmat",
    "read_labeled_tuples",
    "read_mm",
    "read_mm_distributed",
    "read_mm_spmat",
    "read_vec",
    "redistribute_coo",
    "resolve_spgemm_backend",
    "resolve_spmm_backend",
    "rmat_edges",
    "rmat_symmetric_coo",
    "rmat_symmetric_coo_host",
    "row_invdeg",
    "row_selector",
    "segment_reduce",
    "semiring_matmul",
    "semiring_matmul_reference",
    "single_traversed_edges",
    "sparsify",
    "sparsify_windowed",
    "spasgn",
    "spgemm",
    "spgemm3d",
    "spgemm_auto",
    "spgemm_scan",
    "spgemm_support_bits",
    "spgemm_windowed",
    "spmm_backend_heuristic",
    "spmm_khop",
    "spparmat_from_arrays",
    "sssp",
    "sssp_batch",
    "subsref",
    "summa_capacities",
    "summa_capacities_host",
    "summa_rowblock_flops",
    "summa_rowblock_flops_host",
    "summa_rowblock_flops_pair",
    "summa_spgemm",
    "summa_spgemm_mxu",
    "summa_spgemm_scan",
    "summa_spgemm_windowed",
    "summa_spgemm_windowed_blocked",
    "summa_spmm",
    "summa_stage_flops",
    "summa_stage_flops_host",
    "summa_window_bnnz",
    "summa_window_bnnz_host",
    "summa_window_flops_host",
    "summa_window_flops_pair",
    "support_window_counts",
    "traversed_edges",
    "triangle_count",
    "upload_csc_companion",
    "validate_bfs_device",
    "validate_bfs_tree",
    "windowed_plan",
    "windowed_plan_2d",
    "write_binary",
    "write_mm",
    "write_vec",
]
